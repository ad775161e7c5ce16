"""Special numerical functions (distributions_tpu.special).  Everything is
batched over tensors of any shape and computes in float32 on the device of
its input; `log_stirling1_row` builds its row on the host and moves it.
"""

import math

import torch


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(x, dtype=torch.float32)


def gammaln(x):
    """log|Γ(x)| (the JAX package's `jax.scipy.special.gammaln`)."""
    return torch.lgamma(_f32(x))


def logsumexp(scores, axis=-1, keepdims=False):
    """Max-subtracted logsumexp; rows that are all -inf stay -inf, not nan."""
    scores = _f32(scores)
    m = torch.amax(scores, dim=axis, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    out = torch.log(torch.sum(torch.exp(scores - m), dim=axis,
                              keepdim=True)) + m
    return out if keepdims else out.squeeze(axis)


def lgamma_diff(x, y):
    """lgamma(x + y) - lgamma(x), cancellation-safe for x >= 64: Stirling
    with the 1/(12z) and 1/(360z^3) corrections, differenced symbolically
    so every term is O(y log x) (see distributions_tpu.special)."""
    r = y / x
    xy = x + y
    return (y * torch.log(x) + (xy - 0.5) * torch.log1p(r) - y
            + (1.0 / 12.0) * (1.0 / xy - 1.0 / x)
            - (1.0 / 360.0) * (1.0 / (xy * xy * xy) - 1.0 / (x * x * x)))


def lgamma_ratio(x, y):
    """lgamma(x + y) - lgamma(x) for all x > 0, y >= 0: the direct
    difference below x = 64, `lgamma_diff` above it."""
    x = _f32(x)
    y = _f32(y)
    direct = torch.lgamma(x + y) - torch.lgamma(x)
    x_safe = torch.clamp(x, min=64.0)
    return torch.where(x >= 64.0, lgamma_diff(x_safe, y), direct)


def lgamma_nu(nu):
    """lgamma(nu/2 + 1/2) - lgamma(nu/2), the student-t coefficient.

    The naive difference cancels in f32 for large nu, so above nu = 64 the
    asymptotic 0.5 log x - 1/(8x) + 1/(192 x^3) (x = nu/2) is used."""
    nu = _f32(nu)
    direct = torch.lgamma(0.5 * nu + 0.5) - torch.lgamma(0.5 * nu)
    x = torch.clamp(0.5 * nu, min=1e-30)
    asym = 0.5 * torch.log(x) - 1.0 / (8.0 * x) + 1.0 / (192.0 * (x * x * x))
    return torch.where(nu < 64.0, direct, asym)


def log_beta(x, y):
    """log B(x, y).  The three-lgamma identity below max(x, y) = 64; above
    it lgamma(b) - lgamma_diff(a, b), which keeps f32 accuracy where the
    identity cancels."""
    x = _f32(x)
    y = _f32(y)
    a = torch.maximum(x, y)
    b = torch.minimum(x, y)
    direct = torch.lgamma(x) + torch.lgamma(y) - torch.lgamma(x + y)
    a_safe = torch.clamp(a, min=64.0)
    safe = torch.lgamma(b) - lgamma_diff(a_safe, b)
    return torch.where(a >= 64.0, safe, direct)


def log_binom(n, k):
    """log C(n, k) = -log(n + 1) - log B(k + 1, n - k + 1)."""
    n = _f32(n)
    k = _f32(k)
    return -torch.log(n + 1.0) - log_beta(k + 1.0, n - k + 1.0)


def log_factorial(n):
    """log n! = lgamma(n + 1)."""
    return torch.lgamma(_f32(n) + 1.0)


def lmultigamma(d, a):
    """Log multivariate gamma function of dimension `d` (a Python int) at
    `a` (batched)."""
    d = int(d)
    a = _f32(a)[..., None]
    j = torch.arange(1, d + 1, dtype=torch.float32, device=a.device)
    log_pi = 1.1447298858494002
    return (0.25 * d * (d - 1) * log_pi
            + torch.lgamma(a + 0.5 * (1.0 - j)).sum(-1))


def log_sum_exp(x, y):
    """Pairwise logsumexp log(exp(x) + exp(y))."""
    return torch.logaddexp(_f32(x), _f32(y))


def factorial(n):
    return torch.exp(log_factorial(n))


# -- Stirling numbers of the first kind -------------------------------------

_STIRLING1_EXACT_MAX = 32


def _log_stirling1_row_exact(n):
    """Exact unsigned Stirling-1 row [log s(n, 0), ..., log s(n, n)] by the
    log-space recurrence s(n, k) = (n - 1) s(n - 1, k) + s(n - 1, k - 1),
    in float64 numpy (n is a small Python int), returned as float32 on
    the CPU."""
    import numpy as np
    prev = np.array([0.0])   # log s(0, 0) = 0
    for m in range(1, n + 1):
        cur = np.full(m + 1, -np.inf)
        cur[m] = 0.0
        if m > 1:
            cur[1:m] = np.logaddexp(np.log(m - 1) + prev[1:m], prev[0:m - 1])
        prev = cur
    return torch.from_numpy(prev.astype(np.float32))


def _log_stirling1_row_approx(n):
    """Softmin blend of DLMF 26.8.40 (small k) and Gruenberg's asymptotic
    (large k), on the CPU in float32."""
    import numpy as np
    k = torch.arange(n + 1, dtype=torch.float32)
    nf = float(n)
    log_factorial_n_minus_1 = float(torch.lgamma(torch.tensor(
        nf, dtype=torch.float32)))
    log_n_sq_over_two = float(np.log(nf * nf / 2.0))
    euler_gamma = 0.57721566490153286060
    log_stuff = float(np.log(euler_gamma + np.log(nf - 1.0)))
    softness = nf / 3.0
    approx1 = (log_factorial_n_minus_1 - torch.lgamma(k)
               + (k - 1.0) * log_stuff)
    approx2 = (nf - k) * log_n_sq_over_two - torch.lgamma(nf - k + 1.0)
    row = -softness * torch.logaddexp(-approx1 / softness,
                                      -approx2 / softness)
    row[0] = float('-inf')
    row[n] = 0.0
    return row


def log_stirling1_row(n, device=None):
    """[log s(n, 0), ..., log s(n, n)] as float32 on `device` (default:
    the package's default device): exact for n < 32, approximate above."""
    from distributions_tpu_torch.config import resolve_device
    n = int(n)
    row = (_log_stirling1_row_exact(n) if n < _STIRLING1_EXACT_MAX
           else _log_stirling1_row_approx(n))
    return row.to(resolve_device(device))


# -- misc -------------------------------------------------------------------

def log1p_exp(x):
    """log(1 + exp(x)), stable."""
    x = _f32(x)
    return torch.logaddexp(torch.zeros_like(x), x)


def scores_to_likelihoods(scores, axis=-1):
    """Max-subtracted exp: (likelihoods, their sum over `axis`)."""
    scores = _f32(scores)
    m = torch.amax(scores, dim=axis, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    likes = torch.exp(scores - m)
    return likes, likes.sum(axis)


def stick(betas):
    """Normalize a stick of masses to sum to one."""
    return betas / betas.sum()


def clip_finite(x, minval=-3.4e38, maxval=3.4e38):
    return torch.clamp(_f32(x), minval, maxval)


def poly_eval(coeffs, x):
    """Horner evaluation of a polynomial, highest degree first."""
    acc = torch.zeros_like(x) + coeffs[0]
    for c in coeffs[1:]:
        acc = acc * x + c
    return acc


def lax_cumlogsumexp(x, axis=0):
    """Cumulative logsumexp along `axis` (the name is the JAX package's):
    max-subtracted, so a finite maximum keeps every prefix finite."""
    x = _f32(x)
    m = torch.amax(x, dim=axis, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return torch.log(torch.cumsum(torch.exp(x - m), dim=axis)) + m


# -- the JAX module's elementwise names and `fast_*` aliases ----------------
# Each aliases the exact function (as in distributions_tpu.special), never
# the polynomial approximations of ops/fused_kernels.

log = torch.log
exp = torch.exp
sqrt = torch.sqrt
pi = math.pi
lgamma = gammaln
fast_log = torch.log
fast_exp = torch.exp
fast_lgamma = gammaln
fast_log_beta = log_beta
fast_log_binom = log_binom
fast_log_factorial = log_factorial
fast_lgamma_nu = lgamma_nu
fast_log_sum_exp = log_sum_exp

__all__ = [
    'log', 'exp', 'sqrt', 'pi', 'lgamma', 'gammaln',
    'fast_log', 'fast_exp', 'fast_lgamma',
    'log_sum_exp', 'fast_log_sum_exp', 'logsumexp', 'log_beta',
    'fast_log_beta',
    'log_binom', 'fast_log_binom', 'log_factorial', 'fast_log_factorial',
    'factorial', 'lgamma_nu', 'fast_lgamma_nu', 'lmultigamma',
    'log_stirling1_row', 'log1p_exp', 'scores_to_likelihoods',
]
