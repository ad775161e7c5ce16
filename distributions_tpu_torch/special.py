"""Special numerical functions: the part of distributions_tpu.special that
the collapsed-Gibbs path uses.  Everything is batched over tensors of any
shape and computes in float32 on the device of its input.
"""

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
