"""Normal-inverse-chi-squared feature columns (Murphy, "Conjugate Bayesian
analysis of the Gaussian distribution", 2007, Eqs. 141-144, 171, 176), in
plain PyTorch and in any float dtype.  Stats are additive: per slot and
column the row count, the sum and the sum of squares."""

import math

import torch

FLOAT_LEAVES = ('sum', 'sumsq')
INT_LEAVES = ()


def shared(block, dtype, device):
    s = block['shared']
    return {k: torch.tensor(float(s[k]), dtype=dtype, device=device)
            for k in ('mu', 'kappa', 'sigmasq', 'nu')}


def stats(block, values, assign, C, dtype):
    """{'sum', 'sumsq'} [C, cols], summed in `dtype`."""
    v = values.to(dtype)
    cols = v.shape[1]
    out = {}
    for name, x in (('sum', v), ('sumsq', v * v)):
        out[name] = torch.zeros((C, cols), dtype=dtype,
                                device=v.device).index_add_(0, assign, x)
    return out


def program_stats(group):
    """The program's Group (count, mean, count_times_variance), each
    [C, cols], in the additive form, float64; and its per-column counts."""
    n = group.count.to(torch.float64)
    mean = group.mean.to(torch.float64)
    ctv = group.count_times_variance.to(torch.float64)
    return ({'sum': mean * n, 'sumsq': ctv + n * mean * mean},
            {'count': group.count})


def _posterior(sh, counts, st):
    n = counts.to(st['sum'].dtype)[:, None]
    safe = torch.clamp(n, min=1)
    mean = torch.where(n > 0, st['sum'] / safe, torch.zeros_like(n))
    # a sum of squared deviations is never negative (the program clamps
    # its own likewise); low precision can round this difference below 0
    ctv = torch.clamp(torch.where(n > 1, st['sumsq'] - st['sum'] * mean,
                                  torch.zeros_like(n)), min=0)
    kappa_n = sh['kappa'] + n
    mu_n = (sh['kappa'] * sh['mu'] + st['sum']) / kappa_n
    nu_n = sh['nu'] + n
    dev = sh['mu'] - mean
    sigmasq_n = (sh['nu'] * sh['sigmasq'] + ctv
                 + n * sh['kappa'] * dev * dev / kappa_n) / nu_n
    return n, kappa_n, mu_n, nu_n, sigmasq_n


def score_data(block, sh, counts, st):
    """Log marginal likelihood of each slot's rows [C] (Eq. 171)."""
    n, kappa_n, _, nu_n, sigmasq_n = _posterior(sh, counts, st)
    per_col = (torch.lgamma(0.5 * nu_n) - torch.lgamma(0.5 * sh['nu'])
               + 0.5 * torch.log(sh['kappa'] / kappa_n)
               + 0.5 * sh['nu'] * torch.log(sh['nu'] * sh['sigmasq'])
               - 0.5 * nu_n * torch.log(nu_n * sigmasq_n)
               - 0.5 * n * math.log(math.pi))
    return per_col.sum(1)


def predictive(block, sh, counts, st, values):
    """Log posterior predictive [m, K] of m rows' `values` [m, cols]
    against K slots' stats (Eq. 176: a student-t per column)."""
    _, kappa_n, mu_n, nu_n, sigmasq_n = _posterior(sh, counts, st)
    lam = (1 + kappa_n) * sigmasq_n / kappa_n                  # [K, cols]
    head = (torch.lgamma(0.5 * (nu_n + 1)) - torch.lgamma(0.5 * nu_n)
            - 0.5 * torch.log(nu_n * math.pi * lam))
    x = values.to(mu_n.dtype)[:, None, :]                      # [m, 1, cols]
    t = x - mu_n[None]
    tail = 0.5 * (nu_n + 1)[None] * torch.log1p(t * t / (nu_n * lam)[None])
    return (head[None] - tail).sum(-1)
