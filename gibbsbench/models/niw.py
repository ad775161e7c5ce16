"""Normal-inverse-Wishart feature columns (Murphy 2007, Eqs. 251-254, 258,
266), in plain PyTorch.  Stats are additive: per slot and column the sum
of the row vectors and the sum of their outer products.  Two dimensions
take closed forms that hold in any float dtype; more go through
torch.linalg in float32 or float64."""

import math

import torch

FLOAT_LEAVES = ('sum_x', 'sum_xxT')
INT_LEAVES = ()


def shared(block, dtype, device):
    s = block['shared']
    return {'mu': torch.tensor(s['mu'], dtype=dtype, device=device),
            'kappa': torch.tensor(float(s['kappa']), dtype=dtype,
                                  device=device),
            'psi': torch.tensor(s['psi'], dtype=dtype, device=device),
            'nu': torch.tensor(float(s['nu']), dtype=dtype, device=device)}


def stats(block, values, assign, C, dtype):
    """{'sum_x' [C, cols, d], 'sum_xxT' [C, cols, d, d]}, summed in
    `dtype`."""
    v = values.to(dtype)                                       # [R, cols, d]
    cols, d = v.shape[1], v.shape[2]
    outer = v[..., :, None] * v[..., None, :]
    return {'sum_x': torch.zeros((C, cols, d), dtype=dtype,
                                 device=v.device).index_add_(0, assign, v),
            'sum_xxT': torch.zeros((C, cols, d, d), dtype=dtype,
                                   device=v.device).index_add_(0, assign,
                                                               outer)}


def program_stats(group):
    return ({'sum_x': group.sum_x.to(torch.float64),
             'sum_xxT': group.sum_xxT.to(torch.float64)},
            {'count': group.count})


def _det_inv(m):
    """(det, inverse) of [..., d, d] positive definite matrices; a
    determinant that low precision rounds to 0 or below is taken as the
    dtype's least positive number."""
    if m.shape[-1] == 2:
        a, b = m[..., 0, 0], m[..., 0, 1]
        c, e = m[..., 1, 0], m[..., 1, 1]
        det = torch.clamp(a * e - b * c, min=torch.finfo(m.dtype).tiny)
        inv = torch.stack([torch.stack([e, -b], -1),
                           torch.stack([-c, a], -1)], -2) / det[..., None,
                                                                None]
        return det, inv
    wide = m.to(torch.float64 if m.dtype == torch.float64
                else torch.float32)
    return (torch.linalg.det(wide).to(m.dtype),
            torch.linalg.inv(wide).to(m.dtype))


def _lmvgamma(d, a):
    out = d * (d - 1) / 4.0 * math.log(math.pi)
    for j in range(d):
        out = out + torch.lgamma(a - 0.5 * j)
    return out


def _posterior(sh, counts, st):
    n = counts.to(st['sum_x'].dtype)[:, None]                 # [K, 1]
    safe = torch.clamp(n, min=1)[..., None]
    xbar = torch.where(n[..., None] > 0, st['sum_x'] / safe,
                       torch.zeros_like(st['sum_x']))          # [K, cols, d]
    kappa_n = sh['kappa'] + n                                  # [K, cols]
    mu_n = (sh['kappa'] * sh['mu'] + st['sum_x']) / kappa_n[..., None]
    nu_n = sh['nu'] + n
    scatter = (st['sum_xxT'] - n[..., None, None]
               * xbar[..., :, None] * xbar[..., None, :])
    dev = xbar - sh['mu']
    psi_n = (sh['psi'] + scatter
             + (sh['kappa'] * n / kappa_n)[..., None, None]
             * dev[..., :, None] * dev[..., None, :])
    return n, kappa_n, mu_n, nu_n, psi_n


def score_data(block, sh, counts, st):
    """Log marginal likelihood of each slot's rows [C] (Eq. 266)."""
    d = sh['mu'].shape[-1]
    n, kappa_n, _, nu_n, psi_n = _posterior(sh, counts, st)
    det0, _ = _det_inv(sh['psi'])
    det_n, _ = _det_inv(psi_n)
    per_col = (_lmvgamma(d, 0.5 * nu_n) - _lmvgamma(d, 0.5 * sh['nu'])
               + 0.5 * sh['nu'] * torch.log(det0)
               - 0.5 * nu_n * torch.log(det_n)
               - 0.5 * n * d * math.log(math.pi)
               + 0.5 * d * torch.log(sh['kappa'] / kappa_n))
    return per_col.sum(1)


def predictive(block, sh, counts, st, values):
    """Log posterior predictive [m, K] of m rows' `values` [m, cols, d]
    (Eq. 258: a multivariate student-t per column)."""
    d = sh['mu'].shape[-1]
    _, kappa_n, mu_n, nu_n, psi_n = _posterior(sh, counts, st)
    dof = nu_n - d + 1                                         # [K, cols]
    scale = psi_n * ((kappa_n + 1) / (kappa_n * dof))[..., None, None]
    det, inv = _det_inv(scale)
    head = (torch.lgamma(0.5 * (dof + d)) - torch.lgamma(0.5 * dof)
            - 0.5 * d * torch.log(dof * math.pi) - 0.5 * torch.log(det))
    z = values.to(mu_n.dtype)[:, None] - mu_n[None]        # [m, K, cols, d]
    mahal = (z[..., :, None] * inv[None] * z[..., None, :]).sum((-1, -2))
    tail = 0.5 * (dof + d)[None] * torch.log1p(mahal / dof[None])
    return (head[None] - tail).sum(-1)
