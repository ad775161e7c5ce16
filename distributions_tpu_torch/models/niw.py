"""Normal-Inverse-Wishart conjugate model on multivariate normal data
(distributions_tpu.models.niw): Value=float vector [D],
Shared={mu[D], kappa, psi[D, D], nu},
Group={count, sum_x[D], sum_xxT[D, D]}.  Equations from Murphy (2007)
Eqs. 251-254, 258, 266.  Batched over the group's leading axes (usually
[C, cols]) with `torch.linalg` on [..., D, D] batches."""

import math
from typing import NamedTuple

import numpy as np
import torch

from distributions_tpu_torch.config import resolve_device
from distributions_tpu_torch.models import base
from distributions_tpu_torch.random import (
    sample_multivariate_normal, sample_normal_inverse_wishart,
    sample_std_normal)
from distributions_tpu_torch.random import score_student_t  # noqa: F401
from distributions_tpu_torch.special import lgamma_nu, lmultigamma

NAME = 'NormalInverseWishart'
EXAMPLES = [
    {
        'shared': {
            'mu': np.zeros(2), 'kappa': 2., 'psi': np.eye(2), 'nu': 3.,
        },
        'values': [np.array(v) for v in (
            [1., 2.], [-2., 3.], [-0.2, -0.2], [-0.1, 0.5],
            [0.8, 0.5], [0.8, 0.3], [-9., 0.2],
        )],
    },
    {
        'shared': {
            'mu': np.ones(3), 'kappa': 7.5, 'psi': np.eye(3), 'nu': 5.,
        },
        'values': [np.array(v) for v in (
            [1.35, 0.97, 0.88], [0.87, 1.74, 2.13], [-0.31, 1.48, 1.96],
            [1.18, 0.34, 1.00], [1.47, 0.62, -0.10], [-0.23, 2.23, 0.99],
            [1.23, 0.98, 0.36], [1.97, 0.81, 0.79], [0.59, 4.27, 0.44],
        )],
    },
    {
        'shared': {
            'mu': -np.ones(4), 'kappa': 7.5, 'psi': np.eye(4), 'nu': 10.,
        },
        'values': [np.array(v) for v in (
            [0.32, -1.92, -2.13, -0.78], [-2.35, -1.98, -0.27, -1.48],
            [-0.54, -1.76, -1.14, 0.24], [-0.68, -1.62, -0.76, -1.82],
            [-3.03, 0.54, -1.85, -0.53], [0.56, -0.96, -1.00, -2.05],
            [-1.18, -1.52, -1.19, -1.06], [0.47, -0.23, -0.99, 0.69],
            [-1.41, -3.18, -3.09, -1.93],
        )],
    },
]
Value = np.ndarray

_LOG_PI = 1.1447298858494002


class Shared(NamedTuple):
    mu: torch.Tensor     # [..., D]
    kappa: torch.Tensor
    psi: torch.Tensor    # [..., D, D]
    nu: torch.Tensor


class Group(NamedTuple):
    count: torch.Tensor    # [...] int32
    sum_x: torch.Tensor    # [..., D]
    sum_xxT: torch.Tensor  # [..., D, D]


def dim(shared):
    return shared.mu.shape[-1]


def shared_from_dict(raw, device=None):
    device = resolve_device(device)

    def arr(x):
        return torch.from_numpy(np.asarray(x, np.float32).copy()).to(device)
    return Shared(mu=arr(raw['mu']),
                  kappa=base.scalar(raw['kappa'], torch.float32, device),
                  psi=arr(raw['psi']),
                  nu=base.scalar(raw['nu'], torch.float32, device))


def shared_to_dict(shared):
    return {'mu': shared.mu.cpu().numpy().astype(np.float64),
            'kappa': float(shared.kappa),
            'psi': shared.psi.cpu().numpy().astype(np.float64),
            'nu': float(shared.nu)}



def group_from_dict(raw, device=None):
    device = resolve_device(device)

    def arr(x):
        return torch.from_numpy(np.asarray(x, np.float32).copy()).to(device)
    return Group(count=base.scalar(raw['count'], torch.int32, device),
                 sum_x=arr(raw['sum_x']), sum_xxT=arr(raw['sum_xxT']))


def group_to_dict(group):
    return {'count': int(group.count),
            'sum_x': group.sum_x.cpu().numpy().astype(np.float64),
            'sum_xxT': group.sum_xxT.cpu().numpy().astype(np.float64)}


def group_init(shared, shape=()):
    d = dim(shared)
    dev = shared.mu.device
    shape = tuple(shape)
    return Group(count=torch.zeros(shape, dtype=torch.int32, device=dev),
                 sum_x=torch.zeros(shape + (d,), dtype=torch.float32,
                                   device=dev),
                 sum_xxT=torch.zeros(shape + (d, d), dtype=torch.float32,
                                     device=dev))


def _outer(a, b):
    return a[..., :, None] * b[..., None, :]


def plus_group(shared, group):
    """Posterior hyperparameters, Murphy Eqs. 251-254, batched over the
    group's leading axes."""
    n = group.count.to(torch.float32)[..., None]                 # [K, 1]
    safe_n = torch.clamp(n, min=1.0)
    xbar = torch.where(n > 0, group.sum_x / safe_n,
                       torch.zeros_like(group.sum_x))            # [K, D]
    kappa_n = shared.kappa + n                                   # [K, 1]
    mu_n = (shared.kappa * shared.mu + group.sum_x) / kappa_n    # [K, D]
    nu_n = shared.nu + n[..., 0]                                 # [K]
    diff = xbar - shared.mu                                      # [K, D]
    C_n = (group.sum_xxT - _outer(group.sum_x, xbar)
           - _outer(xbar, group.sum_x)
           + n[..., None] * _outer(xbar, xbar))                  # [K, D, D]
    psi_n = (shared.psi + C_n
             + (shared.kappa * n[..., None] / kappa_n[..., None])
             * _outer(diff, diff))
    return Shared(mu=mu_n, kappa=kappa_n[..., 0], psi=psi_n, nu=nu_n)


def add_value(shared, group, value):
    return add_repeated_value(shared, group, value, 1)


def add_repeated_value(shared, group, value, count):
    dev = group.count.device
    v = torch.as_tensor(value, device=dev).to(torch.float32)
    c = torch.as_tensor(count, device=dev).to(torch.int32)
    cf = c.to(torch.float32)
    return Group(count=group.count + c,
                 sum_x=group.sum_x + cf * v,
                 sum_xxT=group.sum_xxT + cf * _outer(v, v))


def remove_value(shared, group, value):
    return add_repeated_value(shared, group, value, -1)


def merge(shared, destin, source):
    return Group(count=destin.count + source.count,
                 sum_x=destin.sum_x + source.sum_x,
                 sum_xxT=destin.sum_xxT + source.sum_xxT)


def unmerge(shared, destin, source):
    return Group(count=destin.count - source.count,
                 sum_x=destin.sum_x - source.sum_x,
                 sum_xxT=destin.sum_xxT - source.sum_xxT)


def _student_t_parts(shared, group):
    """(dof, mu, inverse Cholesky factor of the scale, its logdet) of the
    posterior predictive multivariate student-t, Murphy Eq. 258."""
    post = plus_group(shared, group)
    d = dim(shared)
    dof = post.nu - d + 1.0
    sigma_n = post.psi * ((post.kappa + 1.0)
                          / (post.kappa * dof))[..., None, None]
    # cholesky_ex: cholesky without its error check, which reads the
    # factorisation's status back to the host (a CUDA graph's capture
    # refuses that); sigma_n is positive definite by construction, and a
    # factor that fails gives non-finite scores, as the JAX package's
    chol = torch.linalg.cholesky_ex(sigma_n).L
    eye = torch.eye(d, dtype=chol.dtype, device=chol.device).expand(
        chol.shape)
    chol_inv = torch.linalg.solve_triangular(chol, eye, upper=False)
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    return dof, post.mu, chol_inv, logdet


def _student_t(dof, mahal, logdet, p):
    """Multivariate student-t log density, Murphy Eq. 313, from the
    squared Mahalanobis distance."""
    lg_ratio = sum(lgamma_nu(dof + i) for i in range(p))
    return (lg_ratio - 0.5 * (p * torch.log(dof * math.pi) + logdet
                              + (dof + p) * torch.log1p(mahal / dof)))


def score_value(shared, group, value):
    """Posterior predictive of one value [D] (or a batch broadcastable to
    the group's batch shape) under each group."""
    dof, mu, chol_inv, logdet = _student_t_parts(shared, group)
    z = torch.as_tensor(value, device=mu.device).to(torch.float32) - mu
    sol = (chol_inv * z[..., None, :]).sum(-1)
    return _student_t(dof, (sol * sol).sum(-1), logdet, dim(shared))


def score_value_batch(shared, group, values):
    """[K] groups x [B, D] values -> [B, K].  The triangular solve of the
    JAX package becomes one batched product with the inverse Cholesky
    factor [K, D, D], computed once for all B values."""
    dof, mu, chol_inv, logdet = _student_t_parts(shared, group)
    v = torch.as_tensor(values, device=mu.device).to(torch.float32)
    z = v[None, :, :] - mu[:, None, :]                           # [K, B, D]
    sol = torch.matmul(z, chol_inv.transpose(-1, -2))            # [K, B, D]
    mahal = (sol * sol).sum(-1).t()                              # [B, K]
    return _student_t(dof[None, :], mahal, logdet[None, :], dim(shared))


def score_data(shared, group):
    """Marginal likelihood, Murphy Eq. 266."""
    d = dim(shared)
    post = plus_group(shared, group)
    n = group.count.to(torch.float32)
    logdet0 = torch.linalg.slogdet(shared.psi)[1]
    logdet_n = torch.linalg.slogdet(post.psi)[1]
    return (lmultigamma(d, 0.5 * post.nu)
            + 0.5 * shared.nu * logdet0
            - 0.5 * n * d * _LOG_PI
            - lmultigamma(d, 0.5 * shared.nu)
            - 0.5 * post.nu * logdet_n
            + 0.5 * d * torch.log(shared.kappa / post.kappa))


def from_values_grouped(shared, values, assignments, num_groups):
    """values [B, ..., D] -> Group with leaves [num_groups, ...]."""
    v = torch.as_tensor(values, device=shared.mu.device).to(torch.float32)
    return Group(
        count=base.segment_sum(torch.ones(v.shape[:-1], dtype=torch.int32,
                                          device=v.device),
                               assignments, num_groups),
        sum_x=base.segment_sum(v, assignments, num_groups),
        sum_xxT=base.segment_sum(_outer(v, v), assignments, num_groups))


def row_stat_dim(shared):
    d = dim(shared)
    return 1 + d + d * d


def row_stat_columns(shared, values):
    """[..., 1 + D + D*D] = [1 | v | full outer product] per value."""
    v = torch.as_tensor(values, device=shared.mu.device).to(torch.float32)
    d = v.shape[-1]
    outer = _outer(v, v).reshape(v.shape[:-1] + (d * d,))
    ones = torch.ones(v.shape[:-1] + (1,), dtype=torch.float32,
                      device=v.device)
    return torch.cat([ones, v, outer], dim=-1)


def row_stats_to_tile(shared, sums):
    d = dim(shared)
    return Group(count=torch.round(sums[..., 0]).to(torch.int32),
                 sum_x=sums[..., 1:1 + d],
                 sum_xxT=sums[..., 1 + d:].reshape(sums.shape[:-1] + (d, d)))


# -- samplers ---------------------------------------------------------------

def sampler_init(generator, shared, group=None):
    """(mu, Sigma) ~ NIW of the (posterior) hyperparameters."""
    post = shared if group is None else plus_group(shared, group)
    return sample_normal_inverse_wishart(generator, post.mu, post.kappa,
                                         post.psi, post.nu)


def sampler_eval(generator, shared, params, shape=()):
    mu, cov = params
    return sample_multivariate_normal(generator, mu, cov, shape)


def sample_value(generator, shared, group):
    return sampler_eval(generator, shared,
                        sampler_init(generator, shared, group))


def sample_group(generator, shared, size):
    return base.generic_sample_group(sampler_init, sampler_eval, generator,
                                     shared, size)


# -- uncollapsed parameter-space API (HMC/NUTS/VI backends) -----------------
# params = {'mu': [.., D], 'chol': [.., D*(D+1)/2]}: Sigma = L L^T with L
# lower-triangular, its diagonal exp-transformed for unconstrained sampling.

def _tri_indices(d, device=None):
    """Row-major lower-triangle (rows, cols), the order of
    np.tril_indices(d)."""
    return torch.tril_indices(d, d, device=device)


def _unpack_chol(chol_flat, d):
    """[.., D(D+1)/2] -> lower-triangular L with exp'd diagonal; also
    returns the raw diagonal entries (for the Jacobian)."""
    rows, cols = _tri_indices(d, chol_flat.device)
    L = chol_flat.new_zeros(chol_flat.shape[:-1] + (d, d))
    L[..., rows, cols] = chol_flat
    raw_diag = torch.diagonal(L, dim1=-2, dim2=-1)
    L = L - torch.diag_embed(raw_diag) + torch.diag_embed(torch.exp(raw_diag))
    return L, raw_diag


def param_init(generator, shared, shape=()):
    d = dim(shared)
    dev = shared.mu.device
    shape = tuple(shape)
    return {
        'mu': shared.mu.expand(shape + (d,))
        + 0.1 * sample_std_normal(generator, shape + (d,), device=dev),
        'chol': 0.05 * sample_std_normal(
            generator, shape + (d * (d + 1) // 2,), device=dev),
    }


def _solve_lower(L, b):
    return torch.linalg.solve_triangular(L, b, upper=False)


def param_log_prior(shared, params):
    """NIW(mu0, kappa, psi, nu) density over (mu, Sigma = L L^T) plus the
    log-Jacobian of the Cholesky / log-diagonal parameterization:
    log|J| = D log 2 + sum_i (D - i + 2) l_ii (i 1-based)."""
    d = dim(shared)
    L, raw_diag = _unpack_chol(params['chol'], d)
    logdet_sigma = 2.0 * torch.sum(raw_diag, dim=-1)
    # tr(psi Sigma^-1) through two solves against L
    sol = _solve_lower(L, shared.psi.expand(L.shape[:-2] + shared.psi.shape))
    sol2 = _solve_lower(L, sol.transpose(-1, -2))
    trace_term = torch.diagonal(sol2, dim1=-2, dim2=-1).sum(-1)
    logdet_psi = torch.linalg.slogdet(shared.psi)[1]
    nu = shared.nu
    log_iw = (0.5 * nu * logdet_psi - 0.5 * nu * d * math.log(2.0)
              - lmultigamma(d, 0.5 * nu)
              - 0.5 * (nu + d + 1.0) * logdet_sigma
              - 0.5 * trace_term)
    # mu | Sigma ~ N(mu0, Sigma / kappa)
    z = torch.sqrt(shared.kappa) * (params['mu'] - shared.mu)
    sol_mu = _solve_lower(L, z[..., None])[..., 0]
    log_mu = (-0.5 * d * torch.log(2.0 * math.pi / shared.kappa)
              - 0.5 * logdet_sigma
              - 0.5 * torch.sum(sol_mu * sol_mu, dim=-1))
    # D - i + 2
    weights = torch.arange(d, 0, -1, dtype=torch.float32,
                           device=raw_diag.device) + 1.0
    jacobian = d * math.log(2.0) + torch.sum(weights * raw_diag, dim=-1)
    return log_iw + log_mu + jacobian


def param_log_likelihood(shared, params, value):
    """log N(value | mu, L L^T).  L is broadcast to the full batch shape
    ([R, K, D, D] in the mixture log-prob) before the triangular solve, as
    the JAX package does."""
    d = dim(shared)
    L, raw_diag = _unpack_chol(params['chol'], d)
    v = torch.as_tensor(value, device=L.device).to(torch.float32)
    z = v - params['mu']
    bshape = torch.broadcast_shapes(z.shape[:-1], L.shape[:-2])
    sol = _solve_lower(L.expand(bshape + L.shape[-2:]),
                       z.expand(bshape + z.shape[-1:])[..., None])[..., 0]
    logdet_sigma = 2.0 * torch.sum(raw_diag, dim=-1)
    return (-0.5 * d * math.log(2.0 * math.pi) - 0.5 * logdet_sigma
            - 0.5 * torch.sum(sol * sol, dim=-1))


def param_constrain(shared, params):
    L, _ = _unpack_chol(params['chol'], dim(shared))
    return {'mu': params['mu'], 'sigma': L @ L.transpose(-1, -2)}
