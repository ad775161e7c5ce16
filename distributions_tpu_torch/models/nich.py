"""Normal-Inverse-Chi-Squared conjugate model on univariate normal data
(distributions_tpu.models.nich): Value=float,
Shared={mu, kappa, sigmasq, nu}, Group={count, mean, count_times_variance}.
Equations from Murphy, "Conjugate Bayesian analysis of the Gaussian
distribution" (2007).  Every function broadcasts over the group's batch
shape (usually [C, cols]).
"""

import math
from typing import NamedTuple

import torch

from distributions_tpu_torch.config import resolve_device
from distributions_tpu_torch.special import gammaln, lgamma_nu
from distributions_tpu_torch.models import base
from distributions_tpu_torch.random import sample_chisq, sample_normal

NAME = 'NormalInverseChiSq'
EXAMPLES = [
    {
        'shared': {'mu': 0., 'kappa': 1., 'sigmasq': 1., 'nu': 1.},
        'values': [-4.0, -2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0, 4.0],
    },
]
Value = float

_LOG_PI = 1.1447298858494002


class Shared(NamedTuple):
    mu: torch.Tensor
    kappa: torch.Tensor
    sigmasq: torch.Tensor
    nu: torch.Tensor


class Group(NamedTuple):
    count: torch.Tensor                 # int32
    mean: torch.Tensor                  # float32
    count_times_variance: torch.Tensor  # float32


class TileStats(NamedTuple):
    """Additive raw-moment form (n, sum, sumsq) for tile aggregation."""
    count: torch.Tensor
    sum: torch.Tensor
    sumsq: torch.Tensor


def shared_from_dict(raw, device=None):
    device = resolve_device(device)

    def f(k):
        return base.scalar(raw[k], torch.float32, device)
    return Shared(mu=f('mu'), kappa=f('kappa'), sigmasq=f('sigmasq'),
                  nu=f('nu'))


def shared_to_dict(shared):
    return {'mu': float(shared.mu), 'kappa': float(shared.kappa),
            'sigmasq': float(shared.sigmasq), 'nu': float(shared.nu)}



def group_from_dict(raw, device=None):
    device = resolve_device(device)
    return Group(count=base.scalar(raw['count'], torch.int32, device),
                 mean=base.scalar(raw['mean'], torch.float32, device),
                 count_times_variance=base.scalar(
                     raw['count_times_variance'], torch.float32, device))


def group_to_dict(group):
    return {'count': int(group.count), 'mean': float(group.mean),
            'count_times_variance': float(group.count_times_variance)}


def group_init(shared, shape=()):
    dev = shared.mu.device
    return Group(count=torch.zeros(shape, dtype=torch.int32, device=dev),
                 mean=torch.zeros(shape, dtype=torch.float32, device=dev),
                 count_times_variance=torch.zeros(
                     shape, dtype=torch.float32, device=dev))


def plus_group(shared, group):
    """Posterior hyperparameters, Murphy Eqs. 141-144."""
    count = group.count.to(torch.float32)
    total = group.mean * count
    mu_1 = shared.mu - group.mean
    kappa_n = shared.kappa + count
    mu_n = (shared.kappa * shared.mu + total) / kappa_n
    nu_n = shared.nu + count
    sigmasq_n = (shared.nu * shared.sigmasq
                 + group.count_times_variance
                 + (count * shared.kappa * mu_1 * mu_1) / kappa_n) / nu_n
    return Shared(mu=mu_n, kappa=kappa_n, sigmasq=sigmasq_n, nu=nu_n)


def add_value(shared, group, value):
    """Welford online update."""
    value = torch.as_tensor(value, device=group.mean.device).to(
        torch.float32)
    count = group.count + 1
    delta = value - group.mean
    mean = group.mean + delta / count.to(torch.float32)
    ctv = group.count_times_variance + delta * (value - mean)
    return Group(count=count, mean=mean, count_times_variance=ctv)


def add_repeated_value(shared, group, value, count):
    """`count` copies of `value` in one update, with the JAX package's
    formula (which equals `count` successive `add_value` calls only at
    count = 1)."""
    dev = group.mean.device
    value = torch.as_tensor(value, device=dev).to(torch.float32)
    count = torch.as_tensor(count, device=dev).to(torch.int32)
    new_count = group.count + count
    delta = count.to(torch.float32) * value - group.mean
    mean = group.mean + delta / new_count.to(torch.float32)
    ctv = group.count_times_variance + delta * (value - mean)
    return Group(count=new_count, mean=mean, count_times_variance=ctv)


def remove_value(shared, group, value):
    """Welford downdate, exact zeros once the group empties."""
    value = torch.as_tensor(value, device=group.mean.device).to(
        torch.float32)
    total = group.mean * group.count.to(torch.float32)
    delta = value - group.mean
    count = group.count - 1
    countf = count.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=countf.device)
    mean = torch.where(count == 0, zero,
                       (total - value) / torch.clamp(countf, min=1))
    ctv = torch.where(count <= 1, zero,
                      group.count_times_variance - delta * (value - mean))
    return Group(count=count, mean=mean, count_times_variance=ctv)


def merge(shared, destin, source):
    count = destin.count + source.count
    countf = torch.clamp(count.to(torch.float32), min=1)
    delta = source.mean - destin.mean
    source_part = source.count.to(torch.float32) / countf
    cross_part = destin.count.to(torch.float32) * source_part
    mean = destin.mean + source_part * delta
    ctv = (destin.count_times_variance + source.count_times_variance
           + cross_part * delta * delta)
    return Group(count=count, mean=mean, count_times_variance=ctv)


def unmerge(shared, destin, source):
    """Inverse of merge: remove `source`'s contribution from `destin`."""
    count = destin.count - source.count
    countf = torch.clamp(count.to(torch.float32), min=1)
    destf = torch.clamp(destin.count.to(torch.float32), min=1)
    zero = torch.zeros((), dtype=torch.float32, device=countf.device)
    mean = torch.where(
        count == 0, zero,
        (destin.mean * destin.count.to(torch.float32)
         - source.mean * source.count.to(torch.float32)) / countf)
    delta = source.mean - mean
    cross_part = countf * source.count.to(torch.float32) / destf
    ctv = torch.where(
        count <= 1, zero,
        destin.count_times_variance - source.count_times_variance
        - cross_part * delta * delta)
    return Group(count=count, mean=mean, count_times_variance=ctv)


def score_student_t(x, nu, mu, sigmasq):
    """Student-t log density, Murphy Eq. 304; broadcasts over all args."""
    score = lgamma_nu(nu)
    score = score - 0.5 * torch.log(nu * math.pi * sigmasq)
    xt = x - mu
    s = xt * xt / sigmasq
    return score - (0.5 * (nu + 1.0)) * torch.log1p(s / nu)


def score_value(shared, group, value):
    """Posterior predictive student-t, Murphy Eq. 176."""
    post = plus_group(shared, group)
    value = torch.as_tensor(value, dtype=torch.float32,
                            device=post.mu.device)
    return score_student_t(
        value, post.nu, post.mu,
        ((1.0 + post.kappa) * post.sigmasq) / post.kappa)


def score_value_batch(shared, group, values):
    """[K] group x [B] values -> [B, K] in the cached-coefficient form
    score(v, k) = score_k + log_coeff_k * log(1 + prec_k (v - mean_k)^2)."""
    post = plus_group(shared, group)
    lambda_ = ((1.0 + post.kappa) * post.sigmasq) / post.kappa     # [K]
    score = (lgamma_nu(post.nu)
             - 0.5 * torch.log(post.nu * math.pi * lambda_))      # [K]
    log_coeff = -0.5 * (post.nu + 1.0)                             # [K]
    precision = 1.0 / (post.nu * lambda_)                          # [K]
    v = torch.as_tensor(values).to(torch.float32)[:, None]         # [B, 1]
    t = v - post.mu[None, :]
    return (score[None, :]
            + log_coeff[None, :] * torch.log1p(precision[None, :] * t * t))


def score_data(shared, group):
    """Marginal likelihood of each group, Murphy Eq. 171."""
    post = plus_group(shared, group)
    return (gammaln(0.5 * post.nu) - gammaln(0.5 * shared.nu)
            + 0.5 * torch.log(shared.kappa / post.kappa)
            + (0.5 * shared.nu) * torch.log(shared.nu * shared.sigmasq)
            - (0.5 * post.nu) * torch.log(post.nu * post.sigmasq)
            - 0.5 * group.count.to(torch.float32) * _LOG_PI)


def tile_stats(shared, values, assignments, num_groups):
    v = torch.as_tensor(values).to(torch.float32)
    return TileStats(
        count=base.segment_sum(torch.ones(v.shape, dtype=torch.int32,
                                          device=v.device),
                               assignments, num_groups),
        sum=base.segment_sum(v, assignments, num_groups),
        sumsq=base.segment_sum(v * v, assignments, num_groups))


def tile_to_group(shared, tile):
    n, s, ss = tile.count, tile.sum, tile.sumsq
    nf = torch.clamp(n.to(torch.float32), min=1)
    zero = torch.zeros((), dtype=torch.float32, device=nf.device)
    mean = torch.where(n > 0, s / nf, zero)
    ctv = torch.where(n > 1, ss - s * s / nf, zero)
    return Group(count=n, mean=mean, count_times_variance=torch.clamp(
        ctv, min=0))


def from_values_grouped(shared, values, assignments, num_groups):
    """Segment-summed suff stats: mean/M2 recovered from (n, sum, sumsq)."""
    return tile_to_group(
        shared, tile_stats(shared, values, assignments, num_groups))


ROW_STAT_DIM = 3


def row_stat_columns(shared, values):
    """[..., 3] = [1, v, v^2] per value; tile sums of these are TileStats."""
    v = torch.as_tensor(values).to(torch.float32)
    return torch.stack([torch.ones_like(v), v, v * v], dim=-1)


def row_stats_to_tile(shared, sums):
    """sums [..., 3] (one-hot contracted) -> additive TileStats."""
    return TileStats(count=torch.round(sums[..., 0]).to(torch.int32),
                     sum=sums[..., 1], sumsq=sums[..., 2])


# -- samplers ---------------------------------------------------------------

def sampler_init(generator, shared, group=None):
    """(mu, sigma) from the (posterior) NIX marginals, Murphy Eqs. 156 and
    167: sigma^2 = nu sigmasq / chisq(nu), mu ~ N(mu_n, sigma^2 /
    kappa_n)."""
    post = shared if group is None else plus_group(shared, group)
    sigmasq_star = post.nu * post.sigmasq / sample_chisq(generator, post.nu)
    mu = sample_normal(generator, post.mu,
                       torch.sqrt(sigmasq_star / post.kappa))
    return mu, torch.sqrt(sigmasq_star)


def sampler_eval(generator, shared, params, shape=()):
    mu, sigma = params
    return sample_normal(generator, mu, sigma, shape)


def sample_value(generator, shared, group):
    return sampler_eval(generator, shared,
                        sampler_init(generator, shared, group))


def sample_group(generator, shared, size):
    return base.generic_sample_group(sampler_init, sampler_eval, generator,
                                     shared, size)
