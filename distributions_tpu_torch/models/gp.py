"""Gamma-Poisson conjugate model (distributions_tpu.models.gp): Value=int,
Shared={alpha, inv_beta}, Group={count, sum, log_prod} with
log_prod = sum_i log(y_i!)."""

from typing import NamedTuple

import torch

from distributions_tpu_torch.config import resolve_device
from distributions_tpu_torch.models import base
from distributions_tpu_torch.random import sample_gamma, sample_poisson
from distributions_tpu_torch.special import (gammaln, lgamma_ratio,
                                             log_factorial)

NAME = 'GammaPoisson'
EXAMPLES = [
    {
        'shared': {'alpha': 1., 'inv_beta': 1.},
        'values': [0, 1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 2, 3],
    },
]
Value = int


class Shared(NamedTuple):
    alpha: torch.Tensor
    inv_beta: torch.Tensor


class Group(NamedTuple):
    count: torch.Tensor     # int32
    sum: torch.Tensor       # int32
    log_prod: torch.Tensor  # float32


def shared_from_dict(raw, device=None):
    device = resolve_device(device)
    return Shared(alpha=base.scalar(raw['alpha'], torch.float32, device),
                  inv_beta=base.scalar(raw['inv_beta'], torch.float32,
                                       device))


def shared_to_dict(shared):
    return {'alpha': float(shared.alpha), 'inv_beta': float(shared.inv_beta)}



def group_from_dict(raw, device=None):
    device = resolve_device(device)
    return Group(count=base.scalar(raw['count'], torch.int32, device),
                 sum=base.scalar(raw['sum'], torch.int32, device),
                 log_prod=base.scalar(raw['log_prod'], torch.float32,
                                      device))


def group_to_dict(group):
    return {'count': int(group.count), 'sum': int(group.sum),
            'log_prod': float(group.log_prod)}


def group_init(shared, shape=()):
    dev = shared.alpha.device
    return Group(count=torch.zeros(shape, dtype=torch.int32, device=dev),
                 sum=torch.zeros(shape, dtype=torch.int32, device=dev),
                 log_prod=torch.zeros(shape, dtype=torch.float32,
                                      device=dev))


def plus_group(shared, group):
    """Conjugate posterior update."""
    return Shared(alpha=shared.alpha + group.sum,
                  inv_beta=shared.inv_beta + group.count)


def add_value(shared, group, value):
    return add_repeated_value(shared, group, value, 1)


def add_repeated_value(shared, group, value, count):
    dev = group.count.device
    value = torch.as_tensor(value, device=dev).to(torch.int32)
    count = torch.as_tensor(count, device=dev).to(torch.int32)
    return Group(count=group.count + count,
                 sum=group.sum + count * value,
                 log_prod=group.log_prod + count.to(torch.float32)
                 * log_factorial(value))


def remove_value(shared, group, value):
    return add_repeated_value(shared, group, value, -1)


def merge(shared, destin, source):
    return Group(count=destin.count + source.count,
                 sum=destin.sum + source.sum,
                 log_prod=destin.log_prod + source.log_prod)


def unmerge(shared, destin, source):
    return Group(count=destin.count - source.count,
                 sum=destin.sum - source.sum,
                 log_prod=destin.log_prod - source.log_prod)


def _as_float(values, device):
    return torch.as_tensor(values, device=device).to(torch.float32)


def score_value(shared, group, value):
    """Negative-binomial posterior predictive."""
    post = plus_group(shared, group)
    value = _as_float(value, post.alpha.device)
    return (gammaln(post.alpha + value) - gammaln(post.alpha)
            + post.alpha * torch.log(post.inv_beta)
            - (post.alpha + value) * torch.log(1.0 + post.inv_beta)
            - log_factorial(value))


def score_value_batch(shared, group, values):
    """[K] group x [B] values -> [B, K]: score(y, k) =
    lgamma(alpha_k + y) + coeff_k * y + const_k - log y!."""
    post = plus_group(shared, group)
    alpha, inv_beta = post.alpha, post.inv_beta                    # [K]
    const = -gammaln(alpha) + alpha * (torch.log(inv_beta)
                                       - torch.log1p(inv_beta))
    coeff = -torch.log1p(inv_beta)
    y = _as_float(values, alpha.device)[:, None]                   # [B, 1]
    return (gammaln(alpha[None, :] + y) + coeff[None, :] * y
            + const[None, :] - log_factorial(y))


def score_data(shared, group):
    """Marginal likelihood.  lgamma(post) - lgamma(prior) goes through
    special.lgamma_ratio with the RAW group sum as the increment:
    rebuilding it as post.alpha - shared.alpha would absorb to 0 in f32
    once shared.alpha >> sum."""
    a0, ib0 = shared.alpha, shared.inv_beta
    S = group.sum.to(torch.float32)
    cnt = group.count.to(torch.float32)
    return (lgamma_ratio(a0, S) - a0 * torch.log1p(cnt / ib0)
            - S * torch.log(ib0 + cnt) - group.log_prod)


def from_values_grouped(shared, values, assignments, num_groups):
    v = torch.as_tensor(values, device=shared.alpha.device).to(torch.int32)
    return Group(
        count=base.segment_sum(torch.ones_like(v), assignments, num_groups),
        sum=base.segment_sum(v, assignments, num_groups),
        log_prod=base.segment_sum(log_factorial(v), assignments,
                                  num_groups))


ROW_STAT_DIM = 3


def row_stat_columns(shared, values):
    """[..., 3] = [1, v, log v!] per value."""
    v = _as_float(values, shared.alpha.device)
    return torch.stack([torch.ones_like(v), v, log_factorial(v)], dim=-1)


def row_stats_to_tile(shared, sums):
    return Group(count=torch.round(sums[..., 0]).to(torch.int32),
                 sum=torch.round(sums[..., 1]).to(torch.int32),
                 log_prod=sums[..., 2])


def tile_stats(shared, values, assignments, num_groups):
    return from_values_grouped(shared, values, assignments, num_groups)


def tile_to_group(shared, tile):
    return tile


# -- samplers ---------------------------------------------------------------

def sampler_init(generator, shared, group=None):
    """lambda ~ Gamma(alpha, scale 1 / inv_beta) of the (posterior)
    hyperparameters."""
    post = shared if group is None else plus_group(shared, group)
    return sample_gamma(generator, post.alpha.to(torch.float32),
                        1.0 / post.inv_beta.to(torch.float32))


def sampler_eval(generator, shared, lam, shape=()):
    return sample_poisson(generator, lam, shape)


def sample_value(generator, shared, group):
    return sampler_eval(generator, shared,
                        sampler_init(generator, shared, group))


def sample_group(generator, shared, size):
    return base.generic_sample_group(sampler_init, sampler_eval, generator,
                                     shared, size)
