"""Beta-Negative-Binomial conjugate model (distributions_tpu.models.bnb):
Value=int (failures before the r-th success), Shared={alpha, beta, r},
Group={count, sum}; the predictive follows Cook, "Notes on the negative
binomial distribution" (2009)."""

from typing import NamedTuple

import torch

from distributions_tpu_torch.config import resolve_device
from distributions_tpu_torch.models import base
from distributions_tpu_torch.random import (sample_beta,
                                            sample_negative_binomial)
from distributions_tpu_torch.special import gammaln, lgamma_ratio

NAME = 'BetaNegativeBinomial'
EXAMPLES = [
    {
        'shared': {'alpha': 1., 'beta': 1., 'r': 1},
        'values': [0, 1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 2, 3],
    },
]
Value = int


class Shared(NamedTuple):
    alpha: torch.Tensor
    beta: torch.Tensor
    r: torch.Tensor  # int32


class Group(NamedTuple):
    count: torch.Tensor  # int32
    sum: torch.Tensor    # int32


def shared_from_dict(raw, device=None):
    device = resolve_device(device)
    return Shared(alpha=base.scalar(raw['alpha'], torch.float32, device),
                  beta=base.scalar(raw['beta'], torch.float32, device),
                  r=base.scalar(raw['r'], torch.int32, device))


def shared_to_dict(shared):
    return {'alpha': float(shared.alpha), 'beta': float(shared.beta),
            'r': int(shared.r)}



def group_from_dict(raw, device=None):
    device = resolve_device(device)
    return Group(count=base.scalar(raw['count'], torch.int32, device),
                 sum=base.scalar(raw['sum'], torch.int32, device))


def group_to_dict(group):
    return {'count': int(group.count), 'sum': int(group.sum)}


def group_init(shared, shape=()):
    dev = shared.alpha.device
    return Group(count=torch.zeros(shape, dtype=torch.int32, device=dev),
                 sum=torch.zeros(shape, dtype=torch.int32, device=dev))


def plus_group(shared, group):
    return Shared(alpha=shared.alpha + shared.r * group.count,
                  beta=shared.beta + group.sum, r=shared.r)


def add_value(shared, group, value):
    return add_repeated_value(shared, group, value, 1)


def add_repeated_value(shared, group, value, count):
    dev = group.count.device
    value = torch.as_tensor(value, device=dev).to(torch.int32)
    count = torch.as_tensor(count, device=dev).to(torch.int32)
    return Group(count=group.count + count, sum=group.sum + count * value)


def remove_value(shared, group, value):
    return add_repeated_value(shared, group, value, -1)


def merge(shared, destin, source):
    return Group(count=destin.count + source.count,
                 sum=destin.sum + source.sum)


def unmerge(shared, destin, source):
    return Group(count=destin.count - source.count,
                 sum=destin.sum - source.sum)


def _as_float(values, device):
    return torch.as_tensor(values, device=device).to(torch.float32)


def score_value(shared, group, value):
    post = plus_group(shared, group)
    pa, pb = post.alpha, post.beta
    alpha = pa + shared.r
    beta = pb + _as_float(value, pa.device)
    return (gammaln(pa + pb) - gammaln(alpha + beta)
            + gammaln(alpha) - gammaln(pa)
            + gammaln(beta) - gammaln(pb))


def score_value_batch(shared, group, values):
    """[K] group x [B] values -> [B, K]."""
    post = plus_group(shared, group)
    pa, pb = post.alpha, post.beta                                 # [K]
    alpha = pa + shared.r
    const = gammaln(pa + pb) + gammaln(alpha) - gammaln(pa) - gammaln(pb)
    v = _as_float(values, pa.device)[:, None]                      # [B, 1]
    beta = pb[None, :] + v
    return const[None, :] + gammaln(beta) - gammaln(beta + alpha[None, :])


def score_data(shared, group):
    """Marginal likelihood.  The differences go through
    special.lgamma_ratio with increments built from the RAW group stats
    (r * count, sum): rebuilding them as post - prior absorbs to 0 in f32
    once the prior >> the increment."""
    a0, b0 = shared.alpha, shared.beta
    ya = shared.r.to(torch.float32) * group.count.to(torch.float32)
    yb = group.sum.to(torch.float32)
    return (lgamma_ratio(a0, ya) + lgamma_ratio(b0, yb)
            - lgamma_ratio(a0 + b0, ya + yb))


def from_values_grouped(shared, values, assignments, num_groups):
    v = torch.as_tensor(values, device=shared.alpha.device).to(torch.int32)
    return Group(
        count=base.segment_sum(torch.ones_like(v), assignments, num_groups),
        sum=base.segment_sum(v, assignments, num_groups))


ROW_STAT_DIM = 2


def row_stat_columns(shared, values):
    """[..., 2] = [1, v] per value."""
    v = _as_float(values, shared.alpha.device)
    return torch.stack([torch.ones_like(v), v], dim=-1)


def row_stats_to_tile(shared, sums):
    return Group(count=torch.round(sums[..., 0]).to(torch.int32),
                 sum=torch.round(sums[..., 1]).to(torch.int32))


# -- samplers ---------------------------------------------------------------

def sampler_init(generator, shared, group=None):
    """p ~ Beta of the (posterior) hyperparameters."""
    post = shared if group is None else plus_group(shared, group)
    return sample_beta(generator, post.alpha.to(torch.float32),
                       post.beta.to(torch.float32))


def sampler_eval(generator, shared, p, shape=()):
    return sample_negative_binomial(generator, p, shared.r, shape)


def sample_value(generator, shared, group):
    return sampler_eval(generator, shared,
                        sampler_init(generator, shared, group))


def sample_group(generator, shared, size):
    return base.generic_sample_group(sampler_init, sampler_eval, generator,
                                     shared, size)
