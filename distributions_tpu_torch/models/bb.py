"""Beta-Bernoulli conjugate model (distributions_tpu.models.bb):
Value=bool, Shared={alpha, beta}, Group={heads, tails}; predictive
p(True) = (alpha + heads) / (alpha + beta + n).  Every function broadcasts
over the group's batch shape (usually [C, cols])."""

from typing import NamedTuple

import torch

from distributions_tpu_torch.config import resolve_device
from distributions_tpu_torch.models import base
from distributions_tpu_torch.random import sample_bernoulli, sample_beta
from distributions_tpu_torch.special import lgamma_ratio

NAME = 'BetaBernoulli'
EXAMPLES = [
    {
        'shared': {'alpha': 0.5, 'beta': 2.0},
        'values': [False, False, True, False, True, True, False, False],
    },
    {
        'shared': {'alpha': 10.5, 'beta': 0.5},
        'values': [False, False, False, False, False, False, False, True],
    },
]
Value = bool


class Shared(NamedTuple):
    alpha: torch.Tensor
    beta: torch.Tensor


class Group(NamedTuple):
    heads: torch.Tensor  # int32, any batch shape
    tails: torch.Tensor


def shared_from_dict(raw, device=None):
    device = resolve_device(device)
    return Shared(alpha=base.scalar(raw['alpha'], torch.float32, device),
                  beta=base.scalar(raw['beta'], torch.float32, device))


def shared_to_dict(shared):
    return {'alpha': float(shared.alpha), 'beta': float(shared.beta)}



def group_from_dict(raw, device=None):
    device = resolve_device(device)
    return Group(heads=base.scalar(raw['heads'], torch.int32, device),
                 tails=base.scalar(raw['tails'], torch.int32, device))


def group_to_dict(group):
    return {'heads': int(group.heads), 'tails': int(group.tails)}


def group_init(shared, shape=()):
    dev = shared.alpha.device
    return Group(heads=torch.zeros(shape, dtype=torch.int32, device=dev),
                 tails=torch.zeros(shape, dtype=torch.int32, device=dev))


def _as_bool(value, device):
    return torch.as_tensor(value, device=device).to(torch.bool)


def add_value(shared, group, value):
    return add_repeated_value(shared, group, value, 1)


def add_repeated_value(shared, group, value, count):
    value = _as_bool(value, group.heads.device)
    count = torch.as_tensor(count, device=value.device).to(torch.int32)
    zero = torch.zeros_like(count)
    return Group(heads=group.heads + torch.where(value, count, zero),
                 tails=group.tails + torch.where(value, zero, count))


def remove_value(shared, group, value):
    return add_repeated_value(shared, group, value, -1)


def merge(shared, destin, source):
    return Group(heads=destin.heads + source.heads,
                 tails=destin.tails + source.tails)


def unmerge(shared, destin, source):
    """Inverse of merge (used by blocked Gibbs removal)."""
    return Group(heads=destin.heads - source.heads,
                 tails=destin.tails - source.tails)


def score_value(shared, group, value):
    """Broadcasts a [K] group against a scalar (or [...]) value."""
    heads = shared.alpha + group.heads
    tails = shared.beta + group.tails
    numer = torch.where(_as_bool(value, heads.device), heads, tails)
    return torch.log(numer / (heads + tails))


def score_value_batch(shared, group, values):
    """[K] group x [B] values -> [B, K]."""
    heads = shared.alpha + group.heads                       # [K]
    tails = shared.beta + group.tails
    denom = torch.log(heads + tails)
    log_heads = torch.log(heads) - denom
    log_tails = torch.log(tails) - denom
    v = _as_bool(values, heads.device)[:, None]
    return torch.where(v, log_heads[None, :], log_tails[None, :])


def score_data(shared, group):
    """Marginal likelihood of each group; the differences go through
    special.lgamma_ratio, which is cancellation-safe for large alpha and
    beta."""
    h = group.heads.to(torch.float32)
    t = group.tails.to(torch.float32)
    return (lgamma_ratio(shared.alpha, h) + lgamma_ratio(shared.beta, t)
            - lgamma_ratio(shared.alpha + shared.beta, h + t))


def from_values_grouped(shared, values, assignments, num_groups):
    """Segment sums of the head and tail indicators."""
    v = _as_bool(values, shared.alpha.device).to(torch.int32)
    return Group(heads=base.segment_sum(v, assignments, num_groups),
                 tails=base.segment_sum(1 - v, assignments, num_groups))


ROW_STAT_DIM = 2


def row_stat_columns(shared, values):
    """[..., 2] = [v, 1 - v] per value."""
    vf = _as_bool(values, shared.alpha.device).to(torch.float32)
    return torch.stack([vf, 1.0 - vf], dim=-1)


def row_stats_to_tile(shared, sums):
    return Group(heads=torch.round(sums[..., 0]).to(torch.int32),
                 tails=torch.round(sums[..., 1]).to(torch.int32))


# -- samplers ---------------------------------------------------------------

def sampler_init(generator, shared, group=None):
    """p ~ Beta(alpha + heads, beta + tails) (the prior without a group)."""
    if group is None:
        return sample_beta(generator, shared.alpha, shared.beta)
    return sample_beta(generator, shared.alpha + group.heads,
                       shared.beta + group.tails)


def sampler_eval(generator, shared, p, shape=()):
    return sample_bernoulli(generator, p, shape)


def sample_value(generator, shared, group):
    return sampler_eval(generator, shared,
                        sampler_init(generator, shared, group))


def sample_group(generator, shared, size):
    return base.generic_sample_group(sampler_init, sampler_eval, generator,
                                     shared, size)
