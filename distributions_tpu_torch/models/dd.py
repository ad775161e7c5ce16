"""Dirichlet-Discrete conjugate model (distributions_tpu.models.dd):
Value=int in [0, dim), Shared={alphas[dim]}, Group={counts[..., dim]}."""

from typing import NamedTuple

import torch

from distributions_tpu_torch.config import resolve_device
from distributions_tpu_torch.models import base
from distributions_tpu_torch.random import (sample_dirichlet,
                                            sample_discrete,
                                            sample_std_normal)
from distributions_tpu_torch.special import gammaln, lgamma_ratio

NAME = 'DirichletDiscrete'
EXAMPLES = [
    {
        'shared': {'alphas': [0.5] * 4},
        'values': [0, 1, 0, 2, 0, 1, 0],
    },
    {
        'shared': {'alphas': [1.0, 4.0]},
        'values': [0, 1, 1, 1, 1, 0, 1],
    },
    {
        'shared': {'alphas': [2.0 / n for n in range(1, 21)]},
        'values': list(range(20)),
    },
]
Value = int


class Shared(NamedTuple):
    alphas: torch.Tensor  # [dim] float32


class Group(NamedTuple):
    counts: torch.Tensor  # [..., dim] int32


def dim(shared):
    return shared.alphas.shape[-1]


def shared_from_dict(raw, device=None):
    return Shared(alphas=torch.tensor([float(a) for a in raw['alphas']],
                                      dtype=torch.float32,
                                      device=resolve_device(device)))


def shared_to_dict(shared):
    return {'alphas': [float(a) for a in shared.alphas]}



def group_from_dict(raw, device=None):
    return Group(counts=torch.tensor([int(c) for c in raw['counts']],
                                     dtype=torch.int32,
                                     device=resolve_device(device)))


def group_to_dict(group):
    return {'counts': [int(c) for c in group.counts]}


def group_init(shared, shape=()):
    return Group(counts=torch.zeros(tuple(shape) + (dim(shared),),
                                    dtype=torch.int32,
                                    device=shared.alphas.device))


def _as_index(values, device):
    return torch.as_tensor(values, device=device).to(torch.int64)


def add_value(shared, group, value):
    return add_repeated_value(shared, group, value, 1)


def add_repeated_value(shared, group, value, count):
    onehot = _onehot(shared, value).to(torch.int32)
    count = torch.as_tensor(count, device=onehot.device).to(torch.int32)
    return Group(counts=group.counts + count * onehot)


def remove_value(shared, group, value):
    return add_repeated_value(shared, group, value, -1)


def merge(shared, destin, source):
    return Group(counts=destin.counts + source.counts)


def unmerge(shared, destin, source):
    return Group(counts=destin.counts - source.counts)


def score_value(shared, group, value):
    """A [..., dim]-batched group against an integer value broadcastable
    to the batch."""
    counts = group.counts.to(torch.float32)
    value = _as_index(value, counts.device)
    idx = value.expand(counts.shape[:-1])[..., None]
    numer = counts.gather(-1, idx)[..., 0] + shared.alphas[value]
    denom = counts.sum(-1) + shared.alphas.sum()
    return torch.log(numer / denom)


def score_value_batch(shared, group, values):
    """[K, dim] group x [B] values -> [B, K]."""
    counts = group.counts.to(torch.float32)                        # [K, D]
    denom = torch.log(counts.sum(-1) + shared.alphas.sum())        # [K]
    post = counts + shared.alphas[None, :]                         # [K, D]
    values = _as_index(values, counts.device)
    return torch.log(post[:, values].t()) - denom[None, :]


def score_data(shared, group):
    """Marginal likelihood; the rising-factorial terms go through
    special.lgamma_ratio (the naive lgamma difference cancels in f32 once
    alpha >> count)."""
    a = shared.alphas
    m = group.counts.to(torch.float32)
    return (lgamma_ratio(a, m).sum(-1)
            - lgamma_ratio(a.sum(), m.sum(-1)))


def score_data_grid(shareds, group):
    """[G] scores of one group under a grid of Shareds (leaves with a
    leading [G] axis), one grid point at a time as
    `mixture.block_score_data_grid` does for dd blocks."""
    return torch.stack([score_data(Shared(*(leaf[g] for leaf in shareds)),
                                   group)
                        for g in range(shareds[0].shape[0])])


def _onehot(shared, values):
    v = _as_index(values, shared.alphas.device)
    d = torch.arange(dim(shared), device=v.device)
    return d == v[..., None]


def from_values_grouped(shared, values, assignments, num_groups):
    return Group(counts=base.segment_sum(
        _onehot(shared, values).to(torch.int32), assignments, num_groups))


def row_stat_dim(shared):
    return dim(shared)


def row_stat_columns(shared, values):
    """[..., dim] one-hot of each value."""
    return _onehot(shared, values).to(torch.float32)


def row_stats_to_tile(shared, sums):
    return Group(counts=torch.round(sums).to(torch.int32))


# -- samplers ---------------------------------------------------------------

def sampler_init(generator, shared, group=None):
    """ps ~ Dirichlet(alphas + counts)."""
    if group is None:
        return sample_dirichlet(generator, shared.alphas)
    return sample_dirichlet(generator,
                            group.counts.to(torch.float32) + shared.alphas)


def sampler_eval(generator, shared, ps, shape=()):
    return sample_discrete(generator, ps,
                           shape=tuple(shape) if shape else None)


def sample_value(generator, shared, group):
    return sampler_eval(generator, shared,
                        sampler_init(generator, shared, group))


def sample_group(generator, shared, size):
    return base.generic_sample_group(sampler_init, sampler_eval, generator,
                                     shared, size)


# -- uncollapsed parameter-space API (HMC/NUTS/VI backends) -----------------
# params = {'alr': [..., dim-1]} additive-log-ratio coordinates of the
# simplex; p ~ Dirichlet(alphas).

def _alr_to_simplex(alr):
    z = torch.cat([alr, alr.new_zeros(alr.shape[:-1] + (1,))], dim=-1)
    return torch.softmax(z, dim=-1)


def param_init(generator, shared, shape=()):
    return {'alr': 0.1 * sample_std_normal(
        generator, tuple(shape) + (dim(shared) - 1,),
        device=shared.alphas.device)}


def param_log_prior(shared, params):
    p = _alr_to_simplex(params['alr'])
    a = shared.alphas
    log_dir = (gammaln(torch.sum(a)) - torch.sum(gammaln(a))
               + torch.sum((a - 1.0) * torch.log(p), dim=-1))
    # log |det J| of ALR^-1 = sum_i log p_i
    return log_dir + torch.sum(torch.log(p), dim=-1)


def param_log_likelihood(shared, params, value):
    """log p[value]; params [..., dim-1] broadcast against values.  (The
    JAX package broadcasts the values to the params' shape, so there a
    batch of rows against [K] params raises; where it runs, the two
    agree.)"""
    p = _alr_to_simplex(params['alr'])
    value = _as_index(value, p.device)
    shape = torch.broadcast_shapes(value.shape, p.shape[:-1])
    return torch.log(torch.gather(
        p.expand(shape + p.shape[-1:]), -1,
        value.expand(shape)[..., None]))[..., 0]


def param_constrain(shared, params):
    return {'p': _alr_to_simplex(params['alr'])}
