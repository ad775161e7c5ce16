"""hp Beta-Bernoulli: scalar float64 numpy implementation (independent of
the JAX core models/bb.py; semantics of reference dbg/models/bb.py:33-169).

The marginal likelihood is written in betaln form — a different expression
than the core's six-gammaln form, equal by B(a,b) = G(a)G(b)/G(a+b)."""

from collections import namedtuple

import numpy as np

from distributions_tpu_torch.hp.special import betaln
from distributions_tpu_torch.hp.random import sample_beta, sample_bernoulli

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

Shared = namedtuple('Shared', 'alpha beta')
Group = namedtuple('Group', 'heads tails')


def shared_from_dict(raw):
    return Shared(alpha=float(raw['alpha']), beta=float(raw['beta']))


def shared_to_dict(shared):
    return {'alpha': shared.alpha, 'beta': shared.beta}


def group_from_dict(raw):
    return Group(heads=int(raw['heads']), tails=int(raw['tails']))


def group_to_dict(group):
    return {'heads': group.heads, 'tails': group.tails}


def group_init(shared):
    return Group(heads=0, tails=0)


def add_value(shared, group, value):
    return add_repeated_value(shared, group, value, 1)


def add_repeated_value(shared, group, value, count):
    if value:
        return group._replace(heads=group.heads + count)
    return group._replace(tails=group.tails + count)


def remove_value(shared, group, value):
    return add_repeated_value(shared, group, value, -1)


def merge(shared, destin, source):
    return Group(heads=destin.heads + source.heads,
                 tails=destin.tails + source.tails)


def score_value(shared, group, value):
    heads = shared.alpha + group.heads
    tails = shared.beta + group.tails
    return float(np.log((heads if value else tails) / (heads + tails)))


def score_data(shared, group):
    return float(betaln(shared.alpha + group.heads,
                        shared.beta + group.tails)
                 - betaln(shared.alpha, shared.beta))


def sampler_init(rng, shared, group=None):
    if group is None:
        return sample_beta(rng, shared.alpha, shared.beta)
    return sample_beta(rng, shared.alpha + group.heads,
                       shared.beta + group.tails)


def sampler_eval(rng, shared, p, shape=None):
    return sample_bernoulli(rng, p, shape)


def sample_value(rng, shared, group):
    return sampler_eval(rng, shared, sampler_init(rng, shared, group))


def sample_group(rng, shared, size):
    p = sampler_init(rng, shared)
    return list(sampler_eval(rng, shared, p, (size,)))
