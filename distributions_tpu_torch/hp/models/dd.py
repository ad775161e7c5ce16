"""hp Dirichlet-Discrete: scalar float64 numpy implementation (independent
of the JAX core models/dd.py; semantics of reference dbg/models/dd.py and
the reference's own hp flavor distributions/hp/models/dd.pyx)."""

from collections import namedtuple

import numpy as np

from distributions_tpu_torch.hp.special import gammaln
from distributions_tpu_torch.hp.random import sample_dirichlet, sample_discrete

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

Shared = namedtuple('Shared', 'alphas')
Group = namedtuple('Group', 'counts')


def shared_from_dict(raw):
    return Shared(alphas=np.asarray(raw['alphas'], np.float64))


def shared_to_dict(shared):
    return {'alphas': [float(a) for a in shared.alphas]}


def group_from_dict(raw):
    return Group(counts=np.asarray(raw['counts'], np.int64))


def group_to_dict(group):
    return {'counts': [int(c) for c in group.counts]}


def group_init(shared):
    return Group(counts=np.zeros(len(shared.alphas), np.int64))


def add_value(shared, group, value):
    return add_repeated_value(shared, group, value, 1)


def add_repeated_value(shared, group, value, count):
    counts = group.counts.copy()
    counts[int(value)] += count
    return Group(counts=counts)


def remove_value(shared, group, value):
    return add_repeated_value(shared, group, value, -1)


def merge(shared, destin, source):
    return Group(counts=destin.counts + source.counts)


def score_value(shared, group, value):
    v = int(value)
    numer = shared.alphas[v] + group.counts[v]
    denom = shared.alphas.sum() + group.counts.sum()
    return float(np.log(numer) - np.log(denom))


def score_data(shared, group):
    """Dirichlet-multinomial marginal (no multinomial coefficient — the
    values are an ordered sequence, matching the reference)."""
    a = shared.alphas
    m = group.counts.astype(np.float64)
    return float(np.sum(gammaln(a + m) - gammaln(a))
                 + gammaln(a.sum()) - gammaln(a.sum() + m.sum()))


def sampler_init(rng, shared, group=None):
    post = shared.alphas if group is None else shared.alphas + group.counts
    return sample_dirichlet(rng, post)


def sampler_eval(rng, shared, probs, shape=None):
    if shape is None:
        return sample_discrete(rng, probs)
    return np.asarray([sample_discrete(rng, probs)
                       for _ in range(int(np.prod(shape)))]).reshape(shape)


def sample_value(rng, shared, group):
    return sampler_eval(rng, shared, sampler_init(rng, shared, group))


def sample_group(rng, shared, size):
    probs = sampler_init(rng, shared)
    return [int(v) for v in sampler_eval(rng, shared, probs, (size,))]
