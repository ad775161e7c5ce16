"""hp Dirichlet-Process-Discrete: float64 dict-based implementation
(independent of the JAX core models/dpd.py; semantics of reference
dbg/models/dpd.py:28-290).

Where the core uses a fixed-capacity dense value table (TPU layout), this
flavor keeps REAL sparse dicts — the reference's SparseCounter layout
(dpd.hpp:155-272) — so the flavor-agreement test cross-checks the dense
masked arithmetic against straightforward sparse bookkeeping.  Shared
mutation is functional: shared_add_value consumes a numpy Generator and
returns a new Shared."""

from collections import namedtuple

import numpy as np

from distributions_tpu_torch.hp.special import gammaln
from distributions_tpu_torch.hp.random import (
    sample_beta, sample_dirichlet, sample_discrete)

NAME = 'DirichletProcessDiscrete'
OTHER = -1
MIN_BETA0 = 1e-4

EXAMPLES = [
    {
        'shared': {
            'gamma': 0.5,
            'alpha': 0.5,
            'betas': {0: 0.25, 7: 0.5, 8: 0.25},
            'counts': {0: 1, 7: 2, 8: 4},
        },
        'values': [0, 7, 0, 8, 0, 7, 0],
    },
    {
        'shared': {
            'gamma': 2.0,
            'alpha': 2.0,
            'betas': {},
            'counts': {},
        },
        'values': [5, 4, 3, 2, 1, 0, 3, 2, 1],
    },
]
Value = int

Shared = namedtuple('Shared', 'gamma alpha beta0 betas counts')
Group = namedtuple('Group', 'counts total')


def shared_from_dict(raw):
    betas = {int(v): float(b) for v, b in raw['betas'].items()}
    counts_in = raw.get('counts', {})
    counts = {int(v): int(counts_in.get(v, counts_in.get(str(v), 0)))
              for v in betas}
    beta0 = max(0.0, 1.0 - sum(betas.values()))
    if betas and not all(0.0 <= b <= 1.0 for b in betas.values()):
        raise ValueError('betas out of bounds')
    return Shared(gamma=float(raw['gamma']), alpha=float(raw['alpha']),
                  beta0=beta0, betas=betas, counts=counts)


def shared_to_dict(shared):
    active = {v for v in shared.betas
              if shared.betas[v] > 0 or shared.counts.get(v, 0) > 0}
    return {
        'gamma': shared.gamma,
        'alpha': shared.alpha,
        'betas': {v: shared.betas[v] for v in sorted(active)},
        'counts': {v: shared.counts.get(v, 0) for v in sorted(active)},
    }


def group_from_dict(raw, shared=None):
    counts = {int(v): int(c) for v, c in raw['counts'].items() if c}
    return Group(counts=counts, total=sum(counts.values()))


def group_to_dict(group, shared=None):
    return {'counts': dict(sorted(group.counts.items()))}


def group_init(shared):
    return Group(counts={}, total=0)


# -- Shared mutation ---------------------------------------------------------

def shared_add_value(rng, shared, value):
    """First sight of a value breaks a stick beta = beta0 * Beta(1, gamma);
    repeat sights only bump the shared count (reference
    dbg/models/dpd.py:137-144)."""
    v = int(value)
    betas = dict(shared.betas)
    counts = dict(shared.counts)
    beta0 = shared.beta0
    if v in betas:
        counts[v] = counts.get(v, 0) + 1
    else:
        frac = sample_beta(rng, 1.0, shared.gamma)
        new_beta = beta0 * frac
        beta0 = max(0.0, beta0 - new_beta)
        betas[v] = new_beta
        counts[v] = 1
    return Shared(gamma=shared.gamma, alpha=shared.alpha, beta0=beta0,
                  betas=betas, counts=counts)


def shared_remove_value(rng, shared, value):
    """When a value's shared count hits zero, its stick mass returns to
    beta0 (reference dbg/models/dpd.py:146-153)."""
    v = int(value)
    betas = dict(shared.betas)
    counts = dict(shared.counts)
    beta0 = shared.beta0
    counts[v] = counts.get(v, 0) - 1
    if counts[v] == 0:
        beta0 += betas.pop(v, 0.0)
        del counts[v]
    return Shared(gamma=shared.gamma, alpha=shared.alpha, beta0=beta0,
                  betas=betas, counts=counts)


def shared_realize(rng, shared, max_sticks=10000):
    """Materialize sticks until beta0 is negligible (reference
    dbg/models/dpd.py:155-165)."""
    next_value = max(shared.betas) + 1 if shared.betas else 0
    n = 0
    while shared.beta0 > MIN_BETA0 and n < max_sticks:
        shared = shared_add_value(rng, shared, next_value)
        next_value += 1
        n += 1
    if shared.beta0 > 0:
        betas = dict(shared.betas)
        counts = dict(shared.counts)
        betas[next_value] = betas.get(next_value, 0.0) + shared.beta0
        counts[next_value] = counts.get(next_value, 0) + 1
        shared = shared._replace(beta0=0.0, betas=betas, counts=counts)
    return shared


# -- Group ops ---------------------------------------------------------------

def add_value(shared, group, value):
    return add_repeated_value(shared, group, value, 1)


def add_repeated_value(shared, group, value, count):
    v = int(value)
    counts = dict(group.counts)
    counts[v] = counts.get(v, 0) + count
    if counts[v] == 0:
        del counts[v]
    return Group(counts=counts, total=group.total + count)


def remove_value(shared, group, value):
    return add_repeated_value(shared, group, value, -1)


def merge(shared, destin, source):
    counts = dict(destin.counts)
    for v, c in source.counts.items():
        counts[v] = counts.get(v, 0) + c
        if counts[v] == 0:
            del counts[v]
    return Group(counts=counts, total=destin.total + source.total)


def score_value(shared, group, value):
    """log((beta_v * alpha + n_v) / (alpha + total)); OTHER scores the
    unbroken beta0 mass (reference dbg/models/dpd.py:197-209)."""
    v = int(value)
    if v == OTHER:
        numer = shared.beta0 * shared.alpha
    else:
        numer = shared.betas.get(v, 0.0) * shared.alpha \
            + group.counts.get(v, 0)
    denom = shared.alpha + group.total
    with np.errstate(divide='ignore'):
        return float(np.log(numer) - np.log(denom))


def score_data(shared, group):
    score = 0.0
    for v, n in group.counts.items():
        if n:
            prior = shared.betas.get(v, 0.0) * shared.alpha
            score += float(gammaln(prior + n) - gammaln(prior))
    return score + float(gammaln(shared.alpha)
                         - gammaln(shared.alpha + group.total))


# -- sampling ----------------------------------------------------------------

def sampler_init(rng, shared, group=None):
    """(values list incl. OTHER, Dirichlet probs) over active sticks plus
    the remainder (reference dbg/models/dpd.py:266-278)."""
    values = sorted(shared.betas)
    post = np.asarray(
        [shared.betas[v] * shared.alpha
         + (group.counts.get(v, 0) if group is not None else 0)
         for v in values] + [shared.beta0 * shared.alpha], np.float64)
    return values + [OTHER], sample_dirichlet(rng, post)


def sampler_eval(rng, shared, params, shape=None):
    values, probs = params
    if shape is None:
        return values[sample_discrete(rng, probs)]
    flat = [values[sample_discrete(rng, probs)]
            for _ in range(int(np.prod(shape)))]
    return np.asarray(flat).reshape(shape)


def sample_value(rng, shared, group):
    return int(sampler_eval(rng, shared, sampler_init(rng, shared, group)))


def sample_group(rng, shared, size):
    params = sampler_init(rng, shared)
    return [int(v) for v in sampler_eval(rng, shared, params, (size,))]
