"""hp Gamma-Poisson: scalar float64 implementation (independent of the JAX
core models/gp.py; semantics of reference dbg/models/gp.py and the
reference's own hp flavor distributions/hp/models/gp.pyx).

The posterior predictive is evaluated through scipy.stats.nbinom — a
genuinely different code path than the core's explicit gammaln formula."""

from collections import namedtuple

import numpy as np
from scipy.stats import nbinom

from distributions_tpu_torch.hp.special import gammaln, log_factorial
from distributions_tpu_torch.hp.random import sample_gamma, sample_poisson

NAME = 'GammaPoisson'
EXAMPLES = [
    {
        'shared': {'alpha': 1., 'inv_beta': 1.},
        'values': [0, 1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 2, 3],
    },
]
Value = int

Shared = namedtuple('Shared', 'alpha inv_beta')
Group = namedtuple('Group', 'count sum log_prod')


def shared_from_dict(raw):
    return Shared(alpha=float(raw['alpha']), inv_beta=float(raw['inv_beta']))


def shared_to_dict(shared):
    return {'alpha': shared.alpha, 'inv_beta': shared.inv_beta}


def group_from_dict(raw):
    return Group(count=int(raw['count']), sum=int(raw['sum']),
                 log_prod=float(raw['log_prod']))


def group_to_dict(group):
    return {'count': group.count, 'sum': group.sum,
            'log_prod': group.log_prod}


def group_init(shared):
    return Group(count=0, sum=0, log_prod=0.0)


def plus_group(shared, group):
    return Shared(alpha=shared.alpha + group.sum,
                  inv_beta=shared.inv_beta + group.count)


def add_value(shared, group, value):
    return add_repeated_value(shared, group, value, 1)


def add_repeated_value(shared, group, value, count):
    v = int(value)
    return Group(count=group.count + count, sum=group.sum + count * v,
                 log_prod=group.log_prod + count * float(log_factorial(v)))


def remove_value(shared, group, value):
    return add_repeated_value(shared, group, value, -1)


def merge(shared, destin, source):
    return Group(count=destin.count + source.count,
                 sum=destin.sum + source.sum,
                 log_prod=destin.log_prod + source.log_prod)


def score_value(shared, group, value):
    """NB(y; r=alpha_n, p=ib_n/(1+ib_n)) — the Gamma-Poisson predictive."""
    post = plus_group(shared, group)
    p = post.inv_beta / (1.0 + post.inv_beta)
    return float(nbinom.logpmf(int(value), post.alpha, p))


def score_data(shared, group):
    post = plus_group(shared, group)
    return float(gammaln(post.alpha) - gammaln(shared.alpha)
                 - post.alpha * np.log(post.inv_beta)
                 + shared.alpha * np.log(shared.inv_beta)
                 - group.log_prod)


def sampler_init(rng, shared, group=None):
    post = shared if group is None else plus_group(shared, group)
    return sample_gamma(rng, post.alpha, 1.0 / post.inv_beta)


def sampler_eval(rng, shared, lam, shape=None):
    return sample_poisson(rng, lam, shape)


def sample_value(rng, shared, group):
    return sampler_eval(rng, shared, sampler_init(rng, shared, group))


def sample_group(rng, shared, size):
    lam = sampler_init(rng, shared)
    return [int(v) for v in sampler_eval(rng, shared, lam, (size,))]
