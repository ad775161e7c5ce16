"""hp Normal-Inverse-Chi-Squared: scalar float64 implementation
(independent of the JAX core models/nich.py; semantics of reference
dbg/models/nich.py and the reference's own hp flavor
distributions/hp/models/nich.pyx).

The group keeps RAW MOMENTS (sum, sum of squares) instead of the core's
Welford (mean, M2) pair — a deliberately different sufficient-statistic
layout, affordable in float64, so the flavor-agreement test exercises two
distinct accumulation schemes.  The predictive goes through
scipy.stats.t.logpdf rather than an explicit lgamma formula."""

from collections import namedtuple

import numpy as np
from scipy.stats import t as student_t

from distributions_tpu_torch.hp.special import gammaln
from distributions_tpu_torch.hp.random import sample_chisq, sample_normal

NAME = 'NormalInverseChiSq'
EXAMPLES = [
    {
        'shared': {'mu': 0., 'kappa': 1., 'sigmasq': 1., 'nu': 1.},
        'values': [-4.0, -2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0, 4.0],
    },
]
Value = float

Shared = namedtuple('Shared', 'mu kappa sigmasq nu')
Group = namedtuple('Group', 'count sum sumsq')


def shared_from_dict(raw):
    return Shared(mu=float(raw['mu']), kappa=float(raw['kappa']),
                  sigmasq=float(raw['sigmasq']), nu=float(raw['nu']))


def shared_to_dict(shared):
    return {'mu': shared.mu, 'kappa': shared.kappa,
            'sigmasq': shared.sigmasq, 'nu': shared.nu}


def group_from_dict(raw):
    """Accepts either the raw-moment form or the core's Welford form
    {count, mean, count_times_variance} (they are bijective)."""
    if 'sumsq' in raw:
        return Group(count=int(raw['count']), sum=float(raw['sum']),
                     sumsq=float(raw['sumsq']))
    n = int(raw['count'])
    mean = float(raw['mean'])
    m2 = float(raw['count_times_variance'])
    return Group(count=n, sum=n * mean, sumsq=m2 + n * mean * mean)


def group_to_dict(group):
    """Dumps in the core's Welford schema for cross-flavor comparability."""
    n = group.count
    mean = group.sum / n if n else 0.0
    m2 = group.sumsq - n * mean * mean if n > 1 else 0.0
    return {'count': n, 'mean': mean, 'count_times_variance': max(m2, 0.0)}


def group_init(shared):
    return Group(count=0, sum=0.0, sumsq=0.0)


def plus_group(shared, group):
    """Murphy (2007) Eqs. 141-144 in raw-moment form."""
    n = group.count
    kappa_n = shared.kappa + n
    nu_n = shared.nu + n
    mu_n = (shared.kappa * shared.mu + group.sum) / kappa_n
    if n:
        mean = group.sum / n
        cvar = group.sumsq - group.sum * mean
        d = mean - shared.mu
        extra = cvar + (n * shared.kappa / kappa_n) * d * d
    else:
        extra = 0.0
    sigmasq_n = (shared.nu * shared.sigmasq + extra) / nu_n
    return Shared(mu=mu_n, kappa=kappa_n, sigmasq=sigmasq_n, nu=nu_n)


def add_value(shared, group, value):
    return add_repeated_value(shared, group, value, 1)


def add_repeated_value(shared, group, value, count):
    v = float(value)
    return Group(count=group.count + count, sum=group.sum + count * v,
                 sumsq=group.sumsq + count * v * v)


def remove_value(shared, group, value):
    return add_repeated_value(shared, group, value, -1)


def merge(shared, destin, source):
    return Group(count=destin.count + source.count,
                 sum=destin.sum + source.sum,
                 sumsq=destin.sumsq + source.sumsq)


def score_value(shared, group, value):
    post = plus_group(shared, group)
    scale = np.sqrt((1.0 + post.kappa) * post.sigmasq / post.kappa)
    return float(student_t.logpdf(float(value), df=post.nu, loc=post.mu,
                                  scale=scale))


def score_data(shared, group):
    post = plus_group(shared, group)
    return float(gammaln(0.5 * post.nu) - gammaln(0.5 * shared.nu)
                 + 0.5 * np.log(shared.kappa / post.kappa)
                 + 0.5 * shared.nu * np.log(shared.nu * shared.sigmasq)
                 - 0.5 * post.nu * np.log(post.nu * post.sigmasq)
                 - 0.5 * group.count * np.log(np.pi))


def sampler_init(rng, shared, group=None):
    post = shared if group is None else plus_group(shared, group)
    sigmasq_star = post.nu * post.sigmasq / sample_chisq(rng, post.nu)
    mu = sample_normal(rng, post.mu, np.sqrt(sigmasq_star / post.kappa))
    return mu, np.sqrt(sigmasq_star)


def sampler_eval(rng, shared, params, shape=None):
    mu, sigma = params
    return sample_normal(rng, mu, sigma, shape)


def sample_value(rng, shared, group):
    return float(sampler_eval(rng, shared, sampler_init(rng, shared, group)))


def sample_group(rng, shared, size):
    params = sampler_init(rng, shared)
    return [float(v) for v in sampler_eval(rng, shared, params, (size,))]
