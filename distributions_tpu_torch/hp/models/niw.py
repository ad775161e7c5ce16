"""hp Normal-Inverse-Wishart: float64 implementation (independent of the
JAX core models/niw.py; semantics of reference dbg/models/niw.py).

The predictive goes through scipy.stats.multivariate_t.logpdf and the
marginal through scipy.special.multigammaln + numpy slogdet — independent
code paths from the core's hand-written lmultigamma / student-t."""

from collections import namedtuple

import numpy as np
from scipy.stats import multivariate_t

from distributions_tpu_torch.hp.special import lmultigamma
from distributions_tpu_torch.hp.random import sample_normal_inverse_wishart

NAME = 'NormalInverseWishart'
EXAMPLES = [
    {
        'shared': {
            'mu': np.zeros(2), 'kappa': 2., 'psi': np.eye(2), 'nu': 3.,
        },
        'values': [np.array(v) for v in (
            [1., 2.], [-2., 3.], [-0.2, -0.2], [-0.1, 0.5],
            [0.8, 0.5], [0.8, 0.3], [-9., 0.2],
        )],
    },
    {
        'shared': {
            'mu': np.ones(3), 'kappa': 7.5, 'psi': np.eye(3), 'nu': 5.,
        },
        'values': [np.array(v) for v in (
            [1.35, 0.97, 0.88], [0.87, 1.74, 2.13], [-0.31, 1.48, 1.96],
            [1.18, 0.34, 1.00], [1.47, 0.62, -0.10], [-0.23, 2.23, 0.99],
            [1.23, 0.98, 0.36], [1.97, 0.81, 0.79], [0.59, 4.27, 0.44],
        )],
    },
    {
        'shared': {
            'mu': -np.ones(4), 'kappa': 7.5, 'psi': np.eye(4), 'nu': 10.,
        },
        'values': [np.array(v) for v in (
            [0.32, -1.92, -2.13, -0.78], [-2.35, -1.98, -0.27, -1.48],
            [-0.54, -1.76, -1.14, 0.24], [-0.68, -1.62, -0.76, -1.82],
            [-3.03, 0.54, -1.85, -0.53], [0.56, -0.96, -1.00, -2.05],
            [-1.18, -1.52, -1.19, -1.06], [0.47, -0.23, -0.99, 0.69],
            [-1.41, -3.18, -3.09, -1.93],
        )],
    },
]
Value = np.ndarray

Shared = namedtuple('Shared', 'mu kappa psi nu')
Group = namedtuple('Group', 'count sum_x sum_xxT')


def dim(shared):
    return len(shared.mu)


def shared_from_dict(raw):
    return Shared(mu=np.asarray(raw['mu'], np.float64),
                  kappa=float(raw['kappa']),
                  psi=np.asarray(raw['psi'], np.float64),
                  nu=float(raw['nu']))


def shared_to_dict(shared):
    return {'mu': np.asarray(shared.mu), 'kappa': shared.kappa,
            'psi': np.asarray(shared.psi), 'nu': shared.nu}


def group_from_dict(raw):
    return Group(count=int(raw['count']),
                 sum_x=np.asarray(raw['sum_x'], np.float64),
                 sum_xxT=np.asarray(raw['sum_xxT'], np.float64))


def group_to_dict(group):
    return {'count': group.count, 'sum_x': np.asarray(group.sum_x),
            'sum_xxT': np.asarray(group.sum_xxT)}


def group_init(shared):
    d = dim(shared)
    return Group(count=0, sum_x=np.zeros(d), sum_xxT=np.zeros((d, d)))


def plus_group(shared, group):
    """Murphy (2007) Eqs. 251-254."""
    n = group.count
    kappa_n = shared.kappa + n
    nu_n = shared.nu + n
    mu_n = (shared.kappa * shared.mu + group.sum_x) / kappa_n
    if n:
        xbar = group.sum_x / n
        scatter = group.sum_xxT - np.outer(group.sum_x, xbar) \
            - np.outer(xbar, group.sum_x) + n * np.outer(xbar, xbar)
        d = xbar - shared.mu
        psi_n = shared.psi + scatter \
            + (shared.kappa * n / kappa_n) * np.outer(d, d)
    else:
        psi_n = shared.psi.copy()
    return Shared(mu=mu_n, kappa=kappa_n, psi=psi_n, nu=nu_n)


def add_value(shared, group, value):
    return add_repeated_value(shared, group, value, 1)


def add_repeated_value(shared, group, value, count):
    v = np.asarray(value, np.float64)
    return Group(count=group.count + count,
                 sum_x=group.sum_x + count * v,
                 sum_xxT=group.sum_xxT + count * np.outer(v, v))


def remove_value(shared, group, value):
    return add_repeated_value(shared, group, value, -1)


def merge(shared, destin, source):
    return Group(count=destin.count + source.count,
                 sum_x=destin.sum_x + source.sum_x,
                 sum_xxT=destin.sum_xxT + source.sum_xxT)


def score_value(shared, group, value):
    """Multivariate student-t predictive, Murphy (2007) Eq. 258."""
    post = plus_group(shared, group)
    dof = post.nu - dim(shared) + 1.0
    sigma = post.psi * (post.kappa + 1.0) / (post.kappa * dof)
    return float(multivariate_t.logpdf(
        np.asarray(value, np.float64), loc=post.mu, shape=sigma, df=dof))


def score_data(shared, group):
    """Murphy (2007) Eq. 266."""
    d = dim(shared)
    post = plus_group(shared, group)
    n = group.count
    return float(lmultigamma(d, 0.5 * post.nu)
                 - lmultigamma(d, 0.5 * shared.nu)
                 + 0.5 * shared.nu * np.linalg.slogdet(shared.psi)[1]
                 - 0.5 * post.nu * np.linalg.slogdet(post.psi)[1]
                 - 0.5 * n * d * np.log(np.pi)
                 + 0.5 * d * np.log(shared.kappa / post.kappa))


def sampler_init(rng, shared, group=None):
    post = shared if group is None else plus_group(shared, group)
    return sample_normal_inverse_wishart(
        rng, post.mu, post.kappa, post.psi, post.nu)


def sampler_eval(rng, shared, params, shape=None):
    mu, cov = params
    if shape is None:
        return rng.multivariate_normal(mu, cov, method='cholesky')
    return rng.multivariate_normal(mu, cov, size=shape, method='cholesky')


def sample_value(rng, shared, group):
    return sampler_eval(rng, shared, sampler_init(rng, shared, group))


def sample_group(rng, shared, size):
    params = sampler_init(rng, shared)
    return list(sampler_eval(rng, shared, params, (size,)))
