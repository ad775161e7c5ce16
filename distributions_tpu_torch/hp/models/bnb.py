"""hp Beta-Negative-Binomial: scalar float64 implementation (independent of
the JAX core models/bnb.py; semantics of reference dbg/models/bnb.py).

The predictive is written as a betaln ratio — a different expression than
the core's six-gammaln form; equal by B(a,b) = G(a)G(b)/G(a+b).  Note the
model (like the reference) scores ordered sequences, so the predictive
carries no binomial coefficient — it is NOT scipy's betanbinom pmf."""

from collections import namedtuple

from distributions_tpu_torch.hp.special import betaln
from distributions_tpu_torch.hp.random import sample_beta, sample_negative_binomial

NAME = 'BetaNegativeBinomial'
EXAMPLES = [
    {
        'shared': {'alpha': 1., 'beta': 1., 'r': 1},
        'values': [0, 1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 2, 3],
    },
]
Value = int

Shared = namedtuple('Shared', 'alpha beta r')
Group = namedtuple('Group', 'count sum')


def shared_from_dict(raw):
    return Shared(alpha=float(raw['alpha']), beta=float(raw['beta']),
                  r=int(raw['r']))


def shared_to_dict(shared):
    return {'alpha': shared.alpha, 'beta': shared.beta, 'r': shared.r}


def group_from_dict(raw):
    return Group(count=int(raw['count']), sum=int(raw['sum']))


def group_to_dict(group):
    return {'count': group.count, 'sum': group.sum}


def group_init(shared):
    return Group(count=0, sum=0)


def plus_group(shared, group):
    return Shared(alpha=shared.alpha + shared.r * group.count,
                  beta=shared.beta + group.sum, r=shared.r)


def add_value(shared, group, value):
    return add_repeated_value(shared, group, value, 1)


def add_repeated_value(shared, group, value, count):
    return Group(count=group.count + count,
                 sum=group.sum + count * int(value))


def remove_value(shared, group, value):
    return add_repeated_value(shared, group, value, -1)


def merge(shared, destin, source):
    return Group(count=destin.count + source.count,
                 sum=destin.sum + source.sum)


def score_value(shared, group, value):
    post = plus_group(shared, group)
    return float(betaln(post.alpha + shared.r, post.beta + int(value))
                 - betaln(post.alpha, post.beta))


def score_data(shared, group):
    post = plus_group(shared, group)
    return float(betaln(post.alpha, post.beta)
                 - betaln(shared.alpha, shared.beta))


def sampler_init(rng, shared, group=None):
    post = shared if group is None else plus_group(shared, group)
    return sample_beta(rng, post.alpha, post.beta)


def sampler_eval(rng, shared, p, shape=None):
    return sample_negative_binomial(rng, p, shared.r, shape)


def sample_value(rng, shared, group):
    return sampler_eval(rng, shared, sampler_init(rng, shared, group))


def sample_group(rng, shared, size):
    p = sampler_init(rng, shared)
    return [int(v) for v in sampler_eval(rng, shared, p, (size,))]
