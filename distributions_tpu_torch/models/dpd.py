"""Dirichlet-Process-Discrete model (distributions_tpu.models.dpd): a
stick-breaking DP over an open, growing set of integer values.

Shared={gamma, alpha, beta0, values, betas, counts} is a fixed-capacity
dense value table of static size V:

- ``Shared.values[V]``  the raw integer ids present (padding = -1)
- ``Shared.betas[V]``, ``Shared.counts[V]``  stick masses / shared counts
- ``Group.counts[..., V]``  dense per-group counts (any batch shape);
  they are signed, so a group may hold a negative count ("debt") after a
  remove that precedes its add

Raw values are looked up by an equality scan over the V slots.  `OTHER`
(-1) names every value that has no stick yet.

The Shared changes as values are observed: `shared_add_value` breaks a
new stick beta0 * Beta(1, gamma) off on a value's first sight,
`shared_remove_value` returns a value's mass to beta0 when its shared
count reaches zero, and `shared_realize` breaks sticks until beta0 is
spent.  Each takes a `torch.Generator` and returns a new Shared.
"""

from typing import NamedTuple

import numpy as np
import torch

from distributions_tpu_torch.config import resolve_device
from distributions_tpu_torch.models import base
from distributions_tpu_torch.random import (sample_beta, sample_dirichlet,
                                            sample_discrete)
from distributions_tpu_torch.special import gammaln

NAME = 'DirichletProcessDiscrete'
OTHER = -1
DEFAULT_CAPACITY = 64
REALIZE_MAX = 10000   # reference dbg/models/dpd.py:156
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


class Shared(NamedTuple):
    gamma: torch.Tensor
    alpha: torch.Tensor
    beta0: torch.Tensor
    values: torch.Tensor  # [V] int32, padding -1
    betas: torch.Tensor   # [V] float32
    counts: torch.Tensor  # [V] int32


class Group(NamedTuple):
    counts: torch.Tensor  # [..., V] int32
    total: torch.Tensor   # [...] int32


def capacity(shared):
    return shared.values.shape[-1]


def active_mask(shared):
    return (shared.counts > 0) | (shared.betas > 0)


def shared_from_dict(raw, cap=DEFAULT_CAPACITY, device=None):
    device = resolve_device(device)
    betas = raw['betas']
    counts = raw.get('counts', {})
    if not len(betas) < cap:
        raise ValueError('dpd capacity %d too small for %d betas'
                         % (cap, len(betas)))
    vals = np.full(cap, -1, np.int32)
    bs = np.zeros(cap, np.float32)
    cs = np.zeros(cap, np.int32)
    for i, (v, b) in enumerate(sorted(betas.items())):
        vals[i] = int(v)
        bs[i] = float(b)
        cs[i] = int(counts.get(v, counts.get(str(v), 0)))
    beta0 = max(0.0, 1.0 - float(bs.sum()))
    if not beta0 <= 1.0:
        raise ValueError('beta0 out of bounds: {}'.format(beta0))
    if len(betas) and not (bs.min() >= 0.0 and bs.max() <= 1.0):
        raise ValueError('betas out of bounds')
    return Shared(gamma=base.scalar(raw['gamma'], torch.float32, device),
                  alpha=base.scalar(raw['alpha'], torch.float32, device),
                  beta0=base.scalar(beta0, torch.float32, device),
                  values=torch.from_numpy(vals).to(device),
                  betas=torch.from_numpy(bs).to(device),
                  counts=torch.from_numpy(cs).to(device))


def shared_to_dict(shared):
    vals = shared.values.cpu().numpy()
    bs = shared.betas.cpu().numpy().astype(np.float64)
    cs = shared.counts.cpu().numpy()
    act = active_mask(shared).cpu().numpy()
    return {
        'gamma': float(shared.gamma),
        'alpha': float(shared.alpha),
        'betas': {int(v): float(b) for v, b, a in zip(vals, bs, act) if a},
        'counts': {int(v): int(c) for v, c, a in zip(vals, cs, act) if a},
    }


def group_from_dict(raw, shared):
    """A Group from {'counts': {value: count}}; every value must be one of
    the Shared's."""
    counts = torch.zeros(capacity(shared), dtype=torch.int32)
    total = 0
    vals = shared.values.cpu().numpy()
    for v, c in raw['counts'].items():
        if c:
            hit = np.flatnonzero(vals == int(v))
            if not hit.size:
                raise ValueError('dpd value %r has no slot' % (v,))
            counts[int(hit[0])] = int(c)
            total += int(c)
    dev = shared.values.device
    return Group(counts=counts.to(dev),
                 total=base.scalar(total, torch.int32, dev))


def group_to_dict(group, shared):
    vals = shared.values.cpu().numpy()
    cs = group.counts.cpu().numpy()
    return {'counts': {int(v): int(c) for v, c in zip(vals, cs) if c != 0}}


def group_init(shared, shape=()):
    dev = shared.values.device
    return Group(counts=torch.zeros(tuple(shape) + (capacity(shared),),
                                    dtype=torch.int32, device=dev),
                 total=torch.zeros(shape, dtype=torch.int32, device=dev))


def value_to_slot(shared, value):
    """Raw value(s) -> dense slot index; the capacity V for unknown values
    and OTHER (such indices drop in sums and read as zero in lookups)."""
    value = torch.as_tensor(value, device=shared.values.device).to(
        torch.int32)
    eq = shared.values == value[..., None]                     # [..., V]
    found = eq.any(-1) & (value != OTHER)
    slot = torch.argmax(eq.to(torch.int32), dim=-1)
    return torch.where(found, slot, torch.full_like(slot, capacity(shared)))


def shared_add_value(generator, shared, value):
    """Observe one instance of `value`: on its first sight a new stick
    beta = beta0 * Beta(1, gamma) breaks off beta0 into the first
    inactive slot.  One beta is drawn on every call."""
    value = torch.as_tensor(value, device=shared.values.device).to(
        torch.int32)
    slot = value_to_slot(shared, value)
    found = slot < capacity(shared)
    free = torch.argmin(active_mask(shared).to(torch.int8))
    target = torch.where(found, slot, free)
    frac = sample_beta(generator, 1.0, shared.gamma)
    new_beta = shared.beta0 * frac
    values = shared.values.clone()
    betas = shared.betas.clone()
    counts = shared.counts.clone()
    values[target] = value
    betas[target] = torch.where(found, shared.betas[target], new_beta)
    counts[target] += 1
    return Shared(
        gamma=shared.gamma, alpha=shared.alpha,
        beta0=torch.where(found, shared.beta0,
                          torch.clamp(shared.beta0 - new_beta, min=0.0)),
        values=values, betas=betas, counts=counts)


def shared_remove_value(generator, shared, value):
    """Un-observe one instance of a known `value`; when its shared count
    reaches zero its stick mass returns to beta0 and its slot frees.
    Draws nothing."""
    slot = value_to_slot(shared, value)
    count = shared.counts[slot] - 1
    dead = count == 0
    values = shared.values.clone()
    betas = shared.betas.clone()
    counts = shared.counts.clone()
    values[slot] = torch.where(dead, torch.full_like(values[slot], OTHER),
                               values[slot])
    betas[slot] = torch.where(dead, torch.zeros_like(betas[slot]),
                              betas[slot])
    counts[slot] = count
    return Shared(
        gamma=shared.gamma, alpha=shared.alpha,
        beta0=torch.where(dead, shared.beta0 + shared.betas[slot],
                          shared.beta0),
        values=values, betas=betas, counts=counts)


def shared_realize(generator, shared):
    """Break sticks for new values until beta0 falls below MIN_BETA0 or
    one slot is left, then give what remains of beta0 to one more value.
    A host loop: realizing is set-up, not a hot path."""
    cap = capacity(shared)
    n_active = int(active_mask(shared).sum())
    vals = shared.values.cpu().numpy()
    new_value = int(vals.max()) + 1 if n_active else 0
    while n_active < cap - 1 and float(shared.beta0) > MIN_BETA0:
        shared = shared_add_value(generator, shared, new_value)
        new_value += 1
        n_active += 1
    if float(shared.beta0) > 0 and n_active < cap:
        shared = shared_add_value(generator, shared, new_value)
        slot = int(torch.argmax((shared.values == new_value).to(
            torch.int32)))
        betas = shared.betas.clone()
        betas[slot] += shared.beta0
        shared = shared._replace(betas=betas,
                                 beta0=torch.zeros_like(shared.beta0))
    return shared


def shared_to_state_dict(shared):
    """Serialization that keeps the slot order (the checkpoint's form):
    group count tables are aligned with the slots, so the sorted and
    compacted `shared_to_dict` form is not safe to restore against saved
    groups; this one round-trips the dense table as it is."""
    return {
        'gamma': float(shared.gamma),
        'alpha': float(shared.alpha),
        'beta0': float(shared.beta0),
        'slot_values': [int(v) for v in shared.values.cpu().numpy()],
        'slot_betas': [float(b) for b in shared.betas.cpu().numpy()],
        'slot_counts': [int(c) for c in shared.counts.cpu().numpy()],
    }


def shared_from_state_dict(raw, device=None):
    device = resolve_device(device)

    def arr(key, dtype):
        return torch.from_numpy(np.asarray(raw[key], dtype)).to(device)
    return Shared(gamma=base.scalar(raw['gamma'], torch.float32, device),
                  alpha=base.scalar(raw['alpha'], torch.float32, device),
                  beta0=base.scalar(raw['beta0'], torch.float32, device),
                  values=arr('slot_values', np.int32),
                  betas=arr('slot_betas', np.float32),
                  counts=arr('slot_counts', np.int32))


def add_value(shared, group, value):
    return add_repeated_value(shared, group, value, 1)


def add_repeated_value(shared, group, value, count):
    """Unknown values and OTHER change the total and no count."""
    onehot, slots = _onehot(shared, value)
    count = torch.as_tensor(count, device=slots.device).to(torch.int32)
    return Group(counts=group.counts + count * onehot.to(torch.int32),
                 total=group.total + count)


def remove_value(shared, group, value):
    return add_repeated_value(shared, group, value, -1)


def merge(shared, destin, source):
    return Group(counts=destin.counts + source.counts,
                 total=destin.total + source.total)


def unmerge(shared, destin, source):
    return Group(counts=destin.counts - source.counts,
                 total=destin.total - source.total)


def _padded(a):
    """`a` with one zero appended on the last axis, so that the
    out-of-range slot V reads as zero."""
    return torch.cat([a, torch.zeros_like(a[..., :1])], dim=-1)


def score_value(shared, group, value):
    """log((beta_v * alpha + n_v) / (alpha + total)); OTHER scores the
    unbroken mass beta0 * alpha, and unknown values score -inf."""
    value = torch.as_tensor(value, device=shared.values.device).to(
        torch.int32)
    slot = value_to_slot(shared, value)
    beta = _padded(shared.betas)[slot]
    idx = slot.expand(group.counts.shape[:-1])[..., None]
    cnt = _padded(group.counts).gather(-1, idx)[..., 0].to(torch.float32)
    numer = torch.where(value == OTHER, shared.beta0 * shared.alpha,
                        beta * shared.alpha + cnt)
    denom = shared.alpha + group.total.to(torch.float32)
    return torch.log(numer) - torch.log(denom)


def score_value_batch(shared, group, values):
    """[K, V] groups x [B] raw values -> [B, K]."""
    values = torch.as_tensor(values, device=shared.values.device).to(
        torch.int32)
    slots = value_to_slot(shared, values)                          # [B]
    beta = _padded(shared.betas)[slots]                            # [B]
    cnt = _padded(group.counts)[..., slots].to(torch.float32)      # [K, B]
    numer = torch.where(values[None, :] == OTHER,
                        shared.beta0 * shared.alpha,
                        beta[None, :] * shared.alpha + cnt)        # [K, B]
    denom = shared.alpha + group.total.to(torch.float32)           # [K]
    return (torch.log(numer) - torch.log(denom)[:, None]).t()


def score_data(shared, group):
    prior = shared.betas * shared.alpha                            # [V]
    cnt = group.counts.to(torch.float32)                           # [..., V]
    zero = torch.zeros((), dtype=torch.float32, device=cnt.device)
    terms = torch.where(group.counts != 0,
                        gammaln(prior + cnt) - gammaln(prior), zero)
    return (terms.sum(-1) + gammaln(shared.alpha)
            - gammaln(shared.alpha + group.total.to(torch.float32)))


def _onehot(shared, values):
    slots = value_to_slot(shared, values)                          # [...]
    v = torch.arange(capacity(shared), device=slots.device)
    return v == slots[..., None], slots


def from_values_grouped(shared, values, assignments, num_groups):
    onehot, slots = _onehot(shared, values)
    return Group(
        counts=base.segment_sum(onehot.to(torch.int32), assignments,
                                num_groups),
        total=base.segment_sum(torch.ones(slots.shape, dtype=torch.int32,
                                          device=slots.device),
                               assignments, num_groups))


def row_stat_dim(shared):
    return capacity(shared) + 1


def row_stat_columns(shared, values):
    """[..., V + 1] = [one-hot of the value's slot | 1]."""
    onehot, slots = _onehot(shared, values)
    ones = torch.ones(slots.shape + (1,), dtype=torch.float32,
                      device=slots.device)
    return torch.cat([onehot.to(torch.float32), ones], dim=-1)


def row_stats_to_tile(shared, sums):
    return Group(counts=torch.round(sums[..., :-1]).to(torch.int32),
                 total=torch.round(sums[..., -1]).to(torch.int32))


# -- samplers ---------------------------------------------------------------

def sampler_init(generator, shared, group=None):
    """Probabilities [V + 1] ~ Dirichlet over the active slots
    (betas * alpha + counts) and the unbroken remainder OTHER (beta0 *
    alpha)."""
    act = active_mask(shared)
    cnt = (torch.zeros(capacity(shared), dtype=torch.float32,
                       device=act.device) if group is None
           else group.counts.to(torch.float32))
    post = torch.where(act, shared.betas * shared.alpha + cnt,
                       torch.zeros_like(cnt))
    post = torch.cat([post, (shared.beta0 * shared.alpha)[None]])
    return sample_dirichlet(generator, post)


def sampler_eval(generator, shared, probs, shape=()):
    idx = sample_discrete(generator, probs,
                          shape=tuple(shape) if shape else None)
    vals = torch.cat([shared.values, torch.full(
        (1,), OTHER, dtype=torch.int32, device=shared.values.device)])
    return vals[idx]


def sample_value(generator, shared, group):
    return sampler_eval(generator, shared,
                        sampler_init(generator, shared, group))


def sample_group(generator, shared, size):
    return base.generic_sample_group(sampler_init, sampler_eval, generator,
                                     shared, size)
