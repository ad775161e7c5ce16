"""Clustering priors (distributions_tpu.clustering): Pitman-Yor (CRP) and
the Low-Entropy MDL prior.

The scorers take whole [K] (or [..., K]) counts vectors.  The samplers
take a `torch.Generator`:

- `py_sample_assignments` seats the rows on the host with the prior's
  counts-only seating (`_crp_seating`, which `ops.gibbs.prior_init` uses
  too): the law of the JAX package's capacity-capped scan, in which no
  table opens once `capacity` tables are open, without R steps on the
  device.
- `py_sample_assignments_stick` draws stick-breaking weights and then
  every row at once by an inverse CDF.
- `le_sample_assignments` is a row-by-row loop on the host over
  `le_score_value` (`_le_seating`, which `ops.gibbs.prior_init` uses for
  this prior: LowEntropy is not exchangeable, so there is no shortcut),
  meant for a few hundred rows.
"""

from typing import NamedTuple

import numpy as np
import torch

from distributions_tpu_torch.config import resolve_device
from distributions_tpu_torch.random import (device_generator, draw_seed,
                                            sample_beta, sample_from_scores)
from distributions_tpu_torch.special import gammaln


class PitmanYor(NamedTuple):
    """Pitman-Yor process {alpha, d}; d=0 gives the CRP."""
    alpha: torch.Tensor
    d: torch.Tensor

    @classmethod
    def from_dict(cls, raw, device=None):
        device = resolve_device(device)
        return cls(
            alpha=torch.tensor(float(raw['alpha']), dtype=torch.float32,
                               device=device),
            d=torch.tensor(float(raw['d']), dtype=torch.float32,
                           device=device))

    def to_dict(self):
        return {'alpha': float(self.alpha), 'd': float(self.d)}


class LowEntropy(NamedTuple):
    """Parameter-free MDL clustering prior P(X) ~ exp(-N H(X))."""
    dataset_size: torch.Tensor

    @classmethod
    def from_dict(cls, raw, device=None):
        return cls(dataset_size=torch.tensor(
            int(raw['dataset_size']), dtype=torch.int32,
            device=resolve_device(device)))

    def to_dict(self):
        return {'dataset_size': int(self.dataset_size)}


PitmanYor.EXAMPLES = [
    {'alpha': 1., 'd': 0.},
    {'alpha': 1., 'd': 0.1},
    {'alpha': 1., 'd': 0.9},
    {'alpha': 10., 'd': 0.1},
    {'alpha': 0.1, 'd': 0.1},
]
LowEntropy.EXAMPLES = [
    {'dataset_size': 5},
    {'dataset_size': 1000},
]


def _f32(x, device):
    return torch.as_tensor(x, device=device).to(torch.float32)


# ===========================================================================
# Pitman-Yor

def py_score_add_value(model, group_size, nonempty_group_count, sample_size,
                       empty_group_count=1):
    """Log probability of seating a customer at a table of `group_size`
    (0: a new table, shared by `empty_group_count` empty slots); batched
    over `group_size`."""
    dev = model.alpha.device
    group_size = _f32(group_size, dev)
    nonempty = _f32(nonempty_group_count, dev)
    n = _f32(sample_size, dev)
    e = _f32(empty_group_count, dev)
    new_score = torch.log((model.alpha + model.d * nonempty)
                          / ((n + model.alpha) * e))
    old_score = torch.log((group_size - model.d) / (n + model.alpha))
    return torch.where(group_size == 0, new_score, old_score)


def py_score_remove_value(model, group_size, nonempty_group_count,
                          sample_size, empty_group_count=1):
    """The reverse transition's log probability: minus the score of adding
    the customer back."""
    dev = model.alpha.device
    group_size = _f32(group_size, dev) - 1
    nonempty = _f32(nonempty_group_count, dev)
    nonempty = torch.where(group_size == 0, nonempty - 1, nonempty)
    return -py_score_add_value(model, group_size, nonempty,
                               _f32(sample_size, dev) - 1, empty_group_count)


def py_score_counts(model, counts):
    """Log prob of a partition given its counts [..., K] (zeros ignored;
    `model` may hold a grid of hyperparameters [G] against counts [K] or
    [1, K], giving [G]):
      sum_k' log(alpha + d k') (k' = 0..K'-1)
      + sum_k [lgamma(c_k - d) - lgamma(1 - d)]
      + lgamma(alpha) - lgamma(alpha + n)."""
    counts = torch.as_tensor(counts).to(torch.float32)
    nonzero = counts > 0
    nonempty_count = nonzero.sum(-1).to(torch.float32)
    n = counts.sum(-1)
    K = counts.shape[-1]
    k_idx = torch.arange(K, dtype=torch.float32, device=counts.device)
    zero = torch.zeros((), dtype=torch.float32, device=counts.device)
    # hyperparameters with a batch shape (a grid of models) broadcast
    # against the counts' batch axes: [..., None] lines them up with K
    alpha_k = torch.as_tensor(model.alpha)[..., None]
    d_k = torch.as_tensor(model.d)[..., None]
    new_table_terms = torch.where(
        k_idx < nonempty_count[..., None],
        torch.log(alpha_k + d_k * k_idx), zero).sum(-1)
    size_terms = torch.where(
        nonzero,
        gammaln(torch.clamp(counts, min=1) - d_k) - gammaln(1.0 - d_k),
        zero).sum(-1)
    denom = gammaln(model.alpha + n) - gammaln(model.alpha)
    return new_table_terms + size_terms - denom


def py_score_value(model, counts, alive, sample_size,
                   scores_dtype=torch.float32):
    """Per-slot seating scores [K] over a fixed-capacity counts vector.
    Dead slots score -inf; the empty-slot score is split across the alive
    empty slots."""
    counts = torch.as_tensor(counts).to(torch.float32)
    alive = torch.as_tensor(alive).to(torch.bool)
    is_empty = alive & (counts == 0)
    empty_count = torch.clamp(is_empty.sum(-1).to(torch.float32), min=1.0)
    nonempty_count = (alive & (counts > 0)).sum(-1).to(torch.float32)
    n = torch.as_tensor(sample_size, device=counts.device).to(torch.float32)
    shift = -torch.log(n + model.alpha)
    empty_score = torch.log(
        (model.alpha + model.d * nonempty_count) / empty_count) + shift
    occupied_score = torch.log(
        torch.clamp(counts - model.d, min=1e-30)) + shift
    scores = torch.where(is_empty, empty_score[..., None], occupied_score)
    neg_inf = torch.full((), float('-inf'), device=counts.device)
    return torch.where(alive, scores, neg_inf).to(scores_dtype)


def py_score_value_sharded(model, counts, alive, sample_size, global_empty,
                           global_nonempty):
    """`py_score_value` for a LOCAL slot range of a component-sharded
    state: the same math, with the empty and nonempty slot counts being
    the caller's global values (summed over the component axis), so that
    the empty-slot mass is split as the unsharded scorer splits it.  Given
    tensors on one device (the 2-D sweep passes the two scalar sums as
    0-dim tensors) it reads nothing back and makes no tensor from host
    data, so a CUDA graph of the sweep captures it."""
    counts = torch.as_tensor(counts).to(torch.float32)
    alive = torch.as_tensor(alive).to(torch.bool)
    dev = counts.device
    is_empty = alive & (counts == 0)
    n = torch.as_tensor(sample_size, device=dev).to(torch.float32)
    shift = -torch.log(n + model.alpha)
    g_nonempty = torch.as_tensor(global_nonempty, device=dev).to(
        torch.float32)
    g_empty = torch.clamp(
        torch.as_tensor(global_empty, device=dev).to(torch.float32), min=1.0)
    empty_score = torch.log(
        (model.alpha + model.d * g_nonempty) / g_empty) + shift
    occupied_score = torch.log(
        torch.clamp(counts - model.d, min=1e-30)) + shift
    scores = torch.where(is_empty, empty_score, occupied_score)
    neg_inf = torch.full((), float('-inf'), device=dev)
    return torch.where(alive, scores, neg_inf)


def _uniforms(generator, n):
    """n float64 uniforms on [0, 1) from `generator`, on the host."""
    return torch.rand(n, generator=generator, device=generator.device,
                      dtype=torch.float64).cpu().numpy()


def _crp_seating(alpha, d, counts, alive, R, generator):
    """Slots for R rows seated one after another by the Pitman-Yor prior
    on top of `counts` [C] (host int array; `alive` marks the slots that
    may be taken), as `score_value` would seat them: an occupied slot k
    with probability (n_k - d) / (n + alpha), a new table with (alpha + d
    K) / (n + alpha) on one of the alive empty slots, the first dead slot
    coming alive when an empty one is taken.  With no empty slot left no
    table opens, and the row joins table k with probability proportional
    to n_k - d.

    It depends on counts only, so it needs no scan over [C]-sized scores:
    whether row i opens a table depends on K alone (one scalar chain over
    the rows); a row that joins a table copies the slot of an earlier
    customer picked uniformly, a table's first customer being accepted
    with probability 1 - d (table k is then picked with n_k - d); the
    chains of copies are resolved by pointer doubling."""
    counts = np.asarray(counts, np.int64)
    C = counts.shape[0]
    n0 = int(counts.sum())
    # earlier customers 0..n0-1 stand for the rows already in `counts`
    slot_of = np.full(n0 + R, -1, np.int64)
    slot_of[:n0] = np.repeat(np.arange(C), counts)
    first = np.zeros(n0 + R, bool)
    first[np.cumsum(counts)[counts > 0] - counts[counts > 0]] = True
    empties = [int(k) for k in np.flatnonzero(np.asarray(alive)
                                              & (counts == 0))]
    dead = [int(k) for k in np.flatnonzero(~np.asarray(alive))][::-1]
    K = int((counts > 0).sum())

    # the scalar chain: which rows open a table, and on which slot
    u_new = _uniforms(generator, R).tolist()
    u_slot = _uniforms(generator, min(R, C)).tolist()
    opened = 0
    for i in range(R):
        if empties and u_new[i] * (n0 + i + alpha) < alpha + d * K:
            e = int(u_slot[opened] * len(empties))
            slot_of[n0 + i] = empties[e]
            first[n0 + i] = True
            if dead:
                empties[e] = dead.pop()
            else:
                del empties[e]
            opened += 1
            K += 1
    if n0 == 0 and R > 0 and slot_of[0] < 0:
        raise ValueError('prior_init needs an alive empty slot to start in')

    # the other rows: a parent among the earlier customers
    parent = np.arange(n0 + R)
    pending = n0 + np.flatnonzero(slot_of[n0:] < 0)
    while pending.size:
        j = np.minimum(
            (_uniforms(generator, pending.size) * pending).astype(np.int64),
            pending - 1)
        ok = ~first[j] | (_uniforms(generator, pending.size) < 1.0 - d)
        parent[pending[ok]] = j[ok]
        pending = pending[~ok]
    while True:
        up = parent[parent]
        if np.array_equal(up, parent):
            break
        parent = up
    return slot_of[parent][n0:]


def py_sample_assignments(generator, model, size, capacity=None,
                          device=None):
    """Sequential CRP / Pitman-Yor assignments [size] int32: tables open
    in slot order 0, 1, ..., and none opens once `capacity` are open
    (choose capacity >> the expected table count, ~ alpha log n for the
    CRP).  Seated on the host by `_crp_seating` from empty counts, the
    same law as the JAX package's scan; on `device` (default: the
    model's)."""
    if capacity is None:
        capacity = int(max(64, 16 * (float(model.alpha) + 1.0)
                           * (np.log(size + 1.0) + 1.0)))
    alive = np.zeros(capacity, bool)
    alive[0] = True
    slots = _crp_seating(float(model.alpha), float(model.d),
                         np.zeros(capacity, np.int64), alive, int(size),
                         generator)
    dev = model.alpha.device if device is None else torch.device(device)
    return torch.from_numpy(slots.astype(np.int32)).to(dev)


def py_sample_assignments_stick(generator, model, size, capacity=1024):
    """Pitman-Yor assignments [size] int32 by stick-breaking (GEM):

        V_k ~ Beta(1 - d, alpha + (k + 1) d),   k = 0, 1, ...
        w_k = V_k prod_{j<k} (1 - V_j)
        assignments_i ~ iid Categorical(w)

    By exchangeability the induced partition has the sequential CRP's law;
    labels come in stick (size-biased) order, not in order of creation.
    Two batched draws (a [capacity] beta vector, then [size] uniforms
    through the inverse CDF, a `searchsorted` on the cumulative weights)
    replace R sequential steps.  On the model's device.

    Truncation: the last stick takes all remaining mass, whose expectation
    is prod_{k<K} (alpha + (k + 1) d) / (alpha + 1 + k d) for K =
    capacity; at alpha = 100, d = 0 and K = 1024 that is (100 / 101)^1024,
    about 3.7e-5."""
    dev = model.alpha.device
    k = torch.arange(capacity, dtype=torch.float32, device=dev)
    a = torch.clamp(1.0 - model.d, min=1e-6)
    b = model.alpha + (k + 1.0) * model.d
    v = sample_beta(generator, a, b, (capacity,), device=dev)
    v = torch.clamp(v, 1e-7, 1.0 - 1e-7)
    v[capacity - 1] = 1.0
    logw = torch.log(v) + torch.cat(
        [torch.zeros(1, device=dev), torch.cumsum(torch.log1p(-v)[:-1], 0)])
    cdf = torch.cumsum(torch.exp(logw - torch.logsumexp(logw, 0)), 0)
    cdf[capacity - 1] = 1.0 + 1e-6
    gen = generator if generator.device == dev else device_generator(
        draw_seed(generator), dev)
    u = torch.rand(int(size), generator=gen, device=dev)
    return torch.searchsorted(cdf, u, right=True).to(torch.int32)


# ===========================================================================
# Low-Entropy

# the reference's generated table (derivations/clustering.py)
_LOG_PARTITION_TABLE = np.array([
    0.00000000, 0.00000000, 1.60943791, 3.68887945, 6.07993320,
    8.70549682, 11.51947398, 14.49108422, 17.59827611, 20.82445752,
    24.15668300, 27.58456586, 31.09958507, 34.69462231, 38.36364086,
    42.10145572, 45.90356476, 49.76602176, 53.68533918, 57.65841234,
    61.68245958, 65.75497413, 69.87368527, 74.03652635, 78.24160846,
    82.48719834, 86.77169993, 91.09363859, 95.45164780, 99.84445762,
    104.27088480, 108.72982416, 113.22024112, 117.74116515, 122.29168392,
    126.87093829, 131.47811772, 136.11245629, 140.77322911, 145.45974907,
    150.17136399, 154.90745399, 159.66742919, 164.45072752, 169.25681285,
    174.08517319, 178.93531914, 183.80678238], np.float32)


# device -> _LOG_PARTITION_TABLE on it: copied once, so that scoring a
# partition on the card copies nothing from the host (and can be captured
# into a CUDA graph)
_LOG_PARTITION_TABLES = {}


def le_log_partition_function(model, sample_size):
    """log Z(n): the table for n < 48, the asymptotic
    n log n (1 + 0.28269584 n^-0.75) above."""
    dev = model.dataset_size.device
    n = _f32(sample_size, dev)
    table = _LOG_PARTITION_TABLES.get(dev)
    if table is None:
        table = _LOG_PARTITION_TABLES[dev] = torch.from_numpy(
            _LOG_PARTITION_TABLE).to(dev)
    idx = torch.clamp(torch.as_tensor(sample_size, device=dev).to(
        torch.int64), 0, 47)
    # take, not table[idx]: a 0-dim index tensor would be read back to the
    # host
    exact = torch.take(table, idx)
    coeff = 0.28269584
    n1 = torch.clamp(n, min=1.0)
    log_z_max = n * torch.log(n1)
    approx = log_z_max * (1.0 + coeff * torch.pow(n1, -0.75))
    return torch.where(n < 48, exact, approx)


def _le_postpred_correction(model, sample_size):
    """log(N / n) (0.45 - 0.1 / n - 0.1 / N).

    The reference's two flavors disagree here: its C++ production flavor
    divides in float (it takes sample_size as a float, so `scale =
    dataset_size / sample_size` is a float division) while its py2 debug
    flavor floors (int / int), a difference its own suite masks with a
    0.5-loosened LowEntropy tolerance.  This follows the production C++
    semantics, as the JAX package does; the golden fixtures
    (tests/golden/) pin that choice against the reference C++ itself."""
    dev = model.dataset_size.device
    n = _f32(sample_size, dev)
    N = model.dataset_size.to(torch.float32)
    exponent = 0.45 - 0.1 / n - 0.1 / N
    return torch.log(N / n) * exponent


def _le_dataprob_correction(model, sample_size):
    dev = model.dataset_size.device
    n = torch.log(_f32(sample_size, dev))
    N = torch.log(model.dataset_size.to(torch.float32))
    return 0.061 * n * (n - N) * torch.pow(n + N, 0.75)


def le_score_counts(model, counts):
    """Log prob of a partition given its counts [..., K]."""
    counts = torch.as_tensor(counts).to(torch.float32)
    sample_size = counts.sum(-1)
    zero = torch.zeros((), dtype=torch.float32, device=counts.device)
    score = torch.where(counts > 1,
                        counts * torch.log(torch.clamp(counts, min=1.0)),
                        zero).sum(-1)
    partial = sample_size != model.dataset_size.to(torch.float32)
    num_groups = float(counts.shape[-1])
    correction = (_le_postpred_correction(model, sample_size)
                  * (num_groups - 1.0)
                  + _le_dataprob_correction(model, sample_size))
    score = score + torch.where(partial, correction, zero)
    return score - le_log_partition_function(model, sample_size)


def le_score_add_value(model, group_size, nonempty_group_count, sample_size,
                       empty_group_count=1):
    """Seating scores of the low-entropy prior, batched over
    `group_size` (0: a new group, shared by `empty_group_count` empty
    slots)."""
    dev = model.dataset_size.device
    group_size = _f32(group_size, dev)
    n = _f32(sample_size, dev)
    e = _f32(empty_group_count, dev)
    N = model.dataset_size.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    empty_score = -torch.log(e) + torch.where(
        n + 1.0 < N, _le_postpred_correction(model, n + 1.0), zero)
    bigger = 1.0 + group_size
    very_large = 10000.0
    occupied_score = torch.where(
        group_size > very_large,
        1.0 + torch.log(bigger),
        torch.log(bigger / torch.clamp(group_size, min=1.0)) * group_size
        + torch.log(bigger))
    return torch.where(group_size == 0, empty_score, occupied_score)


def le_score_remove_value(model, group_size, nonempty_group_count,
                          sample_size, empty_group_count=1):
    dev = model.dataset_size.device
    return -le_score_add_value(model, _f32(group_size, dev) - 1.0,
                               nonempty_group_count, sample_size,
                               empty_group_count)


def le_score_value(model, counts, alive, sample_size,
                   scores_dtype=torch.float32):
    """Per-slot seating scores [K] of the low-entropy prior over a
    fixed-capacity counts vector; dead slots score -inf, and the empty
    slots share the new-group score."""
    counts = torch.as_tensor(counts).to(torch.float32)
    alive = torch.as_tensor(alive).to(torch.bool)
    is_empty = alive & (counts == 0)
    empty_count = torch.clamp(is_empty.sum(-1).to(torch.float32), min=1.0)
    scores = le_score_add_value(model, counts, 0.0, sample_size,
                                empty_count[..., None])
    neg_inf = torch.full((), float('-inf'), device=counts.device)
    return torch.where(alive, scores, neg_inf).to(scores_dtype)


def _le_seating(model, counts, alive, sample_size, R, generator):
    """Slots (a host int64 array) for R rows seated one after another by
    the low-entropy prior on top of `counts` / `alive`, as
    `mixture.add_value` would seat them: row i by `le_score_value` of the
    counts before it, a taken empty slot bringing the first dead slot
    alive.  A loop on the host (CPU tensors, a CPU generator seeded from
    `generator`)."""
    host = type(model)(*(x.cpu() for x in model))
    gen = device_generator(draw_seed(generator), 'cpu')
    counts = torch.as_tensor(counts).cpu().clone()
    alive = torch.as_tensor(alive).cpu().clone()
    n = int(sample_size)
    slots = np.zeros(R, np.int64)
    for i in range(R):
        k = int(sample_from_scores(gen, le_score_value(host, counts, alive,
                                                       n + i)))
        if counts[k] == 0:
            alive[torch.argmin(alive.to(torch.int8))] = True
        counts[k] += 1
        slots[i] = k
    return slots


def le_sample_assignments(generator, model, sample_size, capacity=64,
                          device=None):
    """Sequential low-entropy assignments [sample_size] int32: row i
    joins an occupied slot or the first empty one (the one empty slot
    that competes) by `le_score_value` of the counts before it.  Seated
    on the host by `_le_seating` from empty counts, meant for a few
    hundred rows; the result goes to `device` (default: the model's)."""
    alive = torch.zeros(capacity, dtype=torch.bool)
    alive[0] = True
    slots = _le_seating(model, torch.zeros(capacity, dtype=torch.int32),
                        alive, 0, int(sample_size), generator)
    dev = model.dataset_size.device if device is None else torch.device(
        device)
    return torch.from_numpy(slots.astype(np.int32)).to(dev)


# ===========================================================================
# dispatch over both priors

def score_value(model, counts, alive, sample_size,
                scores_dtype=torch.float32):
    if isinstance(model, PitmanYor):
        return py_score_value(model, counts, alive, sample_size,
                              scores_dtype)
    return le_score_value(model, counts, alive, sample_size, scores_dtype)


def score_counts(model, counts):
    if isinstance(model, PitmanYor):
        return py_score_counts(model, counts)
    return le_score_counts(model, counts)


def score_add_value(model, group_size, nonempty_group_count, sample_size,
                    empty_group_count=1):
    fn = (py_score_add_value if isinstance(model, PitmanYor)
          else le_score_add_value)
    return fn(model, group_size, nonempty_group_count, sample_size,
              empty_group_count)


def score_remove_value(model, group_size, nonempty_group_count, sample_size,
                       empty_group_count=1):
    fn = (py_score_remove_value if isinstance(model, PitmanYor)
          else le_score_remove_value)
    return fn(model, group_size, nonempty_group_count, sample_size,
              empty_group_count)


def sample_assignments(generator, model, size, capacity=None, device=None):
    if isinstance(model, PitmanYor):
        return py_sample_assignments(generator, model, size, capacity,
                                     device)
    return le_sample_assignments(generator, model, size, capacity or 64,
                                 device)


def count_assignments(assignments, capacity):
    """counts[k] = #{i : assignments[i] == k} as int32; out-of-range ids
    are dropped."""
    a = torch.as_tensor(assignments).to(torch.int64)
    a = a[(a >= 0) & (a < capacity)]
    return torch.bincount(a, minlength=capacity).to(torch.int32)
