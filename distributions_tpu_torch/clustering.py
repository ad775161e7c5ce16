"""Clustering priors, scoring half: the Pitman-Yor (CRP) prior of
distributions_tpu.clustering.

The low-entropy prior is not ported yet (ROADMAP Queue 1 item 3): its
container exists so that specs naming it convert, and every scorer raises
`NotImplementedError` on it.
"""

from typing import NamedTuple

import torch

from distributions_tpu_torch.config import resolve_device
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
    """Parameter-free MDL clustering prior; scoring is not ported yet."""
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


def _low_entropy_not_ported():
    return NotImplementedError(
        'LowEntropy scoring is not ported yet (ROADMAP Queue 1 item 3)')


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
    the empty-slot mass is split as the unsharded scorer splits it."""
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


def score_value(model, counts, alive, sample_size,
                scores_dtype=torch.float32):
    if isinstance(model, PitmanYor):
        return py_score_value(model, counts, alive, sample_size,
                              scores_dtype)
    raise _low_entropy_not_ported()


def score_counts(model, counts):
    if isinstance(model, PitmanYor):
        return py_score_counts(model, counts)
    raise _low_entropy_not_ported()


def count_assignments(assignments, capacity):
    """counts[k] = #{i : assignments[i] == k} as int32; out-of-range ids
    are dropped."""
    a = torch.as_tensor(assignments).to(torch.int64)
    a = a[(a >= 0) & (a < capacity)]
    return torch.bincount(a, minlength=capacity).to(torch.int32)
