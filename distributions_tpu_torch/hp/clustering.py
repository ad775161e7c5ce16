"""hp clustering priors: independent double-precision implementations of
Pitman-Yor and Low-Entropy (role of reference distributions/lp/clustering
next to dbg; semantics of reference dbg/clustering.py:33-302).

Deliberately different algorithms than the JAX core where the math allows:

- `PitmanYor.score_counts` seats customers ONE AT A TIME through
  `score_add_value` (the reference C++'s incremental accumulation,
  src/clustering.cc:152-183) instead of the core's closed-form lgamma
  sums — so flavor agreement checks the closed form against the product
  of transition probabilities.
- `LowEntropy.log_partition_function` computes the EXACT partition sum
  for n < 48 by dynamic programming over integer partitions (weight
  n!/prod_s (s!)^m_s m_s! * prod_s s^(s m_s)) instead of trusting a
  table — so flavor agreement re-derives the core's
  `_LOG_PARTITION_TABLE` from scratch at import time.

No jax imports allowed in this package.
"""

import functools

import numpy as np

from distributions_tpu_torch.hp.special import gammaln, logsumexp
from distributions_tpu_torch.hp.random import sample_from_scores


def count_assignments(assignments, capacity=None):
    assignments = [int(a) for a in assignments]
    capacity = capacity if capacity is not None \
        else (max(assignments) + 1 if assignments else 0)
    counts = np.zeros(capacity, np.int64)
    for a in assignments:
        counts[a] += 1
    return counts


class PitmanYor(object):
    """Pitman-Yor process {alpha, d}; d=0 is the CRP."""

    EXAMPLES = [
        {'alpha': 1., 'd': 0.},
        {'alpha': 1., 'd': 0.1},
        {'alpha': 1., 'd': 0.9},
        {'alpha': 10., 'd': 0.1},
        {'alpha': 0.1, 'd': 0.1},
    ]

    def __init__(self, alpha, d):
        self.alpha = float(alpha)
        self.d = float(d)

    @classmethod
    def from_dict(cls, raw):
        return cls(alpha=raw['alpha'], d=raw['d'])

    def to_dict(self):
        return {'alpha': self.alpha, 'd': self.d}

    def score_add_value(self, group_size, nonempty_group_count, sample_size,
                        empty_group_count=1):
        """Log prob of seating the (sample_size+1)-th customer at a table
        with group_size occupants (reference clustering.hpp:81-104)."""
        denom = sample_size + self.alpha
        if group_size == 0:
            return float(np.log(
                (self.alpha + self.d * nonempty_group_count)
                / (denom * empty_group_count)))
        return float(np.log((group_size - self.d) / denom))

    def score_remove_value(self, group_size, nonempty_group_count,
                           sample_size, empty_group_count=1):
        group_size -= 1
        if group_size == 0:
            nonempty_group_count -= 1
        return -self.score_add_value(group_size, nonempty_group_count,
                                     sample_size - 1, empty_group_count)

    def score_counts(self, counts):
        """Seat every customer sequentially and accumulate transition
        log-probs — the reference C++ algorithm (src/clustering.cc:152-183),
        structurally different from the core's closed-form lgamma sums."""
        score = 0.0
        n = 0
        nonempty = 0
        for c in counts:
            c = int(c)
            if c == 0:
                continue
            score += self.score_add_value(0, nonempty, n)
            n += 1
            for size in range(1, c):
                score += self.score_add_value(size, nonempty + 1, n)
                n += 1
            nonempty += 1
        return score

    def sample_assignments(self, rng, size):
        """Sequential CRP/PY draw (reference src/clustering.cc:69-142)."""
        assignments = []
        counts = []
        for i in range(size):
            scores = [self.score_add_value(c, len(counts), i)
                      for c in counts]
            scores.append(self.score_add_value(0, len(counts), i))
            k = sample_from_scores(rng, np.asarray(scores))
            if k == len(counts):
                counts.append(1)
            else:
                counts[k] += 1
            assignments.append(k)
        return assignments


@functools.lru_cache(maxsize=None)
def _integer_partitions(n, max_part):
    """All integer partitions of n with parts <= max_part, as tuples."""
    if n == 0:
        return ((),)
    out = []
    for first in range(min(n, max_part), 0, -1):
        for rest in _integer_partitions(n - first, first):
            out.append((first,) + rest)
    return tuple(out)


def exact_log_partition_function(n):
    """log sum over set partitions of n items of prod_k c_k^c_k, computed
    exactly by DP over integer partitions: a set partition with part-size
    multiset {s^m_s} occurs n! / (prod_s (s!)^m_s m_s!) times and carries
    weight prod_s s^(s m_s)."""
    if n <= 1:
        return 0.0
    terms = []
    for parts in _integer_partitions(n, n):
        mult = {}
        for s in parts:
            mult[s] = mult.get(s, 0) + 1
        log_count = float(gammaln(n + 1))
        log_weight = 0.0
        for s, m in mult.items():
            log_count -= m * float(gammaln(s + 1)) + float(gammaln(m + 1))
            log_weight += s * m * np.log(s)
        terms.append(log_count + log_weight)
    return float(logsumexp(np.asarray(terms)))


class LowEntropy(object):
    """Parameter-free MDL clustering prior P(X) ∝ exp(-N H(X))
    (reference dbg/clustering.py:33-302)."""

    EXAMPLES = [
        {'dataset_size': 5},
        {'dataset_size': 1000},
    ]

    #: exact-table size matching the reference (src/clustering.cc:202)
    EXACT_MAX = 48
    #: asymptotic coefficient derived in reference derivations/clustering.py
    APPROX_COEFF = 0.28269584

    def __init__(self, dataset_size):
        self.dataset_size = int(dataset_size)

    @classmethod
    def from_dict(cls, raw):
        return cls(dataset_size=raw['dataset_size'])

    def to_dict(self):
        return {'dataset_size': self.dataset_size}

    def log_partition_function(self, sample_size):
        n = int(sample_size)
        if n < self.EXACT_MAX:
            return exact_log_partition_function(n)
        log_z_max = n * np.log(n)
        return float(log_z_max * (1.0 + self.APPROX_COEFF * n ** -0.75))

    def _postpred_correction(self, sample_size):
        """reference dbg/clustering.py:273-284 with the production C++'s
        float division (see core clustering._le_postpred_correction)."""
        n = float(sample_size)
        N = float(self.dataset_size)
        exponent = 0.45 - 0.1 / n - 0.1 / N
        return np.log(N / n) * exponent

    def _dataprob_correction(self, sample_size):
        """reference dbg/clustering.py:286-294."""
        n = np.log(float(sample_size))
        N = np.log(float(self.dataset_size))
        return 0.061 * n * (n - N) * (n + N) ** 0.75

    def score_counts(self, counts):
        counts = [int(c) for c in counts]
        sample_size = sum(counts)
        score = sum(c * np.log(c) for c in counts if c > 1)
        if sample_size != self.dataset_size:
            score += self._postpred_correction(sample_size) \
                * (len(counts) - 1) \
                + self._dataprob_correction(sample_size)
        return float(score - self.log_partition_function(sample_size))

    def score_add_value(self, group_size, nonempty_group_count, sample_size,
                        empty_group_count=1):
        """reference dbg/clustering.py:170-210."""
        if group_size == 0:
            score = -np.log(float(empty_group_count))
            if sample_size + 1 < self.dataset_size:
                score += self._postpred_correction(sample_size + 1)
            return float(score)
        bigger = 1.0 + group_size
        if group_size > 10000:
            return float(1.0 + np.log(bigger))
        return float(np.log(bigger / group_size) * group_size
                     + np.log(bigger))

    def score_remove_value(self, group_size, nonempty_group_count,
                           sample_size, empty_group_count=1):
        return -self.score_add_value(group_size - 1, nonempty_group_count,
                                     sample_size, empty_group_count)

    def sample_assignments(self, rng, sample_size):
        """Sequential draw (reference dbg/clustering.py:111-143)."""
        assignments = []
        counts = []
        for i in range(sample_size):
            scores = [self.score_add_value(c, len(counts), i)
                      for c in counts]
            scores.append(self.score_add_value(0, len(counts), i))
            k = sample_from_scores(rng, np.asarray(scores))
            if k == len(counts):
                counts.append(1)
            else:
                counts[k] += 1
            assignments.append(k)
        return assignments
