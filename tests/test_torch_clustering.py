"""The port's Pitman-Yor scoring against distributions_tpu.clustering."""

import numpy as np
import pytest
import torch

from distributions_tpu import clustering as jcl
from distributions_tpu_torch import config
from distributions_tpu_torch import clustering as tcl

torch.set_num_threads(1)
config.set_default_device('cpu')

# rtol 1e-5: lgamma and log differ by ulps between torch and XLA
RTOL, ATOL = 1e-5, 1e-5


def _counts(seed, K=64):
    rng = np.random.RandomState(seed)
    counts = rng.poisson(3.0, K).astype(np.int32)
    counts[rng.rand(K) < 0.3] = 0
    alive = counts > 0
    alive[np.flatnonzero(counts == 0)[:2]] = True   # two alive empties
    return counts, alive


@pytest.mark.parametrize('example', range(len(jcl.PitmanYor.EXAMPLES)))
def test_score_value(example):
    raw = jcl.PitmanYor.EXAMPLES[example]
    counts, alive = _counts(example)
    n = int(counts.sum())
    want = np.asarray(jcl.score_value(jcl.PitmanYor.from_dict(raw), counts,
                                      alive, n))
    got = tcl.score_value(tcl.PitmanYor.from_dict(raw),
                          torch.from_numpy(counts), torch.from_numpy(alive),
                          torch.tensor(n, dtype=torch.int32)).numpy()
    # dead slots are -inf at exactly the same positions
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_array_equal(np.isneginf(got), ~alive)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('example', range(len(jcl.PitmanYor.EXAMPLES)))
def test_score_counts(example):
    raw = jcl.PitmanYor.EXAMPLES[example]
    counts, _ = _counts(example + 10)
    batch = np.stack([counts, np.roll(counts, 3), np.zeros_like(counts)])
    batch[2, 0] = 1
    want = np.asarray(jcl.score_counts(jcl.PitmanYor.from_dict(raw), batch))
    got = tcl.score_counts(tcl.PitmanYor.from_dict(raw),
                           torch.from_numpy(batch)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_count_assignments():
    rng = np.random.RandomState(3)
    a = rng.randint(0, 40, 500).astype(np.int32)
    want = np.asarray(jcl.count_assignments(a, 48))
    got = tcl.count_assignments(torch.from_numpy(a), 48)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_low_entropy_not_ported():
    """The low-entropy prior, once refused by every scorer, is ported:
    `score_value` and `score_counts` dispatch to it and equal the JAX
    functions (tests/test_torch_le_clustering.py holds the rest)."""
    for raw in jcl.LowEntropy.EXAMPLES:
        counts, alive = _counts(len(raw))
        n = int(counts.sum())
        jmodel = jcl.LowEntropy.from_dict(raw)
        tmodel = tcl.LowEntropy.from_dict(raw)
        want = np.asarray(jcl.score_value(jmodel, counts, alive, n))
        got = tcl.score_value(tmodel, torch.from_numpy(counts),
                              torch.from_numpy(alive), n).numpy()
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(
            tcl.score_counts(tmodel, torch.from_numpy(counts)).numpy(),
            np.asarray(jcl.score_counts(jmodel, counts)), rtol=RTOL,
            atol=ATOL)
