"""The port's split-merge moves (distributions_tpu_torch.ops.splitmerge):
the per-row score against the JAX function, and the moves by exact
enumeration of a tiny posterior, as tests/test_splitmerge.py checks the
JAX moves (the enumeration and the chain harness are
tests/test_torch_moves.py's)."""

import jax
import numpy as np
import pytest
import torch

from distributions_tpu.ops import splitmerge as jsm
from distributions_tpu_torch import clustering as tcl, config
from distributions_tpu_torch import mixture as tmx
from distributions_tpu_torch.models import nich
from distributions_tpu_torch.ops import gibbs as tg, splitmerge as sm
from tests.test_torch_moves import (KINDS, PY, SHAREDS, SPEC, VALUES,
                                    _problem, run_chain, total_variation)

torch.set_num_threads(1)
config.set_default_device('cpu')


@pytest.mark.parametrize('kind', KINDS)
def test_row_score_matches_jax(kind):
    """`_row_score` of a row against one slot's groups, and against a
    batch of groups at once (the port's allocation scores its four sides
    in one call), equals the JAX function."""
    q = _problem(kind)
    jrow_score = jax.jit(lambda groups, row: jsm._row_score(
        q['jspec'], q['jsh'], groups, row))
    for slot, i in ((0, 3), (1, 10), (2, 40)):
        jgroups = tuple(type(g)(*(leaf[slot] for leaf in g))
                        for g in q['jst'].groups)
        want = float(jrow_score(jgroups, tuple(v[i] for v in q['jv'])))
        groups = tuple(type(g)(*(leaf[slot] for leaf in g))
                       for g in q['st'].groups)
        got = sm._row_score(q['spec'], q['sh'], groups,
                            tuple(v[i] for v in q['tv']))
        # the models' predictive scores: tests/test_torch_models.py's atol
        np.testing.assert_allclose(float(got), want, rtol=1e-5, atol=1e-4)
        batch = tuple(type(g)(*(leaf[:4] for leaf in g))
                      for g in q['st'].groups)
        many = sm._row_score(q['spec'], q['sh'], batch,
                             tuple(v[i] for v in q['tv']))
        assert many.shape == (4,)
        np.testing.assert_allclose(float(many[slot]), want, rtol=1e-5,
                                   atol=1e-4)


def test_composite_chain_stationary():
    """A sequential sweep then a split-merge move a step: 1900 unthinned
    steps against tests/test_splitmerge.py's bound (as
    tests/test_torch_moves.py's sequential chain)."""
    def step(st, an, g):
        st, an = tg.sweep_sequential(SPEC, PY, SHAREDS, st, VALUES, an, g)
        return sm.split_merge_move(SPEC, PY, SHAREDS, st, VALUES, an, g)[:2]
    tv = total_variation(run_chain(step, 2000), 100, 1)
    assert tv < 0.05, tv


def test_splitmerge_only_chain_stationary():
    """Split-merge alone is a valid (slow) chain on the partitions:
    tests/test_splitmerge.py's bound 0.12 over 4000 moves (20000 there)
    thinned by 2 (a move without the proposal correction gives a TV above
    0.5)."""
    accepted = []

    def step(st, an, g):
        st, an, acc = sm.split_merge_move(SPEC, PY, SHAREDS, st, VALUES, an,
                                          g)
        accepted.append(acc)
        return st, an
    trace = run_chain(step, 4000, seed=1)
    assert np.mean(accepted) > 0.02
    tv = total_variation(trace, 400, 2)
    assert tv < 0.12, tv


def test_restricted_composite_chain_stationary():
    """As test_composite_chain_stationary, with the restricted move."""
    def step(st, an, g):
        st, an = tg.sweep_sequential(SPEC, PY, SHAREDS, st, VALUES, an, g)
        return sm.split_merge_restricted(SPEC, PY, SHAREDS, st, VALUES, an,
                                         g)[:2]
    tv = total_variation(run_chain(step, 2000, seed=3), 100, 1)
    assert tv < 0.05, tv


def _two_modes(Rn):
    rng = np.random.RandomState(0)
    spec = tmx.make_spec([(nich, 1)], capacity=8, empties=1)
    sh = (nich.shared_from_dict({'mu': 0., 'kappa': 0.05, 'sigmasq': 0.5,
                                 'nu': 1.}),)
    labels = np.array([0] * (Rn // 2) + [1] * (Rn // 2))
    X = np.where(labels == 0, -3.0, 3.0)[:, None] + 0.2 * rng.randn(Rn, 1)
    values = (torch.from_numpy(X.astype(np.float32)),)
    cl = tcl.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.0})
    an = torch.zeros(Rn, dtype=torch.int32)
    return (spec, cl, sh, tmx.state_from_assignments(spec, cl, sh, values,
                                                     an), values, an, labels)


def _purity(an, labels):
    a = an.numpy()
    return sum(np.bincount(labels[a == k]).max()
               for k in np.unique(a)) / len(a)


def test_splitmerge_jumps_merged_modes():
    spec, cl, sh, st, values, an, labels = _two_modes(8)
    gen = torch.Generator().manual_seed(2)
    for _ in range(500):
        st, an, _ = sm.split_merge_move(spec, cl, sh, st, values, an, gen)
        if int((st.counts > 0).sum()) >= 2:
            break
    assert int((st.counts > 0).sum()) >= 2, 'no split accepted'
    for _ in range(10):
        st, an = tg.sweep_sequential(spec, cl, sh, st, values, an, gen)
    assert _purity(an, labels) > 0.9


def test_restricted_splits_large_cluster():
    """32 rows in two tight modes, started as one cluster: proposals that
    follow the data split it within a few moves, where a random split of
    32 rows almost never aligns.  The first accepted split's purity varies
    with the stream (the JAX function's reaches 0.75-1.0 over 12 keys), so
    the mean over 10 independent starts is held above 0.85."""
    purities = []
    for seed in range(10):
        spec, cl, sh, st, values, an, labels = _two_modes(32)
        gen = torch.Generator().manual_seed(seed)
        for _ in range(30):
            st, an, _ = sm.split_merge_restricted(spec, cl, sh, st, values,
                                                  an, gen)
            if int((st.counts > 0).sum()) >= 2:
                break
        assert int((st.counts > 0).sum()) >= 2, 'no restricted split'
        fresh = tmx.state_from_assignments(spec, cl, sh, values, an)
        assert torch.equal(st.counts, fresh.counts)
        purities.append(_purity(an, labels))
    assert np.mean(purities) > 0.85, purities


def test_restricted_refuses_low_entropy():
    le = tcl.LowEntropy.from_dict({'dataset_size': 4})
    an = torch.zeros(4, dtype=torch.int32)
    st = tmx.state_from_assignments(SPEC, le, SHAREDS, VALUES, an)
    with pytest.raises(ValueError, match='Pitman-Yor'):
        sm.split_merge_restricted(SPEC, le, SHAREDS, st, VALUES, an,
                                  torch.Generator())
    # the simple move scores with score_data and takes either prior
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        st, an, _ = sm.split_merge_move(SPEC, le, SHAREDS, st, VALUES, an,
                                        gen)
    fresh = tmx.state_from_assignments(SPEC, le, SHAREDS, VALUES, an)
    assert torch.equal(st.counts, fresh.counts)
