"""The port's bb, dd, dpd, gp, bnb and niw models against
distributions_tpu.models on each model's EXAMPLES, and against the float64
oracle distributions_tpu.hp.models (which imports no JAX; only this test
imports it, never the port)."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributions_tpu import clustering as jcl, mixture as jmx
from distributions_tpu.hp.models import MODULES as HP
from distributions_tpu_torch import config, convert, testing
from distributions_tpu_torch.models import MODULES

torch.set_num_threads(1)
config.set_default_device('cpu')

# rtol 1e-5 / atol 1e-4: the same f32 formulas, with lgamma, log and log1p
# differing by ulps between torch and XLA; niw adds a Cholesky factor and
# a log-determinant computed by different routines
RTOL, ATOL = 1e-5, 1e-4

NAMES = ('bb', 'dd', 'dpd', 'gp', 'bnb', 'niw')
JAX = {name: importlib.import_module('distributions_tpu.models.' + name)
       for name in NAMES}
CASES = [(name, i) for name in NAMES for i in range(len(JAX[name].EXAMPLES))]
cases = pytest.mark.parametrize(
    'name,idx', CASES, ids=['%s-%d' % c for c in CASES])
K = 4


def _kwargs(name):
    return {'cap': 16} if name == 'dpd' else {}


@functools.lru_cache(maxsize=None)
def _load(name, idx):
    """Example values, and in both packages the Shared and a [K] batch of
    groups over the values (slot 3 empty)."""
    jm, tm = JAX[name], MODULES[name]
    ex = jm.EXAMPLES[idx]
    values = np.asarray(ex['values'])
    if values.dtype == np.float64:
        values = values.astype(np.float32)
    ids = np.arange(len(values), dtype=np.int32) % 3
    jsh = jm.shared_from_dict(ex['shared'], **_kwargs(name))
    tsh = tm.shared_from_dict(ex['shared'], **_kwargs(name))
    jg = jm.from_values_grouped(jsh, jnp.asarray(values), jnp.asarray(ids), K)
    tg = tm.Group(*(convert.tensor(np.asarray(x)) for x in jg))
    return values, ids, jsh, jg, tsh, tg


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               rtol=rtol, atol=atol)


@cases
def test_shared_round_trip(name, idx):
    _, _, jsh, _, tsh, _ = _load(name, idx)
    for got, want in zip(tsh, jsh):
        assert got.dtype == convert.tensor(np.asarray(want)).dtype
        _close(got, want, rtol=0, atol=0)
    got = MODULES[name].shared_to_dict(tsh)
    want = JAX[name].shared_to_dict(jsh)
    assert sorted(got) == sorted(want)
    for k in got:
        if isinstance(got[k], dict):
            assert got[k] == want[k]
        else:
            np.testing.assert_allclose(got[k], want[k])


@cases
def test_from_values_grouped(name, idx):
    values, ids, _, jg, tsh, _ = _load(name, idx)
    got = MODULES[name].from_values_grouped(
        tsh, torch.from_numpy(values), torch.from_numpy(ids), K)
    for g, w in zip(got, jg):
        assert g.dtype == convert.tensor(np.asarray(w)).dtype
        _close(g, w, atol=1e-5)


@cases
def test_score_value(name, idx):
    values, _, jsh, jg, tsh, tg = _load(name, idx)
    want = jax.vmap(lambda v: jax.vmap(
        lambda g: JAX[name].score_value(jsh, g, v))(jg))(jnp.asarray(values))
    for v, w in zip(values, want):
        _close(MODULES[name].score_value(tsh, tg, torch.as_tensor(v)), w)


@cases
def test_score_value_batch(name, idx):
    values, _, jsh, jg, tsh, tg = _load(name, idx)
    got = MODULES[name].score_value_batch(tsh, tg, torch.from_numpy(values))
    assert got.shape == (len(values), K)
    _close(got, JAX[name].score_value_batch(jsh, jg, jnp.asarray(values)))


@cases
def test_score_data(name, idx):
    _, _, jsh, jg, tsh, tg = _load(name, idx)
    _close(MODULES[name].score_data(tsh, tg), JAX[name].score_data(jsh, jg))


@cases
def test_merge_unmerge_round_trip(name, idx):
    values, _, jsh, jg, tsh, tg = _load(name, idx)
    tm = MODULES[name]
    ids = (np.arange(len(values), dtype=np.int32) * 2 + 1) % K
    tsrc = tm.from_values_grouped(tsh, torch.from_numpy(values),
                                  torch.from_numpy(ids), K)
    jsrc = JAX[name].from_values_grouped(jsh, jnp.asarray(values),
                                         jnp.asarray(ids), K)
    merged = tm.merge(tsh, tg, tsrc)
    for got, want in zip(merged, JAX[name].merge(jsh, jg, jsrc)):
        _close(got, want, atol=1e-5)
    for got, want in zip(tm.unmerge(tsh, merged, tsrc), tg):
        assert got.dtype == want.dtype
        # integer leaves come back exactly, float sums to f32 rounding
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-4)


@cases
def test_row_stat_columns_to_tile(name, idx):
    """Segment sums of row_stat_columns, through row_stats_to_tile, are
    from_values_grouped: the identity the fused sweeps rest on."""
    values, ids, jsh, jg, tsh, _ = _load(name, idx)
    tm = MODULES[name]
    cols = tm.row_stat_columns(tsh, torch.from_numpy(values))
    _close(cols, JAX[name].row_stat_columns(jsh, jnp.asarray(values)),
           atol=1e-5)
    dim = tm.row_stat_dim(tsh) if hasattr(tm, 'row_stat_dim') \
        else tm.ROW_STAT_DIM
    assert cols.shape == (len(values), dim)
    onehot = torch.from_numpy(ids)[None, :] == torch.arange(K)[:, None]
    tile = tm.row_stats_to_tile(tsh, onehot.to(torch.float32) @ cols)
    to_group = getattr(tm, 'tile_to_group', None)
    group = tile if to_group is None else to_group(tsh, tile)
    for got, want in zip(group, jg):
        assert got.dtype == convert.tensor(np.asarray(want)).dtype
        _close(got, want, atol=1e-5)


DEBT_CASES = [c for c in CASES if c[0] != 'niw']


@pytest.mark.parametrize('name,idx', DEBT_CASES,
                         ids=['%s-%d' % c for c in DEBT_CASES])
def test_data_debt(name, idx):
    """Signed counts: removing values never added leaves a group in debt,
    and adding them back restores the empty group exactly (the debt case
    of tests/test_hp_models.py, on whole tiles)."""
    values, ids, _, _, tsh, _ = _load(name, idx)
    tm = MODULES[name]
    tile = tm.from_values_grouped(tsh, torch.from_numpy(values),
                                  torch.from_numpy(ids), K)
    empty = tm.group_init(tsh, (K,))
    debt = tm.unmerge(tsh, empty, tile)
    assert any(bool((leaf < 0).any()) for leaf in debt
               if not leaf.dtype.is_floating_point)
    for got, want in zip(tm.merge(tsh, debt, tile), empty):
        assert torch.equal(got, want)


# dpd's second example has no sticks yet: the oracle would break them
# with its own random numbers
HP_CASES = [c for c in CASES if c != ('dpd', 1)]


@pytest.mark.parametrize('name,idx', HP_CASES,
                         ids=['%s-%d' % c for c in HP_CASES])
def test_against_float64_oracle(name, idx):
    """score_value and score_data of one group holding all the example's
    values, against the independent float64 implementation."""
    hp = HP[name]
    tm = MODULES[name]
    ex = hp.EXAMPLES[idx]
    hshared = hp.shared_from_dict(ex['shared'])
    hgroup = hp.group_init(hshared)
    for v in ex['values']:
        hgroup = hp.add_value(hshared, hgroup, v)
    values = np.asarray(ex['values'])
    if values.dtype == np.float64:
        values = values.astype(np.float32)
    tsh = tm.shared_from_dict(ex['shared'], **_kwargs(name))
    tg = tm.from_values_grouped(tsh, torch.from_numpy(values),
                                torch.zeros(len(values), dtype=torch.int32),
                                1)
    # f32 against f64: lgamma differences of magnitude up to ~30
    np.testing.assert_allclose(
        float(tm.score_data(tsh, tg)[0]), hp.score_data(hshared, hgroup),
        rtol=2e-5, atol=1e-4)
    for v in ex['values']:
        np.testing.assert_allclose(
            float(tm.score_value(tsh, tg, torch.as_tensor(
                np.asarray(v, values.dtype)))[0]),
            hp.score_value(hshared, hgroup, v), rtol=2e-5, atol=1e-4)


def test_dpd_value_to_slot_and_unknown_values():
    tm, jm = MODULES['dpd'], JAX['dpd']
    raw = jm.EXAMPLES[0]['shared']
    tsh = tm.shared_from_dict(raw, cap=8)
    jsh = jm.shared_from_dict(raw, cap=8)
    probe = np.array([0, 7, 8, 3, -1], np.int32)
    np.testing.assert_array_equal(
        tm.value_to_slot(tsh, torch.from_numpy(probe)).numpy(),
        np.asarray(jm.value_to_slot(jsh, probe)))
    assert tm.capacity(tsh) == 8 and tm.row_stat_dim(tsh) == 9
    np.testing.assert_array_equal(tm.active_mask(tsh).numpy(),
                                  np.asarray(jm.active_mask(jsh)))
    group = tm.group_init(tsh, (2,))
    jgroup = jm.group_init(jsh, (2,))
    # OTHER scores the unbroken mass; an unknown value scores -inf
    _close(tm.score_value_batch(tsh, group, torch.from_numpy(probe)),
           jm.score_value_batch(jsh, jgroup, probe))
    with pytest.raises(ValueError, match='capacity'):
        tm.shared_from_dict(raw, cap=3)


@pytest.mark.parametrize('fn', ['shared_add_value', 'shared_remove_value',
                                'shared_realize'])
def test_dpd_shared_mutation_waits_for_the_samplers(fn):
    """The Shared's mutations, once waiting for the beta sampler, now run:
    each equals the JAX function wherever no beta is drawn (a known value
    added or removed), and a drawn stick conserves the mass beta0 + sum
    of betas = 1."""
    tm, jm = MODULES['dpd'], JAX['dpd']
    raw = {'gamma': 1.0, 'alpha': 1.0, 'betas': {0: 0.25, 7: 0.5},
           'counts': {0: 1, 7: 2}}
    tsh = tm.shared_from_dict(raw, cap=8)
    jsh = jm.shared_from_dict(raw, cap=8)
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)

    def same(t, j):
        for a, b in zip(t, j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)

    if fn == 'shared_add_value':
        same(tm.shared_add_value(gen, tsh, 7),
             jm.shared_add_value(key, jsh, 7))
        new = tm.shared_add_value(gen, tsh, 3)
        assert int(tm.value_to_slot(new, 3)) == 2
        assert int(new.counts[2]) == 1 and 0 < float(new.betas[2]) < 0.25
        np.testing.assert_allclose(
            float(new.beta0) + float(new.betas.sum()), 1.0, rtol=1e-6)
    elif fn == 'shared_remove_value':
        for v in (7, 0):
            same(tm.shared_remove_value(gen, tsh, v),
                 jm.shared_remove_value(key, jsh, v))
    else:
        real = tm.shared_realize(gen, tsh)
        assert float(real.beta0) == 0.0
        np.testing.assert_allclose(float(real.betas.sum()), 1.0, rtol=1e-5)
        assert int(tm.active_mask(real).sum()) > 2


@pytest.mark.parametrize('kind', ['niw3_nich_bb', 'dpd_nich', 'bbddgp',
                                  'bnb'])
def test_convert_mixed_state_round_trip(kind):
    """convert carries specs, shareds and states of every model across
    with their dtypes, and to_numpy brings them back unchanged."""
    p = testing.mixed_problem(128, 16, seed=2, kind=kind)
    jspec, jpy, jsh = testing.build_problem(
        p, JAX | {'nich': importlib.import_module(
            'distributions_tpu.models.nich')}, jmx.make_spec,
        jcl.PitmanYor.from_dict)
    jst = jmx.state_from_assignments(
        jspec, jpy, jsh, tuple(jnp.asarray(v) for v in p['values']),
        jnp.asarray(p['labels']))
    ref = jax.tree_util.tree_map(np.asarray, jst)
    spec = convert.spec(jspec)
    assert [b.module.NAME for b in spec.blocks] == [
        b.module.NAME for b in jspec.blocks]
    sh = convert.shareds(jspec, jax.tree_util.tree_map(np.asarray, jsh))
    for got, want in zip(jax.tree_util.tree_leaves(convert.to_numpy(sh)),
                         jax.tree_util.tree_leaves(jsh)):
        assert got.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, np.asarray(want))
    state = convert.state(jspec, ref)
    assert isinstance(state.groups[0], spec.blocks[0].module.Group)
    for got, want in zip(
            jax.tree_util.tree_leaves(tuple(convert.to_numpy(state))),
            jax.tree_util.tree_leaves(tuple(ref))):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
