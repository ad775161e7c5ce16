"""The port's mixture machinery against distributions_tpu.mixture on a
seeded nich problem and on mixed-model problems of every ported model."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributions_tpu import clustering as jcl, mixture as jmx_eager
from distributions_tpu.models import nich as jnich
from distributions_tpu_torch import config, convert, mixture as tmx, testing
from distributions_tpu_torch.models import base as tbase

torch.set_num_threads(1)
config.set_default_device('cpu')

R, C = 1024, 128
# score tolerances: the same f32 formulas with log/lgamma differing by
# ulps; the stat sums are f32 sums over up to R rows in another order
RTOL, ATOL = 1e-5, 1e-3


class _Traced:
    """A JAX module whose functions named in `static` (name -> the indices
    of their static arguments) are jitted: traced and compiled once per
    spec, where their eager ops would each compile on their own.  Other
    names are the module's own."""

    def __init__(self, module, static):
        self._module = module
        self._jitted = {name: jax.jit(getattr(module, name),
                                      static_argnums=argnums)
                        for name, argnums in static.items()}

    def __getattr__(self, name):
        return self._jitted.get(name) or getattr(self._module, name)


jmx = _Traced(jmx_eager, dict(
    {name: (0,) for name in (
        'state_from_assignments', 'score_batch', 'score_data', 'remove_tile',
        'add_tile', 'precompute_row_stats', 'tile_sums_fast',
        'tile_deltas_fast', 'sums_to_tiles')},
    apply_stat_tiles=(0, 5, 6)))


@pytest.fixture(scope='module')
def problem():
    values, labels = testing.nich_problem(R)
    jspec = jmx.make_spec([(jnich, 2)], capacity=C)
    jpy = jcl.PitmanYor.from_dict(testing.PY)
    jsh = (jnich.shared_from_dict(testing.NICH_SHARED),)
    jst = jmx.state_from_assignments(jspec, jpy, jsh, (jnp.asarray(values),),
                                     jnp.asarray(labels))
    spec = convert.spec(jspec)
    py = convert.cl_model(jax.tree_util.tree_map(np.asarray, jpy))
    sh = convert.shareds(jspec, jax.tree_util.tree_map(np.asarray, jsh))
    st = tmx.state_from_assignments(spec, py, sh, (torch.from_numpy(values),),
                                    torch.from_numpy(labels))
    return dict(values=values, labels=labels, jspec=jspec, jpy=jpy, jsh=jsh,
                jst=jst, spec=spec, py=py, sh=sh, st=st)


def _state_close(got, want):
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
    assert int(got.sample_size) == int(want.sample_size)
    for g, w in zip(got.groups, want.groups):
        np.testing.assert_array_equal(g.count.numpy(), np.asarray(w.count))
        np.testing.assert_allclose(g.mean.numpy(), np.asarray(w.mean),
                                   rtol=RTOL, atol=1e-5)
        np.testing.assert_allclose(g.count_times_variance.numpy(),
                                   np.asarray(w.count_times_variance),
                                   rtol=1e-4, atol=ATOL)


def test_state_from_assignments(problem):
    st = problem['st']
    assert st.counts.dtype == torch.int32 and st.alive.dtype == torch.bool
    assert st.sample_size.dtype == torch.int32
    _state_close(st, problem['jst'])


def test_tile_sums_fast(problem):
    p = problem
    jrs = jmx.precompute_row_stats(p['jspec'], p['jsh'],
                                   (jnp.asarray(p['values']),))
    trs = tmx.precompute_row_stats(p['spec'], p['sh'],
                                   (torch.from_numpy(p['values']),))
    np.testing.assert_array_equal(trs[0].numpy(), np.asarray(jrs[0]))
    new = np.roll(p['labels'], 7)
    jcd, jsums = jmx.tile_sums_fast(p['jspec'], p['jsh'], jrs,
                                    jnp.asarray(new))
    tcd, tsums = tmx.tile_sums_fast(p['spec'], p['sh'], trs,
                                    torch.from_numpy(new))
    # counts are exactly equal
    np.testing.assert_array_equal(tcd.numpy(), np.asarray(jcd))
    np.testing.assert_allclose(tsums[0].numpy(), np.asarray(jsums[0]),
                               rtol=RTOL, atol=ATOL)


def test_tile_sums_fast_row_chunks(problem, monkeypatch):
    """Above ONEHOT_CHUNK_LIMIT the contraction runs over row chunks with a
    ragged tail and gives the same sums."""
    p = problem
    trs = tmx.precompute_row_stats(p['spec'], p['sh'],
                                   (torch.from_numpy(p['values']),))
    a = torch.from_numpy(p['labels'])
    cd1, s1 = tmx.tile_sums_fast(p['spec'], p['sh'], trs, a)
    monkeypatch.setattr(tbase, 'ONEHOT_CHUNK_LIMIT', C * 300)
    cd2, s2 = tmx.tile_sums_fast(p['spec'], p['sh'], trs, a)
    assert torch.equal(cd1, cd2)
    np.testing.assert_allclose(s2[0].numpy(), s1[0].numpy(), rtol=RTOL,
                               atol=ATOL)
    g = tbase.segment_sum(torch.from_numpy(p['values']), a, C)
    np.testing.assert_allclose(g.numpy(), s1[0][..., 1].numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize('sign', [-1, 1])
def test_apply_stat_tiles(problem, sign):
    p = problem
    rows = slice(0, 256)
    jrs = jmx.precompute_row_stats(p['jspec'], p['jsh'],
                                   (jnp.asarray(p['values'][rows]),))
    trs = tmx.precompute_row_stats(p['spec'], p['sh'],
                                   (torch.from_numpy(p['values'][rows]),))
    a = p['labels'][rows]
    jcd, jtiles = jmx.tile_deltas_fast(p['jspec'], p['jsh'], jrs,
                                       jnp.asarray(a))
    tcd, ttiles = tmx.tile_deltas_fast(p['spec'], p['sh'], trs,
                                       torch.from_numpy(a))
    want = jmx.apply_stat_tiles(p['jspec'], p['jsh'], p['jst'], jcd, jtiles,
                                sign, 256)
    got = tmx.apply_stat_tiles(p['spec'], p['sh'], p['st'], tcd, ttiles, sign,
                               256)
    _state_close(got, want)
    if sign < 0:
        # emptied slots are re-zeroed
        empty = got.counts == 0
        assert (got.groups[0].mean[empty] == 0).all()
        assert (got.groups[0].count_times_variance[empty] == 0).all()


def test_score_batch(problem):
    """Both packages score the same state (the JAX one, converted): the
    student-t exponent grows with the group count, so ulp differences in
    the state would be amplified past the f32 tolerance."""
    p = problem
    v = p['values'][:300]
    st = convert.state(p['jspec'], jax.tree_util.tree_map(np.asarray,
                                                          p['jst']))
    want = np.asarray(jmx.score_batch(p['jspec'], p['jpy'], p['jsh'],
                                      p['jst'], (jnp.asarray(v),)))
    got = tmx.score_batch(p['spec'], p['py'], p['sh'], st,
                          (torch.from_numpy(v),)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=1e-4)


def test_score_data(problem):
    p = problem
    want = float(jmx.score_data(p['jspec'], p['jpy'], p['jsh'], p['jst']))
    got = float(tmx.score_data(p['spec'], p['py'], p['sh'], p['st']))
    # a sum of C*cols f32 terms taken in another order
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_grow_capacity_and_needs_growth(problem):
    p = problem
    jspec2, jst2 = jmx.grow_capacity(p['jspec'], p['jst'], 2 * C)
    spec2, st2 = tmx.grow_capacity(p['spec'], p['st'], 2 * C)
    assert spec2.capacity == jspec2.capacity == 2 * C
    _state_close(st2, jst2)
    for headroom in (0.0, 0.125, 0.95):
        assert (tmx.needs_growth(p['spec'], p['st'], headroom)
                == jmx.needs_growth(p['jspec'], p['jst'], headroom))
        assert (tmx.needs_growth(spec2, st2, headroom)
                == jmx.needs_growth(jspec2, jst2, headroom))
    with pytest.raises(ValueError):
        tmx.grow_capacity(p['spec'], p['st'], C // 2)


# -- every model (values [R, cols] int / bool, and [R, cols, d] for niw) ----

MIXED = ('nich_gp_bb', 'dd_bb', 'niw3_nich_bb', 'dpd_nich', 'bnb')


@functools.lru_cache(maxsize=None)
def _mixed(kind):
    from distributions_tpu_torch.models import MODULES
    jmodels = {name: importlib.import_module('distributions_tpu.models.'
                                             + name) for name in MODULES}
    p = testing.mixed_problem(256, 64, seed=3, kind=kind)
    jspec, jpy, jsh = testing.build_problem(p, jmodels, jmx.make_spec,
                                            jcl.PitmanYor.from_dict)
    jv = tuple(jnp.asarray(v) for v in p['values'])
    jst = jmx.state_from_assignments(jspec, jpy, jsh, jv,
                                     jnp.asarray(p['labels']))
    npy = functools.partial(jax.tree_util.tree_map, np.asarray)
    return dict(p=p, jspec=jspec, jpy=jpy, jsh=jsh, jv=jv, jst=jst,
                spec=convert.spec(jspec), py=convert.cl_model(npy(jpy)),
                sh=convert.shareds(jspec, npy(jsh)),
                tv=tuple(torch.from_numpy(v) for v in p['values']),
                st=convert.state(jspec, npy(jst)))


def _leaves_close(got, want, rtol=RTOL, atol=ATOL):
    got = jax.tree_util.tree_leaves(tuple(convert.to_numpy(got)))
    want = jax.tree_util.tree_leaves(tuple(want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype.kind in 'ib':
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize('kind', MIXED)
def test_mixed_state_from_assignments_and_scores(kind):
    q = _mixed(kind)
    st = tmx.state_from_assignments(q['spec'], q['py'], q['sh'], q['tv'],
                                    torch.from_numpy(q['p']['labels']))
    _leaves_close(st, q['jst'])
    want = np.asarray(jmx.score_batch(q['jspec'], q['jpy'], q['jsh'],
                                      q['jst'], q['jv']))
    got = tmx.score_batch(q['spec'], q['py'], q['sh'], q['st'],
                          q['tv']).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    # gp and bnb difference lgammas of magnitude ~1e3 (see
    # tests/test_torch_fused_mixed.py on their tables)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=2e-3)
    want = float(jmx.score_data(q['jspec'], q['jpy'], q['jsh'], q['jst']))
    got = float(tmx.score_data(q['spec'], q['py'], q['sh'], q['st']))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


@pytest.mark.parametrize('kind', MIXED)
def test_mixed_remove_tile_add_tile(kind):
    q = _mixed(kind)
    rows = slice(64, 192)
    a = q['p']['labels'][rows]
    jtv = tuple(v[rows] for v in q['jv'])
    ttv = tuple(v[rows] for v in q['tv'])
    jrem = jmx.remove_tile(q['jspec'], q['jpy'], q['jsh'], q['jst'], jtv,
                           jnp.asarray(a))
    trem = tmx.remove_tile(q['spec'], q['py'], q['sh'], q['st'], ttv,
                           torch.from_numpy(a))
    _leaves_close(trem, jrem)
    new = (a + 1) % 3
    _leaves_close(
        tmx.add_tile(q['spec'], q['py'], q['sh'], trem, ttv,
                     torch.from_numpy(new)),
        jmx.add_tile(q['jspec'], q['jpy'], q['jsh'], jrem, jtv,
                     jnp.asarray(new)))


@pytest.mark.parametrize('kind', MIXED)
def test_mixed_row_stat_tiles_and_growth(kind):
    """tile_sums_fast -> sums_to_tiles -> apply_stat_tiles on every
    model's stat columns, and grow_capacity on every model's leaves."""
    q = _mixed(kind)
    a = q['p']['labels']
    jrs = jmx.precompute_row_stats(q['jspec'], q['jsh'], q['jv'])
    trs = tmx.precompute_row_stats(q['spec'], q['sh'], q['tv'])
    jcd, jsums = jmx.tile_sums_fast(q['jspec'], q['jsh'], jrs,
                                    jnp.asarray(a))
    tcd, tsums = tmx.tile_sums_fast(q['spec'], q['sh'], trs,
                                    torch.from_numpy(a))
    np.testing.assert_array_equal(tcd.numpy(), np.asarray(jcd))
    _leaves_close(tsums, jsums)
    jtiles = jmx.sums_to_tiles(q['jspec'], q['jsh'], jsums)
    ttiles = tmx.sums_to_tiles(q['spec'], q['sh'], tsums)
    _leaves_close(
        tmx.apply_stat_tiles(q['spec'], q['sh'], q['st'], tcd, ttiles, -1,
                             len(a)),
        jmx.apply_stat_tiles(q['jspec'], q['jsh'], q['jst'], jcd, jtiles, -1,
                             len(a)))
    jspec2, jst2 = jmx.grow_capacity(q['jspec'], q['jst'], 128)
    spec2, st2 = tmx.grow_capacity(q['spec'], q['st'], 128)
    assert spec2.capacity == jspec2.capacity
    _leaves_close(st2, jst2)


def test_init_without_shareds_uses_the_default_device():
    spec = tmx.make_spec([], capacity=4)
    assert tmx.init(spec, ()).counts.device.type == 'cpu'


# -- single-row ops, on every model -----------------------------------------

@pytest.mark.parametrize('kind', MIXED)
def test_single_row_ops_match_jax(kind):
    """score_value, remove_value and add_value of one row against the JAX
    package, from the same (converted) state: scores within the
    score_batch tolerances, integer leaves exactly, float stats within
    RTOL / ATOL.  Row 5 leaves slot k for the first dead slot's
    predecessor, a reserved empty slot, so a slot comes alive."""
    q = _mixed(kind)
    i = 5
    k_old = int(q['p']['labels'][i])
    jrow = tuple(v[i] for v in q['jv'])
    trow = tuple(v[i] for v in q['tv'])
    if kind == 'dd_bb':
        # the JAX package's score_value fails on a dd block (dd.score_value
        # under vmap indexes a [C, dim] table with a scalar); its
        # score_batch of the one row is the same score
        want = np.asarray(jmx.score_batch(
            q['jspec'], q['jpy'], q['jsh'], q['jst'],
            tuple(v[i:i + 1] for v in q['jv'])))[0]
    else:
        want = np.asarray(jmx.score_value(q['jspec'], q['jpy'], q['jsh'],
                                          q['jst'], jrow))
    got = tmx.score_value(q['spec'], q['py'], q['sh'], q['st'], trow).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=2e-3)
    # one row's score equals its row of score_batch
    batch = tmx.score_batch(q['spec'], q['py'], q['sh'], q['st'],
                            tuple(v[i:i + 1] for v in q['tv']))[0].numpy()
    np.testing.assert_allclose(got[fin], batch[fin], rtol=RTOL, atol=2e-3)

    jst, jempty = jmx.remove_value(q['jspec'], q['jpy'], q['jsh'], q['jst'],
                                   k_old, jrow)
    tst, tempty = tmx.remove_value(q['spec'], q['py'], q['sh'], q['st'],
                                   k_old, trow)
    assert bool(tempty) == bool(jempty)
    _leaves_close(tst, jst)
    k_new = int(np.flatnonzero(np.asarray(q['jst'].alive)
                               & (np.asarray(q['jst'].counts) == 0))[0])
    jst2, jwas = jmx.add_value(q['jspec'], q['jpy'], q['jsh'], jst, k_new,
                               jrow)
    tst2, twas = tmx.add_value(q['spec'], q['py'], q['sh'], tst,
                               torch.tensor(k_new), trow)
    assert bool(twas) and bool(jwas)
    _leaves_close(tst2, jst2)
    assert int(tst2.alive.sum()) == int(tst.alive.sum()) + 1


def test_remove_value_kills_the_slot():
    """A slot that empties leaves the alive set with bitwise-zero stats,
    and adding the row back does not revive a dead slot by itself."""
    q = _mixed('nich_gp_bb')
    spec, py, sh = q['spec'], q['py'], q['sh']
    tv = tuple(v[:3] for v in q['tv'])
    st = tmx.state_from_assignments(spec, py, sh, tv,
                                    torch.tensor([0, 0, 2], dtype=torch.int32))
    row = tuple(v[2] for v in tv)
    st2, now_empty = tmx.remove_value(spec, py, sh, st, 2, row)
    assert bool(now_empty) and not bool(st2.alive[2])
    assert int(st2.counts[2]) == 0 and int(st2.sample_size) == 2
    for g in st2.groups:
        for leaf in g:
            assert not leaf[2].any()
    jst = jmx.state_from_assignments(
        q['jspec'], q['jpy'], q['jsh'], tuple(v[:3] for v in q['jv']),
        jnp.asarray([0, 0, 2], jnp.int32))
    jst2, _ = jmx.remove_value(q['jspec'], q['jpy'], q['jsh'], jst, 2,
                               tuple(v[2] for v in q['jv']))
    _leaves_close(st2, jst2)
