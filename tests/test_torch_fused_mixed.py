"""The mixed fused path of the port (kernel K2's plain twin, its [C]-sized
inputs, and `sweep_blocked_pallas_fused_mixed`) against the JAX package,
whose `_fused_v3_kernel` runs in Pallas interpret mode on the CPU as in
tests/test_fused_mixed.py.  The CUDA kernel itself is held against the
twin on the card by tests/test_torch_cuda.py and chip_smoke.py.

Draws that should be equal are compared exactly; a row may differ only at
a near-tie (top-two score gap <= 1e-3, since the JAX kernel rebuilds its
table entries from two bf16 halves where the port reads exact f32), and
such rows are counted, printed and bounded at 1% of the rows."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributions_tpu import clustering as jcl, mixture as jmx
from distributions_tpu.ops import gibbs as jg, pallas_kernels as pk
from distributions_tpu_torch import clustering as tcl, config, convert
from distributions_tpu_torch import mixture as tmx, testing
from distributions_tpu_torch.models import MODULES
from distributions_tpu_torch.ops import fused_kernels as fk, gibbs as tg

torch.set_num_threads(1)
config.set_default_device('cpu')

R, C, BLOCK_ROWS = 256, 128, 128
# stat sums: f32 sums of the same rows in another order (tests/
# test_fused_mixed.py holds the JAX kernel to the same tolerance)
SUM_RTOL, SUM_ATOL = 1e-5, 1e-3
NEAR_TIE = 1e-3
KINDS = ('nich_gp_bb', 'dd_bb', 'niw2', 'niw3_nich_bb', 'dpd_nich', 'bnb')
JAX_MODELS = {name: importlib.import_module('distributions_tpu.models.'
                                            + name) for name in MODULES}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _problem(kind, rows=R):
    """One seeded problem in both packages, the port's state carried over
    from the JAX one, and the kernel operands of both."""
    p = testing.mixed_problem(rows, C, seed=1, kind=kind)
    jspec, jpy, jsh = testing.build_problem(
        p, JAX_MODELS, jmx.make_spec, jcl.PitmanYor.from_dict)
    jv = tuple(jnp.asarray(v) for v in p['values'])
    ja = jnp.asarray(p['labels'])
    jst = jmx.state_from_assignments(jspec, jpy, jsh, jv, ja)
    spec = convert.spec(jspec)
    py = convert.cl_model(_np(jpy))
    sh = convert.shareds(jspec, _np(jsh))
    tv = tuple(torch.from_numpy(v) for v in p['values'])
    st = convert.state(jspec, _np(jst))
    return dict(p=p, jspec=jspec, jpy=jpy, jsh=jsh, jv=jv, ja=ja, jst=jst,
                spec=spec, py=py, sh=sh, tv=tv, st=st,
                ta=torch.from_numpy(p['labels']))


@functools.lru_cache(maxsize=None)
def _operands(kind):
    """(JAX layout and kernel inputs, the port's layout and inputs)."""
    q = _problem(kind)
    jlay = jg._mixed_static_layout(q['jspec'], q['jv'], None)
    jin = jg._build_fused_inputs(
        q['jspec'], jlay.nich_blocks, jlay.quad_blocks, jlay.table_blocks,
        jlay.V, q['jsh'], jlay.supports_dev, q['jst'])
    jcl_scores = jcl.score_value(q['jpy'], q['jst'].counts, q['jst'].alive,
                                 q['jst'].sample_size)
    lay = tg._mixed_static_layout(q['spec'], q['tv'])
    tin = tg._build_fused_inputs(q['spec'], lay, q['sh'], q['st'])
    cl_scores = tcl.score_value(q['py'], q['st'].counts, q['st'].alive,
                                q['st'].sample_size)
    return jlay, jin, jcl_scores, lay, tin, cl_scores


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


@pytest.mark.parametrize('kind', KINDS)
def test_layout_and_fused_inputs(kind):
    """The layout and the [C]-sized kernel inputs: supports, packed
    offsets, row inputs, coefficient rows and packed score tables."""
    jlay, (jco, jqco, jtab), jcls, lay, (co, qco, tab), cls = _operands(kind)
    assert lay.nich_blocks == jlay.nich_blocks
    assert lay.quad_blocks == jlay.quad_blocks
    assert lay.table_blocks == jlay.table_blocks
    assert lay.quad_groups == jlay.quad_groups
    assert lay.table_vs == jlay.table_vs
    vtot = sum(lay.table_vs)
    q = _problem(kind)
    assert tg.packed_value_width(q['spec'], q['tv']) == vtot
    # the JAX layout rounds Vtot up to 128 lanes; the port does not
    assert jg.packed_value_width(q['jspec'], q['jv']) == (
        (vtot + 127) // 128 * 128 if vtot else 0)
    for got, want in ((lay.nich_vals, jlay.nich_vals),
                      (lay.quad_vals, jlay.quad_vals),
                      (lay.table_idx, jlay.table_idx)):
        if got is None:
            # the JAX layout's stand-ins for a kind of block it lacks
            assert want.shape[1] in (0, 1) and not np.asarray(want).any()
        else:
            assert got.dtype == _t(want).dtype
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for i in lay.table_blocks:
        np.testing.assert_array_equal(lay.supports[i].numpy(),
                                      np.asarray(jlay.supports_dev[i]))
    # the same f32 formulas on the same state, with lgamma and log
    # differing by ulps between torch and XLA
    np.testing.assert_allclose(cls.numpy(), np.asarray(jcls), rtol=1e-5,
                               atol=1e-5)
    for got, want in ((co, jco), (qco, jqco)):
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
    if vtot:
        assert tab.shape == (vtot, C)
        # gp's and bnb's table entries difference lgammas of the slot's
        # posterior hypers (gp: alpha + the slot's sum, here up to ~800,
        # lgamma ~4500, one f32 ulp 4.9e-4; bnb: up to ~350, one ulp
        # 1.2e-4): both packages cancel the same large terms, and torch's
        # and XLA's lgamma differ by an ulp or two
        atol = 2e-3 if 'gp' in kind else 5e-4 if kind == 'bnb' else 1e-5
        np.testing.assert_allclose(tab.numpy(), np.asarray(jtab)[:vtot],
                                   rtol=1e-5, atol=atol)
        assert not np.asarray(jtab)[vtot:].any()
    else:
        assert tab is None and jtab.shape == (0, C)


def _run_both(kind, sampling, noise=None, tables_edit=None):
    """The JAX kernel (interpret mode) and the port's twin on the SAME
    operands: the JAX package's arrays, handed to the twin as tensors
    (with the table's lane padding cut off)."""
    jlay, (jco, jqco, jtab), jcls, lay, _, _ = _operands(kind)
    q = _problem(kind)
    if tables_edit is not None:
        jtab = jnp.asarray(tables_edit(np.array(jtab)))
    col_groups = tuple(q['jspec'].blocks[i].cols for i in jlay.nich_blocks)
    jout = pk.fused_mixed_score_sample_stats(
        0, jlay.nich_vals, jlay.table_idx, jcls, jco, jtab, col_groups,
        block_rows=BLOCK_ROWS, sampling=sampling, qvalues=jlay.quad_vals,
        qcoeffs=jqco, quad_groups=jlay.quad_groups,
        noise=None if noise is None else jnp.asarray(noise),
        table_vs=jlay.table_vs)
    vtot = sum(lay.table_vs)
    tables = _t(np.asarray(jtab)[:vtot]) if vtot else None
    args = (lay.nich_vals, lay.table_idx, _t(jcls), _t(jco), tables,
            col_groups)
    kwargs = dict(qvalues=lay.quad_vals, qcoeffs=_t(jqco),
                  quad_groups=lay.quad_groups, table_vs=lay.table_vs)
    tout = fk.fused_mixed_score_sample_stats(
        0, *args, block_rows=BLOCK_ROWS, sampling=sampling,
        noise=_t(noise), **kwargs)
    scores = fk._score_mixed(
        R, lay.nich_vals, lay.table_idx, _t(jcls), _t(jco),
        None if tables is None else torch.clamp(tables, min=-1e30),
        col_groups, lay.quad_vals, _t(jqco), lay.quad_groups, lay.table_vs,
        torch.log)
    return [np.array(x) for x in jout], tout, scores, lay


def _assert_draws(kind, sampling, ja, ta, scores):
    """Equal draws, except recorded near-ties: at most 1% of the rows,
    each with a gap between the two drawn slots' scores <= NEAR_TIE."""
    n_bad, gap = testing.mismatches(scores, ta, ja)
    if n_bad:
        print('near-ties: %s %s: %d of %d rows differ, largest score gap '
              '%.3g' % (kind, sampling, n_bad, len(ja), gap))
    assert n_bad <= len(ja) // 100 and gap <= NEAR_TIE, (n_bad, gap)
    return n_bad


def _assert_sums(jout, tout, lay):
    _, jsums, jtcounts, jqsums = jout
    _, sums, tcounts, qsums = tout
    vtot = sum(lay.table_vs)
    assert tcounts.shape == (C, vtot)
    # counts are integers: exactly equal, at the packed offsets
    np.testing.assert_array_equal(tcounts.numpy(), jtcounts[:, :vtot])
    assert not jtcounts[:, vtot:].any()
    if lay.nich_vals is not None:
        np.testing.assert_allclose(sums.numpy(), jsums, rtol=SUM_RTOL,
                                   atol=SUM_ATOL)
    else:
        assert sums.shape == (C, 0)
    assert qsums.shape == (C, fk.quad_stat_dim(lay.quad_groups))
    np.testing.assert_allclose(qsums.numpy(), jqsums, rtol=SUM_RTOL,
                               atol=SUM_ATOL)


# argmax on every layout; the other deterministic modes on two of them
# (one Pallas interpret-mode compile per case)
DRAW_CASES = [(k, 'argmax') for k in KINDS] + [
    (k, s) for k in ('nich_gp_bb', 'niw3_nich_bb')
    for s in ('argmax_fast', 'gumbel_host')]


@pytest.mark.parametrize('kind,sampling', DRAW_CASES)
def test_twin_draws_and_sums_match_jax_kernel(kind, sampling):
    noise = None
    if sampling == 'gumbel_host':
        noise = np.random.RandomState(1).gumbel(size=(R, C)).astype(
            np.float32)
    jout, tout, scores, lay = _run_both(kind, sampling, noise)
    assert tout[0].dtype == torch.int32
    if noise is not None:
        scores = scores + torch.from_numpy(noise)
    if _assert_draws(kind, sampling, jout[0], tout[0], scores) == 0:
        _assert_sums(jout, tout, lay)


@pytest.mark.parametrize('kind', ['nich_gp_bb', 'niw3_nich_bb'])
def test_twin_cdf_host_matches_jax_kernel(kind):
    noise = np.random.RandomState(2).rand(R, 1).astype(np.float32)
    jout, tout, _, lay = _run_both(kind, 'cdf_host', noise)
    # the TPU kernel rounds p to bf16 before its prefix matmul and the port
    # keeps f32, so a draw within ~2^-9 of a prefix boundary may move
    assert (tout[0].numpy() == jout[0]).mean() >= 0.99
    # the sums belong to the twin's own draws
    want = fk._mixed_stat_sums(tout[0], C, lay.nich_vals, lay.table_idx,
                               (1,), lay.quad_vals, lay.quad_groups,
                               lay.table_vs)
    for got, ref in zip(tout[1:], want):
        assert torch.equal(got, ref)
    np.testing.assert_array_equal(
        np.bincount(tout[0].numpy(), minlength=C),
        tout[2][:, :lay.table_vs[0]].sum(1).numpy().astype(int))


def test_neg_inf_table_entries_stay_unselectable():
    """A -inf table entry (possible from dpd when a value's beta and count
    are both zero) is floored at -1e30: never drawn, never a NaN
    (tests/test_table_split.py)."""
    def edit(tab):
        tab[1, :] = -np.inf      # one dd value impossible everywhere
        tab[:, 5] = -np.inf      # slot 5 impossible for every value
        return tab
    jout, tout, scores, lay = _run_both('dd_bb', 'argmax', tables_edit=edit)
    assert not torch.isnan(scores).any()
    assert not (tout[0] == 5).any() and not (jout[0] == 5).any()
    if _assert_draws('dd_bb -inf', 'argmax', jout[0], tout[0], scores) == 0:
        _assert_sums(jout, tout, lay)
    # rows holding the impossible value score at the floor, far below any
    # real score, yet still draw a live slot
    rows = lay.table_idx[:, 0] == 1
    assert bool(rows.any()) and bool((scores[rows] < -1e29).all())
    assert int(tout[0].min()) >= 0 and int(tout[0].max()) < C


def test_nich_only_call_falls_through_to_k1():
    q = _problem('nich_gp_bb')
    v = q['tv'][0]
    cls = tcl.score_value(q['py'], q['st'].counts, q['st'].alive,
                          q['st'].sample_size)
    co = fk.nich_coeffs_v2(q['sh'][0], q['st'].groups[0])
    out, sums, tcounts, qsums = fk.fused_mixed_score_sample_stats(
        0, v, None, cls, co, None, (1,), sampling='argmax')
    ref, ref_sums = fk.fused_score_sample_stats(0, v, cls, co, (1,),
                                                sampling='argmax')
    assert torch.equal(out, ref) and torch.equal(sums, ref_sums)
    assert tcounts.shape == (C, 0) and qsums.shape == (C, 0)


def test_cpu_tensors_use_the_twin_and_other_devices_raise():
    _, _, _, lay, (co, qco, tab), cls = _operands('niw3_nich_bb')
    before = fk.fused_mixed_score_sample_stats.launches
    fk.fused_mixed_score_sample_stats(
        0, lay.nich_vals, lay.table_idx, cls, co, tab, (1,),
        sampling='argmax', qvalues=lay.quad_vals, qcoeffs=qco,
        quad_groups=lay.quad_groups, table_vs=lay.table_vs)
    assert fk.fused_mixed_score_sample_stats.launches == before
    with pytest.raises(ValueError, match='CPU or CUDA'):
        fk.fused_mixed_score_sample_stats(
            0, lay.nich_vals, lay.table_idx, cls.to('meta'), co, tab, (1,),
            sampling='argmax', qvalues=lay.quad_vals, qcoeffs=qco,
            quad_groups=lay.quad_groups, table_vs=lay.table_vs)
    with pytest.raises(ValueError, match='unknown sampling'):
        fk.fused_mixed_score_sample_stats(
            0, lay.nich_vals, lay.table_idx, cls, co, tab, (1,),
            sampling='best', qvalues=lay.quad_vals, qcoeffs=qco,
            quad_groups=lay.quad_groups, table_vs=lay.table_vs)


@pytest.mark.parametrize('sampling', ['gumbel', 'cdf', 'gumbel_fast'])
def test_twin_rng_modes_match_softmax(sampling):
    """In-kernel-RNG modes can only match in distribution: slot
    frequencies against the softmax of mixture.score_batch."""
    q = _problem('nich_gp_bb', rows=4096)
    lay = tg._mixed_static_layout(q['spec'], q['tv'])
    co, qco, tab = tg._build_fused_inputs(q['spec'], lay, q['sh'], q['st'])
    cls = tcl.score_value(q['py'], q['st'].counts, q['st'].alive,
                          q['st'].sample_size)
    draws = [fk.fused_mixed_score_sample_stats(
        11, lay.nich_vals, lay.table_idx, cls, co, tab, (1,),
        sampling=sampling, table_vs=lay.table_vs)[0] for _ in range(2)]
    assert torch.equal(*draws)
    scores = tmx.score_batch(q['spec'], q['py'], q['sh'], q['st'], q['tv'])
    assert testing.softmax_ztest(draws[0], scores) < 5.0


# -- the [C]-sized niw inputs ------------------------------------------------

@pytest.mark.parametrize('d', [1, 2, 3, 4])
def test_inv_logdet_spd_small(d):
    rng = np.random.RandomState(d)
    A = rng.randn(64, 2, d, d).astype(np.float32)
    m = A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(d, dtype=np.float32)
    # a singular matrix (all ones): its closed-form determinant is 0 and
    # hits the clamp (d <= 3); beyond, neither package raises on it
    m[0, 0] = 1.0
    inv, logdet = fk._inv_logdet_spd_small(torch.from_numpy(m))
    jinv, jlogdet = pk._inv_logdet_spd_small(jnp.asarray(m))
    ok = np.ones((64, 2), bool)
    if d > 1:
        ok[0, 0] = False
        if d <= 3:
            assert np.isfinite(logdet[0, 0].item())
            assert float(logdet[0, 0]) == pytest.approx(
                float(jlogdet[0, 0]))
    # the same closed forms in f32 (torch.linalg against XLA's LU at d=4)
    np.testing.assert_allclose(inv.numpy()[ok], np.asarray(jinv)[ok],
                               rtol=2e-3 if d == 4 else 1e-5,
                               atol=2e-3 if d == 4 else 1e-5)
    np.testing.assert_allclose(logdet.numpy()[ok], np.asarray(jlogdet)[ok],
                               rtol=1e-5, atol=1e-4 if d == 4 else 1e-5)
    want = np.linalg.slogdet(m.astype(np.float64))[1]
    np.testing.assert_allclose(logdet.numpy()[ok], want[ok], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize('kind', ['niw2', 'niw3_nich_bb', 'niw4'])
def test_niw_coeffs_v4_and_quad_sums_to_raw(kind):
    q = _problem(kind)
    got = fk.niw_coeffs_v4(q['sh'][0], q['st'].groups[0])
    want = pk.niw_coeffs_v4(q['jsh'][0], q['jst'].groups[0])
    d = q['tv'][0].shape[-1]
    assert got.shape == (2 + d + d * (d + 1) // 2, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4 if d == 4 else 1e-5)
    groups = ((1, d),)
    qsums = np.random.RandomState(0).rand(C, fk.quad_stat_dim(groups)).astype(
        np.float32)
    assert fk.quad_stat_dim(groups) == pk.quad_stat_dim(groups)
    raw = fk.quad_sums_to_raw(torch.from_numpy(qsums), groups)
    jraw = pk.quad_sums_to_raw(jnp.asarray(qsums), groups)
    assert raw[0].shape == (C, 1, 1 + d + d * d)
    np.testing.assert_array_equal(raw[0].numpy(), np.asarray(jraw[0]))


def test_supports_mixed_pallas():
    for kind in KINDS:
        q = _problem(kind)
        assert fk.supports_mixed_pallas(q['spec'])
        assert pk.supports_mixed_pallas(q['jspec'])
    assert not fk.supports_pallas(_problem('nich_gp_bb')['spec'])


# -- the slice as a whole ----------------------------------------------------

def _cache_close(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=SUM_RTOL,
                                   atol=SUM_ATOL)


def _reference_sweep(q, state, assignments, block):
    """remove_tile -> score_batch -> argmax -> add_tile, tile by tile."""
    out = []
    for t in range(assignments.shape[0] // block):
        sl = slice(t * block, (t + 1) * block)
        tv = tuple(v[sl] for v in q['tv'])
        state = tmx.remove_tile(q['spec'], q['py'], q['sh'], state, tv,
                                assignments[sl])
        scores = tmx.score_batch(q['spec'], q['py'], q['sh'], state, tv)
        new = torch.argmax(scores, dim=1).to(torch.int32)
        state = tmx.add_tile(q['spec'], q['py'], q['sh'], state, tv, new)
        out.append(new)
    return state, torch.cat(out)


@pytest.mark.parametrize('kind', ['nich_gp_bb', 'niw3_nich_bb', 'dd_bb'])
def test_fused_mixed_sweep_argmax_matches_jax(kind):
    """The analogue of test_mixed_fused_argmax_matches_xla and of
    tests/test_small_linalg.py's d=3 sweep."""
    q = _problem(kind)
    jcache = jg.build_stat_cache(q['jspec'], q['jsh'], q['jv'], R, q['ja'])
    jst, jan, _ = jg.sweep_blocked_pallas_fused_mixed(
        q['jspec'], q['jpy'], q['jsh'], q['jst'], q['jv'], q['ja'], R,
        BLOCK_ROWS, jax.random.PRNGKey(0), jcache, sampling='argmax')
    cache = tg.build_stat_cache(q['spec'], q['sh'], q['tv'], R, q['ta'])
    _cache_close(cache, jcache)
    st, an, cache = tg.sweep_blocked_pallas_fused_mixed(
        q['spec'], q['py'], q['sh'], q['st'], q['tv'], q['ta'], R,
        BLOCK_ROWS, torch.Generator().manual_seed(0), cache,
        sampling='argmax')
    assert an.dtype == torch.int32
    np.testing.assert_array_equal(an.numpy(), np.asarray(jan))
    np.testing.assert_array_equal(st.counts.numpy(), np.asarray(jst.counts))
    # the emitted cache equals a fresh one on the new assignments
    _cache_close(cache, jg.build_stat_cache(q['jspec'], q['jsh'], q['jv'], R,
                                            jan))


@pytest.mark.parametrize('kind', sorted(testing.MIXED_KINDS))
def test_fused_mixed_sweep_matches_reference_sweep(kind):
    """Two sweeps of two tiles equal the port's own un-kernelled argmax
    sweep, and the emitted cache equals a fresh build_stat_cache."""
    q = _problem(kind)
    block = R // 2
    cache = tg.build_stat_cache(q['spec'], q['sh'], q['tv'], block, q['ta'])
    st, an, cache = tg.sweep_blocked_pallas_fused_mixed(
        q['spec'], q['py'], q['sh'], q['st'], q['tv'], q['ta'], block,
        BLOCK_ROWS, torch.Generator().manual_seed(0), cache,
        sampling='argmax', n_sweeps=2)
    ref_st, ref_an = q['st'], q['ta']
    for _ in range(2):
        ref_st, ref_an = _reference_sweep(q, ref_st, ref_an, block)
    assert torch.equal(an, ref_an)
    assert torch.equal(st.counts, ref_st.counts)
    fresh = tg.build_stat_cache(q['spec'], q['sh'], q['tv'], block, an)
    assert torch.equal(cache[0], fresh[0])
    for got, want in zip(cache[1], fresh[1]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=SUM_RTOL,
                                   atol=SUM_ATOL)


@pytest.mark.parametrize('sampling', ['argmax', 'cdf_host', 'gumbel',
                                      'cdf_fast'])
def test_fused_mixed_multi_sweep_with_score(sampling):
    """n_sweeps=3, with_score=True returns the score a fresh score_data
    gives, in every kind of sampling mode, and one seed gives one chain."""
    q = _problem('niw3_nich_bb')
    block = R // 2
    runs = []
    for _ in range(2):
        cache = tg.build_stat_cache(q['spec'], q['sh'], q['tv'], block,
                                    q['ta'])
        runs.append(tg.sweep_blocked_pallas_fused_mixed(
            q['spec'], q['py'], q['sh'], q['st'], q['tv'], q['ta'], block,
            BLOCK_ROWS, torch.Generator().manual_seed(3), cache,
            sampling=sampling, n_sweeps=3, with_score=True))
    (st, an, cache, score), (_, an2, _, _) = runs
    assert torch.equal(an, an2)
    np.testing.assert_array_equal(np.bincount(an.numpy(), minlength=C),
                                  st.counts.numpy())
    fresh = float(tmx.score_data(q['spec'], q['py'], q['sh'],
                                 tmx.state_from_assignments(
                                     q['spec'], q['py'], q['sh'], q['tv'],
                                     an)))
    # the state after 3 sweeps of f32 merges and unmerges against one
    # built in one pass
    assert abs(float(score) - fresh) <= 1e-4 * abs(fresh)


def test_supports_argument_and_out_of_support_error():
    q = _problem('nich_gp_bb')
    gp_values = q['p']['values'][1]
    wide = np.arange(int(gp_values.max()) + 3, dtype=np.int32)
    supports = (None, wide, np.array([0, 1], np.int32))
    lay = tg._mixed_static_layout(q['spec'], q['tv'], supports)
    assert lay.table_vs == (len(wide), 2)
    np.testing.assert_array_equal(lay.table_idx[:, 0].numpy(),
                                  gp_values[:, 0])
    cache = tg.build_stat_cache(q['spec'], q['sh'], q['tv'], R, q['ta'])
    _, an, _ = tg.sweep_blocked_pallas_fused_mixed(
        q['spec'], q['py'], q['sh'], q['st'], q['tv'], q['ta'], R,
        BLOCK_ROWS, torch.Generator(), cache, sampling='argmax',
        supports=supports)
    _, ref = _reference_sweep(q, q['st'], q['ta'], R)
    assert torch.equal(an, ref)
    # a support that misses observed values would shift them into the next
    # column's rows of the packed table: rejected (the analogue of
    # test_mixed_layout_rejects_uncovered_support)
    with pytest.raises(ValueError, match='not in the provided support'):
        tg._mixed_static_layout(
            q['spec'], q['tv'], (None, np.array([0, 1], np.int32), None))
    gp = MODULES['gp']
    spec = tmx.make_spec([(gp, 1)], capacity=C)
    with pytest.raises(ValueError, match='not in the provided support'):
        tg._mixed_static_layout(
            spec, (torch.tensor([[0], [1], [5]], dtype=torch.int32),),
            (np.asarray([0, 1], np.int32),))


def test_column_constant_nu_error():
    nich = MODULES['nich']
    rng = np.random.RandomState(0)
    spec = tmx.make_spec([(nich, 2), (MODULES['bb'], 1)], capacity=C)
    py = tcl.PitmanYor.from_dict(testing.PY)
    sh = (nich.Shared(mu=torch.zeros(2), kappa=torch.ones(2),
                      sigmasq=torch.ones(2), nu=torch.tensor([1.0, 2.0])),
          MODULES['bb'].shared_from_dict({'alpha': 0.5, 'beta': 0.5}))
    tv = (torch.from_numpy(rng.randn(R, 2).astype(np.float32)),
          torch.from_numpy(rng.rand(R, 1) < 0.5))
    a = torch.zeros(R, dtype=torch.int32)
    st = tmx.state_from_assignments(spec, py, sh, tv, a)
    cache = tg.build_stat_cache(spec, sh, tv, R, a)
    with pytest.raises(ValueError, match='column-constant nu'):
        tg.sweep_blocked_pallas_fused_mixed(
            spec, py, sh, st, tv, a, R, BLOCK_ROWS, torch.Generator(), cache,
            sampling='argmax')


def test_nich_only_sweeps_reject_mixed_specs():
    q = _problem('nich_gp_bb')
    cache = tg.build_stat_cache(q['spec'], q['sh'], q['tv'], R, q['ta'])
    with pytest.raises(ValueError, match='nich-only'):
        tg.sweep_blocked_pallas_fused(
            q['spec'], q['py'], q['sh'], q['st'], q['tv'], q['ta'], R,
            BLOCK_ROWS, torch.Generator(), cache, sampling='argmax')
