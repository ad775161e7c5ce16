"""The v1 score + sample path (kernels K4 and K5) against the JAX package:
`nich_coeffs`, the twins' scores, the twins' draws, and the two sweeps
that call them.

`_score_sample_kernel` and `_mixed_kernel` draw with the TPU core's
generator, which interpret mode stubs, so the JAX package's own tests of
them skip on the CPU (tests/test_tpu_pallas.py).  What is deterministic is
compared here: the coefficient rows, the twins' scores before the noise
against `mixture.score_batch`, 'argmax' draws against the argmax of those
scores, and the random draws in distribution (z-test of the slot
frequencies against the softmax)."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributions_tpu import clustering as jcl, mixture as jmx
from distributions_tpu.ops import pallas_kernels as pk
from distributions_tpu_torch import clustering as tcl, config, convert
from distributions_tpu_torch import mixture as tmx, testing
from distributions_tpu_torch.models import MODULES
from distributions_tpu_torch.ops import fused_kernels as fk, gibbs as tg

torch.set_num_threads(1)
config.set_default_device('cpu')

R, C = 512, 64
KINDS = ('nich_gp_bb', 'dd_bb', 'dpd_nich', 'bnb')


@functools.lru_cache(maxsize=None)
def _problem(kind):
    jmodels = {name: importlib.import_module('distributions_tpu.models.'
                                             + name) for name in MODULES}
    p = testing.mixed_problem(R, C, seed=11, kind=kind)
    jspec, jpy, jsh = testing.build_problem(p, jmodels, jmx.make_spec,
                                            jcl.PitmanYor.from_dict)
    jv = tuple(jnp.asarray(v) for v in p['values'])
    jst = jmx.state_from_assignments(jspec, jpy, jsh, jv,
                                     jnp.asarray(p['labels']))
    npy = functools.partial(jax.tree_util.tree_map, np.asarray)
    spec = convert.spec(jspec)
    sh = convert.shareds(jspec, npy(jsh))
    tv = tuple(torch.from_numpy(v) for v in p['values'])
    return dict(p=p, jspec=jspec, jpy=jpy, jsh=jsh, jv=jv, jst=jst, spec=spec,
                py=convert.cl_model(npy(jpy)), sh=sh, tv=tv,
                st=convert.state(jspec, npy(jst)))


def _v1_inputs(q):
    """K5's inputs for every row of the problem against its state."""
    spec, sh, st = q['spec'], q['sh'], q['st']
    lay = tg._mixed_static_layout(spec, q['tv'])
    cl_scores = tcl.score_value(q['py'], st.counts, st.alive, st.sample_size)
    coeffs, tables = tg._build_v1_inputs(spec, lay, sh, st)
    return lay.nich_vals, lay.table_idx, cl_scores, coeffs, tables


def test_nich_coeffs_match_jax():
    """Four rows per column {score, log_coeff, prec, mean}: rtol 1e-5, with
    atol 1e-4 for the score row, which differences lgammas and logs that
    differ by ulps between the packages (as test_nich_coeffs_v2)."""
    q = _problem('nich_gp_bb')
    want = np.asarray(pk.nich_coeffs(q['jsh'][0], q['jst'].groups[0]))
    got = fk.nich_coeffs(q['sh'][0], q['st'].groups[0])
    assert got.shape == (4, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    # two columns: rows 4j .. 4j+3 belong to column j
    values, labels = testing.nich_problem(R, cols=2, seed=1)
    from distributions_tpu.models import nich as jnich
    from distributions_tpu_torch.models import nich as tnich
    jsh = jnich.shared_from_dict(testing.NICH_SHARED)
    jg = jnich.from_values_grouped(jsh, jnp.asarray(values[:, 0]),
                                   jnp.asarray(labels), 16)
    jg2 = jax.tree_util.tree_map(
        lambda a, b: jnp.stack([a, b], 1), jg,
        jnich.from_values_grouped(jsh, jnp.asarray(values[:, 1]),
                                  jnp.asarray(labels), 16))
    tg2 = tnich.Group(*(torch.from_numpy(np.array(x)) for x in jg2))
    got = fk.nich_coeffs(tnich.shared_from_dict(testing.NICH_SHARED), tg2)
    want = np.asarray(pk.nich_coeffs(jsh, jg2))
    assert got.shape == (8, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize('kind', KINDS)
def test_twin_scores_match_score_batch(kind):
    """The twins' [B, C] scores before the noise against the JAX
    package's `mixture.score_batch` of the same state (gp and bnb
    difference lgammas of magnitude ~1e3: atol 2e-3, as in
    test_torch_mixture.py), and an 'argmax' draw is their argmax."""
    q = _problem(kind)
    nich_vals, idx, cl_scores, coeffs, tables = _v1_inputs(q)
    got = fk._score_v1(R, nich_vals, idx, cl_scores, coeffs, tables).numpy()
    want = np.asarray(jmx.score_batch(q['jspec'], q['jpy'], q['jsh'],
                                      q['jst'], q['jv']))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=2e-3)
    a = fk.mixed_score_sample(0, nich_vals, idx, cl_scores, coeffs, tables,
                              sampling='argmax')
    assert a.dtype == torch.int32 and a.shape == (R,)
    np.testing.assert_array_equal(a.numpy(), got.argmax(1))


def test_nich_twin_scores_and_host_noise():
    """K4's twin on a two-column nich problem: scores against the JAX
    package's score_batch, and 'gumbel_host' draws equal to the argmax of
    scores + noise."""
    values, labels = testing.nich_problem(R, cols=2, seed=2)
    from distributions_tpu.models import nich as jnich
    from distributions_tpu_torch.models import nich as tnich
    jspec = jmx.make_spec([(jnich, 2)], capacity=C)
    jpy = jcl.PitmanYor.from_dict(testing.PY)
    jsh = (jnich.shared_from_dict(testing.NICH_SHARED),)
    jst = jmx.state_from_assignments(jspec, jpy, jsh, (jnp.asarray(values),),
                                     jnp.asarray(labels))
    st = convert.state(jspec, jax.tree_util.tree_map(np.asarray, jst))
    py = tcl.PitmanYor.from_dict(testing.PY)
    sh = tnich.shared_from_dict(testing.NICH_SHARED)
    cl_scores = tcl.score_value(py, st.counts, st.alive, st.sample_size)
    coeffs = fk.nich_coeffs(sh, st.groups[0])
    v = torch.from_numpy(values)
    scores = fk._score_v1(R, v, None, cl_scores, coeffs, None)
    want = np.asarray(jmx.score_batch(jspec, jpy, jsh, jst,
                                      (jnp.asarray(values),)))
    fin = np.isfinite(want)
    np.testing.assert_allclose(scores.numpy()[fin], want[fin], rtol=1e-5,
                               atol=1e-4)
    noise = torch.from_numpy(np.random.RandomState(0).gumbel(
        size=(R, C)).astype(np.float32))
    a = fk.nich_score_sample(3, v, cl_scores, coeffs, sampling='gumbel_host',
                             noise=noise)
    assert torch.equal(a.long(), torch.argmax(scores + noise, dim=1))
    # the wrapper's launch counter counts kernel launches only
    assert fk.nich_score_sample.launches == 0
    assert fk.mixed_score_sample.launches == 0


@pytest.mark.parametrize('kind', ['nich_gp_bb', 'dd_bb'])
def test_twin_gumbel_draws_in_distribution(kind):
    """'gumbel' draws of one seed repeat, another seed differs, and the
    slot frequencies of 16 seeds pass the z-test against the softmax of
    the scores (|z| < 5, as tests/test_tpu_pallas.py)."""
    q = _problem(kind)
    args = _v1_inputs(q)
    one = fk.mixed_score_sample(5, *args)
    assert torch.equal(one, fk.mixed_score_sample(5, *args))
    draws = torch.cat([fk.mixed_score_sample(s, *args) for s in range(16)])
    assert not torch.equal(draws[:R], draws[R:2 * R])
    scores = fk._score_v1(R, *args).repeat(16, 1)
    assert testing.softmax_ztest(draws, scores) < 5.0


def test_mixed_score_sample_optional_families_and_floor():
    """No nich columns and no table columns are both legal and pass None;
    -inf table entries are floored, never drawn and never NaN."""
    q = _problem('dd_bb')
    nich_vals, idx, cl_scores, coeffs, tables = _v1_inputs(q)
    assert nich_vals is None and coeffs is None and tables.shape[0] == 2
    tables = tables.clone()
    tables[0, :, 5] = float('-inf')
    for sampling in ('argmax', 'gumbel'):
        a = fk.mixed_score_sample(1, None, idx, cl_scores, None, tables,
                                  sampling=sampling)
        assert int(a.min()) >= 0 and int(a.max()) < C
        assert not bool((a == 5).any())
    qn = _problem('dpd_nich')
    nv, _, cls, co, _ = _v1_inputs(qn)
    a = fk.mixed_score_sample(0, nv, None, cls, co, None, sampling='argmax')
    b = fk.nich_score_sample(0, nv, cls, co, sampling='argmax')
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match='no nich or table'):
        fk.mixed_score_sample(0, None, None, cls, None, None)
    for bad in ('cdf', 'gumbel_fast', 'cdf_host'):
        with pytest.raises(ValueError, match='v1 score'):
            fk.nich_score_sample(0, nv, cls, co, sampling=bad)


# -- the sweeps ---------------------------------------------------------------

@pytest.mark.parametrize('kind', ['nich_gp_bb', 'dd_bb', 'dpd_nich'])
def test_xla_backend_equals_sweep_blocked(kind):
    """backend='xla' indexes per-tile [V, C] tables; an index is an exact
    gather, so with generators in the same state its draws and state
    equal sweep_blocked's bitwise (tests/test_mixture.py::
    test_xla_table_sweep_matches_blocked)."""
    q = _problem(kind)
    a0 = torch.from_numpy(q['p']['labels'])
    st = tmx.state_from_assignments(q['spec'], q['py'], q['sh'], q['tv'], a0)
    st_t, an_t = tg.sweep_blocked_pallas_mixed(
        q['spec'], q['py'], q['sh'], st, q['tv'], a0, 128,
        torch.Generator().manual_seed(0), backend='xla')
    st_x, an_x = tg.sweep_blocked(
        q['spec'], q['py'], q['sh'], st, q['tv'], a0, 128,
        generator=torch.Generator().manual_seed(0))
    assert torch.equal(an_t, an_x) and an_t.dtype == torch.int32
    for got, want in zip(jax.tree_util.tree_leaves(convert.to_numpy(st_t)),
                         jax.tree_util.tree_leaves(convert.to_numpy(st_x))):
        np.testing.assert_array_equal(got, want)


def test_xla_backend_two_column_block():
    """A block of two table columns sums its columns before it joins the
    scores, as sweep_blocked does."""
    from distributions_tpu_torch.models import gp, nich
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 3, R)
    values = (
        torch.from_numpy((2.0 * labels - 2.0 + 0.4 * rng.randn(R))[:, None]
                         .astype(np.float32)),
        torch.from_numpy(np.stack(
            [rng.poisson(np.where(labels == 0, 2., 9.)),
             rng.poisson(3 + 2 * labels)], axis=1).astype(np.int32)))
    spec = tmx.make_spec([(nich, 1), (gp, 2)], capacity=C)
    py = tcl.PitmanYor.from_dict(testing.PY)
    sh = (nich.shared_from_dict(testing.NICH_SHARED),
          gp.shared_from_dict({'alpha': 1.0, 'inv_beta': 0.5}))
    a0 = torch.from_numpy(labels.astype(np.int32))
    st = tmx.state_from_assignments(spec, py, sh, values, a0)
    _, an_t = tg.sweep_blocked_pallas_mixed(
        spec, py, sh, st, values, a0, 128, torch.Generator().manual_seed(1),
        backend='xla')
    _, an_x = tg.sweep_blocked(spec, py, sh, st, values, a0, 128,
                               generator=torch.Generator().manual_seed(1))
    assert torch.equal(an_t, an_x)
    st_p, an_p = tg.sweep_blocked_pallas_mixed(
        spec, py, sh, st, values, a0, 128, torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(np.bincount(an_p.numpy(), minlength=C),
                                  st_p.counts.numpy())


@pytest.mark.parametrize('kind,sampling', [
    ('nich_gp_bb', 'gumbel'), ('nich_gp_bb', 'argmax'),
    ('dd_bb', 'gumbel_host'), ('bnb', 'gumbel')])
def test_pallas_backend_sweep_is_consistent(kind, sampling):
    """backend='pallas' (K5's twin here): counts equal a bincount of the
    draws, the state equals a fresh state_from_assignments, one seed gives
    one chain, and under 'argmax' the draws equal the argmax of the plain
    path's scores, so they equal the 'xla' backend's fit."""
    q = _problem(kind)
    a0 = torch.from_numpy(q['p']['labels'])
    st = tmx.state_from_assignments(q['spec'], q['py'], q['sh'], q['tv'], a0)
    runs = [tg.sweep_blocked_pallas_mixed(
        q['spec'], q['py'], q['sh'], st, q['tv'], a0, 128,
        torch.Generator().manual_seed(2), sampling=sampling)
        for _ in range(2)]
    (st1, an1), (_, an2) = runs
    assert torch.equal(an1, an2)
    np.testing.assert_array_equal(np.bincount(an1.numpy(), minlength=C),
                                  st1.counts.numpy())
    fresh = tmx.state_from_assignments(q['spec'], q['py'], q['sh'], q['tv'],
                                       an1)
    got = float(tmx.score_data(q['spec'], q['py'], q['sh'], st1))
    want = float(tmx.score_data(q['spec'], q['py'], q['sh'], fresh))
    assert abs(got - want) <= 1e-4 * abs(want)


def test_sweep_blocked_pallas_nich():
    """The nich-only v1 sweep (K4's twin here) against sweep_blocked in
    fit after 4 sweeps (different streams: score_data within 5%, as
    tests/test_tpu_pallas.py::test_pallas_sweep_matches_xla_statistically),
    with consistent counts."""
    from distributions_tpu_torch.models import nich
    values, labels = testing.nich_problem(1024, seed=6)
    spec = tmx.make_spec([(nich, 2)], capacity=C)
    py = tcl.PitmanYor.from_dict(testing.PY)
    sh = (nich.shared_from_dict(testing.NICH_SHARED),)
    tv = (torch.from_numpy(values),)
    a0 = torch.from_numpy(labels % 4)
    st0 = tmx.state_from_assignments(spec, py, sh, tv, a0)
    st_p, an_p, st_x, an_x = st0, a0, st0, a0
    gp_, gx = torch.Generator().manual_seed(0), torch.Generator().manual_seed(0)
    for _ in range(4):
        st_p, an_p = tg.sweep_blocked_pallas(spec, py, sh, st_p, tv, an_p, 256,
                                             generator=gp_)
        st_x, an_x = tg.sweep_blocked(spec, py, sh, st_x, tv, an_x, 256,
                                      generator=gx)
    np.testing.assert_array_equal(np.bincount(an_p.numpy(), minlength=C),
                                  st_p.counts.numpy())
    sp = float(tmx.score_data(spec, py, sh, st_p))
    sx = float(tmx.score_data(spec, py, sh, st_x))
    assert abs(sp - sx) / abs(sx) < 0.05, (sp, sx)
    q = _problem('nich_gp_bb')
    with pytest.raises(ValueError, match='nich-only'):
        tg.sweep_blocked_pallas(q['spec'], q['py'], q['sh'], q['st'], q['tv'],
                                torch.from_numpy(q['p']['labels']), 128,
                                generator=torch.Generator())


def test_mixed_sweep_rejects_niw_bad_backend_and_uncovered_support():
    q = _problem('nich_gp_bb')
    a0 = torch.from_numpy(q['p']['labels'])
    args = (q['spec'], q['py'], q['sh'], q['st'], q['tv'], a0, 128,
            torch.Generator())
    with pytest.raises(ValueError, match='backend'):
        tg.sweep_blocked_pallas_mixed(*args, backend='mosaic')
    sup = list(tg._block_supports(q['spec'], q['tv']))
    sup[1] = sup[1][:-1]                   # drop gp's largest value
    with pytest.raises(ValueError, match='not in the provided support'):
        tg.sweep_blocked_pallas_mixed(*args, supports=tuple(sup))
    p = testing.mixed_problem(128, C, seed=1, kind='niw3_nich_bb')
    spec, py, sh = testing.build_problem(p, MODULES, tmx.make_spec,
                                         tcl.PitmanYor.from_dict)
    tv = tuple(torch.from_numpy(v) for v in p['values'])
    st = tmx.state_from_assignments(spec, py, sh, tv,
                                    torch.from_numpy(p['labels']))
    with pytest.raises(ValueError, match='niw'):
        tg.sweep_blocked_pallas_mixed(spec, py, sh, st, tv,
                                      torch.from_numpy(p['labels']), 128,
                                      torch.Generator())
