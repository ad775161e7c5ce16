"""K1's plain twin (distributions_tpu_torch.ops.fused_kernels) against the
JAX package's fused_score_sample_stats run in Pallas interpret mode, as
the JAX package's own CPU tests run it.  The CUDA kernel itself is held
against the twin on the card by tests/test_torch_cuda.py and
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from distributions_tpu import clustering as jcl, mixture as jmx
from distributions_tpu.models import nich as jnich
from distributions_tpu.ops import pallas_kernels as pk
from distributions_tpu_torch import config
from distributions_tpu_torch import clustering as tcl, convert, testing
from distributions_tpu_torch import mixture as tmx
from distributions_tpu_torch.models import nich as tnich
from distributions_tpu_torch.ops import fused_kernels as fk

torch.set_num_threads(1)
config.set_default_device('cpu')

R, C = 2048, 128
# stat sums: f32 sums of the same rows in another order (tests/
# test_fused_mixed.py holds the JAX kernel to the same tolerance)
SUM_RTOL, SUM_ATOL = 1e-5, 1e-3


@pytest.fixture(scope='module')
def inputs():
    values, labels = testing.nich_problem(R)
    jspec = jmx.make_spec([(jnich, 2)], capacity=C)
    jpy = jcl.PitmanYor.from_dict(testing.PY)
    jsh = (jnich.shared_from_dict(testing.NICH_SHARED),)
    jst = jmx.state_from_assignments(jspec, jpy, jsh, (jnp.asarray(values),),
                                     jnp.asarray(labels))
    jcl_scores = jcl.score_value(jpy, jst.counts, jst.alive, jst.sample_size)
    jco = pk.nich_coeffs_v2(jsh[0], jst.groups[0])
    st = convert.state(jspec, jax.tree_util.tree_map(np.asarray, jst))
    sh = (tnich.shared_from_dict(testing.NICH_SHARED),)
    py = tcl.PitmanYor.from_dict(testing.PY)
    cl_scores = tcl.score_value(py, st.counts, st.alive, st.sample_size)
    co = fk.nich_coeffs_v2(sh[0], st.groups[0])
    return dict(values=values, jspec=jspec, jsh=jsh, jst=jst,
                jcl=jcl_scores, jco=jco, spec=convert.spec(jspec), sh=sh,
                st=st, cl=cl_scores, co=co, py=py)


def _both(p, sampling, noise=None):
    ja, jsums = pk.fused_score_sample_stats(
        0, jnp.asarray(p['values']), p['jcl'], p['jco'], (2,),
        block_rows=256, interpret=True, sampling=sampling,
        noise=None if noise is None else jnp.asarray(noise))
    ta, tsums = fk.fused_score_sample_stats(
        0, torch.from_numpy(p['values']), p['cl'], p['co'], (2,),
        block_rows=256, sampling=sampling,
        noise=None if noise is None else torch.from_numpy(noise))
    assert ta.dtype == torch.int32 and tsums.shape == (C, 6)
    return np.asarray(ja), np.asarray(jsums), ta.numpy(), tsums.numpy()


def test_nich_coeffs_v2(inputs):
    p = inputs
    # f32 posterior algebra with lgamma/log differing by ulps
    np.testing.assert_allclose(p['co'].numpy(), np.asarray(p['jco']),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(p['cl'].numpy(), np.asarray(p['jcl']),
                               rtol=1e-5, atol=1e-5)


def test_nich_coeffs_v2_column_constant_nu():
    shared = tnich.Shared(mu=torch.zeros(2), kappa=torch.ones(2),
                          sigmasq=torch.ones(2),
                          nu=torch.tensor([1.0, 2.0]))
    group = tnich.group_init(shared, (4, 2))
    with pytest.raises(ValueError, match='column-constant nu'):
        fk.nich_coeffs_v2(shared, group)
    ok = shared._replace(nu=torch.tensor([3.0, 3.0]))
    assert fk.nich_coeffs_v2(ok, group).shape == (6, 4)


@pytest.mark.parametrize('sampling', ['argmax', 'argmax_fast'])
def test_argmax_matches_jax(inputs, sampling):
    ja, jsums, ta, tsums = _both(inputs, sampling)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_allclose(tsums, jsums, rtol=SUM_RTOL, atol=SUM_ATOL)


def test_gumbel_host_matches_jax(inputs):
    noise = np.random.RandomState(1).gumbel(size=(R, C)).astype(np.float32)
    ja, jsums, ta, tsums = _both(inputs, 'gumbel_host', noise)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_allclose(tsums, jsums, rtol=SUM_RTOL, atol=SUM_ATOL)


def test_cdf_host_matches_jax(inputs):
    noise = np.random.RandomState(2).rand(R, 1).astype(np.float32)
    ja, jsums, ta, tsums = _both(inputs, 'cdf_host', noise)
    # the TPU kernel rounds p to bf16 before its prefix matmul and the port
    # keeps f32, so a draw within ~2^-9 of a prefix boundary may move
    assert (ta == ja).mean() >= 0.99
    np.testing.assert_array_equal(np.bincount(ta, minlength=C),
                                  np.round(tsums[:, 0]).astype(int))


def test_split_stat_sums(inputs):
    p = inputs
    _, jsums, _, tsums = _both(p, 'argmax')
    jcd, jraw = pk.split_stat_sums(p['jspec'], jsums)
    tcd, traw = fk.split_stat_sums(p['spec'], torch.from_numpy(tsums))
    assert tcd.dtype == torch.int32
    np.testing.assert_array_equal(tcd.numpy(), np.asarray(jcd))
    np.testing.assert_allclose(traw[0].numpy(), np.asarray(jraw[0]),
                               rtol=SUM_RTOL, atol=SUM_ATOL)


def test_mixed_entry_nich_only_branch(inputs):
    p = inputs
    out, sums, tcounts, qsums = fk.fused_mixed_score_sample_stats(
        0, torch.from_numpy(p['values']), None, p['cl'], p['co'], None,
        (2,), sampling='argmax')
    assert tcounts.shape == (C, 0) and qsums.shape == (C, 0)
    ref, ref_sums = fk.fused_score_sample_stats(
        0, torch.from_numpy(p['values']), p['cl'], p['co'], (2,),
        sampling='argmax')
    assert torch.equal(out, ref) and torch.equal(sums, ref_sums)
    # with a table column the call goes to K2 (its twin here): a table of
    # zeros changes no draw, and the count table holds every row once
    idx = torch.from_numpy((np.arange(R) % 2).astype(np.int32))[:, None]
    out2, sums2, tcounts, qsums = fk.fused_mixed_score_sample_stats(
        0, torch.from_numpy(p['values']), idx, p['cl'], p['co'],
        torch.zeros((2, C)), (2,), sampling='argmax', table_vs=(2,))
    assert torch.equal(out2, ref) and torch.equal(sums2, ref_sums)
    assert tcounts.shape == (C, 2) and qsums.shape == (C, 0)
    assert torch.equal(tcounts.sum(1), sums2[:, 0])
    assert float(tcounts[:, 0].sum()) == R // 2


def test_ragged_capacity_dead_padding(inputs):
    """Any C: padding slots with cl = -inf never receive a draw, and the
    draws and sums over the real slots are unchanged."""
    p = inputs
    v = torch.from_numpy(p['values'][:1000])
    Cr = 100
    cl, co = p['cl'][:Cr].clone(), p['co'][:, :Cr].contiguous()
    cl_pad = torch.cat([cl, torch.full((28,), float('-inf'))])
    co_pad = torch.cat([co, co[:, :28]], dim=1)
    u = torch.from_numpy(np.random.RandomState(3).rand(1000, 1).astype(
        np.float32))
    for sampling, noise in (('argmax', None), ('cdf_host', u)):
        a, s = fk.fused_score_sample_stats(5, v, cl, co, (2,),
                                           sampling=sampling, noise=noise)
        a2, s2 = fk.fused_score_sample_stats(5, v, cl_pad, co_pad, (2,),
                                             sampling=sampling, noise=noise)
        assert int(a.max()) < Cr and torch.equal(a, a2)
        assert not s2[Cr:].any()
        np.testing.assert_allclose(s.numpy(), s2[:Cr].numpy(), rtol=1e-6,
                                   atol=1e-5)


@pytest.mark.parametrize('sampling', ['gumbel', 'cdf', 'gumbel_fast'])
def test_twin_rng_modes_match_softmax(inputs, sampling):
    """In-kernel-RNG modes can only match in distribution: slot
    frequencies against the softmax of mixture.score_batch."""
    p = inputs
    v = torch.from_numpy(p['values'])
    a, _ = fk.fused_score_sample_stats(11, v, p['cl'], p['co'], (2,),
                                       sampling=sampling)
    a_again, _ = fk.fused_score_sample_stats(11, v, p['cl'], p['co'], (2,),
                                             sampling=sampling)
    assert torch.equal(a, a_again)
    scores = tmx.score_batch(p['spec'], p['py'], p['sh'], p['st'], (v,))
    assert testing.softmax_ztest(a, scores) < 5.0


def _pallas(fn, x):
    def kernel(x_ref, o_ref):
        o_ref[:, :] = fn(x_ref[:, :])
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True)(jnp.asarray(x)))


def test_fast_log_twin():
    rng = np.random.RandomState(0)
    x = np.exp(rng.uniform(-17, 30, (64, 128))).astype(np.float32)
    got = fk.fast_log(torch.from_numpy(x)).numpy()
    # tests/test_fastmath.py's tolerance against float64 log
    assert np.abs(got - np.log(x.astype(np.float64))).max() < 2e-6
    # and the JAX fast_log itself, to one f32 ulp of the result (the port
    # splits ln 2 so that e * ln 2 is not rounded on its own)
    np.testing.assert_allclose(got, _pallas(pk.fast_log, x), rtol=2.4e-7,
                               atol=1e-6)


def test_fast_exp_twin():
    rng = np.random.RandomState(1)
    x = rng.uniform(-80, 4, (64, 128)).astype(np.float32)
    got = fk.fast_exp(torch.from_numpy(x)).numpy()
    assert np.abs(got / np.exp(x.astype(np.float64)) - 1).max() < 1e-5
    assert np.abs(got / _pallas(pk.fast_exp, x) - 1).max() < 1e-6
    tiny = fk.fast_exp(torch.full((8,), -1e4)).numpy()
    assert np.isfinite(tiny).all() and (tiny >= 0).all() \
        and (tiny < 1e-36).all()


def test_cpu_tensors_use_the_twin(inputs):
    p = inputs
    before = fk.fused_score_sample_stats.launches
    fk.fused_score_sample_stats(0, torch.from_numpy(p['values']), p['cl'],
                                p['co'], (2,), sampling='argmax')
    assert fk.fused_score_sample_stats.launches == before


def test_other_devices_raise(inputs):
    p = inputs
    with pytest.raises(ValueError, match='CPU or CUDA'):
        fk.fused_score_sample_stats(
            0, torch.empty((4, 2), device='meta'), p['cl'], p['co'], (2,),
            sampling='argmax')
    with pytest.raises(ValueError, match='unknown sampling'):
        fk.fused_score_sample_stats(0, torch.from_numpy(p['values']),
                                    p['cl'], p['co'], (2,), sampling='best')
