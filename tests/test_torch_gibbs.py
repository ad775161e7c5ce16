"""The port's sweeps against distributions_tpu.ops.gibbs.

On the CPU the JAX package runs K1 only through the runner's entry point,
`sweep_blocked_pallas_fused_mixed` (which picks Pallas interpret mode
there; `sweep_blocked_pallas_fused` asks for the compiled TPU kernel).  For
a nich-only spec it runs the same v2 kernel, so it is the reference for
the port's `sweep_blocked_pallas_fused` (n_sweeps=1) and
`run_sweeps_pallas_fused` (n_sweeps=2); under 'argmax' the keys do not
enter the draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributions_tpu import clustering as jcl, mixture as jmx
from distributions_tpu.models import nich as jnich
from distributions_tpu.ops import gibbs as jg
from distributions_tpu_torch import config
from distributions_tpu_torch import convert, mixture as tmx, testing
from distributions_tpu_torch.ops import gibbs as tg

torch.set_num_threads(1)
config.set_default_device('cpu')

R, C, BLOCK = 2048, 128, 512
SUM_RTOL, SUM_ATOL = 1e-5, 1e-3


@pytest.fixture(scope='module')
def problem():
    values, labels = testing.nich_problem(R)
    jspec = jmx.make_spec([(jnich, 2)], capacity=C)
    jpy = jcl.PitmanYor.from_dict(testing.PY)
    jsh = (jnich.shared_from_dict(testing.NICH_SHARED),)
    jv = (jnp.asarray(values),)
    jst = jmx.state_from_assignments(jspec, jpy, jsh, jv, jnp.asarray(labels))
    spec = convert.spec(jspec)
    py = convert.cl_model(jax.tree_util.tree_map(np.asarray, jpy))
    sh = convert.shareds(jspec, jax.tree_util.tree_map(np.asarray, jsh))
    tv = (torch.from_numpy(values),)
    st = tmx.state_from_assignments(spec, py, sh, tv,
                                    torch.from_numpy(labels))
    return dict(labels=labels, jspec=jspec, jpy=jpy, jsh=jsh, jv=jv, jst=jst,
                spec=spec, py=py, sh=sh, tv=tv, st=st)


def _cache_close(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=SUM_RTOL,
                                   atol=SUM_ATOL)


def test_build_stat_cache(problem):
    p = problem
    want = jg.build_stat_cache(p['jspec'], p['jsh'], p['jv'], BLOCK,
                               jnp.asarray(p['labels']))
    got = tg.build_stat_cache(p['spec'], p['sh'], p['tv'], BLOCK,
                              torch.from_numpy(p['labels']))
    assert got[0].shape == (R // BLOCK, C) and got[0].dtype == torch.int32
    _cache_close(got, want)


@pytest.mark.parametrize('n_sweeps', [1, 2])
def test_fused_sweeps_argmax_match_jax(problem, n_sweeps):
    p = problem
    a0 = jnp.asarray(p['labels'])
    jcache = jg.build_stat_cache(p['jspec'], p['jsh'], p['jv'], BLOCK, a0)
    jst, jan, _ = jg.sweep_blocked_pallas_fused_mixed(
        p['jspec'], p['jpy'], p['jsh'], p['jst'], p['jv'], a0, BLOCK, 256,
        jax.random.PRNGKey(0), jcache, sampling='argmax', n_sweeps=n_sweeps)

    t0 = torch.from_numpy(p['labels'])
    cache = tg.build_stat_cache(p['spec'], p['sh'], p['tv'], BLOCK, t0)
    gen = torch.Generator().manual_seed(0)
    if n_sweeps == 1:
        st, an, cache = tg.sweep_blocked_pallas_fused(
            p['spec'], p['py'], p['sh'], p['st'], p['tv'], t0, BLOCK, 256,
            gen, cache, sampling='argmax')
    else:
        st, an, cache = tg.run_sweeps_pallas_fused(
            p['spec'], p['py'], p['sh'], p['st'], p['tv'], t0, BLOCK, 256,
            gen, cache, n_sweeps, sampling='argmax')
    assert an.dtype == torch.int32
    np.testing.assert_array_equal(an.numpy(), np.asarray(jan))
    np.testing.assert_array_equal(st.counts.numpy(), np.asarray(jst.counts))
    # the emitted cache equals a fresh one on the new assignments
    _cache_close(cache, jg.build_stat_cache(p['jspec'], p['jsh'], p['jv'],
                                            BLOCK, jan))


def test_plain_sweep_blocked_fit_matches_jax(problem):
    """Different random streams, so the plain sweeps can only agree in
    fit: score_data after 5 sweeps within 5% (the analog of
    tests/test_tpu_pallas.py::test_pallas_sweep_matches_xla_statistically)."""
    p = problem
    jst, jan = p['jst'], jnp.asarray(p['labels'])
    key = jax.random.PRNGKey(0)
    st, an = p['st'], torch.from_numpy(p['labels'])
    gen = torch.Generator().manual_seed(0)
    for _ in range(5):
        key, sub = jax.random.split(key)
        jst, jan = jg.sweep_blocked(p['jspec'], p['jpy'], p['jsh'], jst,
                                    p['jv'], jan, BLOCK, key=sub)
        st, an = tg.sweep_blocked(p['spec'], p['py'], p['sh'], st, p['tv'],
                                  an, BLOCK, generator=gen)
    sj = float(jmx.score_data(p['jspec'], p['jpy'], p['jsh'], jst))
    st_score = float(tmx.score_data(p['spec'], p['py'], p['sh'], st))
    assert abs(st_score - sj) / abs(sj) < 0.05, (st_score, sj)
    assert int(st.counts.sum()) == R
    np.testing.assert_array_equal(
        np.bincount(an.numpy(), minlength=C), st.counts.numpy())


@pytest.mark.parametrize('sampling', ['gumbel_host', 'cdf_host', 'gumbel',
                                      'cdf_fast'])
def test_fused_sweep_sampling_modes(problem, sampling):
    """Every sampling mode keeps state, assignments and cache consistent,
    and one generator seed gives one chain."""
    p = problem
    t0 = torch.from_numpy(p['labels'])
    runs = []
    for _ in range(2):
        cache = tg.build_stat_cache(p['spec'], p['sh'], p['tv'], BLOCK, t0)
        runs.append(tg.sweep_blocked_pallas_fused(
            p['spec'], p['py'], p['sh'], p['st'], p['tv'], t0, BLOCK, 256,
            torch.Generator().manual_seed(3), cache, sampling=sampling))
    (st, an, cache), (_, an2, _) = runs
    assert torch.equal(an, an2)
    np.testing.assert_array_equal(np.bincount(an.numpy(), minlength=C),
                                  st.counts.numpy())
    fresh = tg.build_stat_cache(p['spec'], p['sh'], p['tv'], BLOCK, an)
    assert torch.equal(cache[0], fresh[0])
    np.testing.assert_allclose(cache[1][0].numpy(), fresh[1][0].numpy(),
                               rtol=SUM_RTOL, atol=SUM_ATOL)


def test_fused_sweep_rejects_ragged_rows(problem):
    p = problem
    t0 = torch.from_numpy(p['labels'])
    cache = tg.build_stat_cache(p['spec'], p['sh'], p['tv'], BLOCK, t0)
    with pytest.raises(ValueError, match='multiple of the block'):
        tg.sweep_blocked_pallas_fused(
            p['spec'], p['py'], p['sh'], p['st'], p['tv'], t0, 1000, 256,
            torch.Generator(), cache, sampling='argmax')
