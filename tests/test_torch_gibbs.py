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


# -- row-by-row initializations ---------------------------------------------

def _set_partitions(n):
    """Every set partition of range(n) as a tuple of label tuples, each
    labelled in order of first appearance."""
    out = [(0,)]
    for _ in range(n - 1):
        out = [p + (k,) for p in out for k in range(max(p) + 2)]
    return out


def _canonical(labels):
    seen = {}
    return tuple(seen.setdefault(int(x), len(seen)) for x in labels)


@pytest.mark.parametrize('alpha,d', [(1.0, 0.1), (0.5, 0.0), (2.0, 0.6)])
def test_prior_init_seating_matches_the_exact_partition_law(alpha, d):
    """`_crp_seating` of 5 rows, 6000 times, against the exact Pitman-Yor
    partition probabilities (EPPF): every one of the 52 set partitions
    within |z| < 5 of its binomial expectation.  Slots fill in order, so a
    row's slot is its table's order of first appearance."""
    n, draws = 5, 6000
    gen = torch.Generator().manual_seed(int(10 * alpha + 100 * d))
    counts = {}
    alive = np.arange(8) < 1
    for _ in range(draws):
        slots = tg._crp_seating(alpha, d, np.zeros(8, np.int64), alive, n,
                                gen)
        assert tuple(slots) == _canonical(slots)
        counts[tuple(slots)] = counts.get(tuple(slots), 0) + 1

    def rising(x, m):
        return float(np.prod([x + i for i in range(m)]))
    worst = 0.0
    for part in _set_partitions(n):
        sizes = np.bincount(part)
        p = (np.prod([alpha + i * d for i in range(1, len(sizes))])
             / rising(alpha + 1.0, n - 1)
             * np.prod([rising(1.0 - d, s - 1) for s in sizes]))
        z = (counts.get(part, 0) - draws * p) / np.sqrt(draws * p * (1 - p))
        worst = max(worst, abs(z))
    assert worst < 5.0, worst


def test_prior_init_seating_on_a_nonempty_state_and_at_capacity():
    """On top of existing counts a row joins slot k with (n_k - d) /
    (n + alpha) (z-test over 4000 single rows), takes any of several
    reserved empties, and at capacity no table opens."""
    gen = torch.Generator().manual_seed(3)
    counts = np.array([5, 0, 2, 0, 0], np.int64)
    alive = np.array([True, True, True, True, False])
    alpha, d, draws = 1.5, 0.2, 4000
    got = np.zeros(5)
    for _ in range(draws):
        got[tg._crp_seating(alpha, d, counts, alive, 1, gen)[0]] += 1
    new = (alpha + 2 * d) / 2
    p = np.array([5 - d, new, 2 - d, new, 0.0]) / (7 + alpha)
    z = (got - draws * p)[p > 0] / np.sqrt(draws * p * (1 - p))[p > 0]
    assert got[4] == 0 and np.abs(z).max() < 5.0, (got, z)
    full = tg._crp_seating(5.0, 0.5, np.zeros(2, np.int64),
                           np.array([True, False]), 200, gen)
    assert set(full) == {0, 1}


def test_prior_init_equals_adding_row_by_row(problem):
    """The state prior_init returns equals `mixture.add_value` of its rows
    one after another (counts and alive exactly, float stats to f32
    tolerance) and `state_from_assignments` of its assignments."""
    p = problem
    tv = (p['tv'][0][:48],)
    st, an = tg.prior_init(p['spec'], p['py'], p['sh'],
                           tmx.init(p['spec'], p['sh']), tv,
                           torch.Generator().manual_seed(5))
    assert an.dtype == torch.int32 and an.shape == (48,)
    assert int(st.counts.sum()) == 48 == int(st.sample_size)
    step = tmx.init(p['spec'], p['sh'])
    for i in range(48):
        step, _ = tmx.add_value(p['spec'], p['py'], p['sh'], step, an[i],
                                (tv[0][i],))
    fresh = tmx.state_from_assignments(p['spec'], p['py'], p['sh'], tv, an)
    for other in (step, fresh):
        assert torch.equal(st.counts, other.counts)
        assert torch.equal(st.alive, other.alive)
        g, w = st.groups[0], other.groups[0]
        assert torch.equal(g.count, w.count)
        np.testing.assert_allclose(g.mean.numpy(), w.mean.numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g.count_times_variance.numpy(),
                                   w.count_times_variance.numpy(),
                                   rtol=1e-4, atol=1e-3)
    # one more alive slot than nonempty ones: the reserved empty
    assert int(st.alive.sum()) == int((st.counts > 0).sum()) + 1


def test_sequential_init_follows_the_data(problem):
    """sequential_init on separated blobs: the state equals
    state_from_assignments of the returned assignments (counts exactly,
    stats to f32 tolerance), and it fits as the JAX package's does."""
    p = problem
    n = 96
    tv = (p['tv'][0][:n],)
    st, an = tg.sequential_init(p['spec'], p['py'], p['sh'],
                                tmx.init(p['spec'], p['sh']), tv,
                                torch.Generator().manual_seed(2))
    assert an.dtype == torch.int32 and int(st.counts.sum()) == n
    fresh = tmx.state_from_assignments(p['spec'], p['py'], p['sh'], tv, an)
    assert torch.equal(st.counts, fresh.counts)
    assert torch.equal(st.alive, fresh.alive)
    np.testing.assert_allclose(st.groups[0].mean.numpy(),
                               fresh.groups[0].mean.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        st.groups[0].count_times_variance.numpy(),
        fresh.groups[0].count_times_variance.numpy(), rtol=1e-4, atol=1e-3)
    # another random stream than the JAX package's, so the two agree in
    # fit only: score_data of the initialized state within 20% (four seeds
    # of either package spread over about 10% on this data)
    jst, _ = jg.sequential_init(p['jspec'], p['jpy'], p['jsh'],
                                jmx.init(p['jspec'], p['jsh']),
                                (p['jv'][0][:n],), jax.random.PRNGKey(2))
    got = float(tmx.score_data(p['spec'], p['py'], p['sh'], st))
    want = float(jmx.score_data(p['jspec'], p['jpy'], p['jsh'], jst))
    assert abs(got - want) < 0.2 * abs(want), (got, want)
