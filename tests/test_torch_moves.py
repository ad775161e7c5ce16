"""The port's other Gibbs moves (distributions_tpu_torch.ops: the sequential
sweep, the MH sweep, chains, the slow tile branch) and the mixture helpers
they use, against the JAX package: deterministic pieces on the same numpy
inputs through both packages, and the moves by exact enumeration of the
posterior of a tiny problem, as tests/test_gibbs_stationary.py and
tests/test_mh.py check the JAX moves."""

import functools
import importlib
import types
from collections import Counter
from itertools import product

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributions_tpu import clustering as jcl, mixture as jmx
from distributions_tpu.ops import gibbs as jg, mh as jmh
from distributions_tpu_torch import clustering as tcl, config, convert
from distributions_tpu_torch import mixture as tmx, testing
from distributions_tpu_torch.models import MODULES, bb, nich
from distributions_tpu_torch.ops import gibbs as tg, mh

torch.set_num_threads(1)
config.set_default_device('cpu')

# the same f32 formulas; lgamma, log and log1p differ by ulps between torch
# and XLA; float stats summed in another order: rtol 1e-5 / atol 1e-3, as
# the port's sharded stats
RTOL, ATOL = 1e-5, 1e-5
STAT_RTOL, STAT_ATOL = 1e-5, 1e-3
KINDS = ('nich_gp_bb', 'dd_bb', 'niw2', 'dpd_nich', 'bnb')
JAX_MODELS = {name: importlib.import_module('distributions_tpu.models.'
                                            + name) for name in MODULES}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _problem(kind, R=64, C=16):
    p = testing.mixed_problem(R, C, seed=3, kind=kind)
    jspec, jpy, jsh = testing.build_problem(
        p, JAX_MODELS, jmx.make_spec, jcl.PitmanYor.from_dict)
    jv = tuple(jnp.asarray(v) for v in p['values'])
    ja = jnp.asarray(p['labels'])
    jst = jax.jit(lambda v, a: jmx.state_from_assignments(
        jspec, jpy, jsh, v, a))(jv, ja)
    return dict(jspec=jspec, jpy=jpy, jsh=jsh, jv=jv, ja=ja, jst=jst,
                spec=convert.spec(jspec), py=convert.cl_model(_np(jpy)),
                sh=convert.shareds(jspec, _np(jsh)),
                tv=tuple(torch.from_numpy(v) for v in p['values']),
                st=convert.state(jspec, _np(jst)),
                ta=torch.from_numpy(p['labels']))


def _leaves_close(got, want, rtol, atol):
    for w, g in zip(jax.tree_util.tree_leaves(_np(want)),
                    [x for grp in got for x in grp]):
        np.testing.assert_allclose(w, g.numpy(), rtol=rtol, atol=atol)


def _state_close(got, want):
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
    assert int(got.sample_size) == int(want.sample_size)
    _leaves_close(got.groups, want.groups, STAT_RTOL, STAT_ATOL)


# -- deterministic pieces against the JAX package ---------------------------

@pytest.mark.parametrize('kind', KINDS)
def test_group_counts_and_tile_deltas_match_jax(kind):
    q = _problem(kind)
    assert int(tmx.group_count(q['st'])) == int(jmx.group_count(q['jst']))
    assert int(tmx.nonempty_group_count(q['st'])) == int(
        jmx.nonempty_group_count(q['jst']))
    sl = slice(16, 48)
    new = np.asarray(q['ja'])[sl][::-1].copy()
    jdeltas = jax.jit(lambda v, a: jmx.tile_deltas(q['jspec'], q['jsh'], v,
                                                   a))
    japply = jax.jit(lambda st, cd, tiles, sign: jmx.apply_tile_deltas(
        q['jspec'], q['jsh'], st, cd, tiles, sign, 32), static_argnums=3)
    jcd, jtiles = jdeltas(tuple(v[sl] for v in q['jv']), q['ja'][sl])
    cd, tiles = tmx.tile_deltas(q['spec'], q['sh'],
                                tuple(v[sl] for v in q['tv']), q['ta'][sl])
    np.testing.assert_array_equal(cd.numpy(), np.asarray(jcd))
    _leaves_close(tiles, jtiles, STAT_RTOL, STAT_ATOL)
    # remove the rows, then add them back under other slots
    jst = japply(q['jst'], jcd, jtiles, -1)
    st = tmx.apply_stat_tiles(q['spec'], q['sh'], q['st'], cd, tiles, -1,
                              32)
    _state_close(st, jst)
    jcd, jtiles = jdeltas(tuple(v[sl] for v in q['jv']), jnp.asarray(new))
    cd, tiles = tmx.tile_deltas(q['spec'], q['sh'],
                                tuple(v[sl] for v in q['tv']),
                                torch.from_numpy(new))
    _state_close(tmx.apply_stat_tiles(q['spec'], q['sh'], st, cd, tiles, +1,
                                      32),
                 japply(jst, jcd, jtiles, +1))


@pytest.mark.parametrize('kind', KINDS)
def test_mh_row_slot_score_matches_jax(kind):
    """`mh._row_slot_score` of every row at a random slot (the port scores
    all rows in one call) equals the JAX function of one row, vmapped over
    the rows."""
    q = _problem(kind)
    k = np.random.RandomState(0).randint(0, 16, 64)
    jcls = jcl.score_value(q['jpy'], q['jst'].counts, q['jst'].alive,
                           q['jst'].sample_size)
    want = np.asarray(jax.jit(jax.vmap(
        lambda row, kk: jmh._row_slot_score(q['jspec'], q['jpy'], q['jsh'],
                                            q['jst'], jcls, row, kk)))(
        q['jv'], jnp.asarray(k)))
    cls = tcl.score_value(q['py'], q['st'].counts, q['st'].alive,
                          q['st'].sample_size)
    got = mh._row_slot_score(q['spec'], q['py'], q['sh'], q['st'], cls,
                             q['tv'], torch.from_numpy(k)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    # the models' predictive scores: tests/test_torch_models.py's atol 1e-4
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=1e-4)


def _without_row_stats(module):
    """A view of a model module without row-stat columns: it sends
    `sweep_blocked` down its slow branch."""
    view = types.ModuleType(module.__name__ + '_no_row_stats')
    for name in dir(module):
        if name not in ('row_stat_columns', 'row_stats_to_tile'):
            setattr(view, name, getattr(module, name))
    return view


def test_sweep_blocked_slow_branch():
    """A model without row-stat columns takes `sweep_blocked`'s slow
    branch (`tile_deltas` from the values): it draws what the
    fast branch draws from the same generator, and leaves a state equal to
    `state_from_assignments` of its draws."""
    values, labels = testing.nich_problem(256, seed=2, n_clusters=4)
    tv = (torch.from_numpy(values),)
    ta = torch.from_numpy(labels)
    py = tcl.PitmanYor.from_dict(testing.PY)
    slow_mod = _without_row_stats(nich)
    outs = []
    for module in (nich, slow_mod):
        spec = tmx.make_spec([(module, 2)], capacity=16)
        sh = (module.shared_from_dict(testing.NICH_SHARED),)
        assert tmx.supports_row_stats(spec) == (module is nich)
        st = tmx.state_from_assignments(spec, py, sh, tv, ta)
        gen = torch.Generator().manual_seed(5)
        an = ta
        for _ in range(3):
            st, an = tg.sweep_blocked(spec, py, sh, st, tv, an, 64,
                                      generator=gen)
        fresh = tmx.state_from_assignments(spec, py, sh, tv, an)
        assert torch.equal(st.counts, fresh.counts)
        np.testing.assert_allclose(st.groups[0].mean.numpy(),
                                   fresh.groups[0].mean.numpy(),
                                   rtol=STAT_RTOL, atol=STAT_ATOL)
        outs.append(an)
    assert torch.equal(outs[0], outs[1])


def test_chains_equal_lone_sweeps_and_init_matches_jax():
    """`sweep_blocked_chains` with one generator per chain equals each
    chain's own `sweep_blocked`; `init_chains` stacks the states the JAX
    function stacks."""
    q = _problem('nich_gp_bb')
    rng = np.random.RandomState(1)
    A = np.stack([np.asarray(q['ja']), rng.randint(0, 8, 64),
                  rng.randint(0, 3, 64)]).astype(np.int32)
    jstates = jg.init_chains(q['jspec'], q['jpy'], q['jsh'], q['jv'],
                             jnp.asarray(A))
    states = tg.init_chains(q['spec'], q['py'], q['sh'], q['tv'],
                            torch.from_numpy(A))
    np.testing.assert_array_equal(states.counts.numpy(),
                                  np.asarray(jstates.counts))
    _leaves_close(states.groups, jstates.groups, STAT_RTOL, STAT_ATOL)
    gens = [torch.Generator().manual_seed(10 + c) for c in range(3)]
    out_st, out_an = tg.sweep_blocked_chains(
        q['spec'], q['py'], q['sh'], states, q['tv'], torch.from_numpy(A),
        16, gens)
    assert out_an.shape == (3, 64) and out_st.counts.shape == (3, 16)
    for c in range(3):
        st, an = tg.sweep_blocked(
            q['spec'], q['py'], q['sh'], tg._chain_take(states, c), q['tv'],
            torch.from_numpy(A[c]), 16,
            generator=torch.Generator().manual_seed(10 + c))
        assert torch.equal(out_an[c], an)
        assert torch.equal(out_st.counts[c], st.counts)
    with pytest.raises(ValueError, match='one generator per chain'):
        tg.sweep_blocked_chains(q['spec'], q['py'], q['sh'], states, q['tv'],
                                torch.from_numpy(A), 16, gens[:2])


# -- exact enumeration (tests/test_gibbs_stationary.py's tiny problem) ------

R, C = 4, 6
PY = tcl.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.0})
SHAREDS = (bb.shared_from_dict({'alpha': 1.0, 'beta': 1.0}),)
SPEC = tmx.make_spec([(bb, 1)], capacity=C, empties=1)
VALUES = (torch.tensor([[True], [True], [False], [False]]),)


def canonical(assign):
    seen = {}
    return tuple(seen.setdefault(a, len(seen)) for a in assign)


@functools.lru_cache(maxsize=None)
def exact_posterior():
    """p(partition) ~ exp(score_data), the JAX package's score_data
    enumerated over the partitions of 4 rows."""
    jspec = jmx.make_spec([(JAX_MODELS['bb'], 1)], capacity=C, empties=1)
    jpy = jcl.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.0})
    jsh = (JAX_MODELS['bb'].shared_from_dict({'alpha': 1.0, 'beta': 1.0}),)
    jv = (jnp.asarray(VALUES[0].numpy()),)
    score = jax.jit(lambda a: jmx.score_data(
        jspec, jpy, jsh, jmx.state_from_assignments(jspec, jpy, jsh, jv, a)))
    scores = {}
    for assign in product(range(R), repeat=R):
        c = canonical(assign)
        if c not in scores:
            scores[c] = float(score(jnp.asarray(c, jnp.int32)))
    top = max(scores.values())
    total = sum(np.exp(s - top) for s in scores.values())
    return {c: np.exp(s - top) / total for c, s in scores.items()}


def run_chain(step, n, seed=0):
    """n steps of `step(state, assignments, generator)` from one cluster;
    the trace of canonical partitions.  Every step leaves the state equal
    to state_from_assignments of its assignments (checked at the end).
    The steps run in inference mode: no autograd bookkeeping on the
    thousands of small ops."""
    gen = torch.Generator().manual_seed(seed)
    an = torch.zeros(R, dtype=torch.int32)
    st = tmx.state_from_assignments(SPEC, PY, SHAREDS, VALUES, an)
    trace = []
    with torch.inference_mode():
        for _ in range(n):
            st, an = step(st, an, gen)
            trace.append(canonical(an.tolist()))
    fresh = tmx.state_from_assignments(SPEC, PY, SHAREDS, VALUES, an)
    assert torch.equal(st.counts, fresh.counts)
    assert torch.equal(st.groups[0].heads, fresh.groups[0].heads)
    return trace


def total_variation(trace, burn, thin):
    counts = Counter(trace[burn::thin])
    n = sum(counts.values())
    post = exact_posterior()
    return 0.5 * sum(abs(counts.get(k, 0) / n - post.get(k, 0.0))
                     for k in set(counts) | set(post))


def test_sequential_sweep_stationary():
    """Exact collapsed Gibbs: the chain's partitions follow the
    enumerated posterior (tests/test_gibbs_stationary.py's bound).  Every
    sweep after a burn-in of 100 is kept: successive sweeps of 4 rows are
    nearly independent, and 1900 unthinned sweeps hold the TV as low as
    4000 sweeps thinned by 2."""
    trace = run_chain(lambda st, an, g: tg.sweep_sequential(
        SPEC, PY, SHAREDS, st, VALUES, an, g), 2000)
    tv = total_variation(trace, 100, 1)
    assert tv < 0.05, tv


def test_mh_sweep_stationary():
    """MH with block 1 targets the exact conditional; it mixes more
    slowly than Gibbs, hence tests/test_mh.py's looser bound 0.08 (2000
    sweeps unthinned here, 6000 thinned by 2 there; an MH step without
    the proposal correction gives a TV above 0.4)."""
    trace = run_chain(lambda st, an, g: mh.sweep_mh(
        SPEC, PY, SHAREDS, st, VALUES, an, 1, mh_steps=8, generator=g), 2000)
    tv = total_variation(trace, 100, 1)
    assert tv < 0.08, tv


def test_mh_sweep_recovers_clusters():
    rng = np.random.RandomState(0)
    Rn = 128
    spec = tmx.make_spec([(nich, 2)], capacity=16, empties=1)
    sh = (nich.shared_from_dict({'mu': 0., 'kappa': 0.1, 'sigmasq': 1.0,
                                 'nu': 1.}),)
    centers = np.array([[-2., -2.], [2., 2.], [-2., 2.]])
    labels = rng.randint(0, 3, Rn)
    values = (torch.from_numpy((centers[labels] + 0.25 * rng.randn(Rn, 2))
                               .astype(np.float32)),)
    cl = tcl.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.1})
    an = torch.from_numpy(rng.randint(0, 8, Rn).astype(np.int32))
    st = tmx.state_from_assignments(spec, cl, sh, values, an)
    gen = torch.Generator().manual_seed(1)
    for _ in range(60):
        st, an = mh.sweep_mh(spec, cl, sh, st, values, an, 32, mh_steps=8,
                             generator=gen, proposal_beta=4.0)
    a = an.numpy()
    assert np.bincount(a, minlength=16).tolist() == st.counts.tolist()
    purity = sum(np.bincount(labels[a == k]).max()
                 for k in np.unique(a)) / Rn
    assert purity > 0.9, purity
