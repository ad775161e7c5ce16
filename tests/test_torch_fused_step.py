"""The fused runner step as the port runs it on the card
(`gibbs._fused_sweep_into`, which a CUDA graph replays there), run eagerly
on the kernels' twins on the CPU:

- bitwise the eager loop it replaced (a frozen copy below), for nich2 (K1)
  and niw2mix (K2) in 'gumbel', 'argmax' and 'cdf', with and without the
  step's score;
- capturable: between the kernel launches it reads nothing back from the
  device and makes no tensor from host data (checked op by op);
- seeded as before: `random.sweep_seeds` consumes the generator as the
  loop did, and the twins draw alike from an int seed and from the
  1-element int64 tensor that the graph passes;
- equal to the JAX package's `_fused_mixed_run` in 'argmax' and
  'gumbel_host' (interpret-mode Pallas on the CPU, the same noise).

The graph itself (capture, replay, fresh seeds, growth, hyper moves) needs
the card: tests/test_torch_cuda.py.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributions_tpu import clustering as jcl, mixture as jmx
from distributions_tpu.ops import gibbs as jg
from distributions_tpu_torch import clustering as tcl, config
from distributions_tpu_torch import mixture as tmx, testing
from distributions_tpu_torch.models import MODULES, nich
from distributions_tpu_torch.ops import fused_kernels as fk, gibbs as tg
from distributions_tpu_torch.random import draw_seed, fold_seed, sweep_seeds

torch.set_num_threads(1)
config.set_default_device('cpu')

R, C, BLOCK, BLOCK_ROWS = 256, 32, 64, 32
JAX_MODELS = {name: importlib.import_module('distributions_tpu.models.'
                                            + name) for name in MODULES}


def _problem(kind, capacity=C, prior=None):
    """(spec, clustering model, shareds, values, labels) of a small seeded
    problem: nich2 (2 nich columns, K1) or a `testing.MIXED_KINDS` layout
    (K2)."""
    py = tcl.PitmanYor.from_dict(testing.PY)
    if kind == 'nich2':
        X, labels = testing.nich_problem(R, cols=2, n_clusters=6, seed=3)
        spec = tmx.make_spec([(nich, 2)], capacity=capacity)
        sh = (nich.shared_from_dict(testing.NICH_SHARED),)
        values = (torch.from_numpy(X),)
    else:
        p = testing.mixed_problem(R, capacity, seed=1, kind=kind,
                                  n_clusters=5)
        spec, py, sh = testing.build_problem(p, MODULES, tmx.make_spec,
                                             tcl.PitmanYor.from_dict)
        values = tuple(torch.from_numpy(v) for v in p['values'])
        labels = p['labels']
    if prior == 'le':
        py = tcl.LowEntropy.from_dict({'dataset_size': R})
    return spec, py, sh, values, torch.from_numpy(labels)


def _bits(tree):
    """The bytes of every tensor of a nested result, in order."""
    return [t.reshape(-1).view(torch.uint8).numpy().tobytes()
            for t in tg._tensors(tuple(tree))]


# -- the eager loop this PR replaced, frozen --------------------------------

def _old_sweep(spec, lay, W, cl_model, shareds, state, block, block_rows,
               sampling, cache, sweep_seed):
    cached_cd, cached_sums = cache
    out, out_cd = [], []
    out_sums = [[] for _ in spec.blocks]
    for t in range(cached_cd.shape[0]):
        tiles = tmx.sums_to_tiles(spec, shareds,
                                  tuple(s[t] for s in cached_sums))
        state = tmx.apply_stat_tiles(spec, shareds, state, cached_cd[t],
                                     tiles, -1, block)
        seed = fold_seed(sweep_seed, t)
        noise = tg._tile_noise(sampling, seed, block, spec.capacity,
                               cached_cd.device)
        new_assign, new_cd, new_sums = tg._fused_tile_core(
            spec, lay, W, block_rows, sampling, cl_model, shareds, state,
            *tg._slice_rows(lay, t, block), seed, noise=noise)
        tiles = tmx.sums_to_tiles(spec, shareds, new_sums)
        state = tmx.apply_stat_tiles(spec, shareds, state, new_cd, tiles,
                                     +1, block)
        out.append(new_assign)
        out_cd.append(new_cd)
        for acc, s in zip(out_sums, new_sums):
            acc.append(s)
    return state, torch.cat(out), (torch.stack(out_cd),
                                   tuple(torch.stack(s) for s in out_sums))


def _old_run(spec, cl_model, shareds, state, values, assignments, generator,
             cache, sampling, n_sweeps, with_score):
    lay = tg._mixed_static_layout(spec, values)
    W = tg._stat_matrices(spec, lay, shareds)
    for _ in range(n_sweeps):
        state, assignments, cache = _old_sweep(
            spec, lay, W, cl_model, shareds, state, BLOCK, BLOCK_ROWS,
            sampling, cache, draw_seed(generator))
    if with_score:
        return state, assignments, cache, tmx.score_data(spec, cl_model,
                                                         shareds, state)
    return state, assignments, cache


@pytest.mark.parametrize('with_score', [False, True])
@pytest.mark.parametrize('sampling', ['gumbel', 'argmax', 'cdf'])
@pytest.mark.parametrize('kind', ['nich2', 'niw2mix'])
def test_step_is_bitwise_the_old_eager_loop(kind, sampling, with_score):
    """Three sweeps of the public entry point (on the CPU: the static
    sweep, run eagerly) equal the replaced loop bitwise: assignments,
    state, stat cache and score; the inputs are not written.  Exact: the
    same ops on the same operands.  The tensor seeds of the graph path are
    held by test_twins_take_the_seed_tensor and
    test_static_sweep_reads_nothing_back."""
    spec, py, sh, values, labels = _problem(kind)
    st = tmx.state_from_assignments(spec, py, sh, values, labels)
    cache = tg.build_stat_cache(spec, sh, values, BLOCK, labels)
    before = _bits((st, labels, cache))
    got = tg.sweep_blocked_pallas_fused_mixed(
        spec, py, sh, st, values, labels, BLOCK, BLOCK_ROWS,
        torch.Generator().manual_seed(5), cache, sampling=sampling,
        n_sweeps=3, with_score=with_score)
    want = _old_run(spec, py, sh, st, values, labels,
                    torch.Generator().manual_seed(5), cache, sampling, 3,
                    with_score)
    assert len(got) == len(want) and _bits(got) == _bits(want)
    assert got[1].dtype == torch.int32
    assert _bits((st, labels, cache)) == before
    if kind == 'nich2' and not with_score:
        assert _bits(tg.run_sweeps_pallas_fused(
            spec, py, sh, st, values, labels, BLOCK, BLOCK_ROWS,
            torch.Generator().manual_seed(5), cache, 3,
            sampling=sampling)) == _bits(want)


def test_sweep_seeds_consume_the_generator_as_the_loop():
    """sweep_seeds(generator, T) is the loop's draw_seed then fold_seed
    per tile, and leaves the generator where the loop left it."""
    a, b = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    for _ in range(3):
        seeds = sweep_seeds(a, 5)
        s = draw_seed(b)
        assert seeds.dtype == torch.int64 and seeds.tolist() == [
            fold_seed(s, t) for t in range(5)]
        assert torch.equal(a.get_state(), b.get_state())


@pytest.mark.parametrize('sampling', ['gumbel', 'cdf', 'gumbel_fast'])
@pytest.mark.parametrize('kernel', ['K1', 'K2'])
def test_twins_take_the_seed_tensor(kernel, sampling):
    """The twins draw alike from an int seed and from the 1-element int64
    tensor holding its 64 bits (the top bit set here); an int64 tensor of
    another size is refused.  Exact."""
    spec, py, sh, values, labels = _problem('nich2' if kernel == 'K1'
                                            else 'niw2mix')
    st = tmx.state_from_assignments(spec, py, sh, values, labels)
    lay = tg._mixed_static_layout(spec, values)
    cls, co, qco, tab = tg._fused_tile_inputs(spec, lay, py, sh, st)
    seed = 0xF123456789ABCDEF

    def launch(s):
        if kernel == 'K1':
            return fk.fused_score_sample_stats(s, lay.nich_vals, cls, co,
                                               (2,), sampling=sampling)
        return fk.fused_mixed_score_sample_stats(
            s, lay.nich_vals, lay.table_idx, cls, co, tab, (1,),
            sampling=sampling, qvalues=lay.quad_vals, qcoeffs=qco,
            quad_groups=lay.quad_groups, table_vs=lay.table_vs)
    assert _bits(launch(seed)) == _bits(launch(torch.tensor(
        [seed - (1 << 64)])))
    assert _bits(launch(7)) == _bits(launch(torch.tensor(7)))
    with pytest.raises(ValueError, match='one int64'):
        launch(torch.tensor([7, 8]))


# -- capturable: nothing between the launches reads the device -------------

@pytest.mark.parametrize('kind,prior', [('nich2', 'py'), ('niw2mix', 'py'),
                                        ('bbddgp', 'py'), ('dpd_nich', 'py'),
                                        ('nich2', 'le'), ('niw2mix', 'le'),
                                        ('niw5', 'py'), ('niw16', 'py')])
def test_static_sweep_reads_nothing_back(kind, prior, monkeypatch):
    """`_fused_sweep_into` and the step's score_data, run a second time
    (the first is the capture's warm-up), run no op outside the kernel
    wrappers that would read the card or copy from the host inside a
    CUDA graph capture.  The wrappers' own host work differs on the card
    (there they take the seed's address) and is left out."""
    spec, py, sh, values, labels = _problem(kind, prior=prior)
    st = tmx.state_from_assignments(spec, py, sh, values, labels)
    lay = tg._mixed_static_layout(spec, values)
    W = tg._stat_matrices(spec, lay, sh)
    state, an, cache = tg._map_tensors(torch.clone, (
        st, labels, tg.build_stat_cache(spec, sh, values, BLOCK, labels)))
    seeds = sweep_seeds(torch.Generator().manual_seed(0), R // BLOCK)

    def step():
        tg._fused_sweep_into(spec, lay, W, BLOCK, BLOCK_ROWS, 'gumbel', py,
                             sh, state, an, cache, seeds)
        return tmx.score_data(spec, py, sh, state)
    step()
    inputs = (py, sh, W, state, an, cache, seeds, lay.nich_vals,
              lay.quad_vals, lay.table_idx, lay.supports,
              tuple(tcl._LOG_PARTITION_TABLES.values()))
    mode = testing.HostReads(t.untyped_storage().data_ptr()
                      for t in tg._tensors(inputs))
    for name in ('fused_score_sample_stats',
                 'fused_mixed_score_sample_stats'):
        wrapper = getattr(fk, name)

        def paused(*a, _w=wrapper, **k):
            mode.paused = True
            try:
                return _w(*a, **k)
            finally:
                mode.paused = False
        monkeypatch.setattr(fk, name, paused)
    with mode:
        step()
    assert mode.found == []


# -- against the JAX package -------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_problem():
    """niw2mix at 128 slots (the JAX kernel's lane width) in both packages,
    the JAX state and stat cache made from the port's (the same inputs,
    and no eager JAX ops to compile)."""
    p = testing.mixed_problem(R, 128, seed=1, kind='niw2mix', n_clusters=5)
    jspec, jpy, jsh = testing.build_problem(
        p, JAX_MODELS, jmx.make_spec, jcl.PitmanYor.from_dict)
    spec, py, sh = testing.build_problem(p, MODULES, tmx.make_spec,
                                         tcl.PitmanYor.from_dict)
    tv = tuple(torch.from_numpy(v) for v in p['values'])
    ta = torch.from_numpy(p['labels'])
    st = tmx.state_from_assignments(spec, py, sh, tv, ta)
    cache = tg.build_stat_cache(spec, sh, tv, BLOCK, ta)

    def to_jax(like, tree):
        return jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(like),
            [jnp.asarray(t.numpy()) for t in tg._tensors(tree)])
    jst = to_jax(jmx.MixtureState(
        counts=0, alive=0, sample_size=0, groups=tuple(
            JAX_MODELS[name].Group(*(0,) * len(g))
            for (name, _, _, _), g in zip(p['blocks'], st.groups))), st)
    jcache = (jnp.asarray(cache[0].numpy()),
              tuple(jnp.asarray(x.numpy()) for x in cache[1]))
    return (jspec, jpy, jsh, tuple(jnp.asarray(v) for v in p['values']),
            jnp.asarray(p['labels']), jst, jcache,
            (spec, py, sh, st, tv, ta, cache))


@pytest.mark.parametrize('sampling', ['argmax', 'gumbel_host'])
def test_step_matches_jax_fused_mixed_run(sampling, monkeypatch):
    """sweep_blocked_pallas_fused_mixed(n_sweeps=3, with_score=True)
    against the JAX package's `_fused_mixed_run` (interpret-mode Pallas),
    on niw2mix (K2), 4 tiles a sweep, from the same state and stat cache.
    In 'gumbel_host' the port's tiles take the JAX run's noise, in its
    order (sweep keys split from the key, tile keys from each).
    Assignments, counts and cached counts exactly equal; cached stat sums
    within rtol 1e-5 / atol 1e-3 and the score within rtol 1e-5 (f32 sums
    in another order, as tests/test_torch_gibbs.py holds them)."""
    jspec, jpy, jsh, jv, ja, jst, jcache, port = _jax_problem()
    key = jax.random.PRNGKey(4)
    jst2, jan, jcache2, jscore = jg.sweep_blocked_pallas_fused_mixed(
        jspec, jpy, jsh, jst, jv, ja, BLOCK, BLOCK_ROWS, key, jcache,
        sampling=sampling, n_sweeps=3, with_score=True)

    noise = []
    if sampling == 'gumbel_host':
        for sweep_key in jax.random.split(key, 3):
            for tile_key in jax.random.split(sweep_key, R // BLOCK):
                noise.append(torch.from_numpy(np.array(jax.random.gumbel(
                    tile_key, (BLOCK, 128), jnp.float32))))
    monkeypatch.setattr(tg, '_tile_noise', lambda s, *a: (
        noise.pop(0) if '_host' in s else None))
    spec, py, sh, st, tv, ta, cache = port
    out = tg.sweep_blocked_pallas_fused_mixed(
        spec, py, sh, st, tv, ta, BLOCK, BLOCK_ROWS,
        torch.Generator().manual_seed(0), cache, sampling=sampling,
        n_sweeps=3, with_score=True)
    assert noise == []
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(jan))
    np.testing.assert_array_equal(out[0].counts.numpy(),
                                  np.asarray(jst2.counts))
    np.testing.assert_array_equal(out[2][0].numpy(), np.asarray(jcache2[0]))
    for got, want in zip(out[2][1], jcache2[1]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(float(out[3]), float(jscore), rtol=1e-5)
