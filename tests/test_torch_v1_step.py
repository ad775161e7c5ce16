"""The v1 sweeps and the single-device plain sweep as the port runs them
on the card (`gibbs._v1_sweep_into`, `_plain_sweep_into`, which a CUDA
graph replays there), run eagerly on the kernels' twins on the CPU:

- bitwise the eager loops they replaced (frozen copies below): K4 on
  nich2, K5 on nichbbddgp in 'gumbel', 'argmax' and 'gumbel_host', the
  plain 'xla' backend, `sweep_blocked`, the chains, and the runner's
  unfused step of k sweeps with its score;
- capturable: between the kernel launches a second run reads nothing
  back from the device and makes no tensor from host data (op by op);
- seeded as before: the K4 / K5 twins draw alike from an int seed and
  from the 1-element int64 tensor a graph passes;
- against the JAX package: the state after a v1 and a plain sweep equals
  `distributions_tpu.mixture.state_from_assignments` of the drawn labels,
  and one 'argmax' v1 tile is the argmax of JAX `mixture.score_batch` on
  the tile-removed state.

The graph itself (capture, registered generators, replays) needs the
card: tests/test_torch_cuda.py.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributions_tpu import clustering as jcl, mixture as jmx
from distributions_tpu_torch import clustering as tcl, config, diagnostics
from distributions_tpu_torch import mixture as tmx, testing
from distributions_tpu_torch.inference import runner
from distributions_tpu_torch.models import MODULES, nich
from distributions_tpu_torch.ops import fused_kernels as fk, gibbs as tg
from distributions_tpu_torch.random import (device_generator, draw_seed,
                                            fold_seed, sample_from_scores,
                                            sweep_seeds)

torch.set_num_threads(1)
config.set_default_device('cpu')

R, C, BLOCK, BLOCK_ROWS = 256, 32, 64, 32
JAX_MODELS = {name: importlib.import_module('distributions_tpu.models.'
                                            + name) for name in MODULES}
# f32 stat sums of the same rows in another order (ROADMAP: deterministic
# functions match to a stated f32 tolerance; as test_torch_gibbs.py)
SUM_RTOL, SUM_ATOL = 1e-4, 1e-3
# an 'argmax' draw against the JAX scores may differ only where the two
# drawn slots' JAX scores are this close (f32 rounding of a score of a few
# hundred, from a state unmerged here and built afresh there)
TIE_GAP = 1e-3


@functools.lru_cache(maxsize=None)
def _problem(kind):
    """(problem dict or None, spec, clustering model, shareds, values,
    labels) of a small seeded problem in the port: nich2 (K4, the plain
    sweep) or a `testing.MIXED_KINDS` layout."""
    py = tcl.PitmanYor.from_dict(testing.PY)
    if kind == 'nich2':
        X, labels = testing.nich_problem(R, cols=2, n_clusters=6, seed=3)
        spec = tmx.make_spec([(nich, 2)], capacity=C)
        sh = (nich.shared_from_dict(testing.NICH_SHARED),)
        return None, spec, py, sh, (torch.from_numpy(X),), \
            torch.from_numpy(labels)
    p = testing.mixed_problem(R, C, seed=1, kind=kind, n_clusters=5)
    spec, py, sh = testing.build_problem(p, MODULES, tmx.make_spec,
                                         tcl.PitmanYor.from_dict)
    return p, spec, py, sh, tuple(torch.from_numpy(v) for v in p['values']), \
        torch.from_numpy(p['labels'])


def _start(kind):
    _, spec, py, sh, values, labels = _problem(kind)
    return spec, py, sh, values, labels, tmx.state_from_assignments(
        spec, py, sh, values, labels)


def _bits(tree):
    """The bytes of every tensor of a nested result, in order."""
    return [t.reshape(-1).view(torch.uint8).numpy().tobytes()
            for t in tg._tensors(tuple(tree))]


def _gen(seed=5):
    return torch.Generator().manual_seed(seed)


# -- the eager loops this PR replaced, frozen ---------------------------------

def _old_sweep_blocked(spec, cl_model, shareds, state, values, assignments,
                       block, generator):
    gen = device_generator(draw_seed(generator), assignments.device)
    row_stats = tmx.precompute_row_stats(spec, shareds, values)
    out = []
    for t in range(assignments.shape[0] // block):
        sl = slice(t * block, (t + 1) * block)
        tile_stats = tuple(rs[sl] for rs in row_stats)
        cd, tiles = tmx.tile_deltas_fast(spec, shareds, tile_stats,
                                         assignments[sl])
        state = tmx.apply_stat_tiles(spec, shareds, state, cd, tiles, -1,
                                     block)
        scores = tmx.score_batch(spec, cl_model, shareds, state,
                                 tuple(v[sl] for v in values))
        new_assign = sample_from_scores(gen, scores).to(torch.int32)
        cd, tiles = tmx.tile_deltas_fast(spec, shareds, tile_stats,
                                         new_assign)
        state = tmx.apply_stat_tiles(spec, shareds, state, cd, tiles, +1,
                                     block)
        out.append(new_assign)
    return state, torch.cat(out)


def _old_sweep_blocked_pallas(spec, cl_model, shareds, state, values,
                              assignments, block, generator, sampling):
    sweep_seed = draw_seed(generator)
    values_cat = torch.cat([torch.as_tensor(v).to(torch.float32)
                            for v in values], dim=1).contiguous()
    row_stats = tmx.precompute_row_stats(spec, shareds, values)
    out = []
    for t in range(assignments.shape[0] // block):
        sl = slice(t * block, (t + 1) * block)
        tile_stats = tuple(rs[sl] for rs in row_stats)
        cd, tiles = tmx.tile_deltas_fast(spec, shareds, tile_stats,
                                         assignments[sl])
        state = tmx.apply_stat_tiles(spec, shareds, state, cd, tiles, -1,
                                     block)
        cl_scores = tcl.score_value(cl_model, state.counts, state.alive,
                                    state.sample_size)
        coeffs = torch.cat([fk.nich_coeffs(shared, group)
                            for shared, group in zip(shareds, state.groups)],
                           dim=0).contiguous()
        seed = fold_seed(sweep_seed, t)
        new_assign = fk.nich_score_sample(
            seed, values_cat[sl], cl_scores, coeffs, block_rows=BLOCK_ROWS,
            sampling=sampling,
            noise=tg._tile_noise(sampling, seed, block, spec.capacity,
                                 cl_scores.device))
        cd, tiles = tmx.tile_deltas_fast(spec, shareds, tile_stats,
                                         new_assign)
        state = tmx.apply_stat_tiles(spec, shareds, state, cd, tiles, +1,
                                     block)
        out.append(new_assign)
    return state, torch.cat(out)


def _old_sweep_blocked_pallas_mixed(spec, cl_model, shareds, state, values,
                                    assignments, block, generator, backend,
                                    sampling):
    lay = tg._mixed_static_layout(spec, values, None)
    dev = assignments.device
    sweep_seed = draw_seed(generator)
    gen = device_generator(sweep_seed, dev) if backend == 'xla' else None
    row_stats = tmx.precompute_row_stats(spec, shareds, values)
    out = []
    for t in range(assignments.shape[0] // block):
        sl = slice(t * block, (t + 1) * block)
        tile_stats = tuple(rs[sl] for rs in row_stats)
        cd, tiles = tmx.tile_deltas_fast(spec, shareds, tile_stats,
                                         assignments[sl])
        state = tmx.apply_stat_tiles(spec, shareds, state, cd, tiles, -1,
                                     block)
        cl_scores = tcl.score_value(cl_model, state.counts, state.alive,
                                    state.sample_size)
        t_nich, _, t_idx = tg._slice_rows(lay, t, block)
        if backend == 'xla':
            table_list = tg._column_tables(spec, lay, shareds, state)
            scores = cl_scores[None, :].expand(block, C)
            ncol = tcol = 0
            for i, blk in enumerate(spec.blocks):
                if i in lay.nich_blocks:
                    part = tmx._block_score_batch(
                        blk, shareds[i], state.groups[i],
                        t_nich[:, ncol:ncol + blk.cols])
                    ncol += blk.cols
                else:
                    part = None
                    for _ in range(blk.cols):
                        s = table_list[tcol][t_idx[:, tcol].long()]
                        part = s if part is None else part + s
                        tcol += 1
                scores = scores + part
            new_assign = sample_from_scores(gen, scores).to(torch.int32)
        else:
            coeffs, tables = tg._build_v1_inputs(spec, lay, shareds, state)
            seed = fold_seed(sweep_seed, t)
            new_assign = fk.mixed_score_sample(
                seed, t_nich, t_idx, cl_scores, coeffs, tables,
                block_rows=BLOCK_ROWS, sampling=sampling,
                noise=tg._tile_noise(sampling, seed, block, C, dev))
        cd, tiles = tmx.tile_deltas_fast(spec, shareds, tile_stats,
                                         new_assign)
        state = tmx.apply_stat_tiles(spec, shareds, state, cd, tiles, +1,
                                     block)
        out.append(new_assign)
    return state, torch.cat(out)


# -- bitwise the frozen loops -------------------------------------------------

def _v1_case(case, sampling):
    """(kind, public sweep (state, assignments, generator) -> result, the
    frozen loop's sweep) of one v1 case."""
    kind = 'nich2' if case == 'K4' else 'nichbbddgp'
    spec, py, sh, values, _, _ = _start(kind)
    if case == 'K4':
        def new(st, an, gen):
            return tg.sweep_blocked_pallas(spec, py, sh, st, values, an,
                                           BLOCK, BLOCK_ROWS, gen,
                                           sampling=sampling)

        def old(st, an, gen):
            return _old_sweep_blocked_pallas(spec, py, sh, st, values, an,
                                             BLOCK, gen, sampling)
        return kind, new, old
    backend = 'xla' if case == 'xla' else 'pallas'

    def new(st, an, gen):
        return tg.sweep_blocked_pallas_mixed(
            spec, py, sh, st, values, an, BLOCK, gen, block_rows=BLOCK_ROWS,
            backend=backend, sampling=sampling)

    def old(st, an, gen):
        return _old_sweep_blocked_pallas_mixed(spec, py, sh, st, values, an,
                                               BLOCK, gen, backend, sampling)
    return kind, new, old


@pytest.mark.parametrize('case,sampling', [
    ('K4', 'gumbel'), ('K4', 'argmax'), ('K4', 'gumbel_host'),
    ('K5', 'gumbel'), ('K5', 'argmax'), ('K5', 'gumbel_host'),
    ('xla', 'gumbel')])
def test_v1_sweeps_are_bitwise_the_old_loops(case, sampling):
    """Three chained sweeps of each v1 entry point (on the CPU:
    `_v1_sweep_into` through `_run_static`, eagerly) equal the replaced
    loop bitwise, state and assignments, and consume the generator as it
    did; the inputs are not written.  Exact: the same ops on the same
    operands."""
    kind, new, old = _v1_case(case, sampling)
    *_, labels, st = _start(kind)
    before = _bits((st, labels))
    g_new, g_old = _gen(), _gen()
    a = b = (st, labels)
    for _ in range(3):
        a = new(*a, g_new)
        b = old(*b, g_old)
        assert _bits(a) == _bits(b)
    assert a[1].dtype == torch.int32
    assert torch.equal(g_new.get_state(), g_old.get_state())
    assert _bits((st, labels)) == before


def test_xla_backend_equals_sweep_blocked():
    """backend='xla' is sweep_blocked bitwise for a generator in the same
    state (its pinned identity), through both static sweeps."""
    spec, py, sh, values, labels, st = _start('nichbbddgp')
    got = tg.sweep_blocked_pallas_mixed(spec, py, sh, st, values, labels,
                                        BLOCK, _gen(), backend='xla')
    want = tg.sweep_blocked(spec, py, sh, st, values, labels, BLOCK,
                            generator=_gen())
    assert _bits(got) == _bits(want)


@pytest.mark.parametrize('kind', ['nich2', 'niw2mix', 'bbddgp'])
def test_plain_sweep_is_bitwise_the_old_loop(kind):
    """sweep_blocked (`_plain_sweep_into`, eagerly) equals the replaced
    row-stats loop bitwise over three chained sweeps, also for an int64
    assignments vector, and `_plain_run(n_sweeps=3, with_score=True)`
    equals three of them and `score_data`."""
    spec, py, sh, values, labels, st = _start(kind)
    g_new, g_old = _gen(), _gen()
    a, b = (st, labels.to(torch.int64)), (st, labels)
    for _ in range(3):
        a = tg.sweep_blocked(spec, py, sh, *a[:1], values, a[1], BLOCK,
                             generator=g_new)
        b = _old_sweep_blocked(spec, py, sh, *b[:1], values, b[1], BLOCK,
                               g_old)
        assert _bits(a) == _bits(b)
    run = tg._plain_run(spec, py, sh, st, values, labels, BLOCK, _gen(), 3,
                        True)
    assert _bits(run[:2]) == _bits(b)
    assert _bits((run[2],)) == _bits((tmx.score_data(spec, py, sh, b[0]),))


def test_chains_are_bitwise_per_chain_sweep_blocked():
    """sweep_blocked_chains (all chains in one static sweep) equals each
    chain's sweep_blocked with its own generator, bitwise, and the frozen
    loop; each generator is consumed as by its own sweep."""
    spec, py, sh, values, labels, _ = _start('nich2')
    A = torch.stack([labels, (labels + 1) % 8, torch.zeros_like(labels)])
    states = tg.init_chains(spec, py, sh, values, A)
    gens = [_gen(10 + c) for c in range(3)]
    got = tg.sweep_blocked_chains(spec, py, sh, states, values, A, BLOCK,
                                  gens)
    for c in range(3):
        want = _old_sweep_blocked(spec, py, sh, tg._chain_take(states, c),
                                  values, A[c], BLOCK, _gen(10 + c))
        assert _bits((tg._chain_take(got[0], c), got[1][c])) == _bits(want)
        assert _bits(want) == _bits(tg.sweep_blocked(
            spec, py, sh, tg._chain_take(states, c), values, A[c], BLOCK,
            generator=_gen(10 + c)))
        ref = _gen(10 + c)
        draw_seed(ref)
        assert torch.equal(gens[c].get_state(), ref.get_state())


@pytest.mark.parametrize('use_pallas,kind', [(False, 'nich2'),
                                             (True, 'nichbbddgp')])
def test_runner_unfused_step_is_bitwise_the_old_sweeps(use_pallas, kind,
                                                       monkeypatch):
    """run_gibbs's unfused step (k sweeps in one call, the step's score
    from the static state) equals the old step (k calls of the sweep, the
    logger's score_data) bitwise: state, assignments and logger rows.
    With use_pallas the fused gate is closed here, so the step takes the
    v1 sweep (K5 for nichbbddgp)."""
    spec, py, sh, values, labels, _ = _start(kind)

    def run():
        return runner.run_gibbs(spec, py, sh, values, _gen(0), 6,
                                block=BLOCK, use_pallas=use_pallas,
                                initial_assignments=labels,
                                grow_headroom=0.0, sweeps_per_step=3,
                                device='cpu')
    monkeypatch.setattr(fk, 'supports_mixed_pallas', lambda spec: False)
    got = run()

    def old_step(spec, use_pallas):
        if use_pallas:
            return lambda *a: _old_sweep_blocked_pallas_mixed(
                *a[:7], a[7], 'pallas', 'gumbel')
        return lambda *a: _old_sweep_blocked(*a)

    def old_unfused(spec, use_pallas):
        sweep = old_step(spec, use_pallas)

        def run_k(spec, cl_model, shareds, state, values, assignments,
                  block, generator, k):
            for _ in range(k):
                state, assignments = sweep(spec, cl_model, shareds, state,
                                           values, assignments, block,
                                           generator)
            return state, assignments, None
        return run_k
    monkeypatch.setattr(runner, '_unfused_sweep', old_unfused)
    want = run()
    assert _bits(got[:2]) == _bits(want[:2])

    def rows(log):
        return [{k: v for k, v in r.items()
                 if k not in diagnostics.CLOCK_KEYS} for r in log.rows]
    assert rows(got[2]) == rows(want[2])


# -- capturable: nothing between the launches reads the device --------------

def _static_case(case):
    """(the inputs a static sweep knows, a step running it once) of one
    static sweep, its buffers cloned as a graph's are."""
    kind = {'K4': 'nich2', 'K5': 'nichbbddgp', 'xla': 'nichbbddgp',
            'plain': 'niw2mix', 'plain_dpd': 'dpd_nich', 'plain_le': 'bnb',
            'chains': 'nich2'}[case]
    spec, py, sh, values, labels, st = _start(kind)
    if case == 'plain_le':
        py = tcl.LowEntropy.from_dict({'dataset_size': R})
        st = tmx.state_from_assignments(spec, py, sh, values, labels)
    rs = tmx.precompute_row_stats(spec, sh, values)
    if case == 'chains':
        A = torch.stack([labels, (labels + 1) % 8])
        states, an = tg._map_tensors(torch.clone, (
            tg.init_chains(spec, py, sh, values, A), A))
        gens = tuple(device_generator(s, 'cpu') for s in (3, 4))

        def step():
            for c in range(2):
                tg._plain_sweep_into(spec, BLOCK, py, sh, rs, values,
                                     tg._chain_take(states, c), an[c],
                                     gens[c])
        return (py, sh, rs, values, states, an), step
    state, an = tg._map_tensors(torch.clone, (st, labels))
    if case.startswith('plain'):
        gen = device_generator(3, 'cpu')

        def step():
            tg._plain_sweep_into(spec, BLOCK, py, sh, rs, values, state, an,
                                 gen)
            return tmx.score_data(spec, py, sh, state)
        return (py, sh, rs, values, state, an), step
    lay = tg._mixed_static_layout(spec, values)
    seeds = (device_generator(3, 'cpu'),) if case == 'xla' else \
        sweep_seeds(_gen(0), R // BLOCK)

    def step():
        tg._v1_sweep_into(spec, lay, BLOCK, BLOCK_ROWS, 'gumbel', case, py,
                          sh, rs, state, an, seeds)
        return tmx.score_data(spec, py, sh, state)
    return (py, sh, rs, state, an, seeds, lay.nich_vals, lay.table_idx,
            lay.supports), step


@pytest.mark.parametrize('case', ['K4', 'K5', 'xla', 'plain', 'plain_dpd',
                                  'plain_le', 'chains'])
def test_static_sweep_reads_nothing_back(case, monkeypatch):
    """`_v1_sweep_into`, `_plain_sweep_into` (niw2mix, dpd + nich, bnb
    under the LowEntropy prior) and the chains' sweep (and the step's
    score_data), run a second time (the first is the capture's warm-up),
    run no op outside the kernel wrappers that would read the card or
    copy from the host inside a CUDA graph capture (an error check of
    `torch.linalg` among them).  The wrappers' own host work differs on
    the card (there they take the seed's address) and is left out."""
    inputs, step = _static_case(case)
    step()
    known = [t.untyped_storage().data_ptr() for t in tg._tensors(
        tuple(inputs) + (tuple(tcl._LOG_PARTITION_TABLES.values()),))]
    mode = testing.HostReads(known)
    for name in ('nich_score_sample', 'mixed_score_sample'):
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


@pytest.mark.parametrize('sampling', ['gumbel', 'argmax'])
@pytest.mark.parametrize('kernel', ['K4', 'K5'])
def test_v1_twins_take_the_seed_tensor(kernel, sampling):
    """The K4 and K5 twins draw alike from an int seed and from the
    1-element int64 tensor holding its 64 bits (the top bit set here);
    another seed draws otherwise in 'gumbel'; an int64 tensor of another
    size is refused.  Exact."""
    nv, idx, cls, co, tab = testing.v1_random_inputs(200, C, 2, 3, seed=8)
    seed = 0xF123456789ABCDEF

    def launch(s):
        if kernel == 'K4':
            return fk.nich_score_sample(s, nv, cls, co, sampling=sampling)
        return fk.mixed_score_sample(s, nv, idx, cls, co, tab,
                                     sampling=sampling)
    assert torch.equal(launch(seed), launch(torch.tensor([seed - (1 << 64)])))
    assert torch.equal(launch(7), launch(torch.tensor(7)))
    if sampling == 'gumbel':
        assert not torch.equal(launch(seed), launch(seed + 1))
    with pytest.raises(ValueError, match='one int64'):
        launch(torch.tensor([7, 8]))


# -- against the JAX package -------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_problem(kind):
    """The JAX (spec, prior, shareds, values) of `_problem(kind)`."""
    p, *_, values, _ = _problem(kind)
    if p is None:
        from distributions_tpu.models import nich as jnich
        return (jmx.make_spec([(jnich, 2)], capacity=C),
                jcl.PitmanYor.from_dict(testing.PY),
                (jnich.shared_from_dict(testing.NICH_SHARED),),
                tuple(jnp.asarray(v.numpy()) for v in values))
    jspec, jpy, jsh = testing.build_problem(p, JAX_MODELS, jmx.make_spec,
                                            jcl.PitmanYor.from_dict)
    return jspec, jpy, jsh, tuple(jnp.asarray(v) for v in p['values'])


def _assert_state_close(got, want):
    """A port state against a JAX state, leaf by leaf in the same order:
    integer and boolean leaves exactly, float leaves within f32
    tolerance."""
    want = jax.tree_util.tree_leaves(want)
    got = list(tg._tensors(tuple(got)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if g.dtype.is_floating_point:
            np.testing.assert_allclose(g.numpy(), w, rtol=SUM_RTOL,
                                       atol=SUM_ATOL)
        else:
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize('case', ['K4', 'K5', 'plain'])
def test_sweep_state_matches_jax_state_from_assignments(case):
    """After two v1 sweeps ('gumbel') or two plain sweeps, the port's
    state equals the JAX package's `state_from_assignments` of the drawn
    labels: counts, alive and sample size exactly, stat leaves within
    rtol 1e-4 / atol 1e-3 (f32 sums in another order)."""
    kind = 'nichbbddgp' if case == 'K5' else 'nich2'
    spec, py, sh, values, labels, st = _start(kind)
    a = (st, labels)
    for _ in range(2):
        if case == 'plain':
            a = tg.sweep_blocked(spec, py, sh, a[0], values, a[1], BLOCK,
                                 generator=_gen())
        else:
            a = _v1_case(case, 'gumbel')[1](a[0], a[1], _gen())
    assert not torch.equal(a[1], labels)
    jspec, jpy, jsh, jv = _jax_problem(kind)
    _assert_state_close(a[0], jmx.state_from_assignments(
        jspec, jpy, jsh, jv, jnp.asarray(a[1].numpy())))


@pytest.mark.parametrize('case', ['K4', 'K5'])
def test_v1_argmax_tile_matches_jax_score_batch(case):
    """One 'argmax' v1 tile (the first of a sweep) draws the argmax of the
    JAX package's `mixture.score_batch` of its rows against the state of
    all the other rows (the tile-removed state): equal but at near-ties,
    where the two slots' JAX scores lie within TIE_GAP."""
    kind = 'nich2' if case == 'K4' else 'nichbbddgp'
    spec, py, sh, values, labels, st = _start(kind)
    _, an = _v1_case(case, 'argmax')[1](st, labels, _gen())
    jspec, jpy, jsh, jv = _jax_problem(kind)
    tile = slice(0, BLOCK)
    jrest = jmx.state_from_assignments(
        jspec, jpy, jsh, tuple(v[BLOCK:] for v in jv),
        jnp.asarray(labels[BLOCK:].numpy()))
    scores = np.array(jmx.score_batch(jspec, jpy, jsh, jrest,
                                        tuple(v[tile] for v in jv)))
    n_bad, gap = testing.mismatches(torch.from_numpy(scores), an[tile],
                                    np.argmax(scores, axis=1))
    assert gap <= TIE_GAP, (n_bad, gap)
