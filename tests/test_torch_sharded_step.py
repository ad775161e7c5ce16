"""The sharded fused sweeps over static buffers
(`parallel/sharding._sharded_fused_sweep_into`, `_sweep_2d_into`), which
the card replays from a CUDA graph, held on the CPU to the eager loops
they replaced (frozen below), to the single-device fused sweep, and to
the capture's rules (no read of the device, no tensor made from host data
between the launches); the packed `psum` of a process-group mesh; and
`save_sharded` of a component-sharded state.

The JAX package's `sharded_sweep_fused` in 'argmax' on the 8 CPU devices
is held to the port's static sweep by
tests/test_torch_sharding.py::test_sharded_fused_matches_jax_and_single_device,
whose JAX trace this file does not repeat; its graph twins on the card are
in tests/test_torch_cuda.py (`-k graph_sharded or graph_2d or
graph_mesh`)."""

import os
import socket
import subprocess
import sys
import time

import pytest
import torch

from distributions_tpu_torch import clustering as tcl, config
from distributions_tpu_torch import mixture as tmx, testing
from distributions_tpu_torch.io import checkpoint_orbax
from distributions_tpu_torch.models import MODULES, nich
from distributions_tpu_torch.ops import fused_kernels as fk, gibbs as tg
from distributions_tpu_torch.parallel import sharding as tsh
from distributions_tpu_torch.random import (device_generator, draw_seed,
                                            fold_seed, gumbel_noise,
                                            sweep_seeds)

torch.set_num_threads(1)
config.set_default_device('cpu')

HERE = os.path.dirname(os.path.abspath(__file__))
R, C, BLOCK = 128, 16, 16


def _problem(kind, R=R, C=C):
    """(spec, prior, shareds, values, labels): nich2 (K1) or niw2mix (K2),
    seeded."""
    if kind == 'nich2':
        X, labels = testing.nich_problem(R, n_clusters=6, seed=3)
        return (tmx.make_spec([(nich, 2)], capacity=C),
                tcl.PitmanYor.from_dict(testing.PY),
                (nich.shared_from_dict(testing.NICH_SHARED),),
                (torch.from_numpy(X),), torch.from_numpy(labels))
    p = testing.mixed_problem(R, C, seed=1, kind=kind, n_clusters=5)
    spec, py, sh = testing.build_problem(p, MODULES, tmx.make_spec,
                                         tcl.PitmanYor.from_dict)
    return (spec, py, sh, tuple(torch.from_numpy(v) for v in p['values']),
            torch.from_numpy(p['labels']))


def _bits(tree):
    """The bytes of every tensor of a nested result (lists too), in
    order."""
    if isinstance(tree, list):
        tree = tuple(tree)
    return [t.reshape(-1).view(torch.uint8).numpy().tobytes()
            for t in tg._tensors(tree)]


def _gen(seed=4):
    return torch.Generator().manual_seed(seed)


# -- the row-sharded eager loop that the static sweep replaced, frozen ------

def _old_sharded_sweep_fused(spec, cl_model, shareds, state, values,
                             assignments, generator, mesh, block, cache,
                             block_rows=512, sampling='cdf', supports=None,
                             n_sweeps=1, with_score=False):
    n_dev = mesh.axis_size(tsh.ROWS)
    supports = tsh._supports_for(spec, values, supports)
    vals = tsh._shard_values(mesh, values)
    assign = tsh._shard_rows(mesh, assignments)
    n_tiles = tsh._check_tiling(mesh, assign[0].shape[0], block)
    n_removed = block * n_dev
    dev = assign[0].device
    shard_idx = mesh.axis_index(tsh.ROWS)
    lays = mesh.map(lambda v: tg._mixed_static_layout(spec, v, supports),
                    vals)
    tg._check_constant_nu(lays[0], shareds)
    W = tg._stat_matrices(spec, lays[0], shareds)
    cached_cd = tsh._shard_rows(mesh, cache[0])
    cached_sums = [tsh._shard_rows(mesh, s) for s in cache[1]]
    caches = [(cached_cd[i], tuple(s[i] for s in cached_sums))
              for i in range(len(mesh.local))]
    states = [state] * len(mesh.local)
    new = None

    for _ in range(n_sweeps):
        sweep_seed = draw_seed(generator)
        out = [[] for _ in mesh.local]
        for t in range(n_tiles):
            delta = mesh.psum(mesh.map(
                lambda c: (c[0][t], tuple(s[t] for s in c[1])), caches),
                tsh.ROWS)
            states = mesh.map_over(
                tsh.ROWS, lambda st, d: tsh._apply_sums(
                    spec, shareds, st, d, -1, n_removed), states, delta)
            inputs = mesh.map_over(
                tsh.ROWS, lambda st, lay: tg._fused_tile_inputs(
                    spec, lay, cl_model, shareds, st), states, lays)

            def tile(lay, st, inp, i):
                seed = fold_seed(sweep_seed, i * n_tiles + t)
                return tg._fused_tile_core(
                    spec, lay, W, block_rows, sampling, cl_model, shareds,
                    st, *tg._slice_rows(lay, t, block), seed,
                    noise=tg._tile_noise(sampling, seed, block,
                                         spec.capacity, dev), inputs=inp)
            res = mesh.map(tile, lays, states, inputs, shard_idx)
            delta = mesh.psum([(r[1], r[2]) for r in res], tsh.ROWS)
            states = mesh.map_over(
                tsh.ROWS, lambda st, d: tsh._apply_sums(
                    spec, shareds, st, d, +1, n_removed), states, delta)
            for acc, r in zip(out, res):
                acc.append(r)
        new = [torch.cat([r[0] for r in acc]) for acc in out]
        caches = [(torch.stack([r[1] for r in acc]),
                   tuple(torch.stack(s)
                         for s in zip(*(r[2] for r in acc))))
                  for acc in out]

    new_cache = (
        tsh._unshard_rows(mesh, [c[0] for c in caches], cache[0]),
        tuple(tsh._unshard_rows(mesh, [c[1][b] for c in caches],
                                cache[1][b])
              for b in range(len(spec.blocks))))
    result = (states[0], tsh._unshard_rows(mesh, new, assignments),
              new_cache)
    if with_score:
        result += (tmx.score_data(spec, cl_model, shareds, states[0]),)
    return result


def _into_with_seed_tensor(spec, py, sh, st, values, labels, gen, mesh,
                           cache, sampling, n_sweeps):
    """`_sharded_fused_sweep_into` driven as the graph drives it: the
    buffers cut and copied once, each sweep's seeds a [row shards x T]
    int64 tensor, each tile reading its view."""
    vals = tsh._shard_values(mesh, values)
    lays = tuple(tg._mixed_static_layout(spec, v) for v in vals)
    W = tg._stat_matrices(spec, lays[0], sh)
    cd = tsh._shard_rows(mesh, cache[0])
    sums = [tsh._shard_rows(mesh, s) for s in cache[1]]
    caches = tuple((cd[i].clone(), tuple(s[i].clone() for s in sums))
                   for i in range(len(mesh.local)))
    assigns = tuple(a.to(torch.int32, copy=True)
                    for a in tsh._shard_rows(mesh, labels))
    state = tg._map_tensors(torch.clone, st)
    for _ in range(n_sweeps):
        # one seed per global tile: row shards x tiles per shard
        tsh._sharded_fused_sweep_into(
            spec, mesh, lays, W, BLOCK, BLOCK, sampling, py, sh, state,
            assigns, caches, sweep_seeds(gen, cache[0].shape[0]))
    return (state, torch.cat(assigns),
            (torch.cat([c[0] for c in caches]),
             tuple(torch.cat([c[1][b] for c in caches])
                   for b in range(len(spec.blocks)))),
            tmx.score_data(spec, py, sh, state))


@pytest.mark.parametrize('sampling', ['gumbel', 'argmax', 'cdf',
                                      'gumbel_host'])
@pytest.mark.parametrize('kind', ['nich2', 'niw2mix'])
def test_sharded_step_is_bitwise_the_old_loop(kind, sampling):
    """On in-process meshes of 1, 2 and 4 row shards, two sweeps with the
    score: the public function (eager on the CPU) and the static sweep
    fed a seed tensor equal the replaced loop bitwise (state,
    assignments, stat cache, score); the caller's tensors are not
    written.  Exact: the same ops on the same operands, the same seeds."""
    spec, py, sh, values, labels = _problem(kind)
    st = tmx.state_from_assignments(spec, py, sh, values, labels)
    for n in (1, 2, 4):
        mesh = tsh.make_mesh(n)
        cache = tg.build_stat_cache(spec, sh, values, BLOCK, labels)
        before = _bits((st, labels, cache))
        want = _old_sharded_sweep_fused(
            spec, py, sh, st, values, labels, _gen(), mesh, BLOCK, cache,
            block_rows=BLOCK, sampling=sampling, n_sweeps=2,
            with_score=True)
        got = tsh.sharded_sweep_fused(
            spec, py, sh, st, values, labels, _gen(), mesh, BLOCK, cache,
            block_rows=BLOCK, sampling=sampling, n_sweeps=2,
            with_score=True)
        assert _bits(got) == _bits(want), n
        assert got[1].dtype == torch.int32
        assert _bits((st, labels, cache)) == before
        into = _into_with_seed_tensor(spec, py, sh, st, values, labels,
                                      _gen(), mesh, cache, sampling, 2)
        assert _bits(into) == _bits(want), n


def test_sharded_seed_table_is_the_loops_fold():
    """The seed table of a sharded sweep, `sweep_seeds(generator, row
    shards x T)`, is the loop's fold of the sweep seed by shard x T + t,
    and consumes the generator as its one `draw_seed`."""
    a, b = _gen(9), _gen(9)
    table = sweep_seeds(a, 4 * 3)
    seed = draw_seed(b)
    assert table.tolist() == [fold_seed(seed, i * 3 + t)
                              for i in range(4) for t in range(3)]
    assert torch.equal(a.get_state(), b.get_state())


@pytest.mark.parametrize('kind', ['nich2', 'niw2mix'])
def test_one_shard_mesh_is_the_single_device_sweep(kind):
    """sharded_sweep_fused on a one-shard mesh equals
    sweep_blocked_pallas_fused_mixed bitwise: state, assignments, stat
    cache and score, two sweeps in 'gumbel'."""
    spec, py, sh, values, labels = _problem(kind)
    st = tmx.state_from_assignments(spec, py, sh, values, labels)
    cache = tg.build_stat_cache(spec, sh, values, BLOCK, labels)
    one = tsh.sharded_sweep_fused(
        spec, py, sh, st, values, labels, _gen(), tsh.make_mesh(1), BLOCK,
        cache, block_rows=BLOCK, sampling='gumbel', n_sweeps=2,
        with_score=True)
    ref = tg.sweep_blocked_pallas_fused_mixed(
        spec, py, sh, st, values, labels, BLOCK, BLOCK, _gen(), cache,
        sampling='gumbel', n_sweeps=2, with_score=True)
    assert _bits(one) == _bits(ref)


# -- the 2-D eager sweep that the static sweep replaced, frozen -------------

def _old_sweep_2d(spec, cl_model, shareds, state, values, assignments,
                  generator, mesh, block, sampling, fused, block_rows=256,
                  supports=None):
    ROWS, COMPONENTS = tsh.ROWS, tsh.COMPONENTS
    n_row = mesh.axis_size(ROWS)
    n_comp = mesh.axis_size(COMPONENTS)
    C = spec.capacity
    C_local = C // n_comp
    local_spec = spec._replace(capacity=C_local)
    full_state = isinstance(state, tmx.MixtureState)
    states = tsh.shard_state_components(state, mesh) if full_state \
        else list(state)
    vals = tsh._shard_values(mesh, values)
    assign = tsh._shard_rows(mesh, assignments)
    n_tiles = tsh._check_tiling(mesh, assign[0].shape[0], block)
    n_removed = block * n_row
    dev = assign[0].device
    sweep_seed = draw_seed(generator)
    comp_idx = mesh.axis_index(COMPONENTS)
    row_idx = mesh.axis_index(ROWS)
    row_stats = mesh.map_over(
        COMPONENTS, lambda v: tmx.precompute_row_stats(spec, shareds, v),
        vals)
    if fused:
        supports = tsh._supports_for(spec, values, supports)
        lays = mesh.map_over(
            COMPONENTS,
            lambda v: tg._mixed_static_layout(spec, v, supports), vals)
        tg._check_constant_nu(lays[0], shareds)
        col_groups = tuple(spec.blocks[i].cols for i in lays[0].nich_blocks)
    out = [[] for _ in mesh.local]

    def local_sums(stats, a, c):
        return tmx.tile_sums_fast(local_spec, shareds, stats,
                                  a - c * C_local)

    def apply(st, d, sign):
        return tsh._apply_sums(local_spec, shareds, st, d, sign, n_removed)

    def slot_kinds(st):
        is_empty = st.alive & (st.counts == 0)
        nonempty = st.alive & (st.counts > 0)
        return (is_empty.sum().to(torch.int32),
                nonempty.sum().to(torch.int32))

    def plain_pair(st, cl_scores, v, r, c, t, sl):
        scores = cl_scores[None, :].expand(block, C_local)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        for b, shared, group, x in zip(spec.blocks, shareds, st.groups, v):
            scores = scores + torch.where(
                st.alive[None, :],
                tmx._block_score_batch(b, shared, group, x[sl]), zero)
        if sampling != 'argmax':
            seed = fold_seed(fold_seed(sweep_seed, r * n_tiles + t), c)
            scores = scores + gumbel_noise(device_generator(seed, dev),
                                           (block, C_local), dev)
        arg = torch.argmax(scores, dim=1)
        return arg.to(torch.int32), scores.gather(1, arg[:, None])[:, 0]

    def fused_pair(lay, cl_scores, inp, r, c, t):
        coeffs, qcoeffs, tables = inp
        t_nich, t_quad, t_idx = tg._slice_rows(lay, t, block)
        return fk.fused_score_sample_pair(
            fold_seed(sweep_seed, r * n_tiles + t), t_nich, t_idx, cl_scores,
            coeffs, tables, col_groups, block_rows=block_rows,
            sampling=sampling, qvalues=t_quad, qcoeffs=qcoeffs,
            quad_groups=lay.quad_groups, table_vs=lay.table_vs,
            slot_offset=c * C_local, total_slots=C)

    for t in range(n_tiles):
        sl = slice(t * block, (t + 1) * block)
        tile_stats = mesh.map_over(
            COMPONENTS, lambda rs: tuple(r[sl] for r in rs), row_stats)
        delta = mesh.psum(mesh.map(
            lambda ts, a, c: local_sums(ts, a[sl], c), tile_stats, assign,
            comp_idx), ROWS)
        states = mesh.map_over(ROWS, lambda st, d: apply(st, d, -1), states,
                               delta)
        kinds = mesh.psum(mesh.map_over(ROWS, slot_kinds, states),
                          COMPONENTS)
        cl_scores = mesh.map_over(
            ROWS, lambda st, k: tcl.py_score_value_sharded(
                cl_model, st.counts, st.alive, st.sample_size, k[0], k[1]),
            states, kinds)
        if fused:
            inputs = mesh.map_over(
                ROWS, lambda st, lay: tg._build_fused_inputs(
                    local_spec, lay, shareds, st), states, lays)
            pairs = mesh.map(
                lambda lay, cs, inp, r, c: fused_pair(lay, cs, inp, r, c, t),
                lays, cl_scores, inputs, row_idx, comp_idx)
        else:
            pairs = mesh.map(
                lambda st, cs, v, r, c: plain_pair(st, cs, v, r, c, t, sl),
                states, cl_scores, vals, row_idx, comp_idx)
        best = mesh.pmax([p[1] for p in pairs], COMPONENTS)
        winner = mesh.map(
            lambda p, gb, c: torch.where(
                p[1] == gb, p[0] + c * C_local,
                torch.full_like(p[0], C)), pairs, best, comp_idx)
        new = mesh.pmin(winner, COMPONENTS)
        delta = mesh.psum(mesh.map(local_sums, tile_stats, new, comp_idx),
                          ROWS)
        states = mesh.map_over(ROWS, lambda st, d: apply(st, d, +1), states,
                               delta)
        for acc, a in zip(out, new):
            acc.append(a)
    new_assign = tsh._unshard_rows(mesh, [torch.cat(a) for a in out],
                                   assignments)
    if full_state:
        return tsh.unshard_state_components(states, mesh), new_assign
    return states, new_assign


@pytest.mark.parametrize('sampling', ['argmax', 'gumbel'])
@pytest.mark.parametrize('fused', [True, False])
def test_2d_step_is_bitwise_the_old_sweep(fused, sampling):
    """On a 2 x 2 mesh, niw2mix, two sweeps (the second from the first's
    component-sharded list): the fused (K3) and the plain 2-D sweep equal
    the replaced sweep bitwise; the fused one also when
    `_sweep_2d_into` takes its seeds as a tensor."""
    spec, py, sh, values, labels = _problem('niw2mix', C=32)
    st = tmx.state_from_assignments(spec, py, sh, values, labels)
    mesh = tsh.make_mesh_2d(2, 2)
    fn = tsh.sharded_sweep_2d_fused if fused else tsh.sharded_sweep_2d
    kw = dict(block_rows=BLOCK) if fused else {}
    got, want = [], []
    for out, sweep in ((got, fn), (want, None)):
        gen, state, an = _gen(), st, labels
        for _ in range(2):
            if sweep is None:
                state, an = _old_sweep_2d(spec, py, sh, state, values, an,
                                          gen, mesh, BLOCK, sampling, fused,
                                          **kw)
            else:
                state, an = sweep(spec, py, sh, state, values, an, gen, mesh,
                                  BLOCK, sampling=sampling, **kw)
            if isinstance(state, list):
                out.append((tsh.unshard_state_components(state, mesh), an))
            else:
                out.append((state, an))
                state = tsh.shard_state_components(state, mesh)
    assert _bits(got) == _bits(want)
    assert got[0][1].dtype == torch.int32
    if not fused:
        return
    row_lines = mesh._lines(tsh.ROWS)
    comp_lines = mesh._lines(tsh.COMPONENTS)
    vals = tsh._shard_values(mesh, values)
    lays = mesh.map_over(tsh.COMPONENTS,
                         lambda v: tg._mixed_static_layout(spec, v), vals)
    sts = tsh.shard_state_components(st, mesh)
    state_lines = tuple(tg._map_tensors(torch.clone, sts[line[0]])
                        for line in row_lines)
    assign_lines = (labels[:R // 2].clone(), labels[R // 2:].clone())
    assert [line[0] for line in comp_lines] == [0, 2]
    tsh._sweep_2d_into(spec, mesh, vals, lays, BLOCK, BLOCK, sampling, py,
                       sh, state_lines, assign_lines,
                       sweep_seeds(_gen(), R // BLOCK))
    full = tsh.unshard_state_components(
        tsh._spread(row_lines, state_lines), mesh)
    assert _bits((full, torch.cat(assign_lines))) == _bits(want[0])


# -- capturable: nothing between the launches reads the device ----------------

def _paused(mode, monkeypatch):
    """Leave the kernel wrappers' own host work out of `mode` (on the
    card they take the seed's address; the twins read it)."""
    for name in ('fused_score_sample_stats', 'fused_mixed_score_sample_stats',
                 'fused_score_sample_pair'):
        wrapper = getattr(fk, name)

        def paused(*a, _w=wrapper, **k):
            mode.paused = True
            try:
                return _w(*a, **k)
            finally:
                mode.paused = False
        monkeypatch.setattr(fk, name, paused)


@pytest.mark.parametrize('sweep', ['rows', '2d'])
def test_static_sharded_sweeps_read_nothing_back(sweep, monkeypatch):
    """`_sharded_fused_sweep_into` on 4 row shards (with the step's
    score_data) and `_sweep_2d_into` with K3 on 2 x 2, niw2mix, run a
    second time (the first is the capture's warm-up), run no op outside
    the kernel wrappers that would read the card or copy from the host
    inside a CUDA graph capture."""
    spec, py, sh, values, labels = _problem('niw2mix', C=32)
    st = tmx.state_from_assignments(spec, py, sh, values, labels)
    if sweep == 'rows':
        mesh = tsh.make_mesh(4)
        vals = tsh._shard_values(mesh, values)
        lays = tuple(tg._mixed_static_layout(spec, v) for v in vals)
        W = tg._stat_matrices(spec, lays[0], sh)
        cache = tg.build_stat_cache(spec, sh, values, BLOCK, labels)
        cd = tsh._shard_rows(mesh, cache[0])
        sums = [tsh._shard_rows(mesh, s) for s in cache[1]]
        state = tg._map_tensors(torch.clone, st)
        bufs = (state,
                tuple(a.clone() for a in tsh._shard_rows(mesh, labels)),
                tuple((cd[i].clone(), tuple(s[i].clone() for s in sums))
                      for i in range(4)))
        seeds = sweep_seeds(_gen(), R // BLOCK)

        def step():
            tsh._sharded_fused_sweep_into(spec, mesh, lays, W, BLOCK, BLOCK,
                                          'gumbel', py, sh, *bufs, seeds)
            return tmx.score_data(spec, py, sh, state)
        inputs = (py, sh, W, bufs, seeds, lays)
    else:
        mesh = tsh.make_mesh_2d(2, 2)
        vals = tsh._shard_values(mesh, values)
        lays = tuple(tg._mixed_static_layout(spec, v) for v in vals)
        sts = tsh.shard_state_components(st, mesh)
        bufs = (tuple(tg._map_tensors(torch.clone, sts[line[0]])
                      for line in mesh._lines(tsh.ROWS)),
                (labels[:R // 2].clone(), labels[R // 2:].clone()))
        seeds = sweep_seeds(_gen(), R // BLOCK)

        def step():
            tsh._sweep_2d_into(spec, mesh, vals, lays, BLOCK, BLOCK,
                               'gumbel', py, sh, *bufs, seeds)
        inputs = (py, sh, bufs, seeds, lays, vals)
    step()
    known = [t.untyped_storage().data_ptr()
             for t in _flatten_layouts(inputs)]
    mode = testing.HostReads(known)
    _paused(mode, monkeypatch)
    with mode:
        step()
    assert mode.found == []


def _flatten_layouts(tree):
    """Every tensor of `tree`, layouts (namedtuples with lists) included."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _flatten_layouts(x)


# -- the capture's rules ------------------------------------------------------

@pytest.mark.parametrize('case', ['cpu', 'host_mode', 'plain', 'v1',
                                  'eager_sweeps', 'graphed'])
def test_graph_refusal_names_each_rule(case):
    """What stays eager on the card does so by a rule `_graph_refusal`
    names: the CPU, the '_host' modes, the plain sweeps of a mesh (and
    sweep_blocked for a model without row stats), `_eager_sweeps()`; the
    three fused sweeps, the v1 sweeps (K4, K5 and backend='xla', which
    passes no mode) and the single-device plain sweeps are graphed."""
    card = torch.device('cuda', 0)
    host = "a '_host' mode draws its noise from the host"
    if case == 'graphed':
        for kind in ('fused', 'sharded_fused', 'fused_2d', 'blocked',
                     'chains'):
            assert tg._graph_refusal(card, 'gumbel', kind) is None
        return
    if case == 'v1':
        assert 'v1' not in tg._EAGER_SWEEPS
        assert tg._graph_refusal(card, 'gumbel', 'v1') is None
        assert tg._graph_refusal(card, None, 'v1') is None
        assert tg._graph_refusal(card, 'gumbel_host', 'v1') == host
        return
    rule = {'cpu': lambda: tg._graph_refusal(torch.device('cpu'), 'gumbel'),
            'host_mode': lambda: tg._graph_refusal(card, 'gumbel_host',
                                                   'sharded_fused'),
            'plain': lambda: tg._graph_refusal(card, 'gumbel', 'plain')}
    if case == 'eager_sweeps':
        with tg._eager_sweeps():
            why = tg._graph_refusal(card, 'gumbel', 'fused_2d')
        assert why == '_eager_sweeps()'
        return
    why = rule[case]()
    assert why and why == {
        'cpu': 'not on the card',
        'host_mode': host,
        'plain': tg._EAGER_SWEEPS['plain']}[case]
    assert 'sharded_sweep_2d' in tg._EAGER_SWEEPS['plain']
    assert 'without row stats' in tg._EAGER_SWEEPS['plain']


def test_sharded_sweeps_on_the_cpu_take_no_graph_path():
    """On the CPU the sharded sweeps never reach the graph path: no key is
    recorded, whatever the number of calls."""
    spec, py, sh, values, labels = _problem('nich2')
    st = tmx.state_from_assignments(spec, py, sh, values, labels)
    cache = tg.build_stat_cache(spec, sh, values, BLOCK, labels)
    tg.reset_graph_stats()
    for _ in range(2):
        tsh.sharded_sweep_fused(spec, py, sh, st, values, labels, _gen(),
                                tsh.make_mesh(2), BLOCK, cache,
                                block_rows=BLOCK, sampling='gumbel')
        tsh.sharded_sweep_2d_fused(spec, py, sh, st, values, labels, _gen(),
                                   tsh.make_mesh_2d(2, 2), BLOCK,
                                   block_rows=BLOCK)
    assert tg.GRAPH_STATS['first_uses'] == 0 and tg._GRAPH['seen'] is None


# -- the packed psum of a process-group mesh ----------------------------------

def _free_port():
    s = socket.socket()
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_packed_psum_equals_per_leaf_all_reduce(tmp_path):
    """Two gloo ranks (tests/torch_psum_worker.py): Mesh.psum / pmax / pmin
    over the ranks, which pack a tree's tensors into one all_reduce per
    dtype, equal one all_reduce per tensor bitwise; every rank checks."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ('XLA_FLAGS', 'JAX_PLATFORMS')}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, 'torch_psum_worker.py'),
         str(rank), '2', str(port), str(tmp_path)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    deadline = time.time() + 120
    try:
        while any(p.poll() is None for p in procs) \
                and time.time() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate()[0][-3000:] for p in procs]
    assert all(p.returncode == 0 for p in procs), '\n---\n'.join(logs)
    for rank in range(2):
        with open(os.path.join(str(tmp_path), 'rank%d.txt' % rank)) as f:
            assert f.read().split() == ['equal', '3']


# -- save_sharded of a component-sharded state --------------------------------

def test_save_sharded_component_state_roundtrip(tmp_path):
    """On a 1 x 4 in-process component mesh: save_sharded takes the list
    a component-sharded sweep returns and writes the full state;
    load_sharded returns it bitwise, and shard_state_components cuts it
    back into the saved shards."""
    spec, py, sh, values, labels = _problem('nich2', C=32)
    st = tmx.state_from_assignments(spec, py, sh, values, labels)
    mesh = tsh.make_mesh_2d(1, 4)
    sts, an = tsh.sharded_sweep_components(
        spec, py, sh, tsh.shard_state_components(st, mesh), values, labels,
        _gen(), tsh.make_mesh_2d(1, 4), BLOCK)
    assert isinstance(sts, list) and len(sts) == 4
    path = str(tmp_path / 'components')
    checkpoint_orbax.save_sharded(path, sts, assignments=an, generator=_gen(),
                                  sweep=3, mesh=mesh)
    loaded, an2, _, sweep, _ = checkpoint_orbax.load_sharded(path, spec, sh)
    assert sweep == 3 and torch.equal(an2, an)
    assert _bits(loaded) == _bits(tsh.unshard_state_components(sts, mesh))
    assert _bits(tsh.shard_state_components(loaded, mesh)) == _bits(sts)
    with pytest.raises(ValueError, match='with its mesh'):
        checkpoint_orbax.save_sharded(str(tmp_path / 'x'), sts)
