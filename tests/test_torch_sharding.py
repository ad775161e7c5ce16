"""The port's sharded sweeps (parallel/sharding.py on in-process meshes),
the pair kernel K3's plain twin and `run_gibbs(mesh=...)` against
distributions_tpu.parallel.sharding on the 8 virtual CPU devices, with the
JAX package's Pallas kernels in interpret mode.

The two packages draw different random numbers from the same seed, so the
sweeps are compared in 'argmax', where the draws are functions of the
scores alone; `sharded_sweep_blocked`, which has no such mode, has the
draw of both packages replaced by an argmax for the comparison.
Assignments and counts must be exactly equal, float stats within rtol 1e-5
/ atol 1e-3 (f32 sums of the same rows in another order), sample_size
equal."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributions_tpu import clustering as jcl, mixture as jmx_eager
from distributions_tpu.inference import runner as jr
from distributions_tpu.models import nich as jnich
from distributions_tpu.ops import gibbs as jg_eager, pallas_kernels as pk
from distributions_tpu.parallel import sharding as jsh
from distributions_tpu_torch import clustering as tcl, config, convert
from distributions_tpu_torch import mixture as tmx, testing
from distributions_tpu_torch.inference import runner as tr
from distributions_tpu_torch.models import MODULES, nich as tnich
from distributions_tpu_torch.ops import fused_kernels as fk, gibbs as tg
from distributions_tpu_torch.parallel import sharding as tsh

torch.set_num_threads(1)
config.set_default_device('cpu')

SUM_RTOL, SUM_ATOL = 1e-5, 1e-3
NEAR_TIE = 1e-3
PY = {'alpha': 1.0, 'd': 0.1}
JAX_MODELS = {name: importlib.import_module('distributions_tpu.models.'
                                            + name) for name in MODULES}


class _Traced:
    """A JAX module whose functions named in `static` (name -> the indices
    of their static arguments) are jitted: traced and compiled once per
    spec and shapes, where their eager ops would each compile on their
    own.  Other names are the module's own."""

    def __init__(self, module, static):
        self._module = module
        self._jitted = {name: jax.jit(getattr(module, name),
                                      static_argnums=argnums)
                        for name, argnums in static.items()}

    def __getattr__(self, name):
        return self._jitted.get(name) or getattr(self._module, name)


jmx = _Traced(jmx_eager, {'state_from_assignments': (0,)})
jg = _Traced(jg_eager, {'_build_fused_inputs': (0, 1, 2, 3, 4),
                        'build_stat_cache': (0, 3)})
# the sharded functions that are no sweep, traced likewise (`jsh` itself
# stays the module: tests patch its `sample_from_scores`)
_jsh_state_from_assignments = jax.jit(jsh.sharded_state_from_assignments,
                                      static_argnums=(0, 5))
_jsh_score_data = jax.jit(jsh.sharded_score_data, static_argnums=(0,))
_jsh_shard_state_components = jax.jit(jsh.shard_state_components,
                                      static_argnums=(1,))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _nich_pair(values, labels, C, shared, py=PY):
    """One nich problem in both packages: (JAX side, port side), each
    (spec, clustering model, shareds, values, assignments, state)."""
    jspec = jmx.make_spec([(jnich, values.shape[1])], capacity=C, empties=1)
    jpy = jcl.PitmanYor.from_dict(py)
    jshd = (jnich.shared_from_dict(shared),)
    jv = (jnp.asarray(values),)
    ja = jnp.asarray(labels, jnp.int32)
    jst = jmx.state_from_assignments(jspec, jpy, jshd, jv, ja)
    spec = convert.spec(jspec)
    tpy = convert.cl_model(_np(jpy))
    shd = convert.shareds(jspec, _np(jshd))
    tv = (torch.from_numpy(values),)
    ta = torch.from_numpy(np.asarray(labels, np.int32))
    st = convert.state(jspec, _np(jst))
    return (jspec, jpy, jshd, jv, ja, jst), (spec, tpy, shd, tv, ta, st)


def _blobs(R, C, cols=2, seed=0, n_clusters=3, random_start=False):
    """tests/test_sharding.py::make_problem and
    tests/test_component_sharding.py::make_problem."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_clusters, cols) * 3
    true = rng.randint(0, n_clusters, R)
    values = (centers[true] + 0.3 * rng.randn(R, cols)).astype(np.float32)
    start = rng.randint(0, n_clusters, R) if random_start else true
    return values, start.astype(np.int32), true


def _saturated(R=512, C=32, cols=2, seed=0):
    """tests/test_sharding_2d.py::_saturated_problem: every slot holds a
    tight cluster, so the per-shard and the global alive sets coincide."""
    rng = np.random.RandomState(seed)
    centers = 6.0 * rng.randn(C, cols).astype(np.float32)
    labels = np.concatenate([np.arange(C), rng.randint(0, C, R - C)])
    values = (centers[labels] + 0.1 * rng.randn(R, cols)).astype(np.float32)
    return values, labels.astype(np.int32)


SAT_SHARED = {'mu': 0., 'kappa': 0.1, 'sigmasq': 0.1, 'nu': 1.}
BLOB_SHARED = {'mu': 0., 'kappa': 0.1, 'sigmasq': 1.0, 'nu': 1.}


def _assert_state_close(st, jst):
    """Counts and sample_size exactly, float stats within tolerance."""
    np.testing.assert_array_equal(st.counts.numpy(), np.asarray(jst.counts))
    assert int(st.sample_size) == int(jst.sample_size)
    for g, jg_ in zip(st.groups, jst.groups):
        for leaf, jleaf in zip(g, jg_):
            np.testing.assert_allclose(leaf.numpy(), np.asarray(jleaf),
                                       rtol=SUM_RTOL, atol=SUM_ATOL)


# -- py_score_value_sharded ---------------------------------------------------

@pytest.mark.parametrize('raw', tcl.PitmanYor.EXAMPLES[1:4])
def test_py_score_value_sharded_matches_jax(raw):
    rng = np.random.RandomState(0)
    counts = rng.randint(0, 6, 32).astype(np.int32)
    counts[5:9] = 0
    alive = (counts > 0) | (np.arange(32) == 6)
    want = jcl.py_score_value_sharded(
        jcl.PitmanYor.from_dict(raw), jnp.asarray(counts),
        jnp.asarray(alive), jnp.int32(90), jnp.int32(3), jnp.int32(40))
    got = tcl.py_score_value_sharded(
        tcl.PitmanYor.from_dict(raw), torch.from_numpy(counts),
        torch.from_numpy(alive), torch.tensor(90, dtype=torch.int32),
        torch.tensor(3, dtype=torch.int32),
        torch.tensor(40, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # the local scorer with the local counts is py_score_value
    is_empty = alive & (counts == 0)
    same = tcl.py_score_value_sharded(
        tcl.PitmanYor.from_dict(raw), torch.from_numpy(counts),
        torch.from_numpy(alive), 90, int(is_empty.sum()),
        int((alive & (counts > 0)).sum()))
    ref = tcl.py_score_value(tcl.PitmanYor.from_dict(raw),
                             torch.from_numpy(counts),
                             torch.from_numpy(alive), 90)
    assert torch.equal(same, ref)


# -- K3's twin ------------------------------------------------------------------

R, C, BLOCK_ROWS = 256, 128, 128


@functools.lru_cache(maxsize=None)
def _operands(kind, rows=R):
    """One seeded problem, its state built by the JAX package and carried
    over, and the kernel operands of both packages.  'nich2' is a
    nich-only layout."""
    if kind == 'nich2':
        values, labels = testing.nich_problem(rows, seed=1)
        (jspec, jpy, jshd, jv, ja, jst), (spec, tpy, shd, tv, ta, st) = \
            _nich_pair(values, labels, C, testing.NICH_SHARED)
    else:
        p = testing.mixed_problem(rows, C, seed=1, kind=kind)
        jspec, jpy, jshd = testing.build_problem(
            p, JAX_MODELS, jmx.make_spec, jcl.PitmanYor.from_dict)
        jv = tuple(jnp.asarray(v) for v in p['values'])
        jst = jmx.state_from_assignments(jspec, jpy, jshd, jv,
                                         jnp.asarray(p['labels']))
        spec = convert.spec(jspec)
        tpy = convert.cl_model(_np(jpy))
        shd = convert.shareds(jspec, _np(jshd))
        tv = tuple(torch.from_numpy(v) for v in p['values'])
        st = convert.state(jspec, _np(jst))
    jlay = jg._mixed_static_layout(jspec, jv, None)
    jin = jg._build_fused_inputs(
        jspec, jlay.nich_blocks, jlay.quad_blocks, jlay.table_blocks, jlay.V,
        jshd, jlay.supports_dev, jst)
    jcls = jcl.score_value(jpy, jst.counts, jst.alive, jst.sample_size)
    lay = tg._mixed_static_layout(spec, tv)
    tin = tg._build_fused_inputs(spec, lay, shd, st)
    cls = tcl.score_value(tpy, st.counts, st.alive, st.sample_size)
    col_groups = tuple(spec.blocks[i].cols for i in lay.nich_blocks)
    return dict(jlay=jlay, jin=jin, jcls=jcls, lay=lay, tin=tin, cls=cls,
                col_groups=col_groups)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


@pytest.mark.parametrize('kind', ['nich2', 'niw3_nich_bb', 'dd_bb'])
def test_pair_twin_matches_jax_kernel(kind):
    """The twin on the JAX package's own operands against
    pk.fused_score_sample_pair in interpret mode ('argmax'): slots exactly
    (a near-tie, where the JAX kernel's bf16-split table entries round
    another way, is counted, printed and bounded; none expected), best
    within rtol 1e-5 / atol 1e-4."""
    o = _operands(kind)
    jlay, (jco, jqco, jtab), lay = o['jlay'], o['jin'], o['lay']
    jidx, jbest = pk.fused_score_sample_pair(
        0, jlay.nich_vals, jlay.table_idx, o['jcls'], jco, jtab,
        o['col_groups'], block_rows=BLOCK_ROWS, interpret=True,
        sampling='argmax', qvalues=jlay.quad_vals, qcoeffs=jqco,
        quad_groups=jlay.quad_groups, table_vs=jlay.table_vs)
    vtot = sum(lay.table_vs)
    tables = _t(np.asarray(jtab)[:vtot]) if vtot else None
    args = (lay.nich_vals, lay.table_idx, _t(o['jcls']),
            _t(jco) if o['col_groups'] else None, tables, o['col_groups'])
    kwargs = dict(qvalues=lay.quad_vals,
                  qcoeffs=_t(jqco) if lay.quad_groups else None,
                  quad_groups=lay.quad_groups, table_vs=lay.table_vs)
    before = fk.fused_score_sample_pair.launches
    idx, best = fk.fused_score_sample_pair(0, *args, sampling='argmax',
                                           **kwargs)
    assert fk.fused_score_sample_pair.launches == before   # the twin ran
    assert idx.dtype == torch.int32 and best.dtype == torch.float32
    scores = fk._score_mixed(
        R, *args[:4], None if tables is None else torch.clamp(tables,
                                                              min=-1e30),
        o['col_groups'], lay.quad_vals, kwargs['qcoeffs'], lay.quad_groups,
        lay.table_vs, torch.log)
    n_bad, gap = testing.mismatches(scores, idx, np.asarray(jidx))
    if n_bad:
        print('near-ties: %s: %d of %d rows differ, largest score gap %.3g'
              % (kind, n_bad, R, gap))
    assert n_bad <= R // 100 and gap <= NEAR_TIE, (n_bad, gap)
    np.testing.assert_allclose(best.numpy(), np.asarray(jbest), rtol=1e-5,
                               atol=1e-4 if n_bad == 0 else NEAR_TIE)


def _pair_reduce(pairs, offsets, n_slots):
    best = torch.stack([p[1] for p in pairs])
    ids = torch.stack([p[0].long() + o for p, o in zip(pairs, offsets)])
    top = best.max(0).values
    return torch.where(best == top, ids, torch.full_like(ids, n_slots)) \
        .min(0).values.to(torch.int32)


@pytest.mark.parametrize('kind,rows,cuts', [
    ('niw3_nich_bb', 256, (0, 32, 64, 96, 128)),
    ('dd_bb', 256, (0, 64, 128)),
    # ragged: slot ranges that are no multiple of 4 at odd offsets, rows
    # that are no multiple of any thread block
    ('niw3_nich_bb', 203, (0, 33, 35, 128)),
    ('nich2', 203, (0, 1, 127, 128))])
@pytest.mark.parametrize('sampling', ['argmax', 'gumbel_host', 'gumbel',
                                      'gumbel_fast'])
def test_pair_twin_shards_reduce_to_k2_twin(kind, rows, cuts, sampling):
    """K3's twin over slices of a K2 problem, pair-reduced, draws what
    K2's twin draws on the whole slot axis, with the same seed also in
    'gumbel': the noise of a (row, global slot) does not depend on the
    cut."""
    o = _operands(kind, rows)
    lay, (co, qco, tab) = o['lay'], o['tin']
    noise = None
    if sampling == 'gumbel_host':
        noise = torch.from_numpy(np.random.RandomState(3).gumbel(
            size=(rows, C)).astype(np.float32))
    whole = fk.fused_mixed_score_sample_stats(
        5, lay.nich_vals, lay.table_idx, o['cls'], co, tab, o['col_groups'],
        sampling=sampling, qvalues=lay.quad_vals, qcoeffs=qco,
        quad_groups=lay.quad_groups, noise=noise, table_vs=lay.table_vs)[0]

    def cut(x, a, b):
        return None if x is None else x[:, a:b].contiguous()
    pairs = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        pairs.append(fk.fused_score_sample_pair(
            5, lay.nich_vals, lay.table_idx, o['cls'][a:b].contiguous(),
            cut(co, a, b), cut(tab, a, b), o['col_groups'], sampling=sampling,
            qvalues=lay.quad_vals, qcoeffs=cut(qco, a, b),
            quad_groups=lay.quad_groups, table_vs=lay.table_vs,
            noise=cut(noise, a, b), slot_offset=a, total_slots=C))
        assert pairs[-1][0].shape == (rows,)
        assert int(pairs[-1][0].max()) < b - a
    assert torch.equal(_pair_reduce(pairs, cuts[:-1], C), whole)


def test_pair_wrapper_rejects_cdf_and_bad_offsets():
    o = _operands('dd_bb')
    lay, (co, qco, tab) = o['lay'], o['tin']
    args = (lay.nich_vals, lay.table_idx, o['cls'], co, tab, ())
    with pytest.raises(ValueError, match='pair kernel draws'):
        fk.fused_score_sample_pair(0, *args, sampling='cdf',
                                   table_vs=lay.table_vs)
    with pytest.raises(ValueError, match='slot_offset'):
        fk.fused_score_sample_pair(0, *args, sampling='argmax',
                                   table_vs=lay.table_vs, slot_offset=-1)
    with pytest.raises(ValueError, match='CPU or CUDA'):
        fk.fused_score_sample_pair(
            0, lay.nich_vals, lay.table_idx, o['cls'].to('meta'), co, tab,
            (), sampling='argmax', table_vs=lay.table_vs)


# -- the mesh -------------------------------------------------------------------

def test_mesh_collectives_in_shard_order():
    mesh = tsh.make_mesh_2d(2, 3)
    assert mesh.size == 6 and mesh.axis_names == ('rows', 'components')
    assert mesh.axis_size('rows') == 2 and mesh.axis_size('components') == 3
    assert mesh.axis_index('rows') == [0, 0, 0, 1, 1, 1]
    assert mesh.axis_index('components') == [0, 1, 2, 0, 1, 2]
    xs = [torch.tensor([float(10 * r + c)]) for r in range(2)
          for c in range(3)]
    assert [float(x) for x in mesh.psum(xs, 'rows')] == [10, 12, 14] * 2
    assert [float(x) for x in mesh.psum(xs, 'components')] == [3] * 3 \
        + [33] * 3
    assert [float(x) for x in mesh.pmax(xs, 'components')] == [2] * 3 \
        + [12] * 3
    assert [float(x) for x in mesh.pmin(xs, 'rows')] == [0, 1, 2] * 2
    # f32 sums go in shard order: (a + b) + c, not a + (b + c)
    a, b, c = (torch.tensor([v], dtype=torch.float32)
               for v in (1e8, -1e8, 1.0))
    line = tsh.make_mesh(3)
    assert float(line.psum([a, b, c], 'rows')[0]) == 1.0
    assert float(line.psum([c, a, b], 'rows')[0]) == 0.0
    # values replicated over an axis are computed once per line
    calls = []
    out = mesh.map_over('rows', lambda x: calls.append(x) or x + 1, xs)
    assert len(calls) == 3 and out[0] is out[3]
    # a mesh without the axis: the collective is the identity
    comps = tsh.make_component_mesh(2)
    ys = [torch.ones(1), 2 * torch.ones(1)]
    assert [float(y) for y in comps.psum(ys, 'rows')] == [1, 2]
    with pytest.raises(ValueError, match='one device'):
        tsh.make_mesh(['cpu', 'meta'])
    assert tsh.make_mesh(['cpu'] * 3).size == 3


# -- row-sharded sweeps -----------------------------------------------------------

def test_sharded_state_matches_local():
    values, start, _ = _blobs(64, 16, random_start=True)
    (jspec, jpy, jshd, jv, ja, jst), (spec, tpy, shd, tv, ta, st) = \
        _nich_pair(values, start, 16, dict(BLOB_SHARED, kappa=1.))
    got = tsh.sharded_state_from_assignments(spec, tpy, shd, tv, ta,
                                             tsh.make_mesh(8))
    want = _jsh_state_from_assignments(jspec, jpy, jshd, jv, ja,
                                       jsh.make_mesh())
    _assert_state_close(got, want)
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
    assert float(tsh.sharded_score_data(spec, tpy, shd, got)) == \
        pytest.approx(float(_jsh_score_data(jspec, jpy, jshd, want)),
                      rel=1e-5)


def _argmax_draws(monkeypatch):
    """Replace the draw of both packages' sharded_sweep_blocked by an
    argmax of the scores."""
    monkeypatch.setattr(jsh, 'sample_from_scores',
                        lambda key, scores: jnp.argmax(scores))
    monkeypatch.setattr(
        tsh, '_draw_rows',
        lambda scores, noise: torch.argmax(scores, dim=1).to(torch.int32))


@pytest.mark.parametrize('n_dev,block', [(8, 4), (2, 8)])
def test_sharded_sweep_blocked_matches_jax(monkeypatch, n_dev, block):
    _argmax_draws(monkeypatch)
    values, start, _ = _blobs(64, 16, random_start=True)
    (jspec, jpy, jshd, jv, ja, jst), (spec, tpy, shd, tv, ta, st) = \
        _nich_pair(values, start, 16, dict(BLOB_SHARED, kappa=1.))
    jst2, jan = jsh.sharded_sweep_blocked(
        jspec, jpy, jshd, jst, jv, ja, jax.random.PRNGKey(0),
        jsh.make_mesh(jax.devices()[:n_dev]), block)
    st2, an = tsh.sharded_sweep_blocked(spec, tpy, shd, st, tv, ta, _gen(),
                                        tsh.make_mesh(n_dev), block)
    assert an.dtype == torch.int32
    np.testing.assert_array_equal(an.numpy(), np.asarray(jan))
    _assert_state_close(st2, jst2)


def test_sharded_sweep_blocked_invariants_layout_and_fit():
    """tests/test_sharding.py: counts equal a bincount; the same generator
    state gives the same draws on 1 and on 8 shards when the tile
    schedules match; 20 sweeps find the clusters."""
    values, start, _ = _blobs(64, 16, random_start=True)
    _, (spec, tpy, shd, tv, ta, st) = _nich_pair(
        values, start, 16, dict(BLOB_SHARED, kappa=1.))
    _, a8 = tsh.sharded_sweep_blocked(spec, tpy, shd, st, tv, ta, _gen(3),
                                      tsh.make_mesh(8), 8)
    _, a1 = tsh.sharded_sweep_blocked(spec, tpy, shd, st, tv, ta, _gen(3),
                                      tsh.make_mesh(1), 64)
    assert torch.equal(a8, a1)
    gen = _gen(1)
    an = ta
    for _ in range(20):
        st, an = tsh.sharded_sweep_blocked(spec, tpy, shd, st, tv, an, gen,
                                           tsh.make_mesh(8), 4)
    np.testing.assert_array_equal(np.bincount(an.numpy(), minlength=16),
                                  st.counts.numpy())
    assert int(st.sample_size) == 64
    assert 2 <= int((st.counts > 0).sum()) <= 6
    with pytest.raises(ValueError, match='multiple of the block'):
        tsh.sharded_sweep_blocked(spec, tpy, shd, st, tv, an, gen,
                                  tsh.make_mesh(8), 5)


def _mixed_pair(kind, rows, capacity=128):
    p = testing.mixed_problem(rows, capacity, seed=0, kind=kind)
    jspec, jpy, jshd = testing.build_problem(
        p, JAX_MODELS, jmx.make_spec, jcl.PitmanYor.from_dict)
    jv = tuple(jnp.asarray(v) for v in p['values'])
    ja = jnp.asarray(p['labels'])
    jst = jmx.state_from_assignments(jspec, jpy, jshd, jv, ja)
    spec = convert.spec(jspec)
    tpy = convert.cl_model(_np(jpy))
    shd = convert.shareds(jspec, _np(jshd))
    tv = tuple(torch.from_numpy(v) for v in p['values'])
    return (jspec, jpy, jshd, jv, ja, jst), (
        spec, tpy, shd, tv, torch.from_numpy(p['labels']),
        convert.state(jspec, _np(jst)))


@pytest.mark.parametrize('kind', ['nich_gp_bb', 'niw3_nich_bb'])
def test_sharded_fused_matches_jax_and_single_device(kind):
    """tests/test_fused_mixed.py::test_sharded_fused_matches_single_device
    _argmax and ::test_niw_sharded_fused_matches_single_device: 8 row
    shards of local tile 64 against the JAX function and against the
    single-device fused sweep with tile 512, and the cache check.  The
    port's sweep is the static one that the card replays from a CUDA
    graph (`_sharded_fused_sweep_into`), here also fed its seeds as a
    tensor."""
    (jspec, jpy, jshd, jv, ja, jst), (spec, tpy, shd, tv, ta, st) = \
        _mixed_pair(kind, 512)
    jcache = jg.build_stat_cache(jspec, jshd, jv, 64, ja)
    jst2, jan, _ = jsh.sharded_sweep_fused(
        jspec, jpy, jshd, jst, jv, ja, jax.random.PRNGKey(0), jsh.make_mesh(),
        64, jcache, block_rows=64, sampling='argmax')
    cache = tg.build_stat_cache(spec, shd, tv, 64, ta)
    mesh = tsh.make_mesh(8)
    st2, an, cache2 = tsh.sharded_sweep_fused(
        spec, tpy, shd, st, tv, ta, _gen(), mesh, 64, cache,
        block_rows=64, sampling='argmax')
    np.testing.assert_array_equal(an.numpy(), np.asarray(jan))
    _assert_state_close(st2, jst2)
    sup = tsh._supports_for(spec, tv, None)
    lays = tuple(tg._mixed_static_layout(spec, v, sup)
                 for v in tsh._shard_values(mesh, tv))
    assigns = tuple(a.clone() for a in tsh._shard_rows(mesh, ta))
    caches = tuple((c.clone(), tuple(x.clone() for x in s)) for c, s in zip(
        tsh._shard_rows(mesh, cache[0]),
        zip(*(tsh._shard_rows(mesh, x) for x in cache[1]))))
    tsh._sharded_fused_sweep_into(
        spec, mesh, lays, tg._stat_matrices(spec, lays[0], shd), 64, 64,
        'argmax', tpy, shd, tg._map_tensors(torch.clone, st), assigns,
        caches, torch.zeros(8, dtype=torch.int64))
    np.testing.assert_array_equal(torch.cat(assigns).numpy(), np.asarray(jan))

    cache1 = tg.build_stat_cache(spec, shd, tv, 512, ta)
    st1, an1, _ = tg.sweep_blocked_pallas_fused_mixed(
        spec, tpy, shd, st, tv, ta, 512, 64, _gen(), cache1,
        sampling='argmax')
    assert torch.equal(an, an1) and torch.equal(st2.counts, st1.counts)
    # the sharded cache (local per-tile sums) is a fresh one on the draws
    fresh = tg.build_stat_cache(spec, shd, tv, 64, an)
    assert torch.equal(cache2[0], fresh[0])
    for got, want in zip(cache2[1], fresh[1]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=SUM_RTOL,
                                   atol=SUM_ATOL)


@pytest.mark.parametrize('sampling', ['gumbel', 'gumbel_host', 'cdf_host'])
def test_sharded_fused_multi_sweep_score_and_one_shard(sampling):
    """n_sweeps, with_score and the '_host' noise per (sweep, global
    tile); on one shard the sweep is the single-device one, bitwise."""
    _, (spec, tpy, shd, tv, ta, st) = _mixed_pair('niw3_nich_bb', 512)
    cache = tg.build_stat_cache(spec, shd, tv, 64, ta)
    runs = [tsh.sharded_sweep_fused(
        spec, tpy, shd, st, tv, ta, _gen(4), tsh.make_mesh(4), 64, cache,
        sampling=sampling, n_sweeps=2, with_score=True) for _ in range(2)]
    (st2, an, _, score), (_, an_again, _, _) = runs
    assert torch.equal(an, an_again)
    np.testing.assert_array_equal(np.bincount(an.numpy(), minlength=128),
                                  st2.counts.numpy())
    fresh = float(tmx.score_data(spec, tpy, shd, tmx.state_from_assignments(
        spec, tpy, shd, tv, an)))
    assert abs(float(score) - fresh) <= 1e-4 * abs(fresh)

    one = tsh.sharded_sweep_fused(
        spec, tpy, shd, st, tv, ta, _gen(4), tsh.make_mesh(1), 64, cache,
        sampling=sampling, n_sweeps=2)
    ref = tg.sweep_blocked_pallas_fused_mixed(
        spec, tpy, shd, st, tv, ta, 64, 64, _gen(4), cache,
        sampling=sampling, n_sweeps=2)
    assert torch.equal(one[1], ref[1])
    for g, w in zip(one[0].groups, ref[0].groups):
        assert all(torch.equal(x, y) for x, y in zip(g, w))


# -- component-sharded and 2-D sweeps -----------------------------------------

def test_component_sharded_argmax_matches_jax():
    """tests/test_component_sharding.py::test_component_sharded_argmax_
    matches_single_device, held to the JAX function itself."""
    py = {'alpha': 0.1, 'd': 0.0}
    values, start, _ = _blobs(64, 32, seed=5)
    (jspec, jpy, jshd, jv, ja, jst), (spec, tpy, shd, tv, ta, st) = \
        _nich_pair(values, start, 32, BLOB_SHARED, py)
    jst2, jan = jsh.sharded_sweep_components(
        jspec, jpy, jshd, jst, jv, ja, jax.random.PRNGKey(0),
        jsh.make_component_mesh(), 16, sampling='argmax')
    st2, an = tsh.sharded_sweep_components(
        spec, tpy, shd, st, tv, ta, _gen(), tsh.make_component_mesh(8), 16,
        sampling='argmax')
    np.testing.assert_array_equal(an.numpy(), np.asarray(jan))
    _assert_state_close(st2, jst2)
    np.testing.assert_array_equal(st2.alive.numpy(), np.asarray(jst2.alive))


def test_component_sharded_gumbel_invariants_and_purity():
    values, start, true = _blobs(64, 32)
    _, (spec, tpy, shd, tv, ta, st) = _nich_pair(values, start, 32,
                                                 BLOB_SHARED)
    mesh = tsh.make_component_mesh(8)
    gen = _gen(0)
    an = ta
    for _ in range(10):
        st, an = tsh.sharded_sweep_components(spec, tpy, shd, st, tv, an, gen,
                                              mesh, 16)
    a = an.numpy()
    np.testing.assert_array_equal(np.bincount(a, minlength=32),
                                  st.counts.numpy())
    assert int(st.sample_size) == 64
    purity = sum(np.bincount(true[a == k]).max() for k in np.unique(a)) / 64
    assert purity > 0.9, purity
    # every shard with a free slot keeps an alive empty one (a shard of
    # four slots can fill up)
    alive = st.alive.numpy().reshape(8, -1)
    free = st.counts.numpy().reshape(8, -1) == 0
    assert ((alive & free).sum(axis=1) >= np.minimum(free.sum(axis=1),
                                                      1)).all()
    assert (alive & free).sum() >= 7


def test_2d_argmax_matches_jax_with_the_sharded_state_carried_over():
    """tests/test_sharding_2d.py::test_2d_argmax_matches_single_device
    against the JAX function, then a second sweep from the JAX package's
    component-sharded state, carried across leaf by leaf."""
    values, labels = _saturated()
    (jspec, jpy, jshd, jv, ja, jst), (spec, tpy, shd, tv, ta, st) = \
        _nich_pair(values, labels, 32, SAT_SHARED)
    jmesh = jsh.make_mesh_2d(2, 4)
    mesh = tsh.make_mesh_2d(2, 4)
    jst2, jan = jsh.sharded_sweep_2d(
        jspec, jpy, jshd, _jsh_shard_state_components(jst, jmesh), jv, ja,
        jax.random.PRNGKey(0), jmesh, 256, sampling='argmax')
    sharded = tsh.shard_state_components(st, mesh)
    assert len(sharded) == 8 and sharded[0] is sharded[4]
    assert sharded[1].counts.shape == (8,)
    sts, an = tsh.sharded_sweep_2d(spec, tpy, shd, sharded, tv, ta, _gen(),
                                   mesh, 256, sampling='argmax')
    assert isinstance(sts, list)           # sharded in, sharded out
    st2 = tsh.unshard_state_components(sts, mesh)
    np.testing.assert_array_equal(an.numpy(), np.asarray(jan))
    _assert_state_close(st2, jst2)
    assert int(st2.sample_size) == 512

    # the single-device reference: remove all, score, argmax, add all
    ref = tmx.remove_tile(spec, tpy, shd, st, tv, ta)
    an_ref = torch.argmax(tmx.score_batch(spec, tpy, shd, ref, tv), dim=1)
    assert torch.equal(an.long(), an_ref)

    carried = convert.sharded_state(jspec, _np(jst2), mesh)
    np.testing.assert_array_equal(
        torch.cat([s.alive for s in carried[:4]]).numpy(),
        np.asarray(jst2.alive))
    jst3, jan3 = jsh.sharded_sweep_2d(
        jspec, jpy, jshd, jst2, jv, jan, jax.random.PRNGKey(1), jmesh, 64,
        sampling='argmax')
    sts3, an3 = tsh.sharded_sweep_2d(
        spec, tpy, shd, carried, tv, torch.from_numpy(np.asarray(jan)),
        _gen(1), mesh, 64, sampling='argmax')
    np.testing.assert_array_equal(an3.numpy(), np.asarray(jan3))
    _assert_state_close(tsh.unshard_state_components(sts3, mesh), jst3)
    back = convert.to_numpy(tsh.unshard_state_components(sts3, mesh))
    np.testing.assert_array_equal(back.alive, np.asarray(jst3.alive))


def test_2d_fused_argmax_matches_jax_and_plain_2d():
    """tests/test_sharding_2d.py::test_2d_fused_argmax_matches_xla_2d:
    C_local = 512 / 4 = 128 meets the JAX kernel's lane rule."""
    values, labels = _saturated(R=1024, C=512)
    (jspec, jpy, jshd, jv, ja, jst), (spec, tpy, shd, tv, ta, st) = \
        _nich_pair(values, labels, 512, SAT_SHARED)
    jmesh = jsh.make_mesh_2d(2, 4)
    jst_f, jan_f = jsh.sharded_sweep_2d_fused(
        jspec, jpy, jshd, _jsh_shard_state_components(jst, jmesh), jv, ja,
        jax.random.PRNGKey(0), jmesh, 512, block_rows=128, sampling='argmax')
    mesh = tsh.make_mesh_2d(2, 4)
    st_f, an_f = tsh.sharded_sweep_2d_fused(
        spec, tpy, shd, st, tv, ta, _gen(), mesh, 512, block_rows=128,
        sampling='argmax')
    st_x, an_x = tsh.sharded_sweep_2d(spec, tpy, shd, st, tv, ta, _gen(),
                                      mesh, 512, sampling='argmax')
    np.testing.assert_array_equal(an_f.numpy(), np.asarray(jan_f))
    _assert_state_close(st_f, jst_f)
    assert torch.equal(an_f, an_x) and torch.equal(st_f.counts, st_x.counts)


@pytest.mark.parametrize('kind', ['niw3_nich_bb', 'dd_bb'])
def test_2d_fused_equals_plain_2d_and_single_device(kind):
    """Mixed layouts, two tiles per row shard: 'argmax' 2-D fused equals
    'argmax' 2-D plain exactly; on a 1 x 1 mesh it equals the single-device
    fused sweep, in 'argmax' exactly and in 'gumbel' draw for draw but for
    near-ties (the same seeds and noise; the stat sums round
    differently)."""
    _, (spec, tpy, shd, tv, ta, st) = _mixed_pair(kind, 512, capacity=64)
    mesh = tsh.make_mesh_2d(2, 4)
    st_f, an_f = tsh.sharded_sweep_2d_fused(spec, tpy, shd, st, tv, ta,
                                            _gen(), mesh, 128,
                                            sampling='argmax')
    st_x, an_x = tsh.sharded_sweep_2d(spec, tpy, shd, st, tv, ta, _gen(),
                                      mesh, 128, sampling='argmax')
    assert torch.equal(an_f, an_x) and torch.equal(st_f.counts, st_x.counts)
    assert int(st_f.sample_size) == 512

    one = tsh.make_mesh_2d(1, 1)
    cache = tg.build_stat_cache(spec, shd, tv, 128, ta)
    for sampling, allowed in (('argmax', 0), ('gumbel', 5)):
        _, an_1 = tsh.sharded_sweep_2d_fused(spec, tpy, shd, st, tv, ta,
                                             _gen(2), one, 128,
                                             sampling=sampling)
        _, an_k2, _ = tg.sweep_blocked_pallas_fused_mixed(
            spec, tpy, shd, st, tv, ta, 128, 64, _gen(2), cache,
            sampling=sampling)
        assert int((an_1 != an_k2).sum()) <= allowed, sampling


def test_2d_gumbel_sweep_invariants_and_purity():
    """tests/test_sharding_2d.py::test_2d_gumbel_sweep_invariants_and_
    purity, on the plain and on the fused 2-D sweep."""
    rng = np.random.RandomState(1)
    Rr, Cc = 512, 32
    centers = np.array([[-4, -4], [4, 4], [-4, 4], [4, -4]], np.float32)
    true = rng.randint(0, 4, Rr)
    values = (centers[true] + 0.3 * rng.randn(Rr, 2)).astype(np.float32)
    start = rng.randint(0, Cc, Rr).astype(np.int32)
    _, (spec, tpy, shd, tv, ta, st0) = _nich_pair(values, start, Cc,
                                                  BLOB_SHARED)
    mesh = tsh.make_mesh_2d(2, 4)
    for sweep in (tsh.sharded_sweep_2d, tsh.sharded_sweep_2d_fused):
        state = tsh.shard_state_components(st0, mesh)
        an = ta
        gen = _gen(2)
        for _ in range(15):
            state, an = sweep(spec, tpy, shd, state, tv, an, gen, mesh, 32)
        full = tsh.unshard_state_components(state, mesh)
        counts, a = full.counts.numpy(), an.numpy()
        assert counts.sum() == Rr and int(full.sample_size) == Rr
        np.testing.assert_array_equal(counts, np.bincount(a, minlength=Cc))
        purity = sum(np.bincount(true[a == k]).max()
                     for k in np.unique(a)) / Rr
        assert purity > 0.95, (sweep.__name__, purity)
        alive = full.alive.numpy().reshape(4, -1)
        assert ((alive & (counts.reshape(4, -1) == 0)).sum(axis=1) >= 1).all()


def test_component_sweeps_reject_bad_arguments():
    values, start, _ = _blobs(64, 30)
    _, (spec, tpy, shd, tv, ta, st) = _nich_pair(values, start, 30,
                                                 BLOB_SHARED)
    with pytest.raises(ValueError, match='does not divide'):
        tsh.sharded_sweep_components(spec, tpy, shd, st, tv, ta, _gen(),
                                     tsh.make_component_mesh(4), 16)
    with pytest.raises(ValueError, match='PitmanYor'):
        tsh.sharded_sweep_components(
            spec, tcl.LowEntropy.from_dict({'dataset_size': 64}), shd, st,
            tv, ta, _gen(), tsh.make_component_mesh(2), 16)
    with pytest.raises(ValueError, match='sampling'):
        tsh.sharded_sweep_2d(spec, tpy, shd, st, tv, ta, _gen(),
                             tsh.make_mesh_2d(2, 2), 16, sampling='cdf')
    with pytest.raises(ValueError, match='pair kernel draws'):
        tsh.sharded_sweep_2d_fused(spec, tpy, shd, st, tv, ta, _gen(),
                                   tsh.make_mesh_2d(2, 2), 16,
                                   sampling='cdf')


# -- the runner --------------------------------------------------------------------

RUN_R, RUN_C, RUN_BLOCK = 2048, 128, 512


def _runner_pair(seed):
    values, labels = testing.nich_problem(RUN_R, seed=seed)
    jspec = jmx.make_spec([(jnich, 2)], capacity=RUN_C)
    jpy = jcl.PitmanYor.from_dict(testing.PY)
    jshd = (jnich.shared_from_dict(testing.NICH_SHARED),)
    spec = tmx.make_spec([(tnich, 2)], capacity=RUN_C)
    tpy = tcl.PitmanYor.from_dict(testing.PY)
    shd = (tnich.shared_from_dict(testing.NICH_SHARED),)
    return values, labels, (jspec, jpy, jshd), (spec, tpy, shd)


def _assert_logs_match(log, jlog):
    assert len(log.rows) == len(jlog.rows)
    for got, want in zip(log.rows, jlog.rows):
        assert got['sweep'] == want['sweep']
        assert got['sample_size'] == want['sample_size']
        assert got['nonempty_groups'] == want['nonempty_groups']
        assert abs(got['score_data'] - want['score_data']) \
            <= 1e-4 * abs(want['score_data'])


def test_run_gibbs_mesh_fused_argmax_matches_jax():
    values, labels, (jspec, jpy, jshd), (spec, tpy, shd) = _runner_pair(4)
    common = dict(block=RUN_BLOCK, use_pallas=True, sampling='argmax',
                  sweeps_per_step=2)
    jst, jan, jlog = jr.run_gibbs(
        jspec, jpy, jshd, (jnp.asarray(values),), jax.random.PRNGKey(0), 2,
        initial_assignments=jnp.asarray(labels),
        mesh=jsh.make_mesh(jax.devices()[:2]), **common)
    before = fk.fused_score_sample_stats.launches
    st, an, log = tr.run_gibbs(
        spec, tpy, shd, (torch.from_numpy(values),), _gen(), 2,
        initial_assignments=torch.from_numpy(labels), mesh=tsh.make_mesh(2),
        **common)
    assert fk.fused_score_sample_stats.launches == before
    np.testing.assert_array_equal(an.numpy(), np.asarray(jan))
    # several sweeps of f32 merges and unmerges: the float stats are held
    # through the logged scores
    np.testing.assert_array_equal(st.counts.numpy(), np.asarray(jst.counts))
    _assert_logs_match(log, jlog)


def test_run_gibbs_mesh_plain_branch_matches_jax(monkeypatch):
    """use_pallas=False under a mesh takes sharded_sweep_blocked sweep by
    sweep; so does a 2-D mesh, whatever use_pallas says."""
    _argmax_draws(monkeypatch)
    values, labels, (jspec, jpy, jshd), (spec, tpy, shd) = _runner_pair(5)
    values, labels = values[:256], labels[:256]
    jst, jan, jlog = jr.run_gibbs(
        jspec, jpy, jshd, (jnp.asarray(values),), jax.random.PRNGKey(0), 2,
        block=32, initial_assignments=jnp.asarray(labels),
        mesh=jsh.make_mesh(jax.devices()[:4]))
    st, an, log = tr.run_gibbs(
        spec, tpy, shd, (torch.from_numpy(values),), _gen(), 2, block=32,
        initial_assignments=torch.from_numpy(labels), mesh=tsh.make_mesh(4))
    np.testing.assert_array_equal(an.numpy(), np.asarray(jan))
    # several sweeps of f32 merges and unmerges: the float stats are held
    # through the logged scores
    np.testing.assert_array_equal(st.counts.numpy(), np.asarray(jst.counts))
    _assert_logs_match(log, jlog)
    st2, an2, _ = tr.run_gibbs(
        spec, tpy, shd, (torch.from_numpy(values),), _gen(), 2, block=32,
        use_pallas=True, initial_assignments=torch.from_numpy(labels),
        mesh=tsh.make_mesh_2d(4, 1))
    assert torch.equal(an2, an)


@pytest.mark.parametrize('use_pallas', [False, True])
def test_run_gibbs_mesh_resume_is_bitwise(tmp_path, use_pallas):
    values, _, _, (spec, tpy, shd) = _runner_pair(6)
    tv = (torch.from_numpy(values[:512]),)
    common = dict(block=64, use_pallas=use_pallas, sampling='gumbel',
                  checkpoint_every=2, sweeps_per_step=2, init='random:8',
                  mesh=tsh.make_mesh(4))

    def run(passes, name, seed, resume):
        return tr.run_gibbs(spec, tpy, shd, tv, _gen(seed), passes,
                            checkpoint_path=str(tmp_path / name),
                            resume=resume, **common)
    st_a, an_a, log_a = run(4, 'full', 5, False)
    run(2, 'crash', 5, False)
    st_b, an_b, log_b = run(4, 'crash', 999, True)
    assert torch.equal(an_a, an_b) and torch.equal(st_a.counts, st_b.counts)
    for x, y in zip(st_a.groups[0], st_b.groups[0]):
        assert torch.equal(x, y)
    assert [r['sweep'] for r in log_b.rows] == [1, 3]
    assert log_a.rows[-1]['score_data'] == log_b.rows[-1]['score_data']


def test_sharded_dry_run_on_eight_shards():
    """The three sharded calls of the JAX package's multi-chip dry run, and
    the two 2-D ones, on 8 logical shards."""
    n = 8

    def problem(R, C=16, seed=0):
        rng = np.random.RandomState(seed)
        values = rng.randn(R, 2).astype(np.float32)
        start = rng.randint(0, 4, R).astype(np.int32)
        return _nich_pair(values, start, C, dict(SAT_SHARED, sigmasq=0.01))[1]
    spec, tpy, shd, tv, ta, st = problem(8 * n)
    st2, _ = tsh.sharded_sweep_blocked(spec, tpy, shd, st, tv, ta, _gen(),
                                       tsh.make_mesh(n), 4)
    assert int(st2.counts.sum()) == 8 * n
    assert np.isfinite(float(tmx.score_data(spec, tpy, shd, st2)))

    spec, tpy, shd, tv, ta, st = problem(64 * n, C=128)
    cache = tg.build_stat_cache(spec, shd, tv, 64, ta)
    st2, _, _, score = tsh.sharded_sweep_fused(
        spec, tpy, shd, st, tv, ta, _gen(), tsh.make_mesh(n), 64, cache,
        block_rows=64, sampling='argmax', n_sweeps=2, with_score=True)
    assert int(st2.counts.sum()) == 64 * n and np.isfinite(float(score))

    spec, tpy, shd, tv, ta, st = problem(8 * n, C=8 * n)
    st2, _ = tsh.sharded_sweep_components(
        spec, tpy, shd, st, tv, ta, _gen(), tsh.make_component_mesh(n), 8)
    assert int(st2.counts.sum()) == 8 * n

    mesh2 = tsh.make_mesh_2d(2, n // 2)
    spec, tpy, shd, tv, ta, st = problem(8 * n, C=4 * n)
    sts, _ = tsh.sharded_sweep_2d(
        spec, tpy, shd, tsh.shard_state_components(st, mesh2), tv, ta, _gen(),
        mesh2, 8 * n // 4)
    assert int(tsh.unshard_state_components(sts, mesh2).counts.sum()) == 8 * n
    spec, tpy, shd, tv, ta, st = problem(256, C=128 * (n // 2))
    sts, _ = tsh.sharded_sweep_2d_fused(
        spec, tpy, shd, tsh.shard_state_components(st, mesh2), tv, ta, _gen(),
        mesh2, 128, block_rows=128, sampling='argmax')
    assert int(tsh.unshard_state_components(sts, mesh2).counts.sum()) == 256
