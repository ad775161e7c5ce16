"""Sharded collapsed-Gibbs sweeps over a mesh
(distributions_tpu.parallel.sharding).

- Row (data) sharding: the R rows are cut over the mesh's 'rows' axis;
  each shard scores and reassigns its rows against all C slots.  The stat
  deltas are additive, so one sum over 'rows' per tile keeps the
  replicated state consistent.
- Component sharding: the C slots are cut over the 'components' axis; each
  shard scores its [B, C_local] columns and the categorical draw is a
  pair reduce of (best perturbed score, slot) over the axis.
- Both at once on a 2-D mesh.

PyTorch has no `shard_map`, so a `Mesh` here is a small object with named
axes and the collectives the sweeps need (`psum`, `pmax`, `pmin`,
`axis_index`).  A value distributed over the mesh is the LIST of the
shards this process holds, in the order of `Mesh.local`; a collective
reduces first over that list, in shard order, and then across the ranks of
the axis's process group.  Two forms follow from it:

- in-process (`make_mesh(4)`, `make_mesh_2d(2, 4)`): one process holds all
  shards, on one device, and no process group exists.  Sums are taken in
  shard order and are bitwise repeatable.  N shards on one card measure
  the sharded code path and its overhead, not a speed-up;
- process group (`distributed.make_global_mesh()`): each rank of
  `torch.distributed` holds one or several shards and the collectives end
  in `all_reduce` (NCCL for CUDA tensors, gloo for CPU tensors).  Integer
  sums are exact; float sums may differ from the in-process form in the
  last bits when a rank holds several shards, because `all_reduce` does
  not add in shard order.

All shards of one process live on one device; more cards means more
processes.  Randomness: every sweep draws one seed from the caller's
`torch.Generator` (`random.draw_seed`), so under a process group every
rank must pass a generator in the same state; tile, row-shard and
component indices are folded into that seed (`random.fold_seed`), never
the rank, so the draws do not depend on which process holds a shard.
"""

import torch
import torch.distributed as dist

from distributions_tpu_torch import clustering as _clustering
from distributions_tpu_torch import mixture as mx
from distributions_tpu_torch.ops import fused_kernels as fk
from distributions_tpu_torch.ops import gibbs as _g
from distributions_tpu_torch.random import (device_generator, draw_seed,
                                            fold_seed, gumbel_noise)
# the JAX module's names for these two, reachable from this module there
from distributions_tpu_torch.models import base as model_base  # noqa: F401
from distributions_tpu_torch.random import sample_from_scores  # noqa: F401

ROWS = 'rows'
COMPONENTS = 'components'


# -- the mesh ---------------------------------------------------------------

def _tree_map(fn, *trees):
    """fn over the tensors of nested tuples / NamedTuples / lists."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if isinstance(first, tuple) and hasattr(first, '_fields'):
        return type(first)(*(_tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_map(fn, *xs) for xs in zip(*trees))
    raise TypeError('cannot reduce a %s over a mesh' % type(first).__name__)


def _all_reduce_packed(tree, op, group):
    """`tree` reduced across the ranks of `group`: its tensors packed into
    one flat buffer per dtype, reduced by one `all_reduce` each, and cut
    back into tensors of their own.  The reduction is elementwise, so this
    is bitwise what one `all_reduce` per tensor gives, with fewer
    collectives a tile; it makes no tensor from host data and waits on
    nothing from the host, so it runs inside a CUDA graph's capture."""
    leaves = []
    _tree_map(lambda t: leaves.append(t) or t, tree)
    by_dtype = {}
    for i, t in enumerate(leaves):
        by_dtype.setdefault(t.dtype, []).append(i)
    out = [None] * len(leaves)
    for idx in by_dtype.values():
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, op=op, group=group)
        parts = torch.split(flat, [leaves[i].numel() for i in idx])
        for i, part in zip(idx, parts):
            out[i] = part.view(leaves[i].shape)
    rest = iter(out)
    return _tree_map(lambda t: next(rest), tree)


class Mesh(object):
    """Named axes, the shards this process holds, and the collectives.

    axis_names: the axes, outermost first.  local_shape: shards per axis
    that THIS process holds.  process_shape / process_index: the grid of
    processes along each axis and this process's place in it (all 1 / 0
    for an in-process mesh).  groups: {axis: process group} for the axes
    cut over processes.  The size of an axis is local x processes; this
    process's shards along it are the contiguous run
    [index * local, (index + 1) * local)."""

    def __init__(self, axis_names, local_shape, process_shape=None,
                 process_index=None, groups=None):
        self.axis_names = tuple(axis_names)
        n = len(self.axis_names)
        local_shape = tuple(int(x) for x in local_shape)
        process_shape = tuple(process_shape or (1,) * n)
        process_index = tuple(process_index or (0,) * n)
        if min(local_shape + process_shape) < 1:
            raise ValueError('a mesh axis needs at least one shard')
        self.local_shape = dict(zip(self.axis_names, local_shape))
        self.process_shape = dict(zip(self.axis_names, process_shape))
        self.process_index = dict(zip(self.axis_names, process_index))
        self.shape = {a: l * p for a, l, p in zip(
            self.axis_names, local_shape, process_shape)}
        self.groups = dict(groups or {})
        # coordinates of the local shards, row-major over the axes
        self.local = [{}]
        for a, l, pi in zip(self.axis_names, local_shape, process_index):
            self.local = [dict(c, **{a: pi * l + i})
                          for c in self.local for i in range(l)]

    @property
    def size(self):
        """Shards in the whole mesh."""
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def axis_size(self, axis):
        return self.shape.get(axis, 1)

    def axis_index(self, axis):
        """Per local shard, its index along `axis` (0 for an axis the
        mesh lacks)."""
        return [c.get(axis, 0) for c in self.local]

    def _lines(self, axis):
        """The local shards grouped into lines along `axis`: lists of
        positions in `self.local` that differ only in their `axis` index,
        in the order of that index."""
        lines = {}
        for pos, c in enumerate(self.local):
            rest = tuple(v for a, v in sorted(c.items()) if a != axis)
            lines.setdefault(rest, []).append(pos)
        return list(lines.values())

    def map(self, fn, *xs):
        """fn(shard of each x) for every local shard."""
        return [fn(*args) for args in zip(*xs)]

    def map_over(self, axis, fn, *xs):
        """`map` for values that are replicated over `axis`: fn runs once
        per line along `axis` and every shard of the line gets the one
        result."""
        out = [None] * len(self.local)
        for line in self._lines(axis):
            res = fn(*(x[line[0]] for x in xs))
            for pos in line:
                out[pos] = res
        return out

    def _reduce(self, xs, axis, local_op, dist_op):
        if axis not in self.shape:
            return list(xs)
        group = self.groups.get(axis)
        out = [None] * len(self.local)
        for line in self._lines(axis):
            acc = xs[line[0]]
            for pos in line[1:]:
                acc = _tree_map(local_op, acc, xs[pos])
            if group is not None:
                acc = _all_reduce_packed(acc, dist_op, group)
            for pos in line:
                out[pos] = acc
        return out

    def psum(self, xs, axis):
        """Sum over `axis`, replicated over it: over the local shards in
        shard order, then across the axis's ranks."""
        return self._reduce(xs, axis, torch.add, dist.ReduceOp.SUM)

    def pmax(self, xs, axis):
        return self._reduce(xs, axis, torch.maximum, dist.ReduceOp.MAX)

    def pmin(self, xs, axis):
        return self._reduce(xs, axis, torch.minimum, dist.ReduceOp.MIN)

    def gather(self, xs, axis):
        """The shards along `axis` concatenated on dim 0 in axis order,
        replicated over `axis`."""
        if axis not in self.shape:
            return list(xs)
        group = self.groups.get(axis)
        out = [None] * len(self.local)
        for line in self._lines(axis):
            acc = _tree_map(lambda *ts: torch.cat(ts, dim=0),
                            *(xs[pos] for pos in line))
            if group is not None:
                def across(t):
                    t = t.contiguous()
                    parts = [torch.empty_like(t)
                             for _ in range(self.process_shape[axis])]
                    dist.all_gather(parts, t, group=group)
                    return torch.cat(parts, dim=0)
                acc = _tree_map(across, acc)
            for pos in line:
                out[pos] = acc
        return out


def _shard_count(devices):
    """`devices` of the mesh makers: None (one shard), a shard count, or a
    sequence of devices, one per shard, which must all name one device
    (a process keeps its shards on one device)."""
    if devices is None:
        return 1
    if isinstance(devices, int):
        return devices
    devices = [torch.device(d) for d in devices]
    if any(d != devices[0] for d in devices):
        raise ValueError('the shards of one process live on one device; '
                         'use one process per card '
                         '(parallel.distributed.make_global_mesh)')
    return len(devices)


def make_mesh(devices=None, axis_name=ROWS):
    """1-D in-process mesh named 'rows'.  devices: a shard count, or a
    sequence with one (and the same) device per shard; None is one
    shard."""
    return Mesh((axis_name,), (_shard_count(devices),))


def make_component_mesh(devices=None):
    """1-D in-process mesh named 'components'."""
    return Mesh((COMPONENTS,), (_shard_count(devices),))


def make_mesh_2d(n_rows, n_components, devices=None):
    """2-D in-process mesh ('rows' x 'components'): the mixture's analog
    of a (data, tensor) parallel grid."""
    if devices is not None and _shard_count(devices) < n_rows * n_components:
        raise ValueError('%d shards given for a %d x %d mesh'
                         % (_shard_count(devices), n_rows, n_components))
    return Mesh((ROWS, COMPONENTS), (n_rows, n_components))


# -- values cut along 'rows' --------------------------------------------------

class RowSharded(object):
    """A [n_rows, ...] array cut along 'rows' of which this process holds
    only its own row shards: `shards`, in shard order (what
    `distributed.global_rows_from_host_data` returns).  A sweep given
    such values and assignments returns its assignments in this form
    too."""

    def __init__(self, shards, n_rows, mesh):
        self.shards = list(shards)
        self.n_rows = int(n_rows)
        self.mesh = mesh


def _local_rows(mesh):
    """The 'rows' indices this process holds, ascending."""
    return sorted(set(mesh.axis_index(ROWS)))


def _shard_rows(mesh, x):
    """Per local shard, its rows of `x` (a full [R, ...] tensor, or a
    RowSharded)."""
    rows = _local_rows(mesh)
    if isinstance(x, RowSharded):
        if len(x.shards) != len(rows):
            raise ValueError('%d row shards given, this process holds %d'
                             % (len(x.shards), len(rows)))
        by_row = dict(zip(rows, x.shards))
    else:
        x = torch.as_tensor(x)
        n_row = mesh.axis_size(ROWS)
        if x.shape[0] % n_row != 0:
            raise ValueError('%d rows do not divide over %d row shards'
                             % (x.shape[0], n_row))
        per = x.shape[0] // n_row
        by_row = {r: x[r * per:(r + 1) * per] for r in rows}
    return [by_row[r] for r in mesh.axis_index(ROWS)]


def _unshard_rows(mesh, xs, like):
    """The inverse of `_shard_rows` for a per-shard list that is
    replicated over the other axes: a RowSharded when `like` is one, else
    the full tensor (gathered across the ranks of 'rows')."""
    first = {}
    for r, x in zip(mesh.axis_index(ROWS), xs):
        first.setdefault(r, x)
    shards = [first[r] for r in _local_rows(mesh)]
    if isinstance(like, RowSharded):
        return RowSharded(shards, like.n_rows, mesh)
    full = torch.cat(shards, dim=0)
    group = mesh.groups.get(ROWS)
    if group is not None:
        parts = [torch.empty_like(full)
                 for _ in range(mesh.process_shape[ROWS])]
        dist.all_gather(parts, full.contiguous(), group=group)
        full = torch.cat(parts, dim=0)
    return full


def local_row_ranges(mesh, n_rows):
    """The [start, stop) global row range of each 'rows' shard this
    process holds, ascending."""
    n = mesh.axis_size(ROWS)
    if n_rows % n != 0:
        raise ValueError('%d rows do not divide over %d row shards'
                         % (n_rows, n))
    per = n_rows // n
    return [(r * per, (r + 1) * per) for r in _local_rows(mesh)]


def cut_rows(full, mesh):
    """A full [R, ...] tensor as the RowSharded of this process's row
    shards."""
    return RowSharded([full[a:b] for a, b in local_row_ranges(
        mesh, full.shape[0])], full.shape[0], mesh)


def _shard_values(mesh, values):
    """Per local shard the tuple of its rows of every block's values."""
    cut = [_shard_rows(mesh, v) for v in values]
    return [tuple(c[i] for c in cut) for i in range(len(mesh.local))]


def _check_tiling(mesh, local_R, block):
    if local_R % block != 0:
        raise ValueError(
            'rows per shard (%d) must be a multiple of the block size (%d): '
            'pad rows to a multiple of row shards * block = %d'
            % (local_R, block, mesh.axis_size(ROWS) * block))
    return local_R // block


# -- row-sharded sweeps -------------------------------------------------------

def _draw_rows(scores, noise):
    """One slot per row of [B, C] scores by gumbel-argmax with the given
    noise."""
    return torch.argmax(scores + noise, dim=1).to(torch.int32)


def _apply_sums(spec, shareds, state, delta, sign, nrows):
    """Apply (counts delta, per-block raw sums) to a state."""
    cd, sums = delta
    return mx.apply_stat_tiles(spec, shareds, state, cd,
                               mx.sums_to_tiles(spec, shareds, sums), sign,
                               nrows)


def sharded_sweep_blocked(spec, cl_model, shareds, state, values,
                          assignments, generator, mesh, block):
    """One blocked-Gibbs pass with the rows sharded over `mesh`'s 'rows'
    axis.

    Per tile step every shard removes its local tile (the additive raw
    stat sums are summed over 'rows'), scores its [block, C] rows against
    the tile-frozen replicated state, draws by gumbel-argmax, and adds its
    tile back.  The effective global tile is block * row shards: global
    tile t is the union of every shard's local tile t.  State is
    replicated; values and assignments are full [R, ...] tensors (each
    shard takes its contiguous rows) or RowSharded.  R must be a multiple
    of row shards * block.

    The noise of global tile t is one [row shards * block, C] draw from a
    generator seeded with (sweep seed, t), of which shard i takes rows
    [i * block, (i + 1) * block): the draws depend on neither the process
    that holds a shard nor, when the tile schedules match, on the number
    of shards.  Returns (state, assignments)."""
    n_dev = mesh.axis_size(ROWS)
    vals = _shard_values(mesh, values)
    assign = _shard_rows(mesh, assignments)
    n_tiles = _check_tiling(mesh, assign[0].shape[0], block)
    n_removed = block * n_dev
    dev = assign[0].device
    sweep_seed = draw_seed(generator)
    shard_idx = mesh.axis_index(ROWS)
    states = [state] * len(mesh.local)
    row_stats = mesh.map(
        lambda v: mx.precompute_row_stats(spec, shareds, v), vals)
    out = [[] for _ in mesh.local]

    def tile_sums(stats, a):
        return mx.tile_sums_fast(spec, shareds, stats, a)

    for t in range(n_tiles):
        sl = slice(t * block, (t + 1) * block)
        tile_stats = mesh.map(lambda rs: tuple(r[sl] for r in rs), row_stats)
        delta = mesh.psum(mesh.map(
            lambda ts, a: tile_sums(ts, a[sl]), tile_stats, assign), ROWS)
        states = mesh.map_over(
            ROWS, lambda st, d: _apply_sums(spec, shareds, st, d, -1,
                                            n_removed), states, delta)
        noise = gumbel_noise(device_generator(fold_seed(sweep_seed, t), dev),
                             (n_dev * block, spec.capacity), dev)
        new = mesh.map(
            lambda st, v, i: _draw_rows(
                mx.score_batch(spec, cl_model, shareds, st,
                               tuple(x[sl] for x in v)),
                noise[i * block:(i + 1) * block]),
            states, vals, shard_idx)
        del noise
        delta = mesh.psum(mesh.map(tile_sums, tile_stats, new), ROWS)
        states = mesh.map_over(
            ROWS, lambda st, d: _apply_sums(spec, shareds, st, d, +1,
                                            n_removed), states, delta)
        for acc, a in zip(out, new):
            acc.append(a)
    return states[0], _unshard_rows(mesh, [torch.cat(a) for a in out],
                                    assignments)


def _supports_for(spec, values, supports):
    """The value supports of the table blocks.  They must be the same on
    every shard, so rows this process does not hold in full need them
    given."""
    if supports is not None:
        return supports
    if any(isinstance(v, RowSharded) for v in values):
        if any(_g._is_table_block(b) for b in spec.blocks):
            raise ValueError('RowSharded values of a spec with discrete '
                             'blocks need `supports` (the same on every '
                             'rank)')
        return (None,) * len(spec.blocks)
    return _g._block_supports(spec, values)


def _mesh_key(mesh):
    """What a captured sharded sweep is specialised to in `mesh`: its axes,
    their local and process shapes, this process's place, and the
    identity of each axis's process group (the graph keeps the mesh, and
    with it the groups)."""
    return (mesh.axis_names, tuple(mesh.local_shape.items()),
            tuple(mesh.process_shape.items()),
            tuple(mesh.process_index.items()),
            tuple((a, id(g)) for a, g in sorted(mesh.groups.items())))


def _on_device(values, device):
    """Full values as tensors on `device` (values given on the host become
    new tensors, so a key that names them is never used twice);
    RowSharded values as they are."""
    return tuple(v if isinstance(v, RowSharded)
                 else torch.as_tensor(v, device=device) for v in values)


def _values_key(vals, supports):
    """The addresses and versions of each local shard's values and of the
    supports: part of a graph's key."""
    return (tuple(_g._tensor_key(v) for sv in vals for v in sv),
            None if supports is None else tuple(
                None if s is None else _g._tensor_key(torch.as_tensor(s))
                for s in supports))


def _sharded_fused_sweep_into(spec, mesh, lays, W, block, block_rows,
                              sampling, cl_model, shareds, state, assigns,
                              caches, seeds):
    """One row-sharded fused sweep that writes its results into the
    tensors it reads: the leaves of the replicated `state`, and per local
    shard its assignments (`assigns`, [local R]) and its stat cache
    (`caches`, (counts [T, C], per-block sums [T, ...])), whose entry of
    tile t is read before the tile writes its new one.  The shard with
    'rows' index i takes seeds[i * T + t] at tile t: an int, or a view of
    the [row shards * T] int64 seed table that the kernel reads when it
    runs.

    As `gibbs._fused_sweep_into`: with a seed tensor and a mode without
    '_host', the sweep reads nothing back from the card and makes no
    tensor from host data (its collectives end in one `all_reduce` per
    dtype), so on the card it is captured into a CUDA graph; on the CPU it
    runs on the kernels' twins."""
    n_tiles = caches[0][0].shape[0]
    n_removed = block * mesh.axis_size(ROWS)
    dev = assigns[0].device
    shard_idx = mesh.axis_index(ROWS)
    states = [state] * len(mesh.local)
    for t in range(n_tiles):
        delta = mesh.psum([(c[0][t], tuple(s[t] for s in c[1]))
                           for c in caches], ROWS)
        states = mesh.map_over(
            ROWS, lambda st, d: _apply_sums(spec, shareds, st, d, -1,
                                            n_removed), states, delta)
        inputs = mesh.map_over(
            ROWS, lambda st, lay: _g._fused_tile_inputs(
                spec, lay, cl_model, shareds, st), states, lays)

        def tile(lay, st, inp, i):
            seed = seeds[i * n_tiles + t]
            return _g._fused_tile_core(
                spec, lay, W, block_rows, sampling, cl_model, shareds, st,
                *_g._slice_rows(lay, t, block), seed,
                noise=_g._tile_noise(sampling, seed, block, spec.capacity,
                                     dev), inputs=inp)
        res = mesh.map(tile, lays, states, inputs, shard_idx)
        delta = mesh.psum([(r[1], r[2]) for r in res], ROWS)
        states = mesh.map_over(
            ROWS, lambda st, d: _apply_sums(spec, shareds, st, d, +1,
                                            n_removed), states, delta)
        for a, (cd, sums), r in zip(assigns, caches, res):
            a[t * block:(t + 1) * block] = r[0]
            cd[t] = r[1]
            for buf, s in zip(sums, r[2]):
                buf[t] = s
    for dst, src in zip(_g._tensors(state), _g._tensors(states[0])):
        dst.copy_(src)


def sharded_sweep_fused(spec, cl_model, shareds, state, values,
                        assignments, generator, mesh, block, cache,
                        block_rows=512, sampling='cdf', supports=None,
                        n_sweeps=1, with_score=False):
    """Row-sharded blocked Gibbs with the fused kernel (K2, or K1 for a
    nich-only spec) per shard.

    Each shard runs the fused score + sample + stats kernel on its local
    [block] tile; the kernel's additive stat sums are summed over 'rows'.
    The remove side is the cached add-side sums of the previous sweep,
    kept LOCAL per shard and summed at use.

    cache = gibbs.build_stat_cache(spec, shareds, values, block,
    assignments): its leading tile axis is shard-major, so cutting it
    along 'rows' gives each shard exactly its own tiles' sums (RowSharded
    leaves go with RowSharded rows).

    Tile seeds are folded from the sweep seed by the GLOBAL tile index
    shard * tiles per shard + t (`random.sweep_seeds` over row shards x
    tiles), which also seeds the noise of the '_host' modes; on a
    one-shard mesh the sweep equals `gibbs.sweep_blocked_pallas_fused_mixed`
    bitwise.

    On the card each sweep is the replay of one CUDA graph of all its
    tiles and local shards (`gibbs._SweepGraph` over
    `_sharded_fused_sweep_into`), captured as the single-device fused
    sweep's is: on a key's second call, or its first within
    `gibbs.sweep_graph_session()`; the key holds the mesh (its shapes and
    process groups) and the values' tensors.  '_host' modes run eagerly
    (`gibbs._graph_refusal`).  The results are tensors of their own.

    Returns (state, assignments, cache), plus the joint mx.score_data when
    with_score=True."""
    n_row = mesh.axis_size(ROWS)
    assign = _shard_rows(mesh, assignments)
    n_tiles = _check_tiling(mesh, assign[0].shape[0], block)
    dev = assign[0].device
    cached_cd = _shard_rows(mesh, cache[0])
    cached_sums = [_shard_rows(mesh, s) for s in cache[1]]
    caches = tuple((cached_cd[i], tuple(s[i] for s in cached_sums))
                   for i in range(len(mesh.local)))
    assigns = tuple(a.to(torch.int32) for a in assign)

    key = None
    if _g._graph_refusal(dev, sampling, 'sharded_fused') is None:
        values = _on_device(values, dev)
        key = ('sharded_fused', spec, block, block_rows, sampling, dev,
               type(cl_model), _mesh_key(mesh),
               _values_key(_shard_values(mesh, values), supports),
               _g._signature((cl_model, shareds, state, assigns, caches)))

    def layout():
        sup = _supports_for(spec, values, supports)
        return tuple(mesh.map(
            lambda v: _g._mixed_static_layout(spec, v, sup),
            _shard_values(mesh, values)))

    def inputs(lays):
        _g._check_constant_nu(lays[0], shareds)
        W = _g._stat_matrices(spec, lays[0], shareds)
        return (cl_model, shareds, W), (state, assigns, caches)

    def sweep(lays, static, seeds):
        (cl, sh, W), (st, an, ca) = static
        _sharded_fused_sweep_into(spec, mesh, lays, W, block, block_rows,
                                  sampling, cl, sh, st, an, ca, seeds)
    (st, an, ca), score = _g._run_static(
        key, (values, mesh), layout, inputs, sweep, _g._static_score(spec),
        n_row * n_tiles, generator, n_sweeps, with_score)

    new_cache = (
        _unshard_rows(mesh, [c[0] for c in ca], cache[0]),
        tuple(_unshard_rows(mesh, [c[1][b] for c in ca], cache[1][b])
              for b in range(len(spec.blocks))))
    result = (st, _unshard_rows(mesh, list(an), assignments), new_cache)
    if with_score:
        result += (score,)
    return result


# -- component-sharded and 2-D sweeps -----------------------------------------

def shard_state_components(state, mesh):
    """Cut a full MixtureState along the mesh's 'components' axis: the
    list, per local shard, of the MixtureState of its contiguous slot
    range (counts, alive and group leaves cut; sample_size replicated).
    The cut is pure slicing, so a component-sharded state of the JAX
    package, gathered to [C] leaves, crosses over leaf by leaf."""
    n_comp = mesh.axis_size(COMPONENTS)
    C = state.counts.shape[0]
    if C % n_comp != 0:
        raise ValueError('capacity %d does not divide over %d component '
                         'shards' % (C, n_comp))
    per = C // n_comp

    def cut(c):
        sl = slice(c * per, (c + 1) * per)
        return mx.MixtureState(
            counts=state.counts[sl], alive=state.alive[sl],
            sample_size=state.sample_size,
            groups=tuple(mx._map_group(lambda a: a[sl], g)
                         for g in state.groups))
    parts = {c: cut(c) for c in sorted(set(mesh.axis_index(COMPONENTS)))}
    return [parts[c] for c in mesh.axis_index(COMPONENTS)]


def unshard_state_components(states, mesh):
    """The full MixtureState of a component-sharded one (the inverse of
    `shard_state_components`; gathers across the ranks of
    'components')."""
    full = mesh.gather(
        [(s.counts, s.alive, s.groups) for s in states], COMPONENTS)[0]
    return mx.MixtureState(counts=full[0], alive=full[1],
                           sample_size=states[0].sample_size,
                           groups=full[2])


def _spread(lines, per_line):
    """Per local shard, the value of its line (`Mesh._lines`): the shards
    of a line share one object."""
    out = [None] * sum(len(line) for line in lines)
    for line, x in zip(lines, per_line):
        for pos in line:
            out[pos] = x
    return out


def _sweep_2d_into(spec, mesh, vals, lays, block, block_rows, sampling,
                   cl_model, shareds, state_lines, assign_lines, seeds):
    """One component-sharded sweep that writes its results into the
    tensors it reads: `state_lines`, the component-sharded state of each
    line of local shards along 'rows' (`Mesh._lines(ROWS)`: the shards of
    a line hold the same slots), and `assign_lines`, the assignments of
    each line along 'components' (the same rows).  `vals`: each local
    shard's rows of every block's values.  With `lays` (each shard's
    `gibbs._mixed_static_layout`) K3 scores and draws; with None the plain
    scorer does.  The row shard r takes seeds[r * T + t] at tile t: an
    int, or a view of the [row shards * T] int64 seed table that K3 reads
    when it runs; the plain sweep folds the component index into it.

    With K3, a seed tensor and a mode without '_host', the sweep reads
    nothing back from the card and makes no tensor from host data, so on
    the card it is captured into a CUDA graph."""
    C = spec.capacity
    n_row = mesh.axis_size(ROWS)
    C_local = C // mesh.axis_size(COMPONENTS)
    local_spec = spec._replace(capacity=C_local)
    n_tiles = assign_lines[0].shape[0] // block
    n_removed = block * n_row
    dev = assign_lines[0].device
    comp_idx = mesh.axis_index(COMPONENTS)
    row_idx = mesh.axis_index(ROWS)
    row_lines, comp_lines = mesh._lines(ROWS), mesh._lines(COMPONENTS)
    states = _spread(row_lines, state_lines)
    assign = _spread(comp_lines, assign_lines)
    row_stats = mesh.map_over(
        COMPONENTS, lambda v: mx.precompute_row_stats(spec, shareds, v), vals)
    if lays is not None:
        col_groups = tuple(spec.blocks[i].cols for i in lays[0].nich_blocks)

    def local_sums(stats, a, c):
        # this shard's rows x this shard's slot range: ids outside the
        # range drop in the one-hot contraction
        return mx.tile_sums_fast(local_spec, shareds, stats, a - c * C_local)

    def apply(st, d, sign):
        return _apply_sums(local_spec, shareds, st, d, sign, n_removed)

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
                mx._block_score_batch(b, shared, group, x[sl]), zero)
        if sampling != 'argmax':
            seed = fold_seed(seeds[r * n_tiles + t], c)
            scores = scores + gumbel_noise(device_generator(seed, dev),
                                           (block, C_local), dev)
        arg = torch.argmax(scores, dim=1)
        return arg.to(torch.int32), scores.gather(1, arg[:, None])[:, 0]

    def fused_pair(lay, cl_scores, inp, r, c, t):
        coeffs, qcoeffs, tables = inp
        t_nich, t_quad, t_idx = _g._slice_rows(lay, t, block)
        return fk.fused_score_sample_pair(
            seeds[r * n_tiles + t], t_nich, t_idx, cl_scores, coeffs, tables,
            col_groups, block_rows=block_rows, sampling=sampling,
            qvalues=t_quad, qcoeffs=qcoeffs, quad_groups=lay.quad_groups,
            table_vs=lay.table_vs, slot_offset=c * C_local, total_slots=C)

    for t in range(n_tiles):
        sl = slice(t * block, (t + 1) * block)
        tile_stats = mesh.map_over(
            COMPONENTS, lambda rs: tuple(r[sl] for r in rs), row_stats)
        delta = mesh.psum(mesh.map(
            lambda ts, a, c: local_sums(ts, a[sl], c), tile_stats, assign,
            comp_idx), ROWS)
        states = mesh.map_over(ROWS, lambda st, d: apply(st, d, -1), states,
                               delta)

        # the local slots' clustering scores with the GLOBAL empty and
        # nonempty counts: two scalar sums over 'components'
        kinds = mesh.psum(mesh.map_over(ROWS, slot_kinds, states), COMPONENTS)
        cl_scores = mesh.map_over(
            ROWS, lambda st, k: _clustering.py_score_value_sharded(
                cl_model, st.counts, st.alive, st.sample_size, k[0], k[1]),
            states, kinds)
        if lays is not None:
            inputs = mesh.map_over(
                ROWS, lambda st, lay: _g._build_fused_inputs(
                    local_spec, lay, shareds, st), states, lays)
            pairs = mesh.map(
                lambda lay, cs, inp, r, c: fused_pair(lay, cs, inp, r, c, t),
                lays, cl_scores, inputs, row_idx, comp_idx)
        else:
            pairs = mesh.map(
                lambda st, cs, v, r, c: plain_pair(st, cs, v, r, c, t, sl),
                states, cl_scores, vals, row_idx, comp_idx)

        # the pair reduce over 'components': the largest best and, at
        # equal best, the lowest global slot (as a plain argmax over the
        # unsharded score row)
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
        for line, buf in zip(comp_lines, assign_lines):
            buf[sl] = new[line[0]]
    for line, buf in zip(row_lines, state_lines):
        for dst, src in zip(_g._tensors(buf), _g._tensors(states[line[0]])):
            dst.copy_(src)


def _sweep_2d(spec, cl_model, shareds, state, values, assignments,
              generator, mesh, block, sampling, fused, block_rows=256,
              supports=None):
    """The component-sharded sweep on a mesh with a 'components' axis and,
    optionally, a 'rows' axis; `fused` scores and draws through K3.  On
    the card a fused sweep is the replay of one CUDA graph
    (`gibbs._SweepGraph` over `_sweep_2d_into`), captured as
    `sharded_sweep_fused`'s is; the plain sweeps run eagerly
    (`gibbs._graph_refusal`).  Full states are cut and joined outside the
    graph."""
    if not isinstance(cl_model, _clustering.PitmanYor):
        raise ValueError('component-sharded sweeps support the PitmanYor '
                         'prior')
    if fused:
        fk._parse_pair_sampling(sampling)
    elif sampling not in ('gumbel', 'argmax'):
        raise ValueError("sampling must be 'gumbel' or 'argmax', got %r"
                         % (sampling,))
    n_comp = mesh.axis_size(COMPONENTS)
    C = spec.capacity
    if C % n_comp != 0:
        raise ValueError('capacity %d does not divide over %d component '
                         'shards' % (C, n_comp))
    full_state = isinstance(state, mx.MixtureState)
    states = shard_state_components(state, mesh) if full_state \
        else list(state)
    assign = _shard_rows(mesh, assignments)
    n_tiles = _check_tiling(mesh, assign[0].shape[0], block)
    dev = assign[0].device
    row_lines, comp_lines = mesh._lines(ROWS), mesh._lines(COMPONENTS)
    state_lines = tuple(states[line[0]] for line in row_lines)
    assign_lines = tuple(assign[line[0]].to(torch.int32)
                         for line in comp_lines)
    key = None
    if _g._graph_refusal(dev, sampling,
                         'fused_2d' if fused else 'plain') is None:
        values = _on_device(values, dev)
        key = ('fused_2d', spec, block, block_rows, sampling, dev,
               _mesh_key(mesh),
               _values_key(_shard_values(mesh, values), supports),
               _g._signature((cl_model, shareds, state_lines,
                              assign_lines)))

    def layout():
        vals = _shard_values(mesh, values)
        if not fused:
            return vals, None
        sup = _supports_for(spec, values, supports)
        return vals, tuple(mesh.map_over(
            COMPONENTS, lambda v: _g._mixed_static_layout(spec, v, sup),
            vals))

    def inputs(lay):
        if fused:
            _g._check_constant_nu(lay[1][0], shareds)
        return (cl_model, shareds), (state_lines, assign_lines)

    def sweep(lay, static, seeds):
        (cl, sh), (st, an) = static
        _sweep_2d_into(spec, mesh, lay[0], lay[1], block, block_rows,
                       sampling, cl, sh, st, an, seeds)
    (st, an), _ = _g._run_static(
        key, (values, mesh), layout, inputs, sweep, None,
        mesh.axis_size(ROWS) * n_tiles, generator, 1, False)
    states = _spread(row_lines, st)
    new_assign = _unshard_rows(mesh, _spread(comp_lines, an), assignments)
    if full_state:
        return unshard_state_components(states, mesh), new_assign
    return states, new_assign


def sharded_sweep_components(spec, cl_model, shareds, state, values,
                             assignments, generator, mesh, block,
                             sampling='gumbel'):
    """Blocked sweep with the COMPONENT axis sharded over the mesh: each
    shard owns a contiguous slot range [c * C_local, (c + 1) * C_local)
    with that range's counts and group stats.  Per tile every shard
    builds the stat deltas of its own slots (rows are replicated; the
    one-hot contraction masks to the local range), scores its [B,
    C_local] columns plus local gumbel noise, and the global draw is one
    pair reduce over the axis of (local best, global slot): only [B]
    floats and ints cross shards.  The clustering scores need the global
    empty and nonempty slot counts: two scalar sums.

    state: a full MixtureState (returned full) or the list from
    `shard_state_components` (returned as a list).  sampling: 'gumbel' or
    'argmax' (deterministic; pins equality with the single-device sweep).
    Against the unsharded sweep: (a) `spec.empties` empty slots are kept
    alive PER SHARD, so the empty mass splits over more slots and argmax
    equality holds when no empty slot wins; (b) an exact cross-shard tie
    goes to the lowest global slot, as a plain argmax; (c) in 'gumbel'
    the noise is seeded per (tile, shard): equal in distribution, not
    bitwise.  Returns (state, assignments)."""
    return _sweep_2d(spec, cl_model, shareds, state, values, assignments,
                     generator, mesh, block, sampling, fused=False)


def sharded_sweep_2d(spec, cl_model, shareds, state, values, assignments,
                     generator, mesh, block, sampling='gumbel'):
    """Blocked sweep on a 2-D ('rows' x 'components') mesh: rows AND slots
    sharded at once.  Per tile each shard holds a [block, C_local]
    problem: local stat sums for ITS rows x ITS slot range, summed over
    'rows'; the clustering normalisation by two scalar sums over
    'components'; scores plus per-shard gumbel noise; the draw by the pair
    reduce over 'components'.  The effective global tile is block * row
    shards.  State as in `sharded_sweep_components`; values and
    assignments are cut over 'rows' and replicated over 'components'.
    Returns (state, assignments)."""
    return _sweep_2d(spec, cl_model, shareds, state, values, assignments,
                     generator, mesh, block, sampling, fused=False)


def sharded_sweep_2d_fused(spec, cl_model, shareds, state, values,
                           assignments, generator, mesh, block,
                           block_rows=256, sampling='gumbel', supports=None):
    """The 2-D sweep with the pair kernel K3
    (`fused_kernels.fused_score_sample_pair`) scoring each shard's [block,
    C_local] problem and emitting its (local argmax, best) pair.  The
    stat sums are the one-hot contraction on the winning global slots,
    taken after the pair reduce and summed over 'rows'.

    sampling: 'gumbel' (or 'gumbel_fast') | 'argmax' (equal to
    `sharded_sweep_2d` under 'argmax').  The seed of a tile is folded by
    the global tile index row shard * tiles per shard + t, as in
    `sharded_sweep_fused`, and every component shard passes its slot
    offset, so the 'gumbel' draw of a row does not depend on how the
    slots are cut: a 1 x N mesh draws what the single-device fused sweep
    draws from the same scores.  Returns (state, assignments)."""
    return _sweep_2d(spec, cl_model, shareds, state, values, assignments,
                     generator, mesh, block, sampling, fused=True,
                     block_rows=block_rows, supports=supports)


def sharded_score_data(spec, cl_model, shareds, state, mesh=None):
    """score_data on the replicated state (no collective: the state is
    replicated; kept for symmetry with the JAX package)."""
    return mx.score_data(spec, cl_model, shareds, state)


def sharded_state_from_assignments(spec, cl_model, shareds, values,
                                   assignments, mesh):
    """The replicated state from row-sharded (values, assignments) with
    one sum over 'rows'."""
    vals = _shard_values(mesh, values)
    assign = _shard_rows(mesh, assignments)
    delta = mesh.psum(mesh.map(
        lambda v, a: mx.tile_sums_fast(
            spec, shareds, mx.precompute_row_stats(spec, shareds, v), a),
        vals, assign), ROWS)
    n = assign[0].shape[0] * mesh.axis_size(ROWS)
    return _apply_sums(spec, shareds, mx.init(spec, shareds), delta[0], +1,
                       n)
