"""Blocked collapsed-Gibbs sweeps over a mixture state
(distributions_tpu.ops.gibbs).

- `sweep_blocked` is the un-kernelled sweep: per tile of `block` rows,
  remove the tile's stats, score [B, C] against the tile-frozen state,
  draw with gumbel-argmax, add the new stats back.
- `sweep_blocked_pallas_fused_mixed` (the runner's sweep, any mix of
  nich, niw and discrete blocks) and the nich-only
  `sweep_blocked_pallas_fused` / `run_sweeps_pallas_fused` run each tile
  through a fused kernel (ops/fused_kernels.py: K2, or K1 for a nich-only
  spec), which scores, draws and sums the new stats in one launch.  The
  remove side is the cached add-side sums of the previous sweep
  (`build_stat_cache`).  In the port, "pallas" in these names means the
  hand-written fused kernels.
- `sweep_blocked_pallas` (nich-only specs, kernel K4) and
  `sweep_blocked_pallas_mixed` (nich and discrete blocks, kernel K5 or,
  with backend='xla', plain PyTorch tables) are the v1 sweeps: the remove
  and add sides are `tile_deltas_fast` of the row stats, and the kernel
  only scores and draws.
- `sweep_sequential` is exact collapsed Gibbs, one row after another
  (meant for small R); `sweep_blocked_chains` runs `sweep_blocked` on N
  chains at once, their states stacked on a leading chain axis
  (`init_chains`).
- `prior_init` and `sequential_init` assign the rows one after another,
  from the clustering prior alone (`prior_seating`) or from the running
  predictive.

Randomness: every sweep draws one seed from the caller's
`torch.Generator`, and each tile folds its index into it
(`random.fold_seed`), as the JAX package splits a sweep key per tile; the
plain sweeps seed one device generator with it instead, which all the
tiles draw from.

On the card each blocked sweep is the replay of one CUDA graph of all its
tiles (`_SweepGraph`), but for what `_graph_refusal` names (the mesh's
plain sweeps, the '_host' modes).
"""

import contextlib
from collections import namedtuple

import numpy as np
import torch

from distributions_tpu_torch import clustering as _cl, diagnostics
from distributions_tpu_torch import mixture as mx
from distributions_tpu_torch.clustering import _crp_seating, _le_seating
from distributions_tpu_torch.models import nich as nich_mod, niw as niw_mod
from distributions_tpu_torch.ops import fused_kernels as fk
from distributions_tpu_torch.random import (device_generator, draw_seed,
                                            gumbel_noise, sample_from_scores,
                                            sweep_seeds)


def _n_tiles(assignments, block):
    R = assignments.shape[0]
    if R % block != 0:
        raise ValueError('rows (%d) must be a multiple of the block size '
                         '(%d)' % (R, block))
    return R // block


def build_stat_cache(spec, shareds, values, block, assignments):
    """Per-tile (counts_delta [T, C], raw sums [T, C, cols, S]) for the
    current assignments: the remove-side inputs of the next fused sweep."""
    n_blocks = _n_tiles(assignments, block)
    row_stats = mx.precompute_row_stats(spec, shareds, values)
    cds = []
    sums = [[] for _ in spec.blocks]
    for t in range(n_blocks):
        sl = slice(t * block, (t + 1) * block)
        cd, s = mx.tile_sums_fast(spec, shareds,
                                  tuple(rs[sl] for rs in row_stats),
                                  assignments[sl])
        cds.append(cd)
        for acc, si in zip(sums, s):
            acc.append(si)
    return torch.stack(cds), tuple(torch.stack(s) for s in sums)


def sweep_sequential(spec, cl_model, shareds, state, values, assignments,
                     generator):
    """One pass of exact collapsed Gibbs: row i is removed, scored against
    the state of every other row (rows 0..i-1 already moved in this
    pass) and added back at its draw.  A loop of R single-row steps
    (`mixture.remove_value`, `score_value`, a gumbel-argmax draw,
    `add_value`), each a few dozen [C]-sized ops: meant for small R.
    Returns (state, assignments)."""
    values = tuple(torch.as_tensor(v) for v in values)
    dev = state.counts.device
    gen = device_generator(draw_seed(generator), dev)
    assignments = assignments.clone()
    for i in range(values[0].shape[0]):
        row = tuple(v[i] for v in values)
        state, _ = mx.remove_value(spec, cl_model, shareds, state,
                                   assignments[i], row)
        scores = mx.score_value(spec, cl_model, shareds, state, row)
        k = sample_from_scores(gen, scores)
        state, _ = mx.add_value(spec, cl_model, shareds, state, k, row)
        assignments[i] = k
    return state, assignments


def sweep_blocked(spec, cl_model, shareds, state, values, assignments, block,
                  generator=None):
    """One full pass of blocked collapsed Gibbs with tile size `block`:
    the tile's rows are scored against the state with the tile removed,
    drawn at once, and added back.  With row-stat columns for every block
    (all seven models) the tile's stats are one contraction of
    precomputed columns (`_plain_sweep_into`; on the card the replay of
    one CUDA graph of all the tiles, see `_plain_run`); otherwise the slow
    branch takes the tile's stats from its values (`mixture.tile_deltas`).
    The tiles draw from one generator on the rows' device, seeded with one
    `draw_seed(generator)`.  Returns (state, assignments)."""
    return _plain_run(spec, cl_model, shareds, state, values, assignments,
                      block, generator, 1, False)


def _slow_sweep(spec, cl_model, shareds, state, values, assignments, block,
                gen):
    """sweep_blocked for a model without row stats: each tile's stats from
    its values, eagerly (the 'plain' rule of `_graph_refusal`)."""
    out = []
    for t in range(_n_tiles(assignments, block)):
        sl = slice(t * block, (t + 1) * block)
        tile_vals = tuple(torch.as_tensor(v)[sl] for v in values)
        cd, tiles = mx.tile_deltas(spec, shareds, tile_vals, assignments[sl])
        state = mx.apply_stat_tiles(spec, shareds, state, cd, tiles, -1,
                                    block)
        scores = mx.score_batch(spec, cl_model, shareds, state, tile_vals)
        new_assign = sample_from_scores(gen, scores).to(torch.int32)
        cd, tiles = mx.tile_deltas(spec, shareds, tile_vals, new_assign)
        state = mx.apply_stat_tiles(spec, shareds, state, cd, tiles, +1,
                                    block)
        out.append(new_assign)
    return state, torch.cat(out)


def sweep_blocked_pallas(spec, cl_model, shareds, state, values, assignments,
                         block, block_rows=256, generator=None,
                         sampling='gumbel'):
    """Blocked collapsed-Gibbs sweep of a nich-only spec with the v1
    score + sample kernel K4 (`fused_kernels.nich_score_sample`); in the
    port "pallas" names the hand-written kernel.

    Equal to `sweep_blocked` in distribution: the kernel draws with its
    own Philox stream.  sampling: 'gumbel' | 'argmax' | 'gumbel_host'
    (the tile's noise drawn outside the kernel).  On the card the sweep
    is the replay of one CUDA graph of all its tiles (`_v1_run`).
    Returns (state, assignments)."""
    if not fk.supports_pallas(spec):
        raise ValueError('sweep_blocked_pallas takes nich-only specs; use '
                         'sweep_blocked_pallas_mixed')
    return _v1_run(spec, values, None, 'K4', block, block_rows, sampling,
                   1, False, cl_model, shareds, state, assignments, generator)


def _is_table_block(block):
    return block.module is not nich_mod and block.module is not niw_mod


def _block_supports(spec, values):
    """Per-block value supports for the mixed fused sweep: None for nich
    and niw blocks (scored analytically), the sorted unique values (a
    tensor on the values' device) for discrete blocks."""
    return tuple(
        torch.unique(torch.as_tensor(v)).to(torch.int32)
        if _is_table_block(block) else None
        for block, v in zip(spec.blocks, values))


def packed_value_width(spec, values, supports=None):
    """Rows of the packed score table for this spec and data: the sum of
    the table columns' support sizes (0 when there are no table blocks)."""
    if supports is None:
        supports = _block_supports(spec, values)
    return sum(len(supports[i]) * b.cols
               for i, b in enumerate(spec.blocks) if _is_table_block(b))


_MixedLayout = namedtuple('_MixedLayout', [
    'nich_blocks', 'quad_blocks', 'table_blocks', 'quad_groups',
    'nich_vals', 'quad_vals', 'table_idx', 'supports', 'table_vs'])


def _mixed_static_layout(spec, values, supports=None):
    """The layout of the mixed fused sweep: the split into nich, niw and
    table blocks, per-block sorted supports, and the kernel's row inputs.

    All table columns share one packed value axis: column j's support
    takes rows [off_j, off_j + V_j) of the [Vtot, C] score table, with
    Vtot the sum of the support sizes.  `table_vs` gives each table
    column's support size in column order; `table_idx` [R, table_cols]
    int32 is each value's index in its support.  `nich_vals` [R, ncols]
    and `quad_vals` [R, sum(cols * d)] are the blocks' values
    concatenated; a kind of block that the spec lacks gives None."""
    if supports is None:
        supports = _block_supports(spec, values)
    nich_blocks = tuple(i for i, b in enumerate(spec.blocks)
                        if b.module is nich_mod)
    quad_blocks = tuple(i for i, b in enumerate(spec.blocks)
                        if b.module is niw_mod)
    table_blocks = tuple(i for i, b in enumerate(spec.blocks)
                         if _is_table_block(b))
    R = torch.as_tensor(values[0]).shape[0]

    nich_vals = quad_vals = table_idx = None
    if nich_blocks:
        nich_vals = torch.cat(
            [torch.as_tensor(values[i]).to(torch.float32)
             for i in nich_blocks], dim=1).contiguous()
    quad_groups = []
    if quad_blocks:
        quad_cols = []
        for i in quad_blocks:
            v = torch.as_tensor(values[i]).to(torch.float32)   # [R, cols, D]
            quad_groups.append((v.shape[1], v.shape[2]))
            quad_cols.append(v.reshape(R, -1))
        quad_vals = torch.cat(quad_cols, dim=1).contiguous()
    sups = [None] * len(spec.blocks)
    if table_blocks:
        idx_cols = []
        for i in table_blocks:
            v = torch.as_tensor(values[i])
            v = v.to(torch.int32)
            sup = torch.as_tensor(supports[i], device=v.device).to(
                torch.int32)
            idx = torch.searchsorted(sup, v.contiguous())
            # every value must be IN the support: on the packed value axis
            # an out-of-support index would land in the NEXT column's rows
            # and silently corrupt its scores and count table
            ok = (idx < len(sup)) & (
                sup[torch.clamp(idx, max=len(sup) - 1)] == v)
            if not bool(ok.all()):
                bad = torch.unique(v[~ok])[:8]
                raise ValueError(
                    'block %d: values %s are not in the provided support '
                    '(the fused table sweep requires supports to cover '
                    'every observed value)' % (i, bad.tolist()))
            idx_cols.append(idx.to(torch.int32))
            sups[i] = sup
        table_idx = torch.cat(idx_cols, dim=1).contiguous()
    table_vs = tuple(len(sups[i]) for i in table_blocks
                     for _ in range(spec.blocks[i].cols))
    return _MixedLayout(nich_blocks, quad_blocks, table_blocks,
                        tuple(quad_groups), nich_vals, quad_vals, table_idx,
                        tuple(sups), table_vs)


def _column_tables(spec, lay, shareds, state):
    """One [V_j, C] score table per table column, in column order:
    `score_value_batch` of the column's groups over its block's support."""
    table_list = []
    for i in lay.table_blocks:
        blk = spec.blocks[i]
        for j in range(blk.cols):
            g = mx._map_group(lambda a: a[:, j], state.groups[i])
            table_list.append(blk.module.score_value_batch(
                shareds[i], g, lay.supports[i]))
    return table_list


def _build_v1_inputs(spec, lay, shareds, state):
    """K5's per-slot inputs from the current groups: (coeffs, tables), the
    `nich_coeffs` rows of the nich blocks and the table columns' score
    tables stacked to [table_cols, largest V, C] (rows beyond a column's
    own support are zero and never indexed); None for a kind of block the
    spec lacks."""
    coeffs = tables = None
    if lay.nich_blocks:
        coeffs = torch.cat([fk.nich_coeffs(shareds[i], state.groups[i])
                            for i in lay.nich_blocks], dim=0).contiguous()
    table_list = _column_tables(spec, lay, shareds, state)
    if table_list:
        vmax = max(lay.table_vs)
        tables = torch.stack([
            torch.nn.functional.pad(tb, (0, 0, 0, vmax - tb.shape[0]))
            for tb in table_list]).contiguous()
    return coeffs, tables


def sweep_blocked_pallas_mixed(spec, cl_model, shareds, state, values,
                               assignments, block, generator, supports=None,
                               block_rows=256, backend='pallas',
                               sampling='gumbel'):
    """The v1 sweep for any mix of nich blocks and bounded-support discrete
    blocks (bb/dd/dpd/gp/bnb).

    Discrete blocks are scored through per-tile [V, C] tables (V = support
    size) of `score_value_batch` over the support, which takes the lgamma
    cost of a cell down by the factor B / V; each row's support index then
    selects its table row.  `supports` (from `_block_supports`) must cover
    every value in `values`.

    backend='pallas' scores and draws in kernel K5
    (`fused_kernels.mixed_score_sample`; sampling: 'gumbel' | 'argmax' |
    'gumbel_host').  backend='xla' keeps its name from the JAX package and
    is the plain PyTorch form: the same tables indexed by `tables[idx]`,
    added block by block in the spec's order, and drawn with
    `random.sample_from_scores` from one generator per sweep, so that it
    equals `sweep_blocked` bitwise for a generator in the same state.
    On the card either backend's sweep is the replay of one CUDA graph of
    all its tiles (`_v1_run`).

    Returns (state, assignments)."""
    if backend not in ('pallas', 'xla'):
        raise ValueError("backend must be 'pallas' or 'xla', got %r"
                         % (backend,))
    if any(b.module is niw_mod for b in spec.blocks):
        raise ValueError('sweep_blocked_pallas_mixed takes nich and discrete '
                         'blocks; a niw block needs '
                         'sweep_blocked_pallas_fused_mixed')
    return _v1_run(spec, values, supports,
                   'K5' if backend == 'pallas' else 'xla', block, block_rows,
                   sampling, 1, False, cl_model, shareds, state, assignments,
                   generator)


def _check_constant_nu(lay, shareds):
    """The product-form nich block takes one log per block with one
    exponent, so `nu` must be column-constant within a block."""
    for i in lay.nich_blocks:
        nu = shareds[i].nu
        if nu.dim() > 0 and nu.numel() > 1 and not bool(
                (nu == nu.reshape(-1)[0]).all()):
            raise ValueError(
                'fused nich block %d requires column-constant nu (got %r); '
                'put columns with distinct nu in separate cols=1 blocks'
                % (i, nu.tolist()))


def _stat_matrices(spec, lay, shareds):
    """Per table block the [V, S] matrix of row_stat_columns over its
    support: a column's count table times it gives the raw tile sums,
    since every discrete model's tile stats are linear in the per-value
    counts."""
    return tuple(
        b.module.row_stat_columns(shareds[i], lay.supports[i])
        if i in lay.table_blocks else None
        for i, b in enumerate(spec.blocks))


def _tile_noise(sampling, seed, block, C, device):
    """'_host' sampling: the tile's noise, drawn from a generator seeded
    with the tile seed (gumbel [block, C] or uniform [block, 1])."""
    if '_host' not in sampling:
        return None
    gen = device_generator(seed, device)
    if sampling.startswith('gumbel'):
        return gumbel_noise(gen, (block, C), device)
    return torch.rand((block, 1), generator=gen, device=device,
                      dtype=torch.float32)


def _build_fused_inputs(spec, lay, shareds, state, mark=None):
    """Per-slot kernel inputs (coeffs, qcoeffs, tables) from the current
    groups; a kind of block that the spec lacks gives None.  tables is
    the PACKED [Vtot, C] score table: every table column's [V, C] table of
    `score_value_batch` over its support, stacked in column order.
    `mark(i)`, when given, stamps the `_DeviceClock`'s niw marks, i = 0
    before and i = 1 after the niw coefficients (their posterior, inverse
    and logdet) of a spec with niw blocks."""
    coeffs = qcoeffs = tables = None
    if lay.nich_blocks:
        coeffs = torch.cat([fk.nich_coeffs_v2_rows(shareds[i],
                                                   state.groups[i])
                            for i in lay.nich_blocks], dim=0).contiguous()
    if lay.quad_blocks:
        if mark is not None:
            mark(0)
        qcoeffs = torch.cat([fk.niw_coeffs_v4(shareds[i], state.groups[i])
                             for i in lay.quad_blocks], dim=0).contiguous()
        if mark is not None:
            mark(1)
    table_list = _column_tables(spec, lay, shareds, state)
    if table_list:
        tables = torch.cat(table_list, dim=0).contiguous()
    return coeffs, qcoeffs, tables


def _slice_rows(lay, t, block):
    sl = slice(t * block, (t + 1) * block)
    return tuple(None if x is None else x[sl]
                 for x in (lay.nich_vals, lay.quad_vals, lay.table_idx))


def _fused_tile_inputs(spec, lay, cl_model, shareds, state, mark=None):
    """The fused kernel's per-slot inputs from the current state:
    (cl_scores, coeffs, qcoeffs, tables); `mark` as `_build_fused_inputs`
    takes it."""
    cl_scores = _cl.score_value(cl_model, state.counts, state.alive,
                                state.sample_size)
    return (cl_scores,) + _build_fused_inputs(spec, lay, shareds, state,
                                              mark)


def _fused_tile_core(spec, lay, W, block_rows, sampling, cl_model, shareds,
                     state, t_nich, t_quad, t_idx, seed, noise=None,
                     inputs=None, after_kernel=None):
    """Score + sample + stats for ONE tile against the current (already
    tile-removed) state via the fused kernel.  `inputs`: the
    `_fused_tile_inputs` of `state` when the caller has them already (row
    shards that share one state).  `after_kernel()`, when given, is called
    once the kernel is launched.  Returns (new_assign [B], counts_delta
    [C], per-block raw sums in build_stat_cache's format)."""
    col_groups = tuple(spec.blocks[i].cols for i in lay.nich_blocks)
    if inputs is None:
        inputs = _fused_tile_inputs(spec, lay, cl_model, shareds, state)
    cl_scores, coeffs, qcoeffs, tables = inputs
    new_assign, nich_sums, tcounts, qsums = \
        fk.fused_mixed_score_sample_stats(
            seed, t_nich, t_idx, cl_scores, coeffs, tables, col_groups,
            block_rows=block_rows, sampling=sampling, qvalues=t_quad,
            qcoeffs=qcoeffs, quad_groups=lay.quad_groups, noise=noise,
            table_vs=lay.table_vs)
    if after_kernel is not None:
        after_kernel()

    # counts delta: the ones column of whichever stat family is present
    # (nich [1|v|v^2] sums; quad [1|v|vv^T] sums; or the row sums of the
    # first table column's count table)
    if lay.nich_blocks:
        ones = nich_sums[:, 0]
    elif lay.quad_blocks:
        ones = qsums[:, 0]
    else:
        ones = tcounts[:, :lay.table_vs[0]].sum(1)
    new_cd = torch.round(ones).to(torch.int32)

    quad_raw = fk.quad_sums_to_raw(qsums, lay.quad_groups)
    ncols = sum(col_groups)
    new_sums = []
    nc0 = 0
    off = 0
    tcol = 0
    qi = 0
    for bi, b in enumerate(spec.blocks):
        if bi in lay.nich_blocks:
            sl = slice(nc0, nc0 + b.cols)
            new_sums.append(torch.stack(
                [nich_sums[:, sl],
                 nich_sums[:, ncols + nc0:ncols + nc0 + b.cols],
                 nich_sums[:, 2 * ncols + nc0:2 * ncols + nc0 + b.cols]],
                dim=-1))
            nc0 += b.cols
        elif bi in lay.quad_blocks:
            new_sums.append(quad_raw[qi])
            qi += 1
        else:
            cols_s = []
            for _ in range(b.cols):
                # exact integer counts up to the tile size times f32 stat
                # columns, in a full-f32 matmul (TF32 stays off): the cached
                # raw sums are subtracted across sweeps and must be exact
                v = lay.table_vs[tcol]
                cols_s.append(torch.matmul(tcounts[:, off:off + v], W[bi]))
                off += v
                tcol += 1
            new_sums.append(torch.stack(cols_s, dim=1))
    return new_assign, new_cd, tuple(new_sums)


# -- the fused step: one sweep over static buffers, replayed from a CUDA graph

def _fused_sweep_into(spec, lay, W, block, block_rows, sampling, cl_model,
                      shareds, state, assignments, cache, seeds):
    """One fused sweep over all tiles that writes its results into the
    tensors it reads: the leaves of `state`, `assignments` [R] and those of
    the stat cache.  Tile t reads its cached entry before it writes its new
    one, so the cache is updated in place.  Tile t takes seeds[t]: an int,
    or a view of a [T] int64 tensor that the kernel reads when it runs.

    With a tensor of seeds and a mode without '_host', a sweep reads nothing
    back from the card and makes no tensor from host data: on the card it
    is captured into a CUDA graph (`_SweepGraph`); on the CPU it runs on the
    kernels' twins.  On the card the sweep stamps the phase marks of the
    card's `_DeviceClock`: tile 0's, the last tile's end and the state
    copy's; and a capture records the stat stage's plan
    (`_record_stat_plan`)."""
    cached_cd, cached_sums = cache
    clock = _device_clock(cached_cd.device)
    _record_stat_plan(spec, lay, block, cached_cd.device)
    cur = state
    for t in range(cached_cd.shape[0]):
        mark = clock.tile if t == 0 else _NO_CLOCK.tile
        niw_mark = clock.niw if t == 0 else _NO_CLOCK.niw
        mark(0)
        tiles = mx.sums_to_tiles(spec, shareds,
                                 tuple(s[t] for s in cached_sums))
        cur = mx.apply_stat_tiles(spec, shareds, cur, cached_cd[t], tiles, -1,
                                  block)
        mark(1)
        noise = _tile_noise(sampling, seeds[t], block, spec.capacity,
                            cached_cd.device)
        inputs = _fused_tile_inputs(spec, lay, cl_model, shareds, cur,
                                    niw_mark)
        mark(2)
        new_assign, new_cd, new_sums = _fused_tile_core(
            spec, lay, W, block_rows, sampling, cl_model, shareds, cur,
            *_slice_rows(lay, t, block), seeds[t], noise=noise,
            inputs=inputs, after_kernel=lambda: mark(3))
        mark(4)
        tiles = mx.sums_to_tiles(spec, shareds, new_sums)
        cur = mx.apply_stat_tiles(spec, shareds, cur, new_cd, tiles, +1,
                                  block)
        mark(5)
        assignments[t * block:(t + 1) * block] = new_assign
        cached_cd[t] = new_cd
        for buf, s in zip(cached_sums, new_sums):
            buf[t] = s
        mark(6)
    clock.tile(7)
    for dst, src in zip(_tensors(state), _tensors(cur)):
        dst.copy_(src)
    clock.tile(8)


def _record_stat_plan(spec, lay, block, device):
    """While a sweep graph captures on the card: the plan of the stat
    stage of the sweep's K1 or K2 launches (`fused_kernels.stat_plan`) in
    GRAPH_STATS['stat_plan']: its warps, slots a chunk and chunks of the
    slot axis."""
    if device.type != 'cuda' or not torch.cuda.is_current_stream_capturing():
        return
    col_groups = tuple(spec.blocks[i].cols for i in lay.nich_blocks)
    if lay.quad_groups or lay.table_vs:
        plan = fk.stat_plan('fused_v3', block, spec.capacity, col_groups,
                            lay.quad_groups, lay.table_vs)
    else:
        plan = fk.stat_plan('fused_v2', block, spec.capacity, col_groups)
    cks = plan['chunk_slots']
    GRAPH_STATS['stat_plan'] = {
        'warps': plan['warps'], 'chunk_slots': cks,
        'chunks': -(-spec.capacity // cks) if cks else 0}


def _map_tensors(fn, tree):
    """`tree` (tensors in nested tuples and NamedTuples) with fn applied to
    every tensor; other leaves (None, numbers) are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        items = [_map_tensors(fn, x) for x in tree]
        return type(tree)(*items) if hasattr(tree, '_fields') else tuple(
            items)
    return tree


def _tensors(tree):
    """The tensors of `tree` in a fixed order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, tuple):
        for x in tree:
            yield from _tensors(x)


def _signature(tree):
    """What a captured graph is specialised to in `tree`: the nesting, and
    the shape and dtype of every tensor or the value of any other leaf."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    if isinstance(tree, tuple):
        return (type(tree).__name__,) + tuple(_signature(x) for x in tree)
    return (type(tree).__name__, repr(tree))


# fused runs forced onto the eager loop (`_eager_sweeps`)
_EAGER = [False]
# fused runs within `sweep_graph_session()`, which capture a key on its
# first use
_SESSION = [False]
# the one captured sweep graph and its key; and the key of the last run on
# the graph path that was not captured, with the values it names (kept, so
# that their addresses are not given to other tensors while the key is
# held).  A key is captured on its second use (or its first within a
# session), and its graph replaces the one before.
_GRAPH = {'key': None, 'graph': None, 'seen': None, 'seen_values': None}
# what the graph path did since the counters were last set to 0: graphs
# captured, sweeps replayed, seconds spent capturing (the `graph.capture`
# spans: the first sweep of a graph, which warms it up, and the capture),
# the bytes of the captures' memory pools, the joint-score graph's captures
# and replays, the runs that took the eager loop because their key was new,
# the nodes of the last sweep graph captured (each launch, copy, memset and
# event record in it), the stat stage's plan in the last fused sweep graph
# captured (`_record_stat_plan`), and the host spans' totals
# (`diagnostics.span`)
GRAPH_STATS = {'captures': 0, 'replays': 0, 'capture_seconds': 0.0,
               'pool_bytes': 0, 'score_captures': 0, 'score_replays': 0,
               'first_uses': 0, 'sweep_graph_nodes': 0, 'stat_plan': {},
               'spans': diagnostics.SPAN_TOTALS}
# the wrappers whose launches a replay repeats
_COUNTED = (fk.fused_score_sample_stats, fk.fused_mixed_score_sample_stats,
            fk.fused_score_sample_pair, fk.nich_score_sample,
            fk.mixed_score_sample)
# the sweeps that take the eager loop on the card by rule, and the rule;
# the others are replayed from a CUDA graph: the fused sweeps ('fused':
# this module's; 'sharded_fused' and 'fused_2d': parallel/sharding.py's),
# the v1 sweeps ('v1': K4, K5 and backend='xla') and the single-device
# plain sweeps ('blocked': sweep_blocked's row-stats branch; 'chains')
_EAGER_SWEEPS = {
    'plain': 'the mesh\'s plain sweeps (sharded_sweep_blocked, '
             'sharded_sweep_components, sharded_sweep_2d) and sweep_blocked '
             'for a model without row stats are not graphed: their speed '
             'work is ROADMAP Queue 3 item 4',
}


@contextlib.contextmanager
def _eager_sweeps():
    """Within `with gibbs._eager_sweeps():` every fused run takes the eager
    loop, seeds passed by value, as a CUDA graph's sweeps would run without
    the graph: the reference that `chip_smoke.py` and the CUDA tests hold
    the graph path to, bitwise."""
    was, _EAGER[0] = _EAGER[0], True
    try:
        yield
    finally:
        _EAGER[0] = was


@contextlib.contextmanager
def sweep_graph_session():
    """Within `with gibbs.sweep_graph_session():` a fused run on the graph
    path captures its key on the first use, not the second: the caller
    (the runner's steps) will call again with the same key.  On exit the
    graph is released."""
    was, _SESSION[0] = _SESSION[0], True
    try:
        yield
    finally:
        _SESSION[0] = was
        release_sweep_graphs()


def release_sweep_graphs():
    """Drop the captured sweep graph, its memory pools and the key held
    for a second use (the runner does so when capacity grows and when its
    run ends)."""
    _GRAPH.update(key=None, graph=None, seen=None, seen_values=None)


def reset_graph_stats():
    """Set the counters of GRAPH_STATS to 0 and empty the span totals and
    ring (`diagnostics.reset_spans`); returns GRAPH_STATS, to be read after
    the run."""
    for k in GRAPH_STATS:
        if k == 'stat_plan':
            GRAPH_STATS[k] = {}
        elif k != 'spans':
            GRAPH_STATS[k] = type(GRAPH_STATS[k])(0)
    diagnostics.reset_spans()
    return GRAPH_STATS


def _graph_nodes(graph):
    """The nodes of a captured torch.cuda.CUDAGraph made with
    keep_graph=True: libcuda's cuGraphGetNodes on its cudaGraph_t (a
    CUgraph)."""
    import ctypes
    fn = ctypes.CDLL('libcuda.so.1').cuGraphGetNodes
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_size_t)]
    fn.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    rc = fn(graph.raw_cuda_graph(), None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError('cuGraphGetNodes failed with CUresult %d' % rc)
    return int(n.value)


class _DeviceClock:
    """Timing marks of the sweeps on one card, which the runner reads after
    a step's sync (`step_times`).

    The step's edge: CUDA timing events on the current stream, outside any
    graph, at its start (before the load of its buffers), after the load,
    after its last sweep, and after its score and the copies of its
    outputs.  Two sets of them, one each step in turn, so that the last
    event of the step before is there to time the device's idle edge from.

    Tile 0's phases inside a fused sweep (`_fused_sweep_into`): stamps of
    the card's global timer (`fused_kernels.clock_mark`) before its remove
    and after its remove, inputs, kernel, sums, add and write, before the
    end-of-sweep state copy and after it; and with niw blocks, inside its
    inputs, before and after the niw coefficients (`niw`, stamps of their
    own).  In a capture each mark is a kernel node of the graph, which
    `_SweepGraph` switches on for the last sweep of a step alone: the
    stamps are that sweep's."""

    STEP = ('start', 'loaded', 'swept', 'scored')
    PHASES = ('remove', 'inputs', 'kernel', 'sums', 'add', 'write')
    # the marks: one before the tile's phases, one after each, one after
    # the last tile and one after the state copy
    MARKS = len(PHASES) + 3

    def __init__(self, device):
        self.device = device
        self.steps = [[torch.cuda.Event(enable_timing=True)
                       for _ in self.STEP] for _ in range(2)]
        # the phase marks, then the two niw marks (stamped by specs with
        # niw blocks alone)
        self.stamps = torch.zeros(self.MARKS, dtype=torch.int64,
                                  device=device)
        self.niw_stamps = torch.zeros(2, dtype=torch.int64, device=device)
        # their host copies, made on the stream at the step's end
        self.host_stamps = torch.zeros(self.MARKS, dtype=torch.int64,
                                       pin_memory=True)
        self.host_niw_stamps = torch.zeros(2, dtype=torch.int64,
                                           pin_memory=True)
        self.turn = 0
        # sweeps that stamped the tile marks, eagerly or in a capture
        self.tiled = 0
        # whether a sweep has stamped the niw marks
        self.niw_used = False
        # while a graph captures: the mark nodes it captured
        self.nodes = None
        # (graph or None, its 'scored' event) of the last step
        self.last = None
        self.pending = None

    def mark(self, point):
        self.steps[self.turn][self.STEP.index(point)].record(
            torch.cuda.current_stream(self.device))

    def tile(self, i):
        self._stamp(self.stamps, i)
        if i == self.MARKS - 1:
            self.tiled += 1

    def niw(self, i):
        self._stamp(self.niw_stamps, i)
        self.niw_used = True

    def _stamp(self, stamps, i):
        node = fk.clock_mark(stamps, i)
        if node is not None and self.nodes is not None:
            self.nodes.append(node)

    def end_step(self, graph, n_sweeps, captured, tiled):
        """After the step's score and output copies: copy the stamps of a
        step that `tiled` to the host, mark 'scored', and keep the step to
        read."""
        if tiled:
            self.host_stamps.copy_(self.stamps, non_blocking=True)
            if self.niw_used:
                self.host_niw_stamps.copy_(self.niw_stamps,
                                           non_blocking=True)
        self.mark('scored')
        scored = self.steps[self.turn][-1]
        edge_from = None
        if graph is not None and self.last is not None \
                and self.last[0] is graph:
            edge_from = self.last[1]
        self.pending = dict(events=self.steps[self.turn], n=n_sweeps,
                            captured=captured, tiled=tiled,
                            edge_from=edge_from)
        self.last = (graph, scored)
        self.turn ^= 1

    def read(self):
        """The last step's {'device_ms', 'tile_ms', 'captured'} (see
        `step_times`), or None when none is there to read."""
        p, self.pending = self.pending, None
        if p is None:
            return None
        start, loaded, swept, scored = p['events']
        scored.synchronize()
        device = {'load': start.elapsed_time(loaded),
                  'sweeps': loaded.elapsed_time(swept) / p['n'],
                  'score': swept.elapsed_time(scored)}
        if p['edge_from'] is not None:
            device['edge'] = p['edge_from'].elapsed_time(start)
        out = {'device_ms': device}
        if p['tiled']:
            t = self.host_stamps.tolist()
            tile = {name: (t[i + 1] - t[i]) / 1e6
                    for i, name in enumerate(self.PHASES)}
            tile['state_copy'] = (t[-1] - t[-2]) / 1e6
            tile['sweep'] = (t[-1] - t[0]) / 1e6
            # the niw marks of this sweep lie inside its inputs phase
            # (older stamps, of another run, before it)
            a, b = self.host_niw_stamps.tolist()
            if t[1] <= a <= b <= t[2]:
                tile['niw_coeffs'] = (b - a) / 1e6
            out['tile_ms'] = tile
        if p['captured']:
            out['captured'] = True
        return out


class _NoClock:
    """The clock off the card: it records nothing."""

    tiled = 0

    def mark(self, point):
        pass

    def tile(self, i):
        pass

    def niw(self, i):
        pass

    def end_step(self, graph, n_sweeps, captured, tiled):
        pass


_NO_CLOCK = _NoClock()
# the `_DeviceClock` of each card, by device index
_CLOCKS = {}


def _device_clock(device):
    if device.type != 'cuda':
        return _NO_CLOCK
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    clock = _CLOCKS.get(index)
    if clock is None:
        clock = _CLOCKS[index] = _DeviceClock(torch.device('cuda', index))
    return clock


def step_times(device):
    """What the card's timing events saw of the last fused, v1 or plain
    run of sweeps on `device` (`_run_static`), once its outputs have
    synced, or None (off the card, or nothing since the last read):
    {'device_ms': {'load', 'sweeps' (a sweep), 'score', and on the graph
    path after a step of the same graph 'edge', the device time from that
    step's last event to this one's first}, 'tile_ms' (fused sweeps: tile
    0's phases in the last sweep, 'state_copy' and the whole 'sweep'), and
    'captured': True when the run captured its graph}, times in ms."""
    if device.type != 'cuda':
        return None
    return _device_clock(device).read()


def _graph_refusal(device, sampling, sweep='fused'):
    """Why a run of the `sweep` kind on `device` takes the eager loop, or
    None when its sweeps are replayed from a CUDA graph.  Rules, not
    failures: a graph that fails to capture raises.
    - The CPU runs the twins, eagerly.
    - The mesh's plain sweeps and sweep_blocked's slow branch
      (`_EAGER_SWEEPS`).
    - The '_host' modes draw each tile's noise from a generator seeded from
      the host (`_tile_noise`): they are the bitwise bridge to the JAX
      package, not a production mode.  (`sampling` None: a sweep with no
      mode, whose draws come from a device generator.)
    - `_eager_sweeps()`.
    Graphed: the fused sweeps ('fused', 'sharded_fused', 'fused_2d'), the
    v1 sweeps ('v1') and the single-device plain sweeps ('blocked',
    'chains')."""
    if device.type != 'cuda':
        return 'not on the card'
    if sweep in _EAGER_SWEEPS:
        return _EAGER_SWEEPS[sweep]
    if sampling is not None and '_host' in sampling:
        return "a '_host' mode draws its noise from the host"
    if _EAGER[0]:
        return '_eager_sweeps()'
    return None


class _SweepGraph:
    """One sweep of a fused run captured as a CUDA graph over static
    buffers, and the joint score as a second graph with a memory pool of
    its own.

    sweep(lay, static, seeds) runs one sweep that writes its results into
    the tensors it reads; score(lay, static) returns the joint score (None:
    the run has none).  `static` is (params, outs): the buffers that a call
    loads (`load`), so new shareds or a new clustering model after a hyper
    move are copied in, not captured anew, and of them `outs`, the ones the
    sweep writes (state, assignments, stat cache), which `outputs` copies
    out.  `seeds` is the [n_seeds] int64 seed table on the card or, with
    `gens`, a tuple of n_seeds device generators of the graph's own,
    registered with the capture and seeded anew before each replay
    (`manual_seed`, which starts a generator's Philox offset at 0 as a
    freshly seeded one's: the replay draws what the eager loop draws).
    `lay` (the run's layout) and `keep` (the values its key names by
    address) are held with the graph.

    Each sweep costs the host one copy of the seed table (or n_seeds
    reseeds) and one replay; the first sweep runs the eager function on a
    side stream, which warms up what the capture needs (the kernels'
    build, cuBLAS, a process group's communicator), and then captures it.
    A replay adds the launches of each kernel wrapper that the capture
    recorded, as if the wrapper had launched them.  The card's
    `_DeviceClock` marks the start and the end of each load (the clone of
    the inputs at construction); `marks` are the clock's mark nodes in the
    sweep graph, off but in the replays that `sweep(marks=True)` asks
    for."""

    def __init__(self, lay, sweep, score, inputs, n_seeds, keep, gens=False):
        self.lay, self.keep = lay, keep
        self._sweep_fn, self._score_fn = sweep, score
        self.device = next(_tensors(inputs[1])).device
        self.clock = _device_clock(self.device)
        self.clock.mark('start')
        self.static = _map_tensors(torch.clone, inputs)
        self.clock.mark('loaded')
        self.marks = ()
        self.gens = tuple(torch.Generator(device=self.device)
                          for _ in range(n_seeds if gens else 0))
        self.seeds = self.gens or torch.zeros(
            n_seeds, dtype=torch.int64, device=self.device)
        self.stream = torch.cuda.Stream(self.device)
        self.pools = (torch.cuda.graph_pool_handle(),
                      torch.cuda.graph_pool_handle())
        self.graph = self.score_graph = self.score_out = None
        self.launches = {}

    def load(self, inputs):
        """Copy `inputs` into the buffers; the step's start was marked
        before `inputs` were made."""
        for dst, src in zip(_tensors(self.static), _tensors(inputs)):
            dst.copy_(src)
        self.clock.mark('loaded')

    def _capture(self, fn, pool, gens=(), sweep=False):
        """Run fn on the side stream (the warm-up, and a real run), then
        capture it into `pool`, with the generators `gens` registered.
        For the `sweep` graph, GRAPH_STATS['sweep_graph_nodes'] takes the
        captured graph's nodes, and `marks` the clock's mark nodes, turned
        off.  Returns (fn's result, the graph, the capture's output)."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            result = fn()
        cur.wait_stream(self.stream)
        if result is not None:
            result.record_stream(cur)
        before = [w.launches for w in _COUNTED]
        # the sweep graph is kept, for its nodes: a mark node is switched
        # in the graph instantiated from the one that holds it
        graph = torch.cuda.CUDAGraph(keep_graph=sweep)
        for g in gens:
            graph.register_generator_state(g)
        self.clock.nodes = [] if sweep else None
        try:
            with torch.cuda.graph(graph, pool=pool, stream=self.stream):
                out = fn()
        finally:
            marks, self.clock.nodes = self.clock.nodes, None
        if sweep:
            GRAPH_STATS['sweep_graph_nodes'] = _graph_nodes(graph)
            graph.instantiate()
            self.marks = tuple(marks)
            if self.marks:
                fk.clock_set_enabled(graph.raw_cuda_graph_exec(),
                                     self.marks, False)
        GRAPH_STATS['pool_bytes'] += sum(
            seg['total_size'] for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get('segment_pool_id', ())) == tuple(pool))
        # the capture launched nothing: its count is what a replay launches
        for w, n in zip(_COUNTED, before):
            self.launches[w] = self.launches.get(w, 0) + w.launches - n
            w.launches = n
        return result, graph, out

    def sweep(self, seeds, marks=False):
        """One sweep with the [n_seeds] int64 host seed table `seeds` (with
        generators: each generator's seed); a replay with `marks` stamps
        the clock's tile marks.  (The first sweep, the capture's warm-up,
        stamps them whatever `marks` says.)"""
        if self.gens:
            for g, seed in zip(self.gens, seeds.tolist()):
                g.manual_seed(seed)
        else:
            self.seeds.copy_(seeds.pin_memory(), non_blocking=True)
        if self.graph is not None:
            if marks and self.marks:
                exec_ = self.graph.raw_cuda_graph_exec()
                fk.clock_set_enabled(exec_, self.marks, True)
                self.graph.replay()
                fk.clock_set_enabled(exec_, self.marks, False)
            else:
                self.graph.replay()
            GRAPH_STATS['replays'] += 1
            for w, n in self.launches.items():
                w.launches += n
            return
        with diagnostics.span('graph.capture') as capture:
            _, self.graph, _ = self._capture(
                lambda: self._sweep_fn(self.lay, self.static, self.seeds),
                self.pools[0], self.gens, sweep=True)
        GRAPH_STATS['captures'] += 1
        GRAPH_STATS['capture_seconds'] += capture.seconds

    def score(self):
        """The joint score of the static state, a tensor of its own."""
        if self.score_graph is not None:
            self.score_graph.replay()
            GRAPH_STATS['score_replays'] += 1
            return self.score_out.clone()
        with diagnostics.span('graph.capture') as capture:
            score, self.score_graph, self.score_out = self._capture(
                lambda: self._score_fn(self.lay, self.static), self.pools[1])
        GRAPH_STATS['score_captures'] += 1
        GRAPH_STATS['capture_seconds'] += capture.seconds
        return score

    def outputs(self):
        """Copies of the buffers the sweep writes, which the next replay
        does not write."""
        return _map_tensors(torch.clone, self.static[1])


def _tensor_key(t):
    return (t.data_ptr(), t._version, tuple(t.shape), t.dtype, t.device)


def _graph_for(key, keep, layout, inputs, sweep, score, n_seeds, gens):
    """The `_SweepGraph` of the run with `key`, loaded with its inputs, or
    None when the run takes the eager loop because its key is used for the
    first time outside a session: a call made once costs what the eager
    loop costs.  The key names the values by address and version
    (`_tensor_key`), and `keep` holds them while it is held, so that their
    addresses are not given to other tensors: values given on the host are
    copied to new tensors on every call, so their key is never used twice.

    layout(): the run's static layout, built when the graph is captured
    and kept with it; inputs(lay): the (params, outs) that a call loads;
    sweep, score, n_seeds and gens: as `_SweepGraph` takes them."""
    graph = _GRAPH['graph'] if _GRAPH['key'] == key else None
    if graph is None and not _SESSION[0] and _GRAPH['seen'] != key:
        _GRAPH.update(seen=key, seen_values=keep)
        GRAPH_STATS['first_uses'] += 1
        return None
    with diagnostics.span('graph.load'):
        if graph is not None:
            graph.clock.mark('start')
            graph.load(inputs(graph.lay))
            return graph
        lay = layout()
        loaded = inputs(lay)
        # the graph before is freed before this one takes its memory
        release_sweep_graphs()
        graph = _SweepGraph(lay, sweep, score, loaded, n_seeds, keep, gens)
        _GRAPH.update(key=key, graph=graph)
    return graph


def _run_static(key, keep, layout, inputs, sweep, score, n_seeds,
                generator, n_sweeps, with_score, gens=False):
    """`n_sweeps` sweeps of a static sweep function (`_SweepGraph`'s
    `sweep`) from `generator`: replayed from the CUDA graph of `key`
    (`_graph_for`), or eagerly over copies of the inputs with the seeds
    passed by value where `key` is None (a rule of `_graph_refusal`) or
    new.  Each sweep draws its seeds on the host: the [n_seeds] tile
    seeds of `random.sweep_seeds(generator, n_seeds)` or, with `gens`,
    one `draw_seed` from each of the n_seeds generators in `generator`,
    each the seed of a device generator that the sweep draws from (the
    eager loop's `device_generator`, the graph's own generators
    reseeded).  Both give the same draws.  Returns (outs, the joint score
    or None): tensors of their own, which later calls do not write.

    On the card both paths mark the step's edge on the card's
    `_DeviceClock` (`step_times` reads it)."""
    def host_seeds():
        if gens:
            return torch.tensor([draw_seed(g) for g in generator],
                                dtype=torch.int64)
        return sweep_seeds(generator, n_seeds)
    graph = None if key is None else _graph_for(
        key, keep, layout, inputs, sweep, score, n_seeds, gens)
    if graph is not None:
        clock = graph.clock
        captured = graph.graph is None or (
            with_score and graph.score_graph is None)
        with diagnostics.span('graph.replays'):
            for i in range(n_sweeps):
                graph.sweep(host_seeds(), marks=i == n_sweeps - 1)
        clock.mark('swept')
        outs = graph.outputs()
        result = None
        if with_score:
            with diagnostics.span('graph.score'):
                result = graph.score()
        clock.end_step(graph, n_sweeps, captured, bool(graph.marks))
        return outs, result
    lay = layout()
    params, outs = inputs(lay)
    dev = next(_tensors(outs)).device
    clock = _device_clock(dev)
    clock.mark('start')
    static = (params, _map_tensors(torch.clone, outs))
    clock.mark('loaded')
    tiled = clock.tiled
    for _ in range(n_sweeps):
        seeds = host_seeds().tolist()
        if gens:
            seeds = tuple(device_generator(x, dev) for x in seeds)
        sweep(lay, static, seeds)
    clock.mark('swept')
    result = score(lay, static) if with_score else None
    clock.end_step(None, n_sweeps, False, clock.tiled > tiled)
    return static[1], result


def _fused_run(spec, values, supports, nich_only, block, block_rows,
               sampling, n_sweeps, with_score, cl_model, shareds, state,
               assignments, generator, cache):
    """`n_sweeps` fused sweeps from `generator` (`_run_static` over
    `_fused_sweep_into`).  Returns (state, assignments, cache) and, with
    `with_score`, the joint score."""
    assignments = assignments.to(torch.int32)
    key = None
    if _graph_refusal(assignments.device, sampling) is None:
        values = tuple(torch.as_tensor(v, device=assignments.device)
                       for v in values)
        key = ('fused', spec, block, block_rows, sampling,
               assignments.device, type(cl_model),
               tuple(_tensor_key(v) for v in values),
               None if supports is None else tuple(
                   None if s is None else _tensor_key(torch.as_tensor(s))
                   for s in supports),
               _signature((cl_model, shareds, state, assignments, cache)))

    def inputs(lay):
        _check_constant_nu(lay, shareds)
        return ((cl_model, shareds, _stat_matrices(spec, lay, shareds)),
                (state, assignments, cache))

    def sweep(lay, static, seeds):
        (cl, sh, W), (st, an, ca) = static
        _fused_sweep_into(spec, lay, W, block, block_rows, sampling, cl, sh,
                          st, an, ca, seeds)
    outs, score = _run_static(
        key, values, lambda: _fused_layout(spec, values, supports, nich_only),
        inputs, sweep, _static_score(spec), cache[0].shape[0], generator,
        n_sweeps, with_score)
    return outs + (score,) if with_score else outs


def _static_score(spec):
    """The `score` of a `_SweepGraph` whose static buffers are ((clustering
    model, shareds, ...), (replicated state, ...)): the joint score."""
    def score(lay, static):
        return mx.score_data(spec, static[0][0], static[0][1], static[1][0])
    return score


def _fused_layout(spec, values, supports, nich_only):
    if nich_only and not fk.supports_pallas(spec):
        raise ValueError('sweep_blocked_pallas_fused takes nich-only specs; '
                         'use sweep_blocked_pallas_fused_mixed')
    return _mixed_static_layout(spec, values, supports)


def sweep_blocked_pallas_fused(spec, cl_model, shareds, state, values,
                               assignments, block, block_rows, generator,
                               cache, sampling='cdf'):
    """One fused sweep of a nich-only spec; in the port "pallas" names the
    hand-written fused kernel K1.

    cache = build_stat_cache(spec, shareds, values, block, assignments) for
    the CURRENT assignments.  Returns (state, assignments, new_cache)."""
    _n_tiles(assignments, block)
    return _fused_run(spec, values, None, True, block, block_rows, sampling,
                      1, False, cl_model, shareds, state, assignments,
                      generator, cache)


def run_sweeps_pallas_fused(spec, cl_model, shareds, state, values,
                            assignments, block, block_rows, generator, cache,
                            n_sweeps, sampling='cdf'):
    """n_sweeps fused sweeps of a nich-only spec on K1.  Returns (state,
    assignments, cache)."""
    _n_tiles(assignments, block)
    return _fused_run(spec, values, None, True, block, block_rows, sampling,
                      n_sweeps, False, cl_model, shareds, state, assignments,
                      generator, cache)


def sweep_blocked_pallas_fused_mixed(spec, cl_model, shareds, state, values,
                                     assignments, block, block_rows,
                                     generator, cache, sampling='cdf',
                                     supports=None, n_sweeps=1,
                                     with_score=False):
    """The runner's fused sweep for ANY mix of nich, niw and
    bounded-support discrete blocks (bb/dd/dpd/gp/bnb): one fused kernel
    per tile (K2, or K1 for a nich-only spec) scores every row against
    every slot, draws, and emits the tile's stat sums: nich [1, v, v^2]
    sums, niw [1, v, vv^T] sums, and per-column [C, V] count tables that a
    [C, V] x [V, S] product outside the kernel turns into per-model raw
    sums.

    sampling: 'cdf' | 'gumbel' | 'argmax' with an optional '_fast'
    suffix, or 'cdf_host' | 'gumbel_host', which draw each tile's noise
    from the generator outside the kernel.  supports: optional per-block
    sorted value supports (None entries for nich and niw blocks); they
    must cover every observed value.

    cache = build_stat_cache(...) on the current assignments.  Runs
    `n_sweeps` sweeps and returns (state, assignments, new_cache), plus
    the joint mx.score_data when with_score=True.

    On the card each sweep is the replay of one CUDA graph of all its tiles
    (`_SweepGraph`), as the JAX package runs a step as one device program;
    the '_host' modes run eagerly (`_graph_refusal`).  The results are
    tensors of their own, which later calls do not write.  A key's first
    call runs eagerly, and its second captures the graph, which is kept
    until a call with another key captures its own: pass the values as
    the same tensors on the card to reuse it (`sweep_graph_session`
    captures on the first call)."""
    _n_tiles(assignments, block)
    return _fused_run(spec, values, supports, False, block, block_rows,
                      sampling, n_sweeps, with_score, cl_model, shareds,
                      state, assignments, generator, cache)


# -- the unfused sweeps over static buffers, replayed from a CUDA graph ------

def _tile_loop_into(spec, block, shareds, row_stats, state, assignments,
                    draw):
    """One unfused sweep that writes its results into the tensors it reads
    (the leaves of `state`, `assignments` [R]): per tile t, remove its
    stats (`tile_deltas_fast` of the row stats), draw its rows with
    draw(t, tile-removed state) -> [block] int32, add the new stats back.
    Tile t reads its rows of `assignments` before it writes them."""
    cur = state
    for t in range(assignments.shape[0] // block):
        sl = slice(t * block, (t + 1) * block)
        tile_stats = tuple(rs[sl] for rs in row_stats)
        cd, tiles = mx.tile_deltas_fast(spec, shareds, tile_stats,
                                        assignments[sl])
        cur = mx.apply_stat_tiles(spec, shareds, cur, cd, tiles, -1, block)
        new_assign = draw(t, cur)
        cd, tiles = mx.tile_deltas_fast(spec, shareds, tile_stats,
                                        new_assign)
        cur = mx.apply_stat_tiles(spec, shareds, cur, cd, tiles, +1, block)
        assignments[sl] = new_assign
    for dst, src in zip(_tensors(state), _tensors(cur)):
        dst.copy_(src)


def _plain_sweep_into(spec, block, cl_model, shareds, row_stats, values,
                      state, assignments, gen):
    """`sweep_blocked`'s row-stats branch as a `_tile_loop_into` sweep:
    each tile's [B, C] `mixture.score_batch`, drawn by gumbel-argmax from
    the device generator `gen` (`random.sample_from_scores`)."""
    def draw(t, cur):
        sl = slice(t * block, (t + 1) * block)
        scores = mx.score_batch(spec, cl_model, shareds, cur,
                                tuple(v[sl] for v in values))
        return sample_from_scores(gen, scores).to(torch.int32)
    _tile_loop_into(spec, block, shareds, row_stats, state, assignments,
                    draw)


def _v1_sweep_into(spec, lay, block, block_rows, sampling, kernel, cl_model,
                   shareds, row_stats, state, assignments, seeds):
    """One v1 sweep as a `_tile_loop_into` sweep.  kernel 'K4'
    (`sweep_blocked_pallas`: `fused_kernels.nich_score_sample`) or 'K5'
    (`fused_kernels.mixed_score_sample`) scores and draws tile t with
    seeds[t], an int or a view of a [T] int64 tensor that the kernel reads
    when it runs; 'xla' (`sweep_blocked_pallas_mixed(backend='xla')`)
    adds the tables block by block and draws from the device generator
    seeds[0].

    With a tensor of seeds (or a generator) and a mode without '_host', a
    sweep reads nothing back from the card and makes no tensor from host
    data: on the card it is captured into a CUDA graph (`_SweepGraph`); on
    the CPU it runs on the kernels' twins."""
    C = spec.capacity

    def draw(t, cur):
        cl_scores = _cl.score_value(cl_model, cur.counts, cur.alive,
                                    cur.sample_size)
        t_nich, _, t_idx = _slice_rows(lay, t, block)
        if kernel == 'xla':
            return _xla_draw(spec, lay, shareds, cur, cl_scores, t_nich,
                             t_idx, seeds[0])
        coeffs, tables = _build_v1_inputs(spec, lay, shareds, cur)
        noise = _tile_noise(sampling, seeds[t], block, C, cl_scores.device)
        if kernel == 'K4':
            return fk.nich_score_sample(seeds[t], t_nich, cl_scores, coeffs,
                                        block_rows=block_rows,
                                        sampling=sampling, noise=noise)
        return fk.mixed_score_sample(seeds[t], t_nich, t_idx, cl_scores,
                                     coeffs, tables, block_rows=block_rows,
                                     sampling=sampling, noise=noise)
    _tile_loop_into(spec, block, shareds, row_stats, state, assignments,
                    draw)


def _xla_draw(spec, lay, shareds, state, cl_scores, t_nich, t_idx, gen):
    """backend='xla''s draw of one tile: [B, C] scores from the nich
    blocks' `score_value_batch` and the table columns' `tables[idx]`, in
    the spec's block order, drawn from `gen` as `sweep_blocked` draws."""
    table_list = _column_tables(spec, lay, shareds, state)
    B = (t_nich if t_nich is not None else t_idx).shape[0]
    scores = cl_scores[None, :].expand(B, spec.capacity)
    ncol = tcol = 0
    for i, blk in enumerate(spec.blocks):
        if i in lay.nich_blocks:
            part = mx._block_score_batch(blk, shareds[i], state.groups[i],
                                         t_nich[:, ncol:ncol + blk.cols])
            ncol += blk.cols
        else:
            part = None
            for _ in range(blk.cols):
                s = table_list[tcol][t_idx[:, tcol].long()]
                part = s if part is None else part + s
                tcol += 1
        scores = scores + part
    return sample_from_scores(gen, scores).to(torch.int32)


def _v1_run(spec, values, supports, kernel, block, block_rows, sampling,
            n_sweeps, with_score, cl_model, shareds, state, assignments,
            generator):
    """`n_sweeps` v1 sweeps from `generator` (`_run_static` over
    `_v1_sweep_into`).  K4 and K5 take each sweep's tile seeds from
    `random.sweep_seeds(generator, T)`: one `draw_seed` folded with each
    tile index (`fold_seed`), the seeds the eager loop took.  'xla' seeds
    its device generator with one `draw_seed(generator)` a sweep.  The
    row stats are loaded with the shareds at each call, so a hyper move is
    copied into the graph, not captured anew.  Returns (state,
    assignments) and, with `with_score`, the joint score."""
    n_tiles = _n_tiles(assignments, block)
    assignments = assignments.to(torch.int32)
    xla = kernel == 'xla'
    mode = None if xla else sampling
    key = None
    if _graph_refusal(assignments.device, mode, 'v1') is None:
        values = tuple(torch.as_tensor(v, device=assignments.device)
                       for v in values)
        key = ('v1', spec, block, block_rows, mode, kernel,
               assignments.device, type(cl_model),
               tuple(_tensor_key(v) for v in values),
               None if supports is None else tuple(
                   None if s is None else _tensor_key(torch.as_tensor(s))
                   for s in supports),
               _signature((cl_model, shareds, state, assignments)))

    def inputs(lay):
        return ((cl_model, shareds,
                 mx.precompute_row_stats(spec, shareds, values)),
                (state, assignments))

    def sweep(lay, static, seeds):
        (cl, sh, rs), (st, an) = static
        _v1_sweep_into(spec, lay, block, block_rows, mode, kernel, cl, sh,
                       rs, st, an, seeds)
    outs, score = _run_static(
        key, values, lambda: _mixed_static_layout(spec, values, supports),
        inputs, sweep, _static_score(spec), 1 if xla else n_tiles,
        (generator,) if xla else generator, n_sweeps, with_score, gens=xla)
    return outs + (score,) if with_score else outs


def _plain_run(spec, cl_model, shareds, state, values, assignments, block,
               generator, n_sweeps, with_score):
    """`n_sweeps` of `sweep_blocked` from `generator`: `_run_static` over
    `_plain_sweep_into`, each sweep's tiles drawing from one device
    generator seeded with one `draw_seed(generator)`; for a model without
    row stats the slow branch, eagerly.  Returns (state, assignments) and,
    with `with_score`, the joint score."""
    _n_tiles(assignments, block)
    dev = assignments.device
    if not mx.supports_row_stats(spec):
        for _ in range(n_sweeps):
            state, assignments = _slow_sweep(
                spec, cl_model, shareds, state, values, assignments, block,
                device_generator(draw_seed(generator), dev))
        if with_score:
            return state, assignments, mx.score_data(spec, cl_model, shareds,
                                                     state)
        return state, assignments
    assignments = assignments.to(torch.int32)
    key = None
    if _graph_refusal(dev, None, 'blocked') is None:
        values = tuple(torch.as_tensor(v, device=dev) for v in values)
        key = ('blocked', spec, block, dev, type(cl_model),
               tuple(_tensor_key(v) for v in values),
               _signature((cl_model, shareds, state, assignments)))

    def inputs(vals):
        return ((cl_model, shareds,
                 mx.precompute_row_stats(spec, shareds, vals)),
                (state, assignments))

    def sweep(vals, static, gens):
        (cl, sh, rs), (st, an) = static
        _plain_sweep_into(spec, block, cl, sh, rs, vals, st, an, gens[0])
    outs, score = _run_static(
        key, values, lambda: values, inputs, sweep, _static_score(spec), 1,
        (generator,), n_sweeps, with_score, gens=True)
    return outs + (score,) if with_score else outs


# -- row-by-row initializations ---------------------------------------------

def sequential_init(spec, cl_model, shareds, state, values, generator):
    """Sequential (greedy posterior-predictive) initialization: assign the
    rows one at a time, each from the running predictive of the rows
    before it.  A loop of R single-row steps (`mixture.score_value`, a
    gumbel-argmax draw, `mixture.add_value`), each a few dozen [C]-sized
    ops: meant for small R.  Returns (state, assignments)."""
    values = tuple(torch.as_tensor(v) for v in values)
    R = values[0].shape[0]
    dev = state.counts.device
    gen = device_generator(draw_seed(generator), dev)
    assignments = torch.zeros(R, dtype=torch.int32, device=dev)
    for i in range(R):
        row = tuple(v[i] for v in values)
        scores = mx.score_value(spec, cl_model, shareds, state, row)
        k = sample_from_scores(gen, scores)
        state, _ = mx.add_value(spec, cl_model, shareds, state, k, row)
        assignments[i] = k
    return state, assignments


def prior_seating(cl_model, state, R, generator):
    """[R] int32 slots of R rows seated by the clustering prior alone, as
    if added one at a time to `state`: Pitman-Yor's seating depends on the
    counts alone, so it is drawn on the host at once
    (`clustering._crp_seating`); the low-entropy prior is not
    exchangeable, and its rows are seated one by one on the host
    (`clustering._le_seating`, meant for small R).  On the state's
    device."""
    if isinstance(cl_model, _cl.PitmanYor):
        slots = _crp_seating(float(cl_model.alpha), float(cl_model.d),
                             state.counts.cpu().numpy(),
                             state.alive.cpu().numpy(), R, generator)
    else:
        slots = _le_seating(cl_model, state.counts, state.alive,
                            state.sample_size, R, generator)
    return torch.from_numpy(slots.astype(np.int32)).to(state.counts.device)


def prior_init(spec, cl_model, shareds, state, values, generator):
    """Prior-predictive initialization: assign each row from the
    clustering prior only, ignoring the likelihoods (`prior_seating`),
    then add the rows' statistics in one `mixture.add_tile`.  Returns
    (state, assignments)."""
    values = tuple(torch.as_tensor(v) for v in values)
    assignments = prior_seating(cl_model, state, values[0].shape[0],
                                generator)
    state = mx.add_tile(spec, cl_model, shareds, state, values, assignments)
    return state, assignments


# -- chains -----------------------------------------------------------------

def _chain_take(states, c):
    """Chain `c` of a MixtureState whose leaves lead with a chain axis."""
    return mx.MixtureState(
        counts=states.counts[c], alive=states.alive[c],
        sample_size=states.sample_size[c],
        groups=tuple(mx._map_group(lambda a: a[c], g)
                     for g in states.groups))


def _chain_stack(states):
    """One MixtureState with a leading chain axis from a list of them."""
    first = states[0]
    return mx.MixtureState(
        counts=torch.stack([s.counts for s in states]),
        alive=torch.stack([s.alive for s in states]),
        sample_size=torch.stack([s.sample_size for s in states]),
        groups=tuple(
            mx._map_group(lambda *leaves: torch.stack(leaves),
                          *[s.groups[b] for s in states])
            for b in range(len(first.groups))))


def sweep_blocked_chains(spec, cl_model, shareds, states, values,
                         assignments, block, generators):
    """One blocked sweep on each of N independent chains: `states` and
    `assignments` [N, R] lead with the chain axis, `values` are shared,
    and `generators` holds one `torch.Generator` per chain (the JAX
    package's [N] keys), so chain c equals `sweep_blocked` of its own
    state with generators[c].  The chains run one after another in one
    sweep function (`_plain_sweep_into` on each chain's rows of the
    stacked buffers, chain c drawing from a device generator seeded with
    one `draw_seed(generators[c])`): on the card all N chains are the
    replay of one CUDA graph, the analog of the JAX package's `vmap`.
    Returns (states, assignments)."""
    if len(generators) != assignments.shape[0]:
        raise ValueError('one generator per chain: %d generators for %d '
                         'chains' % (len(generators), assignments.shape[0]))
    if not mx.supports_row_stats(spec):
        out_states, out_assign = [], []
        for c, gen in enumerate(generators):
            st, an = sweep_blocked(spec, cl_model, shareds,
                                   _chain_take(states, c), values,
                                   assignments[c], block, generator=gen)
            out_states.append(st)
            out_assign.append(an)
        return _chain_stack(out_states), torch.stack(out_assign)
    _n_tiles(assignments[0], block)
    n = len(generators)
    assignments = assignments.to(torch.int32)
    dev = assignments.device
    key = None
    if _graph_refusal(dev, None, 'chains') is None:
        values = tuple(torch.as_tensor(v, device=dev) for v in values)
        key = ('chains', n, spec, block, dev, type(cl_model),
               tuple(_tensor_key(v) for v in values),
               _signature((cl_model, shareds, states, assignments)))

    def inputs(vals):
        return ((cl_model, shareds,
                 mx.precompute_row_stats(spec, shareds, vals)),
                (states, assignments))

    def sweep(vals, static, gens):
        (cl, sh, rs), (sts, an) = static
        for c in range(n):
            _plain_sweep_into(spec, block, cl, sh, rs, vals,
                              _chain_take(sts, c), an[c], gens[c])
    outs, _ = _run_static(key, values, lambda: values, inputs, sweep, None,
                          n, tuple(generators), 1, False, gens=True)
    return outs


def init_chains(spec, cl_model, shareds, values, assignments_per_chain):
    """[N]-chain states from an [N, R] assignment matrix."""
    return _chain_stack([
        mx.state_from_assignments(spec, cl_model, shareds, values, an)
        for an in assignments_per_chain])
