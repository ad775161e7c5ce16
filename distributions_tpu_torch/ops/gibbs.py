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

Randomness: every sweep draws one seed from the caller's
`torch.Generator`, and each tile folds its index into it
(`random.fold_seed`), as the JAX package splits a sweep key per tile.
"""

from collections import namedtuple

import torch

from distributions_tpu_torch import clustering as _cl, mixture as mx
from distributions_tpu_torch.models import nich as nich_mod, niw as niw_mod
from distributions_tpu_torch.ops import fused_kernels as fk
from distributions_tpu_torch.random import (device_generator, draw_seed,
                                            fold_seed, gumbel_noise,
                                            sample_from_scores)


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


def sweep_blocked(spec, cl_model, shareds, state, values, assignments, block,
                  generator=None):
    """One full pass of blocked collapsed Gibbs with tile size `block`
    (the fast row-stat branch).  Returns (state, assignments)."""
    if not mx.supports_row_stats(spec):
        raise NotImplementedError('sweep_blocked needs row-stat columns '
                                  'for every block')
    n_blocks = _n_tiles(assignments, block)
    dev = assignments.device
    gen = device_generator(draw_seed(generator), dev)
    row_stats = mx.precompute_row_stats(spec, shareds, values)
    out = []
    for t in range(n_blocks):
        sl = slice(t * block, (t + 1) * block)
        tile_stats = tuple(rs[sl] for rs in row_stats)
        cd, tiles = mx.tile_deltas_fast(spec, shareds, tile_stats,
                                        assignments[sl])
        state = mx.apply_stat_tiles(spec, shareds, state, cd, tiles, -1,
                                    block)
        scores = mx.score_batch(spec, cl_model, shareds, state,
                                tuple(v[sl] for v in values))
        new_assign = sample_from_scores(gen, scores).to(torch.int32)
        del scores
        cd, tiles = mx.tile_deltas_fast(spec, shareds, tile_stats,
                                        new_assign)
        state = mx.apply_stat_tiles(spec, shareds, state, cd, tiles, +1,
                                    block)
        out.append(new_assign)
    return state, torch.cat(out)


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


def _build_fused_inputs(spec, lay, shareds, state):
    """Per-slot kernel inputs (coeffs, qcoeffs, tables) from the current
    groups; a kind of block that the spec lacks gives None.  tables is
    the PACKED [Vtot, C] score table: every table column's [V, C] table of
    `score_value_batch` over its support, stacked in column order."""
    coeffs = qcoeffs = tables = None
    if lay.nich_blocks:
        coeffs = torch.cat([fk.nich_coeffs_v2(shareds[i], state.groups[i])
                            for i in lay.nich_blocks], dim=0).contiguous()
    if lay.quad_blocks:
        qcoeffs = torch.cat([fk.niw_coeffs_v4(shareds[i], state.groups[i])
                             for i in lay.quad_blocks], dim=0).contiguous()
    table_list = []
    for i in lay.table_blocks:
        blk = spec.blocks[i]
        for j in range(blk.cols):
            g = mx._map_group(lambda a: a[:, j], state.groups[i])
            table_list.append(blk.module.score_value_batch(
                shareds[i], g, lay.supports[i]))            # [V, C]
    if table_list:
        tables = torch.cat(table_list, dim=0).contiguous()
    return coeffs, qcoeffs, tables


def _slice_rows(lay, t, block):
    sl = slice(t * block, (t + 1) * block)
    return tuple(None if x is None else x[sl]
                 for x in (lay.nich_vals, lay.quad_vals, lay.table_idx))


def _fused_tile_core(spec, lay, W, block_rows, sampling, cl_model, shareds,
                     state, t_nich, t_quad, t_idx, seed, noise=None):
    """Score + sample + stats for ONE tile against the current (already
    tile-removed) state via the fused kernel.  Returns (new_assign [B],
    counts_delta [C], per-block raw sums in build_stat_cache's format)."""
    col_groups = tuple(spec.blocks[i].cols for i in lay.nich_blocks)
    cl_scores = _cl.score_value(cl_model, state.counts, state.alive,
                                state.sample_size)
    coeffs, qcoeffs, tables = _build_fused_inputs(spec, lay, shareds, state)
    new_assign, nich_sums, tcounts, qsums = \
        fk.fused_mixed_score_sample_stats(
            seed, t_nich, t_idx, cl_scores, coeffs, tables, col_groups,
            block_rows=block_rows, sampling=sampling, qvalues=t_quad,
            qcoeffs=qcoeffs, quad_groups=lay.quad_groups, noise=noise,
            table_vs=lay.table_vs)

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


def _fused_sweep(spec, lay, W, cl_model, shareds, state, block, block_rows,
                 sampling, cache, sweep_seed):
    """One fused sweep over all tiles.  Returns (state, assignments,
    new_cache)."""
    cached_cd, cached_sums = cache
    n_blocks = cached_cd.shape[0]
    out, out_cd = [], []
    out_sums = [[] for _ in spec.blocks]
    for t in range(n_blocks):
        tiles = mx.sums_to_tiles(spec, shareds,
                                 tuple(s[t] for s in cached_sums))
        state = mx.apply_stat_tiles(spec, shareds, state, cached_cd[t],
                                    tiles, -1, block)
        seed = fold_seed(sweep_seed, t)
        noise = _tile_noise(sampling, seed, block, spec.capacity,
                            cached_cd.device)
        new_assign, new_cd, new_sums = _fused_tile_core(
            spec, lay, W, block_rows, sampling, cl_model, shareds, state,
            *_slice_rows(lay, t, block), seed, noise=noise)
        tiles = mx.sums_to_tiles(spec, shareds, new_sums)
        state = mx.apply_stat_tiles(spec, shareds, state, new_cd, tiles,
                                    +1, block)
        out.append(new_assign)
        out_cd.append(new_cd)
        for acc, s in zip(out_sums, new_sums):
            acc.append(s)
    return state, torch.cat(out), (torch.stack(out_cd),
                                   tuple(torch.stack(s) for s in out_sums))


def _nich_only_layout(spec, shareds, values):
    if not fk.supports_pallas(spec):
        raise ValueError('sweep_blocked_pallas_fused takes nich-only specs; '
                         'use sweep_blocked_pallas_fused_mixed')
    lay = _mixed_static_layout(spec, values)
    _check_constant_nu(lay, shareds)
    return lay


def sweep_blocked_pallas_fused(spec, cl_model, shareds, state, values,
                               assignments, block, block_rows, generator,
                               cache, sampling='cdf'):
    """One fused sweep of a nich-only spec; in the port "pallas" names the
    hand-written fused kernel K1.

    cache = build_stat_cache(spec, shareds, values, block, assignments) for
    the CURRENT assignments.  Returns (state, assignments, new_cache)."""
    lay = _nich_only_layout(spec, shareds, values)
    _n_tiles(assignments, block)
    return _fused_sweep(spec, lay, None, cl_model, shareds, state, block,
                        block_rows, sampling, cache, draw_seed(generator))


def run_sweeps_pallas_fused(spec, cl_model, shareds, state, values,
                            assignments, block, block_rows, generator, cache,
                            n_sweeps, sampling='cdf'):
    """n_sweeps fused sweeps of a nich-only spec on K1.  Returns (state,
    assignments, cache)."""
    lay = _nich_only_layout(spec, shareds, values)
    _n_tiles(assignments, block)
    return _fused_mixed_run(spec, lay, None, block, block_rows, sampling,
                            n_sweeps, False, cl_model, shareds, state,
                            assignments, generator, cache)


def _fused_mixed_run(spec, lay, W, block, block_rows, sampling, n_sweeps,
                     with_score, cl_model, shareds, state, assignments,
                     generator, cache):
    for _ in range(n_sweeps):
        state, assignments, cache = _fused_sweep(
            spec, lay, W, cl_model, shareds, state, block, block_rows,
            sampling, cache, draw_seed(generator))
    if with_score:
        return state, assignments, cache, mx.score_data(
            spec, cl_model, shareds, state)
    return state, assignments, cache


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
    the joint mx.score_data when with_score=True."""
    _n_tiles(assignments, block)
    lay = _mixed_static_layout(spec, values, supports)
    _check_constant_nu(lay, shareds)
    return _fused_mixed_run(spec, lay, _stat_matrices(spec, lay, shareds),
                            block, block_rows, sampling, n_sweeps,
                            with_score, cl_model, shareds, state,
                            assignments, generator, cache)
