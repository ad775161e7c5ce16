"""Vectorized mixture-model machinery (distributions_tpu.mixture): a
fixed-capacity padded component axis with an alive mask.

- `counts[C]`   int32 rows per slot
- `alive[C]`    slot is present: nonempty, or one of `empties` reserved
                empty slots
- per-feature-block `Group` NamedTuples batched `[C, cols]`

A feature block is (model module, cols): `cols` same-model features scored
together.  Slot ids are stable, so an assignment vector indexes slots
directly.
"""

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from distributions_tpu_torch import clustering as _clustering
from distributions_tpu_torch.config import default_device
from distributions_tpu_torch.models import base


class FeatureBlock(NamedTuple):
    """Static description of one block of same-model features."""
    module: Any   # model module
    cols: int     # number of feature columns in this block


class MixtureSpec(NamedTuple):
    """Static structure of a mixture problem."""
    blocks: Tuple[FeatureBlock, ...]
    capacity: int
    empties: int = 1


class MixtureState(NamedTuple):
    """Dynamic state of a mixture."""
    counts: torch.Tensor        # [C] int32
    alive: torch.Tensor         # [C] bool
    sample_size: torch.Tensor   # int32
    groups: Tuple               # per-block Group, leaves [C, cols]


def make_spec(blocks, capacity, empties=1):
    return MixtureSpec(
        blocks=tuple(FeatureBlock(m, int(c)) for m, c in blocks),
        capacity=int(capacity), empties=int(empties))


def _map_group(fn, *groups):
    return type(groups[0])(*(fn(*leaves) for leaves in zip(*groups)))


def init(spec, shareds, counts=None):
    """A mixture state with empty feature groups; `counts` (optional
    [<=C] int) seeds the initial group sizes."""
    C = spec.capacity
    dev = shareds[0][0].device if shareds else default_device()
    counts_arr = torch.zeros(C, dtype=torch.int32, device=dev)
    if counts is not None:
        counts = torch.as_tensor(counts, device=dev).to(torch.int32)
        counts_arr[:counts.shape[0]] = counts
    groups = tuple(
        block.module.group_init(shared, (C, block.cols))
        for block, shared in zip(spec.blocks, shareds))
    return MixtureState(
        counts=counts_arr,
        alive=_recompute_alive(counts_arr, spec.empties),
        sample_size=counts_arr.sum().to(torch.int32),
        groups=groups)


def _recompute_alive(counts, empties):
    """alive = nonempty slots + the first `empties` empty slots."""
    is_zero = counts == 0
    rank = torch.cumsum(is_zero.to(torch.int32), dim=0)
    return (~is_zero) | (is_zero & (rank <= empties))


def group_count(state):
    """Number of present groups, the reserved empties included."""
    return state.alive.to(torch.int32).sum()


def nonempty_group_count(state):
    return (state.counts > 0).to(torch.int32).sum()


def _block_score_batch(block, shared, group, values):
    """Score [B, cols] values ([B, cols, d] for niw) against all C slots
    -> [B, C]."""
    total = None
    for j in range(block.cols):
        g = _map_group(lambda a: a[:, j], group)
        s = block.module.score_value_batch(shared, g, values[:, j])
        total = s if total is None else total + s
    return total


def _block_score_row(block, shared, group, values_row):
    """Score one row's `cols` values against all C slots -> [C]: the
    model's `score_value` broadcasts the [C, cols] group against the
    [cols] values."""
    return block.module.score_value(shared, group, values_row).sum(1)


def _block_update_row(block, shared, group, k, values_row, sign):
    """Add (sign=+1) or remove (sign=-1) one row's values to slot k."""
    fn = block.module.add_value if sign > 0 else block.module.remove_value
    sub = fn(shared, base.group_take(group, k), values_row)
    return base.group_set(group, k, sub)


def _zero_slot(block, shared, group, k, do_zero):
    """Reset slot k's stats to zero where do_zero: a slot that died must
    be bitwise empty for later reuse."""
    sub = base.group_take(group, k)
    sub = _map_group(lambda s: torch.where(do_zero, torch.zeros_like(s), s),
                     sub)
    return base.group_set(group, k, sub)


# -- single-row ops ---------------------------------------------------------
# These rebuild [C]-sized tensors per call: right for single rows and the
# sequential initialization, far slower per row than the blocked sweeps.

def score_value(spec, cl_model, shareds, state, values_row):
    """scores [C] of one row: clustering seating scores plus the feature
    predictive scores; dead slots score -inf."""
    scores = _clustering.score_value(
        cl_model, state.counts, state.alive, state.sample_size)
    zero = torch.zeros((), dtype=torch.float32, device=scores.device)
    for block, shared, group, v in zip(
            spec.blocks, shareds, state.groups, values_row):
        scores = scores + torch.where(
            state.alive,
            _block_score_row(block, shared, group, torch.as_tensor(v)), zero)
    return scores


def add_value(spec, cl_model, shareds, state, groupid, values_row):
    """Assign a row to slot `groupid`; when it takes a reserved empty slot
    the first dead slot comes alive in its place.  Returns (state,
    was_empty)."""
    groupid = torch.as_tensor(groupid, device=state.counts.device).long()
    was_empty = state.counts[groupid] == 0
    counts = state.counts.clone()
    counts[groupid] += 1
    # torch.argmin returns the first of several minima: the first dead slot
    dead = torch.argmin(state.alive.to(torch.int8))
    do_activate = was_empty & ~state.alive[dead]
    alive = state.alive.clone()
    alive[dead] = state.alive[dead] | do_activate
    groups = tuple(
        _block_update_row(block, shared, group, groupid, torch.as_tensor(v),
                          +1)
        for block, shared, group, v in zip(
            spec.blocks, shareds, state.groups, values_row))
    return MixtureState(counts=counts, alive=alive,
                        sample_size=state.sample_size + 1,
                        groups=groups), was_empty


def remove_value(spec, cl_model, shareds, state, groupid, values_row):
    """Unassign a row; a slot that empties dies (leaves the alive set, its
    stats zeroed).  Returns (state, now_empty)."""
    groupid = torch.as_tensor(groupid, device=state.counts.device).long()
    counts = state.counts.clone()
    counts[groupid] -= 1
    now_empty = counts[groupid] == 0
    alive = state.alive.clone()
    alive[groupid] = state.alive[groupid] & ~now_empty
    groups = []
    for block, shared, group, v in zip(
            spec.blocks, shareds, state.groups, values_row):
        group = _block_update_row(block, shared, group, groupid,
                                  torch.as_tensor(v), -1)
        groups.append(_zero_slot(block, shared, group, groupid, now_empty))
    return MixtureState(counts=counts, alive=alive,
                        sample_size=state.sample_size - 1,
                        groups=tuple(groups)), now_empty


def score_data(spec, cl_model, shareds, state):
    """Joint log prob of the partition and all feature data."""
    total = _clustering.score_counts(cl_model, state.counts)
    for block, shared, group in zip(spec.blocks, shareds, state.groups):
        total = total + block.module.score_data(shared, group).sum()
    return total


def score_batch(spec, cl_model, shareds, state, values):
    """[B, C] scores for a batch of rows against the current state."""
    scores = _clustering.score_value(
        cl_model, state.counts, state.alive, state.sample_size)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=scores.device)
    for block, shared, group, v in zip(
            spec.blocks, shareds, state.groups, values):
        block_scores = _block_score_batch(
            block, shared, group, torch.as_tensor(v))
        scores = scores + torch.where(state.alive[None, :], block_scores,
                                      zero)
    return scores


def log_predictive(spec, cl_model, shareds, state, values):
    """Collapsed posterior-predictive density of new rows [B]:
    log p(x | data) = logsumexp_k [log p(z=k | partition) + log p(x | k)].
    The seating scores of the clustering prior are normalised over the
    alive slots, so one logsumexp over `score_batch` marginalises the
    assignment."""
    return torch.logsumexp(
        score_batch(spec, cl_model, shareds, state, values), dim=1)


def _broadcasts_over_grid(module):
    """True for the models whose `score_data` is elementwise in the Shared
    leaves (nich, bb, gp, bnb): a leading grid axis broadcasts through it.
    dd sums its `alphas`, dpd its `betas`, niw takes determinants of
    `psi`: those are scored one grid point at a time."""
    return module.__name__.rsplit('.', 1)[-1] in ('nich', 'bb', 'gp', 'bnb')


def block_score_data_grid(block, grid_shared, group):
    """[G] data scores of one block's groups under each point of a grid
    of Shareds (leaves with a leading [G] axis): the sum of `score_data`
    over the block's [C, cols] groups."""
    G = grid_shared[0].shape[0]
    if _broadcasts_over_grid(block.module):
        rank = group[0].dim()
        lifted = type(grid_shared)(*(
            leaf.reshape((G,) + (1,) * (rank - (leaf.dim() - 1))
                         + tuple(leaf.shape[1:]))
            for leaf in grid_shared))
        per = block.module.score_data(lifted, group)       # [G, C, cols]
        return per.reshape(G, -1).sum(1)
    return torch.stack([
        block.module.score_data(
            type(grid_shared)(*(leaf[g] for leaf in grid_shared)),
            group).sum()
        for g in range(G)])


def score_data_grid(spec, cl_model, shareds_grid, state):
    """Score the current groups under a grid of Shared settings.

    shareds_grid: per block a Shared whose leaves carry a leading grid
    axis [G].  Returns [G] total data scores (the feature part only, the
    clustering term excluded).  Where the JAX package vmaps over the grid,
    nich, bb, gp and bnb blocks broadcast the grid axis through
    `score_data`; dd, dpd and niw blocks loop over the grid points."""
    total = None
    for block, grid_shared, group in zip(spec.blocks, shareds_grid,
                                         state.groups):
        s = block_score_data_grid(block, grid_shared, group)
        total = s if total is None else total + s
    return total


def _zero_emptied(group, counts):
    """Re-zero the slots that emptied (cancels float drift)."""
    empty_now = counts == 0
    return _map_group(
        lambda m: torch.where(
            empty_now.reshape((-1,) + (1,) * (m.dim() - 1)),
            torch.zeros_like(m), m), group)


def remove_tile(spec, cl_model, shareds, state, values, assignments):
    """Remove a whole tile of rows by segment-summed unmerge."""
    C = spec.capacity
    counts = state.counts - _clustering.count_assignments(assignments, C)
    groups = tuple(
        _zero_emptied(block.module.unmerge(
            shared, group, block.module.from_values_grouped(
                shared, torch.as_tensor(v), assignments, C)), counts)
        for block, shared, group, v in zip(
            spec.blocks, shareds, state.groups, values))
    n = torch.as_tensor(assignments).shape[0]
    return MixtureState(counts=counts,
                        alive=_recompute_alive(counts, spec.empties),
                        sample_size=state.sample_size - n,
                        groups=groups)


def add_tile(spec, cl_model, shareds, state, values, assignments):
    """Add a whole tile of rows by segment-summed merge."""
    C = spec.capacity
    counts = state.counts + _clustering.count_assignments(assignments, C)
    groups = tuple(
        block.module.merge(shared, group, block.module.from_values_grouped(
            shared, torch.as_tensor(v), assignments, C))
        for block, shared, group, v in zip(
            spec.blocks, shareds, state.groups, values))
    n = torch.as_tensor(assignments).shape[0]
    return MixtureState(counts=counts,
                        alive=_recompute_alive(counts, spec.empties),
                        sample_size=state.sample_size + n,
                        groups=groups)


# -- precomputed row-stat fast path -----------------------------------------

def supports_row_stats(spec):
    return all(hasattr(b.module, 'row_stat_columns') for b in spec.blocks)


def precompute_row_stats(spec, shareds, values):
    """Per-block [R, cols, S] statistic columns."""
    return tuple(
        block.module.row_stat_columns(shared, torch.as_tensor(v))
        for block, shared, v in zip(spec.blocks, shareds, values))


def tile_sums_fast(spec, shareds, row_stats, assignments):
    """(counts_delta[C], per-block RAW sums [C, cols, S]).  The raw-sum
    form is additive and cacheable: a tile's add-side sums in sweep t are
    exactly its remove-side sums in sweep t+1, so they must be exact f32
    (no TF32).  All blocks' stat columns plus a ones column ride one
    one-hot contraction (base.segment_sum, row-chunked above
    base.ONEHOT_CHUNK_LIMIT)."""
    C = spec.capacity
    B = assignments.shape[0]
    dev = assignments.device
    flats = [torch.ones((B, 1), dtype=torch.float32, device=dev)]
    widths = []
    for rs in row_stats:
        f = rs.reshape(B, -1)
        flats.append(f)
        widths.append(f.shape[1])
    acc = base.segment_sum(torch.cat(flats, dim=1), assignments, C)
    counts_delta = torch.round(acc[:, 0]).to(torch.int32)
    sums = []
    off = 1
    for rs, w in zip(row_stats, widths):
        sums.append(acc[:, off:off + w].reshape((C,) + tuple(rs.shape[1:])))
        off += w
    return counts_delta, tuple(sums)


def sums_to_tiles(spec, shareds, raw_sums):
    return tuple(
        block.module.row_stats_to_tile(shared, s)
        for block, shared, s in zip(spec.blocks, shareds, raw_sums))


def tile_deltas_fast(spec, shareds, row_stats, assignments):
    """(counts_delta[C], per-block additive stats [C, cols])."""
    counts_delta, sums = tile_sums_fast(spec, shareds, row_stats,
                                        assignments)
    return counts_delta, sums_to_tiles(spec, shareds, sums)


def apply_stat_tiles(spec, shareds, state, counts_delta, tiles, sign, nrows):
    """Apply additive stat tiles (of `tile_deltas_fast` or `tile_deltas`,
    possibly summed over row shards): sign=+1 merges, sign=-1 unmerges
    and re-zeroes the slots that emptied (cancels float drift).  The JAX
    package's `apply_tile_deltas` is this update."""
    counts = state.counts + sign * counts_delta
    groups = []
    for block, shared, group, tile in zip(
            spec.blocks, shareds, state.groups, tiles):
        to_group = getattr(block.module, 'tile_to_group', None)
        tile_group = tile if to_group is None else to_group(shared, tile)
        if sign > 0:
            merged = block.module.merge(shared, group, tile_group)
        else:
            merged = _zero_emptied(
                block.module.unmerge(shared, group, tile_group), counts)
        groups.append(merged)
    return MixtureState(counts=counts,
                        alive=_recompute_alive(counts, spec.empties),
                        sample_size=state.sample_size + sign * nrows,
                        groups=tuple(groups))


def _block_tile_stats(block, shared, values, assignments, C):
    """Additive tile statistics [C, cols] of one block: the model's
    `tile_stats` where it has one (nich, gp: raw moments), else its
    `from_values_grouped` (a Group that is already additive)."""
    fn = getattr(block.module, 'tile_stats', block.module.from_values_grouped)
    per_col = [fn(shared, values[:, j], assignments, C)
               for j in range(block.cols)]
    return _map_group(lambda *leaves: torch.stack(leaves, dim=1), *per_col)


def tile_deltas(spec, shareds, values, assignments):
    """(counts_delta [C], per-block additive tile stats [C, cols]) of a
    tile of rows, from the values themselves (the slow branch; the fast
    one, `tile_deltas_fast`, sums precomputed row-stat columns).  Every
    leaf is additive, so the deltas of row shards sum to the tile's."""
    C = spec.capacity
    counts_delta = _clustering.count_assignments(assignments, C)
    tiles = tuple(
        _block_tile_stats(block, shared, torch.as_tensor(v), assignments, C)
        for block, shared, v in zip(spec.blocks, shareds, values))
    return counts_delta, tiles


def state_from_assignments(spec, cl_model, shareds, values, assignments):
    """A full mixture state from data and an assignment vector in one
    segment-sum pass."""
    return add_tile(spec, cl_model, shareds, init(spec, shareds), values,
                    assignments)


def grow_capacity(spec, state, new_capacity):
    """Pad every [C]-leading leaf to `new_capacity` slots.
    Returns (new_spec, new_state)."""
    C_new = int(new_capacity)
    if C_new < spec.capacity:
        raise ValueError('cannot shrink capacity %d -> %d'
                         % (spec.capacity, C_new))
    new_spec = spec._replace(capacity=C_new)
    pad = C_new - spec.capacity

    def pad_leaf(a):
        return torch.cat(
            [a, torch.zeros((pad,) + tuple(a.shape[1:]), dtype=a.dtype,
                            device=a.device)], dim=0)

    counts = pad_leaf(state.counts)
    groups = tuple(_map_group(pad_leaf, g) for g in state.groups)
    return new_spec, MixtureState(
        counts=counts,
        alive=_recompute_alive(counts, new_spec.empties),
        sample_size=state.sample_size,
        groups=groups)


def needs_growth(spec, state, headroom=0.125, counts=None):
    """True when fewer than `headroom * capacity` slots remain free.
    counts: optional host copy of state.counts."""
    if counts is None:
        counts = state.counts.cpu().numpy()
    nonempty = int((np.asarray(counts) > 0).sum())
    free = spec.capacity - nonempty
    return free < max(1, int(headroom * spec.capacity))
