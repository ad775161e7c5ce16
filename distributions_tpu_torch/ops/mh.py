"""Metropolis-Hastings mixture sweeps with O(1) cost a row
(distributions_tpu.ops.mh).

Per tile, every row takes `mh_steps` Metropolis-Hastings steps against the
tile-frozen state:

    proposal   q(k) ~ counts(k) + beta over the alive slots, the same for
               every row of the tile (an inverse CDF: one uniform and a
               `searchsorted` on the cumulative q)
    acceptance min(1, p(row, k') q(k) / (p(row, k) q(k'))), with the
               posterior scores at just the two slots involved, gathered

so a row costs two gathered predictive scores a step instead of C.  The
chain targets the same tile-frozen conditional as `gibbs.sweep_blocked`.

Where the JAX package vmaps over the rows and scans the steps, the port
loops over the `mh_steps` steps in Python with whole [block] vectors: a
step is a few launches for all the rows of a tile.
"""

import torch

from distributions_tpu_torch import clustering as _cl, mixture as mx
from distributions_tpu_torch.ops.gibbs import _n_tiles
from distributions_tpu_torch.random import device_generator, draw_seed


def _gather_block_score(block, shared, group, values, k):
    """Each row's values [B, cols(, d)] scored against its own slot k [B]
    -> [B]: the [C, cols] groups gathered at k, then the model's
    `score_value` summed over the columns."""
    sub = mx._map_group(lambda a: a[k], group)              # [B, cols, ...]
    return block.module.score_value(shared, sub, values).sum(-1)


def _row_slot_score(spec, cl_model, shareds, state, cl_scores, rows, k):
    """The full log score of each row of `rows` (per block [B, cols(, d)])
    at its slot k [B] -> [B]: the clustering score plus every block's
    predictive score."""
    total = cl_scores[k]
    for block, shared, group, v in zip(spec.blocks, shareds, state.groups,
                                       rows):
        total = total + _gather_block_score(block, shared, group, v, k)
    return total


def sweep_mh(spec, cl_model, shareds, state, values, assignments, block,
             mh_steps=4, generator=None, proposal_beta=1.0):
    """One MH pass: per tile of `block` rows, `mh_steps` stale-proposal MH
    steps for every row, then the tile's stats are added back by the usual
    one-hot contraction.  Randomness: one seed a sweep from `generator`,
    and each step draws [block] proposal uniforms and [block] acceptance
    uniforms.  Returns (state, assignments)."""
    n_blocks = _n_tiles(assignments, block)
    values = tuple(torch.as_tensor(v) for v in values)
    dev = assignments.device
    gen = device_generator(draw_seed(generator), dev)
    row_stats = mx.precompute_row_stats(spec, shareds, values)
    C = spec.capacity
    out = []
    for t in range(n_blocks):
        sl = slice(t * block, (t + 1) * block)
        tile_stats = tuple(rs[sl] for rs in row_stats)
        rows = tuple(v[sl] for v in values)
        cd, tiles = mx.tile_deltas_fast(spec, shareds, tile_stats,
                                        assignments[sl])
        state = mx.apply_stat_tiles(spec, shareds, state, cd, tiles, -1,
                                    block)
        cl_scores = _cl.score_value(cl_model, state.counts, state.alive,
                                    state.sample_size)
        # the stale proposal: alive-masked counts + beta
        q = torch.where(state.alive,
                        state.counts.to(torch.float32) + proposal_beta,
                        torch.zeros((), device=dev))
        cum_q = torch.cumsum(q, 0)
        total_q = cum_q[-1]
        log_q = torch.log(torch.clamp(q, min=1e-30)) - torch.log(total_q)

        k = assignments[sl].to(torch.int64)
        score_k = _row_slot_score(spec, cl_model, shareds, state, cl_scores,
                                  rows, k)
        for _ in range(mh_steps):
            u = torch.rand(block, generator=gen, device=dev) * total_q
            k_prop = torch.clamp(torch.searchsorted(cum_q, u), 0, C - 1)
            score_prop = _row_slot_score(spec, cl_model, shareds, state,
                                         cl_scores, rows, k_prop)
            log_accept = score_prop - score_k + log_q[k] - log_q[k_prop]
            accept = torch.log(torch.rand(block, generator=gen,
                                          device=dev)) < log_accept
            k = torch.where(accept, k_prop, k)
            score_k = torch.where(accept, score_prop, score_k)
        new_assign = k.to(torch.int32)

        cd, tiles = mx.tile_deltas_fast(spec, shareds, tile_stats,
                                        new_assign)
        state = mx.apply_stat_tiles(spec, shareds, state, cd, tiles, +1,
                                    block)
        out.append(new_assign)
    return state, torch.cat(out)
