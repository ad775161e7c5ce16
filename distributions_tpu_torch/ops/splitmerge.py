"""Split-merge Metropolis-Hastings moves for mixture states
(distributions_tpu.ops.splitmerge).

Per-row Gibbs mixes slowly between well separated modes; split-merge
moves (Jain & Neal 2004) jump whole clusters at once:

- `split_merge_move` (simple random split): merge an ordered pair of
  occupied slots [q = 1/(m(m-1)), m occupied], or split one occupied slot
  by fair coins, the heads moving to the first alive empty slot
  [q = (1/2)^n / m]; an all-heads or all-tails pattern is refused.
- `split_merge_restricted`: proposals that follow the data, built by
  allocating the rows of the two clusters one by one between two anchors.

Acceptance uses the exact collapsed posterior (`mixture.score_data`:
clustering EPPF plus feature marginals) with the reverse-proposal
densities, so a chain that mixes them with Gibbs sweeps keeps the true
posterior.  Each move rebuilds one state from the proposed assignments:
O(R + C) work a move, and host decisions (the slots picked, validity, the
acceptance) read a few scalars.
"""

import torch

from distributions_tpu_torch import clustering as _cl, mixture as mx
from distributions_tpu_torch.random import (device_generator, draw_seed,
                                            sample_pair_from_urn)

_LOG_HALF = -0.6931471805599453


def _host_uniforms(generator, n):
    return torch.rand(n, generator=generator, device=generator.device,
                      dtype=torch.float64).cpu().tolist()


def _row_score(spec, shareds, groups, row):
    """The feature log score of one row against per-block groups of
    leaves [..., cols(, ...)] -> [...]: each model's `score_value`
    summed over the block's columns and over the blocks."""
    total = None
    for block, shared, group, v in zip(spec.blocks, shareds, groups, row):
        s = block.module.score_value(shared, group, v).sum(-1)
        total = s if total is None else total + s
    return total


def _accept(generator, dev, log_accept):
    """MH acceptance as a host bool: log(u) < log_accept, u uniform."""
    u = torch.rand((), generator=device_generator(draw_seed(generator), dev),
                   device=dev)
    return bool(torch.log(u) < log_accept)


def split_merge_move(spec, cl_model, shareds, state, values, assignments,
                     generator):
    """One simple random split-merge MH move.  Returns (state,
    assignments, accepted), `accepted` a Python bool; a refused move
    returns the inputs."""
    values = tuple(torch.as_tensor(v) for v in values)
    dev = assignments.device
    counts = state.counts.cpu()
    alive = state.alive.cpu()
    occupied = torch.nonzero(counts > 0).flatten().tolist()
    m = len(occupied)
    u_type, u_i, u_j = _host_uniforms(generator, 3)
    f32 = torch.float32
    m_t = torch.tensor(float(m), dtype=f32, device=dev)
    if u_type < 0.5:
        # split: slot i's heads go to the first alive empty slot
        empties = torch.nonzero(alive & (counts == 0)).flatten().tolist()
        if not (m and empties):
            return state, assignments, False
        i = occupied[int(u_i * m)]
        in_i = assignments == i
        coins = torch.rand(assignments.shape[0], generator=device_generator(
            draw_seed(generator), dev), device=dev) < 0.5
        heads = int((in_i & coins).sum())
        if heads == 0 or heads == int(counts[i]):
            return state, assignments, False
        proposal = torch.where(in_i & coins,
                               torch.full_like(assignments, empties[0]),
                               assignments)
        n = torch.tensor(float(counts[i]), dtype=f32, device=dev)
        log_corr = -n * _LOG_HALF - torch.log(m_t + 1.0)
    else:
        # merge: slot j's rows go to slot i
        if m < 2:
            return state, assignments, False
        i = occupied[int(u_i * m)]
        rest = [k for k in occupied if k != i]
        j = rest[int(u_j * (m - 1))]
        proposal = torch.where(assignments == j,
                               torch.full_like(assignments, i), assignments)
        n = torch.tensor(float(counts[i] + counts[j]), dtype=f32,
                         device=dev)
        log_corr = n * _LOG_HALF + torch.log(torch.clamp(m_t, min=1.0))
    score_cur = mx.score_data(spec, cl_model, shareds, state)
    prop_state = mx.state_from_assignments(spec, cl_model, shareds, values,
                                           proposal)
    score_prop = mx.score_data(spec, cl_model, shareds, prop_state)
    if _accept(generator, dev, score_prop - score_cur + log_corr):
        return prop_state, proposal, True
    return state, assignments, False


def _side_groups(spec, shareds, row_a, row_b):
    """Per block [4, cols] groups: the anchors a, b, a, b alone (sides 1
    and 2 of the free allocation, then of the forced one)."""
    out = []
    for block, shared, va, vb in zip(spec.blocks, shareds, row_a, row_b):
        g = block.module.group_init(shared, (4, block.cols))
        out.append(block.module.add_value(
            shared, g, torch.stack([va, vb, va, vb])))
    return tuple(out)


def _allocate(spec, cl_model, shareds, rows, anchors, u, forced):
    """The sequential two-way allocation of the in-play rows, once freely
    (row i to side 1 when u_i < p1) and once forced to `forced` [n_play]
    bool, both from the anchors alone, in one pass: four side groups,
    sides 1 and 2 of each allocation.  The seating ratio of a side with
    n rows is n - d (Pitman-Yor).  Returns (free sides [n_play] bool,
    log q of the free allocation, log q of the forced one)."""
    groups = _side_groups(spec, shareds, *anchors)
    dev = u.device
    n = torch.ones(4, dtype=torch.float32, device=dev)
    n_play = u.shape[0]
    sides = torch.zeros(n_play, dtype=torch.bool, device=dev)
    log_q = torch.zeros(2, dtype=torch.float32, device=dev)
    for i in range(n_play):
        row = tuple(v[i] for v in rows)
        s = torch.log(n - cl_model.d) + _row_score(spec, shareds, groups,
                                                   row)
        diff = s[0::2] - s[1::2]                       # [free, forced]
        choose1 = torch.stack([u[i] < torch.sigmoid(diff[0]), forced[i]])
        log_q = log_q + torch.where(
            choose1, torch.nn.functional.logsigmoid(diff),
            torch.nn.functional.logsigmoid(-diff))
        mask = torch.stack([choose1, ~choose1], 1).reshape(4)
        groups = tuple(
            mx._map_group(
                lambda new, old: torch.where(
                    mask.reshape((4,) + (1,) * (old.dim() - 1)), new, old),
                block.module.add_value(shared, g, v), g)
            for block, shared, g, v in zip(spec.blocks, shareds, groups,
                                           row))
        n = n + mask.to(torch.float32)
        sides[i] = choose1[0]
    return sides, log_q[0], log_q[1]


def split_merge_restricted(spec, cl_model, shareds, state, values,
                           assignments, generator):
    """Split-merge move with data-driven proposals (Pitman-Yor prior).

    1. Pick two distinct rows (a, b) uniformly.  Same slot: propose to
       split it between its slot and the first alive empty slot;
       different slots: propose to merge b's cluster into a's.
    2. The rows in play are the two clusters' other rows.  They are
       allocated one by one, in index order, between side 1 (anchored by
       a) and side 2 (anchored by b), each by its two-way conditional
       given the anchors and the rows allocated before it.  A split is
       that allocation drawn freely, with q_fwd the product of its
       conditionals; a merge's reverse probability q_rev is the product
       of the conditionals of the allocation forced to the current two
       clusters.
    3. Accept with min(1, exp(dscore) q_rev / q_fwd); the pair choice is
       symmetric and cancels.

    The JAX function walks all R rows with a mask and draws one uniform a
    row; rows not in play change nothing there, so the port walks the
    in-play rows only, taking their uniforms from one [R] draw: the same
    law.  Its intermediate restricted scans (`n_intermediate`) restart
    from the anchors and leave no trace in the final allocation, so the
    port runs none and takes no such argument.

    Returns (state, assignments, accepted), `accepted` a Python bool."""
    if not isinstance(cl_model, _cl.PitmanYor):
        raise ValueError('split_merge_restricted seats the sides with the '
                         'Pitman-Yor ratio n - d; got %s'
                         % type(cl_model).__name__)
    values = tuple(torch.as_tensor(v) for v in values)
    dev = assignments.device
    R = assignments.shape[0]
    a, b = sample_pair_from_urn(generator, R)
    assign_h = assignments.cpu()
    slot_a, slot_b = int(assign_h[a]), int(assign_h[b])
    is_split = slot_a == slot_b
    empties = torch.nonzero(state.alive.cpu() & (state.counts.cpu() == 0)
                            ).flatten().tolist()
    if is_split and not empties:
        return state, assignments, False
    slot2 = empties[0] if is_split else slot_b
    idx = torch.arange(R, device=dev)
    in_play = (((assignments == slot_a) | (assignments == slot2))
               & (idx != a) & (idx != b))
    play = torch.nonzero(in_play).flatten()
    u = torch.rand(R, generator=device_generator(draw_seed(generator), dev),
                   device=dev)[play]
    sides, log_q_split, log_q_rev = _allocate(
        spec, cl_model, shareds, tuple(v[play] for v in values),
        (tuple(v[a] for v in values), tuple(v[b] for v in values)), u,
        assignments[play] == slot_a)
    if is_split:
        proposal = assignments.clone()
        proposal[play] = torch.where(
            sides, torch.full_like(play, slot_a),
            torch.full_like(play, slot2)).to(assignments.dtype)
        proposal[b] = slot2
        log_q_corr = -log_q_split
    else:
        proposal = torch.where(assignments == slot2,
                               torch.full_like(assignments, slot_a),
                               assignments)
        log_q_corr = log_q_rev
    score_cur = mx.score_data(spec, cl_model, shareds, state)
    prop_state = mx.state_from_assignments(spec, cl_model, shareds, values,
                                           proposal)
    score_prop = mx.score_data(spec, cl_model, shareds, prop_state)
    if _accept(generator, dev, score_prop - score_cur + log_q_corr):
        return prop_state, proposal, True
    return state, assignments, False
