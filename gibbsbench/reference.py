"""The plain reference that decides `correct`: a mixture's statistics, its
joint score and the conditional law of a tile's draws, worked out again
from the rows and the assignments in plain PyTorch, float64 unless asked
otherwise.  It imports nothing of the program; the feature models are the
modules of `gibbsbench/models/`, found by the configuration's model names.

What is compared (each number against the configuration's limit):
- counts_gap: the largest difference of a slot's row count (or of any
  whole-number statistic, such as bb's heads) from the reference's, plus
  the rows assigned outside the slots.  Exact: limit 0.
- stats_gap: the largest difference of a float statistic in additive form
  (sums, sums of squares) from the reference's, over the largest
  magnitude of that statistic; absent where a configuration has none.
- score_gap: the joint score the program logged for its last step
  against the reference's joint score of the final assignments, relative.
- draw_z: the draws of the last tile of the last sweep.  The program draws
  each row of a tile against the state without that tile; after the last
  tile of the last sweep that state is every other row under its final
  assignment, so the reference rebuilds it exactly and each drawn slot is
  an independent draw from the row's conditional law there.  With lp the
  log probabilities of a row's choices (each occupied slot, and a new
  group for any slot empty there), T = sum over a sample of rows of
  lp(drawn) - E[lp] has mean 0 and variance sum Var[lp]: draw_z =
  |T| / sqrt(Var).
"""

import importlib

import torch

def model(name):
    """The plain model module gibbsbench/models/<name>.py."""
    return importlib.import_module('gibbsbench.models.' + name)


def _counts(assign, C, dtype):
    ones = torch.ones(assign.shape[0], dtype=dtype, device=assign.device)
    return torch.zeros(C, dtype=dtype, device=assign.device).index_add_(
        0, assign, ones)


def stats(cfg, values, assign, C, dtype=torch.float64):
    """{'counts' [C], 'blocks': [per block {leaf: tensor}]} of the rows
    `values` (a tensor per block) under `assign` [R] (int64), summed in
    `dtype`."""
    return {'counts': _counts(assign, C, dtype),
            'blocks': [model(b['model']).stats(b, v, assign, C, dtype)
                       for b, v in zip(cfg['blocks'], values)]}


def py_score_counts(prior, counts):
    """Pitman-Yor log probability of a partition from its counts [C]."""
    alpha, d = prior['alpha'], prior['d']
    occupied = counts > 0
    k = torch.arange(counts.shape[0], dtype=counts.dtype,
                     device=counts.device)
    n_occ = occupied.sum()
    zero = torch.zeros((), dtype=counts.dtype, device=counts.device)
    tables = torch.where(k < n_occ, torch.log(alpha + d * k), zero).sum()
    sizes = torch.where(occupied, torch.lgamma(torch.clamp(counts, min=1)
                                               - d)
                        - torch.lgamma(1 - d + zero), zero).sum()
    n = counts.sum()
    return (tables + sizes + torch.lgamma(alpha + zero)
            - torch.lgamma(alpha + n))


def joint_score(cfg, st):
    """Joint log probability of the partition and all rows."""
    counts = st['counts']
    dtype, dev = counts.dtype, counts.device
    total = py_score_counts(cfg['prior'], counts)
    for b, leaves in zip(cfg['blocks'], st['blocks']):
        m = model(b['model'])
        total = total + m.score_data(b, m.shared(b, dtype, dev), counts,
                                     leaves).sum()
    return total


def choice_scores(cfg, st, rows, chunk=2048):
    """Log probabilities [m, K + 1] of m rows' choices against the state
    `st` (which holds none of them), in the dtype of its statistics: the K
    occupied slots (in slot order), then a new group; and the K occupied
    slot ids.  `rows`: per block the rows' values."""
    counts = st['counts']
    dtype, dev = counts.dtype, counts.device
    prior = cfg['prior']
    occ = torch.nonzero(counts > 0).flatten()
    cnt = torch.cat([counts[occ], torch.zeros(1, dtype=dtype, device=dev)])
    n_occ = torch.tensor(float(occ.shape[0]), dtype=dtype, device=dev)
    prior_scores = torch.cat([
        torch.log(counts[occ] - prior['d']),
        torch.log(prior['alpha'] + prior['d'] * n_occ).reshape(1)])
    blocks = []
    for b, leaves in zip(cfg['blocks'], st['blocks']):
        m = model(b['model'])
        sel = {k: torch.cat([v[occ], torch.zeros_like(v[:1])])
               for k, v in leaves.items()}
        blocks.append((b, m, m.shared(b, dtype, dev), sel))
    out = []
    m_rows = rows[0].shape[0]
    for lo in range(0, m_rows, chunk):
        s = prior_scores[None]
        for (b, m, sh, sel), v in zip(blocks, rows):
            s = s + m.predictive(b, sh, cnt, sel, v[lo:lo + chunk])
        out.append(torch.log_softmax(s, dim=1))
    return torch.cat(out), occ


def choice_of(occ, C, drawn):
    """Each drawn slot's column in choice_scores: its place among the
    occupied slots, or K (a new group) for a slot empty there."""
    place = torch.full((C,), occ.shape[0], dtype=torch.int64,
                       device=occ.device)
    place[occ] = torch.arange(occ.shape[0], device=occ.device)
    return place[drawn]


def draw_z(lp, choice):
    """T / sqrt(Var) of the drawn choices under the log probabilities
    lp [m, K + 1] (module docstring); below 0 where the draws are less
    likely than the law's own."""
    p = torch.exp(lp)
    finite = torch.where(p > 0, lp, torch.zeros_like(lp))
    mean = (p * finite).sum(1)
    var = torch.clamp((p * finite * finite).sum(1) - mean * mean, min=0)
    t = (lp.gather(1, choice[:, None])[:, 0] - mean).sum()
    v = var.sum()
    if v <= 0:
        return 0.0 if t == 0 else float('inf') * float(torch.sign(t))
    return float(t / torch.sqrt(v))


def last_tile_sample(R, tile_rows, n, generator, device):
    """Row ids of a sample of n rows of the last tile, drawn from
    `generator`."""
    take = torch.randperm(tile_rows, generator=generator,
                          device=generator.device)[:min(n, tile_rows)]
    return (R - tile_rows + take).to(device)


def compare(cfg, values, out, sample):
    """The compared numbers of the program's outputs `out`: a dict with
    'assignments' [R], 'counts' [C], 'sample_size', 'blocks' (per block
    (float leaves, whole-number leaves) in float64 as the models'
    program_stats give them) and 'score' (the joint score logged last).
    `sample`: the row ids of the last tile that draw_z reads.  Returns
    (the numbers, {'reference_score', 'draw_z_signed'})."""
    assign = out['assignments'].to(torch.int64)
    C = out['counts'].shape[0]
    R = assign.shape[0]
    tile_rows = cfg['tile_rows']
    outside = int(((assign < 0) | (assign >= C)).sum())
    assign = torch.clamp(assign, 0, C - 1)
    ref = stats(cfg, values, assign, C)
    counts_gap = float((out['counts'].to(torch.float64)
                        - ref['counts']).abs().max())
    counts_gap = max(counts_gap, abs(float(out['sample_size']) - R))
    stats_gap = 0.0
    for b, (floats, ints), want in zip(cfg['blocks'], out['blocks'],
                                       ref['blocks']):
        for name, got in ints.items():
            # a per-column copy of the slot counts
            counts_gap = max(counts_gap, float(
                (got.to(torch.float64) - ref['counts'][:, None]).abs().max()))
        for name in model(b['model']).INT_LEAVES:
            counts_gap = max(counts_gap, float(
                (floats[name] - want[name]).abs().max()))
        for name in model(b['model']).FLOAT_LEAVES:
            scale = float(want[name].abs().max())
            gap = float((floats[name] - want[name]).abs().max())
            stats_gap = max(stats_gap, gap / scale if scale > 0 else gap)
    score = float(joint_score(cfg, ref))
    score_gap = abs(float(out['score']) - score) / abs(score)
    keep = R - tile_rows
    removed = stats(cfg, tuple(v[:keep] for v in values), assign[:keep], C)
    lp, occ = choice_scores(cfg, removed, tuple(v[sample] for v in values))
    z = draw_z(lp, choice_of(occ, C, assign[sample]))
    numbers = {'counts_gap': counts_gap + outside, 'stats_gap': stats_gap,
               'score_gap': score_gap, 'draw_z': abs(z)}
    if not any(model(b['model']).FLOAT_LEAVES for b in cfg['blocks']):
        # whole-number statistics alone: counts_gap holds them all
        del numbers['stats_gap']
    return numbers, {'reference_score': score, 'draw_z_signed': z}


def judge(numbers, limits):
    """(correct, [(name, value, limit)]) of compared numbers against their
    limits: every number at most its limit (NaN fails)."""
    rows = [(name, numbers[name], limits[name]) for name in numbers]
    return all(v <= lim for _, v, lim in rows), rows


# -- the control: the reference in the program's place, in bfloat16 ---------

CONTROL_DTYPE = torch.bfloat16


def control_outputs(cfg, values, assign, C, sample, generator,
                    dtype=CONTROL_DTYPE):
    """What the reference computed in `dtype` puts out in the program's
    place, from the same rows and assignments: the sampled rows of the last
    tile drawn from its conditional law in `dtype` (Gumbel-max on the
    same tile-removed state), then the counts, the statistics and the
    joint score of the result, all in `dtype`.  Returns `out` as compare
    takes it."""
    assign = assign.to(torch.int64).clone()
    tile_rows = cfg['tile_rows']
    keep = assign.shape[0] - tile_rows
    low_removed = stats(cfg, tuple(v[:keep] for v in values),
                        assign[:keep], C, dtype)
    lp, occ = choice_scores(cfg, low_removed,
                            tuple(v[sample] for v in values))
    u = torch.rand(lp.shape, generator=generator, device=generator.device,
                   dtype=torch.float32).to(lp.device)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=1e-30)))
    pick = torch.argmax(lp + gumbel.to(dtype), dim=1)
    slots = torch.cat([occ, _first_empty(low_removed['counts'])])
    assign[sample] = slots[pick]
    low = stats(cfg, values, assign, C, dtype)
    blocks = [({k: v.to(torch.float64) for k, v in leaves.items()}, {})
              for leaves in low['blocks']]
    return {'assignments': assign, 'counts': low['counts'],
            'sample_size': float(low['counts'].sum()),
            'blocks': blocks, 'score': float(joint_score(cfg, low))}


def _first_empty(counts):
    empty = torch.nonzero(counts == 0).flatten()
    return empty[:1] if empty.numel() else torch.zeros(
        1, dtype=torch.int64, device=counts.device)
