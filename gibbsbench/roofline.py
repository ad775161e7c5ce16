"""The frozen yardstick of the rooflines and of sweep_mfu: operations and
bytes that depend only on a configuration's shapes (rows, slots, and its
nich, niw and table columns), against the published peaks of one NVIDIA
H100 SXM (data sheet, dense rates): 67 TFLOP/s in float32 outside the
tensor cores and 3.35 TB/s of HBM.  Those peaks assume the full power
limit of 700 W; the run prints the card's limit beside them.

A cell is one row scored against one slot.  The operations a cell needs,
whatever kernel computes it:
- the prior's slot score: 1 add;
- a nich column (student-t predictive): x - mu, square, times the
  precision, log1p, times the log coefficient, add: 5 + 1 log;
- a niw column of dimension d (tri = d (d + 1) / 2 entries of the packed
  precision): d subtractions, 2 tri multiplies, tri - 1 adds for the
  quadratic form, log1p, times the coefficient, add: d + 3 tri + 2;
- a table column (bb): 1 gather-add;
- the Gumbel-max draw: the uniform's scaling, two logs, a negation, the
  add, the compare: 5 + 2 logs.
A log counts as one operation; the random bits count as none.  Per row
(not per cell) the new tile's statistics: a nich column 1 multiply and 3
adds, a niw column tri multiplies and 1 + d + tri adds, a table column 2
adds.

Bytes of one tile's launch: each input read once and each output written
once, in 4-byte words: the rows' values (a table column one index a
row), the per-slot inputs (the prior's score; per nich column 4
coefficients; per niw column d + tri + 2; per table column its 2
scores), the drawn slots and the per-slot statistics (the count; per
nich column 2; per niw column d + tri; per table column 2).

Only a benchmark change may change these counts."""

PEAK_F32_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12
WORD = 4
PRIOR_OPS = 1
DRAW_OPS = 7


def _niw_dim(block):
    return len(block['shared']['mu'])


def column_ops(block):
    """Operations per cell of one column of `block`."""
    if block['model'] == 'nich':
        return 6
    if block['model'] == 'niw':
        d = _niw_dim(block)
        return d + 3 * (d * (d + 1) // 2) + 2
    return 1


def cell_ops(cfg):
    return PRIOR_OPS + DRAW_OPS + sum(b['cols'] * column_ops(b)
                                      for b in cfg['blocks'])


def row_ops(cfg):
    total = 0
    for b in cfg['blocks']:
        if b['model'] == 'nich':
            per = 4
        elif b['model'] == 'niw':
            d = _niw_dim(b)
            tri = d * (d + 1) // 2
            per = tri + 1 + d + tri
        else:
            per = 2
        total += b['cols'] * per
    return total


def _words(cfg):
    """(words a row reads, words a slot's inputs, words a slot's stats)."""
    row, slot_in, slot_out = 0, 1, 1
    for b in cfg['blocks']:
        c = b['cols']
        if b['model'] == 'nich':
            row, slot_in, slot_out = row + c, slot_in + 4 * c, slot_out + 2 * c
        elif b['model'] == 'niw':
            d = _niw_dim(b)
            tri = d * (d + 1) // 2
            row += c * d
            slot_in += c * (d + tri + 2)
            slot_out += c * (d + tri)
        else:
            row, slot_in, slot_out = row + c, slot_in + 2 * c, slot_out + 2 * c
    return row, slot_in, slot_out


def launch_ops(cfg, B, C):
    return float(B) * C * cell_ops(cfg) + float(B) * row_ops(cfg)


def launch_bytes(cfg, B, C):
    row, slot_in, slot_out = _words(cfg)
    # + 1 word a row: its drawn slot
    return WORD * (B * (row + 1) + C * (slot_in + slot_out))


def launch_bound_s(cfg, B, C):
    """(seconds, 'operations' | 'bytes'): the least time one tile's launch
    could take."""
    by_ops = launch_ops(cfg, B, C) / PEAK_F32_PER_S
    by_bytes = launch_bytes(cfg, B, C) / PEAK_BYTES_PER_S
    return (by_ops, 'operations') if by_ops >= by_bytes else (by_bytes,
                                                              'bytes')


def sweep_ops(cfg, C):
    """f32 operations of one sweep over all the configuration's rows."""
    return launch_ops(cfg, cfg['rows'], C)


def kernel_share(run):
    """Percent of the least time of one tile's launch over its profiled
    device time (the score + draw kernel and its stat stage), or None."""
    p = run.profile
    if p is None or run.device_type != 'cuda' or not p['split_launches']:
        return None
    launch_s = (p['split_ms'] + p['stat_ms']) / 1e3 / p['split_launches']
    bound_s, _ = launch_bound_s(run.config, run.config['tile_rows'],
                                run.slots)
    return 100.0 * bound_s / launch_s
