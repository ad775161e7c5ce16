"""K1's time split into phases (profile_kernel_phases.py of the JAX
package): scaffolding, scoring, generator, draw and stat sums.

Each phase of B5 (`bench_kernels.fused_phase`) runs a cumulative part of
K1 over the same row stream in tiles of BLOCK rows, as the main path
launches K1, with frozen [C]-sized inputs; the differences of their steady
times are the phases' costs:

  noop          load the values, write one int per row    -> scaffolding
  score_max     + product-form scoring, the row maximum   -> + scoring
  score_bits    + Philox, no logs                         -> + generator
  score_gumbel  + the gumbel draw (two logs a cell)       -> + draw
  score_cdf     the inverse-CDF draw in its place
  full_gumbel   + the stat sums: K1 itself (full_cdf likewise)

The JAX script's transposed-layout (`t*`) and 16-bit (`bits16`) variants
are layouts and generator modes of the TPU kernel only and have no
counterpart.  A phase that fails ends the run.

    python -m distributions_tpu_torch.benchmarks.kernel_phases

Sizes: ROWS (1048576), CAP (1024), BLOCK (131072), COLS (1), REPS (10),
MODES (comma-separated phases).
"""

import argparse
import json
import os

import numpy as np
import torch

from distributions_tpu_torch import clustering, config, mixture as mx
from distributions_tpu_torch.benchmarks.timing import (device_name, int_env,
                                                       median_ms)
from distributions_tpu_torch.models import nich
from distributions_tpu_torch.ops import bench_kernels as bk
from distributions_tpu_torch.ops import fused_kernels as fk

MODES = ('noop', 'score_max', 'score_bits', 'score_cdf', 'score_gumbel',
         'full_cdf', 'full_gumbel')
# (label, phase, the phase before it)
SPLIT = (('scaffolding (load + write)', 'noop', None),
         ('scoring', 'score_max', 'noop'),
         ('generator (Philox)', 'score_bits', 'score_max'),
         ('gumbel draw (two logs a cell)', 'score_gumbel', 'score_bits'),
         ('gumbel sampling in all', 'score_gumbel', 'score_max'),
         ('cdf sampling in all', 'score_cdf', 'score_max'),
         ('stat sums (gumbel)', 'full_gumbel', 'score_gumbel'),
         ('stat sums (cdf)', 'full_cdf', 'score_cdf'))


def problem(rows, cap, cols, device):
    """The JAX script's problem: cap - 8 true clusters, 0.1 noise, seed 0,
    and K1's frozen inputs (values, cl_scores, coeffs) for its state."""
    rng = np.random.RandomState(0)
    spec = mx.make_spec([(nich, cols)], capacity=cap, empties=1)
    cl = clustering.PitmanYor.from_dict({'alpha': 100.0, 'd': 0.1},
                                        device=device)
    shareds = (nich.shared_from_dict(
        {'mu': 0., 'kappa': 0.1, 'sigmasq': 0.01, 'nu': 1.}, device=device),)
    n_true = max(cap - 8, 1)
    centers = rng.randn(n_true, cols).astype(np.float32)
    labels = rng.randint(0, n_true, rows)
    X = centers[labels] + 0.1 * rng.randn(rows, cols).astype(np.float32)
    values = torch.from_numpy(X.astype(np.float32)).to(device)
    state = mx.state_from_assignments(
        spec, cl, shareds, (values,),
        torch.from_numpy(labels.astype(np.int32)).to(device))
    cl_scores = clustering.score_value(cl, state.counts, state.alive,
                                       state.sample_size)
    coeffs = fk.nich_coeffs_v2(shareds[0], state.groups[0]).contiguous()
    return values, cl_scores, coeffs


def run(device=None, rows=None, cap=None, block=None, cols=None, reps=None,
        modes=None):
    """Time every phase in `modes`.  Returns {'ms': {phase: ms per pass
    over all rows}, 'split': {label: ms}, 'tiles', and the sizes}."""
    device = config.resolve_device(device)
    rows = int_env('ROWS', 1048576) if rows is None else rows
    cap = int_env('CAP', 1024) if cap is None else cap
    block = int_env('BLOCK', 131072) if block is None else block
    cols = int_env('COLS', 1) if cols is None else cols
    reps = int_env('REPS', 10) if reps is None else reps
    if modes is None:
        modes = tuple(os.environ.get('MODES', ','.join(MODES)).split(','))
    if rows % block:
        raise ValueError('ROWS (%d) must be a multiple of BLOCK (%d)'
                         % (rows, block))
    values, cl_scores, coeffs = problem(rows, cap, cols, device)
    tiles = [values[t * block:(t + 1) * block] for t in range(rows // block)]
    seeds = iter(range(1, 1 << 30))

    def one_pass(mode):
        for tile in tiles:
            bk.fused_phase(mode, next(seeds), tile, cl_scores, coeffs,
                           (cols,))
    ms = {mode: median_ms(lambda: one_pass(mode), reps, device)
          for mode in modes}
    split = {label: ms[a] - (ms[b] if b else 0.0)
             for label, a, b in SPLIT
             if a in ms and (b is None or b in ms)}
    return {'device': device_name(device), 'rows': rows, 'cap': cap,
            'block': block, 'cols': cols, 'reps': reps, 'tiles': len(tiles),
            'ms': ms, 'split': split}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--device', default=None,
                    help="default: the package's default device, the card")
    args = ap.parse_args(argv)
    out = run(args.device)
    print('R=%d C=%d BLOCK=%d COLS=%d on %s'
          % (out['rows'], out['cap'], out['block'], out['cols'],
             out['device']))
    for mode, ms in out['ms'].items():
        print('%-14s %8.3f ms/sweep-equivalent' % (mode, ms))
    print()
    for label, ms in out['split'].items():
        print('%-32s %8.3f ms' % (label + ':', ms))
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
