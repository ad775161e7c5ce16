"""Production-runner wall-clock benchmark (benchmarks/bench_runner.py of
the JAX package): `inference.runner.run_gibbs` itself, with its init,
per-step sync, validation, sweep statistics and logging, at the flagship
shape.

RUNNER_MODEL=nich (default): 1,048,576 rows x 1024 slots x 2 nich features.
RUNNER_MODEL=niw2mix: niw d=2 + nich + bb (the mixed problem of the JAX
package's profile_mixed.py), tiles of 65,536 rows.  Both start from the
generating labels with grow_headroom=0, so that capacity growth never fires
mid-run, and with RUNNER_CLUSTERS = 3C/4 true clusters: the chain opens
about a hundred new groups in 20 sweeps, and from the JAX script's 7C/8 it
fills all 1024 slots within 30, where the port's runner refuses to go on
(the time of a sweep does not depend on how many slots are occupied: the
kernels score every slot).  After one warm-up run, RUNNER_REPEATS runs of
RUNNER_PASSES sweeps are timed inside one process and the median is
reported; two versions are compared only inside one run of one machine.

    python -m distributions_tpu_torch.benchmarks.bench_runner

Prints one JSON line {"metric": "runner_gibbs_cells_per_sec", "value",
"unit", "ms_per_sweep", "sweeps_per_step", ...}, after a line
'# graphs: ...': on the card each sweep is replayed from a CUDA graph
(ops/gibbs.py), which each run captures in its first step and frees at
its end, as a user's run does (the capture is part of its time); that
line gives the graphs captured and the seconds the captures took.
Sizes: RUNNER_ROWS, RUNNER_COMPONENTS, RUNNER_CLUSTERS, RUNNER_BLOCK,
RUNNER_FEATURES, RUNNER_SPS (10), RUNNER_PASSES (3 x RUNNER_SPS),
RUNNER_REPEATS (3), RUNNER_SAMPLING.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from distributions_tpu_torch import clustering, config, mixture as mx, testing
from distributions_tpu_torch.benchmarks.timing import (
    device_name, graphs_line, int_env)
from distributions_tpu_torch.inference import runner
from distributions_tpu_torch.models import MODULES, nich
from distributions_tpu_torch.ops import gibbs


def run(device=None):
    device = config.resolve_device(device)
    R = int_env('RUNNER_ROWS', 1048576)
    C = int_env('RUNNER_COMPONENTS', 1024)
    FEATURES = int_env('RUNNER_FEATURES', 2)
    SPS = int_env('RUNNER_SPS', 10)
    PASSES = int_env('RUNNER_PASSES', 3 * SPS)
    REPEATS = int_env('RUNNER_REPEATS', 3)
    model = os.environ.get('RUNNER_MODEL', 'nich')
    n_true = int_env('RUNNER_CLUSTERS', max(C // 4 * 3, 1))

    if model == 'niw2mix':
        BLOCK = int_env('RUNNER_BLOCK', 65536)
        problem = testing.mixed_problem(R, C, seed=0, kind='niw2mix',
                                        n_clusters=n_true)
        spec, cl, shareds = testing.build_problem(
            problem, MODULES, mx.make_spec, clustering.PitmanYor.from_dict,
            device=device)
        values, labels = problem['values'], problem['labels']
        FEATURES = len(spec.blocks)
    elif model == 'nich':
        BLOCK = int_env('RUNNER_BLOCK', 131072)
        rng = np.random.RandomState(0)
        spec = mx.make_spec([(nich, FEATURES)], capacity=C, empties=1)
        cl = clustering.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.1},
                                            device=device)
        shareds = (nich.shared_from_dict(
            {'mu': 0., 'kappa': 0.1, 'sigmasq': 0.01, 'nu': 1.},
            device=device),)
        labels = rng.randint(0, n_true, R).astype(np.int32)
        centers = rng.randn(n_true, FEATURES).astype(np.float32)
        values = ((centers[labels] + 0.1 * rng.randn(R, FEATURES).astype(
            np.float32)).astype(np.float32),)
    else:
        raise ValueError("RUNNER_MODEL must be 'nich' or 'niw2mix', got %r"
                         % (model,))
    values = tuple(torch.from_numpy(np.asarray(v)).to(device)
                   for v in values)
    common = dict(block=BLOCK, initial_assignments=labels, use_pallas=True,
                  sampling=os.environ.get('RUNNER_SAMPLING', 'gumbel'),
                  grow_headroom=0.0, sweeps_per_step=SPS, device=device)

    def one(seed, passes):
        t0 = time.perf_counter()
        state, an, log = runner.run_gibbs(
            spec, cl, shareds, values, torch.Generator().manual_seed(seed),
            passes, **common)
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0, state, log

    graphs = gibbs.reset_graph_stats()
    one(1, SPS)                                             # warm-up
    runs = [one(seed, PASSES) for seed in range(REPEATS)]
    seconds, state, log = sorted(runs, key=lambda r: r[0])[len(runs) // 2]
    per_sweep = seconds / PASSES
    cells = float(R) * C * FEATURES
    return {'metric': 'runner_gibbs_cells_per_sec',
            'value': cells / per_sweep, 'unit': 'cells/s',
            'ms_per_sweep': 1e3 * per_sweep,
            'ms_per_sweep_of_each_run': [1e3 * r[0] / PASSES for r in runs],
            'sweeps_per_step': SPS, 'passes': PASSES, 'model': model,
            'rows': R, 'components': C, 'true_clusters': n_true,
            'block': BLOCK,
            'step_seconds': [r['seconds'] for r in log.rows],
            'final_capacity': int(state.counts.shape[0]),
            'nonempty_groups': log.rows[-1]['nonempty_groups'],
            'graphs': dict(graphs), 'device': device_name(device)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--device', default=None,
                    help="default: the package's default device, the card")
    out = run(ap.parse_args(argv).device)
    print(graphs_line(out['graphs']))
    print(json.dumps(out))
    print('# model=%s R=%d C=%d block=%d passes=%d final capacity %d '
          'device=%s' % (out['model'], out['rows'], out['components'],
                         out['block'], out['passes'], out['final_capacity'],
                         out['device']), file=sys.stderr)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
