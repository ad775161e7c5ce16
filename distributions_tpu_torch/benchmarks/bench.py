"""Headline benchmark (bench.py of the JAX package): collapsed-Gibbs
cell-scoring throughput of the nich sweep loop on a Pitman-Yor mixture.

Workload: R rows x C components, FEATURES nich features; one blocked sweep
= per tile {remove the tile, score [B, C], draw, add the tile}.  Metric:
cell-scores per second, a cell being one (row, component) predictive
evaluation for one feature.  BENCH_REPEATS timed calls of BENCH_SWEEPS
sweeps each run inside one process, and the median call is reported; two
versions are compared only inside one run of one machine.

    python -m distributions_tpu_torch.benchmarks.bench

Prints one JSON line {"metric", "value", "unit", "ms_per_sweep", ...},
after a line '# graphs: ...': on the card every kernel's sweeps (v2, v1
and plain) are replayed from CUDA graphs (ops/gibbs.py), and that line
gives how many graphs the run captured and the seconds the captures took
(a key's first call runs eagerly and its second captures, within the
warm-up call or at the first timed one: the median call is replays).
Sizes: BENCH_ROWS (1048576), BENCH_COMPONENTS (1024), BENCH_BLOCK
(131072), BENCH_FEATURES (2), BENCH_SWEEPS (30), BENCH_REPEATS (5),
BENCH_SAMPLING (gumbel), BENCH_KERNEL (v2: the fused sweep on K1 | v1: K4's
sweep | plain).
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from distributions_tpu_torch import clustering, config, mixture as mx
from distributions_tpu_torch.benchmarks.timing import (
    device_name, graphs_line, int_env)
from distributions_tpu_torch.models import nich
from distributions_tpu_torch.ops import gibbs


def timed_calls(call, repeats, device):
    """Milliseconds of each of `repeats` calls after one warm-up call, by
    the host clock around work that ends in a synchronize."""
    device = torch.device(device)

    def sync():
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
    call()
    sync()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        call()
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
    return times


def run(device=None):
    device = config.resolve_device(device)
    R = int_env('BENCH_ROWS', 1048576)
    C = int_env('BENCH_COMPONENTS', 1024)
    BLOCK = int_env('BENCH_BLOCK', 131072)
    FEATURES = int_env('BENCH_FEATURES', 2)
    SWEEPS = int_env('BENCH_SWEEPS', 30)
    REPEATS = int_env('BENCH_REPEATS', 5)
    sampling = os.environ.get('BENCH_SAMPLING', 'gumbel')
    kernel = os.environ.get('BENCH_KERNEL', 'v2')

    rng = np.random.RandomState(0)
    spec = mx.make_spec([(nich, FEATURES)], capacity=C, empties=1)
    cl = clustering.PitmanYor.from_dict({'alpha': 100.0, 'd': 0.1},
                                        device=device)
    shareds = (nich.shared_from_dict(
        {'mu': 0., 'kappa': 0.1, 'sigmasq': 0.01, 'nu': 1.}, device=device),)
    n_true = max(C - 8, 1)
    centers = rng.randn(n_true, FEATURES).astype(np.float32)
    labels = rng.randint(0, n_true, R)
    X = centers[labels] + 0.1 * rng.randn(R, FEATURES).astype(np.float32)
    values = (torch.from_numpy(X.astype(np.float32)).to(device),)
    assignments = torch.from_numpy(labels.astype(np.int32)).to(device)
    state = mx.state_from_assignments(spec, cl, shareds, values, assignments)
    gen = torch.Generator().manual_seed(0)
    carry = [state, assignments,
             gibbs.build_stat_cache(spec, shareds, values, BLOCK, assignments)
             if kernel == 'v2' else None]

    def call():
        st, an, cache = carry
        if kernel == 'v2':
            st, an, cache = gibbs.run_sweeps_pallas_fused(
                spec, cl, shareds, st, values, an, BLOCK, 2048, gen, cache,
                SWEEPS, sampling)
        elif kernel == 'v1':
            for _ in range(SWEEPS):
                st, an = gibbs.sweep_blocked_pallas(
                    spec, cl, shareds, st, values, an, BLOCK, generator=gen,
                    sampling=sampling)
        elif kernel == 'plain':
            for _ in range(SWEEPS):
                st, an = gibbs.sweep_blocked(spec, cl, shareds, st, values,
                                             an, BLOCK, generator=gen)
        else:
            raise ValueError("BENCH_KERNEL must be 'v2', 'v1' or 'plain', "
                             'got %r' % (kernel,))
        carry[:] = [st, an, cache]

    gibbs.release_sweep_graphs()
    graphs = gibbs.reset_graph_stats()
    times = timed_calls(call, REPEATS, device)
    ms_sweep = sorted(times)[len(times) // 2] / SWEEPS
    cells = float(R) * C * FEATURES
    return {'metric': 'gibbs_cell_scores_per_sec',
            'value': cells / (ms_sweep / 1e3), 'unit': 'cells/s',
            'ms_per_sweep': ms_sweep,
            'ms_per_sweep_of_each_call': [t / SWEEPS for t in times],
            'rows': R, 'components': C, 'block': BLOCK, 'features': FEATURES,
            'sweeps_per_call': SWEEPS, 'kernel': kernel,
            'sampling': sampling, 'graphs': dict(graphs),
            'device': device_name(device)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--device', default=None,
                    help="default: the package's default device, the card")
    out = run(ap.parse_args(argv).device)
    print(graphs_line(out['graphs']))
    print(json.dumps(out))
    print('# R=%d C=%d block=%d kernel=%s sweep=%.3f ms device=%s'
          % (out['rows'], out['components'], out['block'], out['kernel'],
             out['ms_per_sweep'], out['device']), file=sys.stderr)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
