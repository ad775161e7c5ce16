"""The benchmark suite (benchmarks/suite.py of the JAX package).  Each
section prints one JSON line per result:

  python -m distributions_tpu_torch.benchmarks.suite                 # all ported
  python -m distributions_tpu_torch.benchmarks.suite kernel_sampler  # one

Ported sections: `kernel_sampler` (B1, the production sampler alone),
`hyper_grid` (the runner's grid step), `mixture` (the cell-scoring rate
per model and K), `sample_from_scores`, `score_counts`,
`sample_assignments` and `special`.  `backends` needs modules that are not
ported yet and raises NotImplementedError naming the ROADMAP item.
"""

import argparse
import json
import os

import numpy as np
import torch

from distributions_tpu_torch import clustering, config, mixture as mx
from distributions_tpu_torch import random as _random, special
from distributions_tpu_torch.benchmarks.timing import (device_name, int_env,
                                                       median_ms)
from distributions_tpu_torch.inference import hypers
from distributions_tpu_torch.models import MODULES, nich
from distributions_tpu_torch.ops import bench_kernels as bk, gibbs

# B1's rows: the TPU kernel sizes its block by a VMEM cap
# (`auto_block_rows`); the card has no such cap, and 2048 rows fill it at
# every C
SAMPLER_ROWS = 2048


def _emit(out):
    print(json.dumps(out), flush=True)
    return out


def bench_kernel_sampler(device=None, sizes=None, rows=None, cells=None,
                         reps=3):
    """The production sampler primitive alone: in-kernel Philox
    gumbel-argmax over a resident [rows, C] score block, T = max(16,
    cells / (rows * C)) draws per row in one launch
    (`bench_kernels.sampler_gumbel`).  draws/s counts categorical samples,
    elems/s the score elements consumed (draws x C)."""
    device = config.resolve_device(device)
    if sizes is None:
        sizes = [int(c) for c in os.environ.get(
            'BENCH_SAMPLER_SIZES', '256,1024,4096').split(',')]
    rows = int_env('BENCH_SAMPLER_ROWS', SAMPLER_ROWS) if rows is None \
        else rows
    cells = int_env('BENCH_SAMPLER_CELLS', 1 << 28) if cells is None \
        else cells
    results = []
    for C in sizes:
        rng = np.random.RandomState(0)
        scores = torch.from_numpy(
            rng.randn(rows, C).astype(np.float32)).to(device)
        T = max(16, cells // (rows * C))
        seeds = iter(range(1, 1 << 30))
        ms = median_ms(lambda: bk.sampler_gumbel(next(seeds) << 20, scores,
                                                 T), reps, device)
        results.append(_emit({
            'metric': 'kernel_gumbel_draws_per_sec', 'size': C,
            'value': rows * T / (ms / 1e3), 'unit': 'draws/s',
            'elems_per_sec': float(rows) * C * T / (ms / 1e3), 'rows': rows,
            'in_kernel_iters': T, 'ms': ms, 'device': device_name(device)}))
    return results


def bench_hyper_grid(device=None, rows=None, cap=None, grid=None, iters=10):
    """Hyper-grid scoring rate: one `hypers.grid_step_feature` of a [G]
    grid of nich Shareds against [C] groups of 2 columns (the runner's
    hyper_grids step).  Metric: grid cells (G x C group marginals) per
    second."""
    device = config.resolve_device(device)
    R = int_env('BENCH_ROWS', 65536) if rows is None else rows
    C = int_env('BENCH_CAP', 1024) if cap is None else cap
    G = int_env('BENCH_GRID', 64) if grid is None else grid
    rng = np.random.RandomState(0)
    spec = mx.make_spec([(nich, 2)], capacity=C, empties=1)
    shareds = (nich.shared_from_dict(
        {'mu': 0., 'kappa': 0.1, 'sigmasq': 1.0, 'nu': 1.}, device=device),)
    cl = clustering.PitmanYor.from_dict({'alpha': 100.0, 'd': 0.1},
                                        device=device)
    values = (torch.from_numpy(rng.randn(R, 2).astype(np.float32)).to(
        device),)
    assignments = torch.from_numpy(
        rng.randint(0, max(C - 8, 1), R).astype(np.int32)).to(device)
    state = mx.state_from_assignments(spec, cl, shareds, values, assignments)
    grid_shared = nich.Shared(
        mu=torch.zeros(G, device=device),
        kappa=torch.full((G,), 0.1, device=device),
        sigmasq=torch.from_numpy(
            np.logspace(-2, 2, G).astype(np.float32)).to(device),
        nu=torch.ones(G, device=device))
    gen = torch.Generator().manual_seed(0)

    def step():
        # the chosen index is read on the host, as the runner reads it
        return int(hypers.grid_step_feature(gen, spec, 0, shareds, state,
                                            grid_shared)[1])
    ms = median_ms(step, iters, device)
    return [_emit({'metric': 'hyper_grid_cells_per_sec', 'G': G, 'C': C,
                   'value': G * C / (ms / 1e3), 'unit': 'grid-cells/s',
                   'ms': ms, 'device': device_name(device)})]


def bench_mixture(device=None, rows=None, block=None, Ks=None, models=None,
                  iters=3):
    """Gibbs cell-scoring rate per model and K: one blocked sweep over the
    rows, counting cells = rows x K.  BENCH_SWEEP=xla (default) times the
    plain `gibbs.sweep_blocked`, BENCH_SWEEP=fused the fused sweep (K1 or
    K2, sampling BENCH_SAMPLING, 5 sweeps a call)."""
    device = config.resolve_device(device)
    R = int_env('BENCH_ROWS', 65536) if rows is None else rows
    BLOCK = int_env('BENCH_BLOCK', 16384) if block is None else block
    if Ks is None:
        Ks = [int(k) for k in os.environ.get('BENCH_K',
                                             '64,512,1024').split(',')]
    only = models or (os.environ['BENCH_MODELS'].split(',')
                      if os.environ.get('BENCH_MODELS') else None)
    mode = os.environ.get('BENCH_SWEEP', 'xla')
    sampling = os.environ.get('BENCH_SAMPLING', 'gumbel')
    cl = clustering.PitmanYor.from_dict({'alpha': 100.0, 'd': 0.1},
                                        device=device)
    rng = np.random.RandomState(0)
    cases = {
        'bb': ('bb', {'alpha': 0.5, 'beta': 2.0}, {},
               lambda: rng.randint(0, 2, (R, 1)).astype(bool)),
        'dd4': ('dd', {'alphas': [0.5] * 4}, {},
                lambda: rng.randint(0, 4, (R, 1)).astype(np.int32)),
        'gp': ('gp', {'alpha': 1.0, 'inv_beta': 1.0}, {},
               lambda: rng.poisson(3.0, (R, 1)).astype(np.int32)),
        'bnb': ('bnb', {'alpha': 1., 'beta': 1., 'r': 1}, {},
                lambda: rng.poisson(3.0, (R, 1)).astype(np.int32)),
        'nich': ('nich', {'mu': 0., 'kappa': 1., 'sigmasq': 1., 'nu': 1.},
                 {}, lambda: rng.randn(R, 1).astype(np.float32)),
        'dpd': ('dpd', {'gamma': 1.0, 'alpha': 1.0,
                        'betas': {i: 1.0 / 8 for i in range(8)}},
                {'cap': 16},
                lambda: rng.randint(0, 8, (R, 1)).astype(np.int32)),
    }
    results = []
    for K in Ks:
        for name, (module, raw, kw, make) in cases.items():
            if only and name not in only:
                continue
            module = MODULES[module]
            spec = mx.make_spec([(module, 1)], capacity=K, empties=1)
            shareds = (module.shared_from_dict(raw, device=device, **kw),)
            X = (torch.from_numpy(make()).to(device),)
            assignments = torch.from_numpy(
                rng.randint(0, max(K - 8, 1), R).astype(np.int32)).to(device)
            state = mx.state_from_assignments(spec, cl, shareds, X,
                                              assignments)
            gen = torch.Generator().manual_seed(0)
            if mode == 'fused':
                cache = gibbs.build_stat_cache(spec, shareds, X, BLOCK,
                                               assignments)
                ms = median_ms(
                    lambda: gibbs.sweep_blocked_pallas_fused_mixed(
                        spec, cl, shareds, state, X, assignments, BLOCK, 1024,
                        gen, cache, sampling=sampling, n_sweeps=5),
                    iters, device) / 5
            else:
                ms = median_ms(
                    lambda: gibbs.sweep_blocked(spec, cl, shareds, state, X,
                                                assignments, BLOCK,
                                                generator=gen),
                    iters, device)
            results.append(_emit({
                'metric': 'mixture_cells_per_sec', 'model': name, 'K': K,
                'mode': mode, 'value': float(R) * K / (ms / 1e3),
                'unit': 'cells/s', 'ms_per_sweep': ms,
                'device': device_name(device)}))
    return results


# the reference's sizes for the sampler, score-count and special sections
SFS_ROWS, SFS_ITERS = 4096, 16
SFS_SIZES = (16, 64, 256, 1024, 4096, 16384)
SC_BATCH, SC_ITERS = 4096, 64
SC_SIZES = (1000, 10000, 100000, 1000000, 10000000)
SA_SIZES = (1000, 10000)
SA_STICK_SIZES = (10000, 1048576)
SPECIAL_N, SPECIAL_ITERS = 1 << 20, 64


def bench_sample_from_scores(device=None):
    """Categorical draws from [SFS_ROWS, size] log-scores
    (`random.sample_from_scores`, gumbel-argmax), SFS_ITERS draws a timed
    call.  draws/s counts samples, elems/s the score elements consumed."""
    device = config.resolve_device(device)
    B, T = SFS_ROWS, SFS_ITERS
    rng = np.random.RandomState(0)
    gen = torch.Generator(device=device).manual_seed(0)
    results = []
    for size in SFS_SIZES:
        scores = torch.from_numpy(rng.randn(B, size).astype(
            np.float32)).to(device)

        def run():
            for _ in range(T):
                _random.sample_from_scores(gen, scores)
        ms = median_ms(run, 3, device) / T
        results.append(_emit({
            'metric': 'sample_from_scores_choices_per_sec', 'size': size,
            'value': B / (ms / 1e3), 'unit': 'draws/s',
            'elems_per_sec': float(B) * size / (ms / 1e3), 'rows': B,
            'iters': T, 'device': device_name(device)}))
    return results


def _py_counts(rng, n, alpha, d):
    """Counts of a Pitman-Yor prior draw of n items: GEM stick-breaking,
    truncated when the remaining mass cannot hold another expected item,
    then a multinomial."""
    sticks = []
    log_rest = 0.0
    k = 0
    while log_rest > -np.log(4.0 * n) and k < 1 << 20:
        v = rng.beta(1 - d, alpha + (k + 1) * d)
        sticks.append(np.exp(log_rest) * v)
        log_rest += np.log1p(-v)
        k += 1
    w = np.asarray(sticks)
    counts = rng.multinomial(n, w / w.sum())
    return counts[counts > 0].astype(np.float32)


def bench_score_counts(device=None):
    """Pitman-Yor `score_counts` of a prior draw's counts vector against
    the dataset size: SC_ITERS dependent single scores one after another
    (each adds one to the first count), and SC_BATCH count vectors in one
    call."""
    device = config.resolve_device(device)
    B, T = SC_BATCH, SC_ITERS
    alpha, d = 1.0, 0.2
    model = clustering.PitmanYor.from_dict({'alpha': alpha, 'd': d},
                                           device=device)
    rng = np.random.RandomState(0)
    results = []
    for size in SC_SIZES:
        counts = torch.from_numpy(_py_counts(rng, size, alpha, d)).to(device)
        one = torch.zeros_like(counts)
        one[0] = 1.0

        def run_seq():
            c = counts
            for _ in range(T):
                c = c + one
                clustering.py_score_counts(model, c)
        ms = median_ms(run_seq, 3, device) / T
        cb = counts[None, :] + torch.arange(
            B, dtype=torch.float32, device=device)[:, None]
        ms_b = median_ms(lambda: clustering.py_score_counts(model, cb), 3,
                         device) / B
        results.append(_emit({
            'metric': 'py_score_counts_per_sec', 'dataset_size': size,
            'n_groups': int(counts.shape[0]), 'value': 1e3 / ms,
            'unit': 'scores/s', 'batched_scores_per_sec': 1e3 / ms_b,
            'iters': T, 'device': device_name(device)}))
    return results


def bench_sample_assignments(device=None):
    """Pitman-Yor assignment sampling: `py_sample_assignments` (the
    sequential law, seated on the host) and `py_sample_assignments_stick`
    (stick-breaking, capacity 1024), samples/s."""
    device = config.resolve_device(device)
    model = clustering.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.2},
                                           device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    results = []
    for size in SA_SIZES:
        ms = median_ms(lambda: clustering.py_sample_assignments(
            gen, model, size, capacity=256), 3, device)
        results.append(_emit({
            'metric': 'py_sample_assignments_per_sec', 'size': size,
            'value': size / (ms / 1e3), 'unit': 'samples/s',
            'device': device_name(device)}))
    for size in SA_STICK_SIZES:
        ms = median_ms(lambda: clustering.py_sample_assignments_stick(
            gen, model, size, capacity=1024), 3, device)
        results.append(_emit({
            'metric': 'py_sample_assignments_stick_per_sec', 'size': size,
            'value': size / (ms / 1e3), 'unit': 'samples/s',
            'device': device_name(device)}))
    return results


def bench_special(device=None):
    """Special-function calls/s over SPECIAL_N elements: each timed call
    accumulates f(x + 1e-6 i) for i < SPECIAL_ITERS."""
    device = config.resolve_device(device)
    n, T = SPECIAL_N, SPECIAL_ITERS
    rng = np.random.RandomState(0)
    x = torch.from_numpy((np.abs(rng.randn(n)) * 10 + 0.1).astype(
        np.float32)).to(device)
    results = []
    for name, fn in (('exp', torch.exp), ('log', torch.log),
                     ('lgamma', special.gammaln),
                     ('lgamma_nu', special.lgamma_nu)):
        def run(f=fn):
            acc = torch.zeros_like(x)
            for i in range(T):
                acc = acc + f(x + 1e-6 * i)
            return acc
        ms = median_ms(run, 3, device) / T
        results.append(_emit({
            'metric': 'special_calls_per_sec', 'fn': name,
            'value': n / (ms / 1e3), 'unit': 'calls/s', 'iters': T,
            'device': device_name(device)}))
    return results


def _not_ported(section, item):
    def bench(device=None):
        raise NotImplementedError(
            'suite section %r is not ported yet (ROADMAP Queue 1 item %d)'
            % (section, item))
    return bench


SECTIONS = {
    'mixture': bench_mixture,
    'hyper_grid': bench_hyper_grid,
    'kernel_sampler': bench_kernel_sampler,
    'sample_from_scores': bench_sample_from_scores,
    'score_counts': bench_score_counts,
    'sample_assignments': bench_sample_assignments,
    'special': bench_special,
    # the gradient and particle backends
    'backends': _not_ported('backends', 15),
}
PORTED = ('mixture', 'hyper_grid', 'kernel_sampler', 'sample_from_scores',
          'score_counts', 'sample_assignments', 'special')


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('sections', nargs='*',
                    help='default: every ported section (%s)'
                    % ', '.join(PORTED))
    ap.add_argument('--device', default=None,
                    help="default: the package's default device, the card")
    args = ap.parse_args(argv)
    for name in args.sections or PORTED:
        if name not in SECTIONS:
            raise SystemExit('unknown section %r (one of %s)'
                             % (name, ', '.join(SECTIONS)))
        SECTIONS[name](args.device)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
