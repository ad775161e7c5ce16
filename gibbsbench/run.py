"""One run of one cell of the benchmark of the PyTorch and CUDA port:

    python3 -m gibbsbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (`setup_s`): the imports, the rows made on the card from the seed
(gibbsbench/problem.py), and a warm-up run_gibbs call from the
generating labels, which loads the kernels (builds them in a checkout's
first run, into build/torch_kernels/ inside the checkout), captures the
cell's graphs and measures the rate that sizes the window.

The window is one run_gibbs(use_pallas=True) call of a whole number of
steps, sized to last about --seconds, warm from the warm-up's final
assignments with the last tile's rows permuted among themselves (a call
that returned its input unchanged would keep that permutation, which the
draw check refuses).  Its capture of the sweep graph is inside it, as a
user's call pays for it.  With --trace 1 the profiler covers its last
steps.  Then the plain reference (gibbsbench/reference.py) judges the
call's outputs.

The last line of standard output is one JSON object: correct, attempted
and failed (the window's sweeps), metrics (the cell's end-to-end metrics,
or with --trace 1 its per-layer metrics, as BENCHMARK.json lists them),
device, with --trace 1 breakdown, and last the compared numbers with
their limits, which also end standard error.  Without a CUDA device for
each chip the cell asks for, or with JAX or the JAX package loaded once
the window has closed, it prints no result and exits non-zero.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

from gibbsbench import metrics, problem  # noqa: E402

# top-level module names no run may hold once its window has closed
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'distributions_tpu')
WARMUP_SWEEPS = 4          # sweeps a warm-up step; two steps
PROFILE_SECONDS = 0.5      # a traced run profiles its last steps of this
MIN_UNPROFILED = 2


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules(modules=None):
    """The FORBIDDEN top-level names among the loaded modules."""
    tops = {name.split('.')[0] for name in list(modules or sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def cell_metrics(bench, cell, trace):
    """[(name, unit)] of the metrics a run of `cell` reports."""
    group = bench['per_layer'] if trace else bench['end_to_end']
    return [(m['name'], m['unit']) for m in group
            if cell['name'] in m.get('workloads', [cell['name']])]


def scrambled_start(assignments, tile_rows, seed, device):
    """`assignments` with the last tile's rows permuted among themselves,
    by a permutation drawn from the seed."""
    import torch
    start = assignments.clone()
    g = problem.generator(seed, 'start', device)
    perm = torch.randperm(tile_rows, generator=g, device=device)
    start[-tile_rows:] = assignments[-tile_rows:][perm]
    return start


def window_limits(cfg, sweeps):
    """The configuration's limits, stats_gap at most the rounding that
    the window's updates of the float32 statistics can account for (an
    unmerge and a merge a tile and sweep, each within 2^-24 of the
    largest magnitude): drift beyond it is the program's fault."""
    limits = dict(cfg['limits'])
    if 'stats_gap' in limits:
        updates = 2 * (cfg['rows'] // cfg['tile_rows']) * sweeps
        limits['stats_gap'] = min(limits['stats_gap'], updates * 2.0 ** -24)
    return limits


def _sync(device):
    import torch
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def _card(device):
    """The card's name and power limit, as nvidia-smi gives them."""
    import subprocess
    import torch
    if torch.device(device).type != 'cuda':
        return str(device)
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(device)


def measure(bench, cell, seed, seconds, trace, device, overrides=None,
            t_start=None, keep=None):
    """One run of `cell` on `device`: (result dict, [(name, value, limit)]
    of the compared numbers, lines for standard error).  `overrides`
    replaces keys of the configuration, the traffic or the run ('steps'
    fixes the window's steps), for tests at small sizes.  `keep`, a dict,
    receives what the reference read (config, values, outputs, sample)."""
    import torch
    from gibbsbench import program, reference
    from gibbsbench import trace as tracing
    torch.set_num_threads(1)
    overrides = dict(overrides or {})
    cfg = problem.config(cell['config'])
    tfc = problem.traffic(cell['traffic'])
    for d in (cfg, tfc, cfg['check']):
        for k in list(d):
            if k in overrides:
                d[k] = overrides[k]
    names = cell_metrics(bench, cell, trace)
    readers = {name: metrics.find(name) for name, _ in names}
    device = torch.device(device)
    t0 = T0 if t_start is None else t_start
    # the set-up's phases, each stamped when it ends
    stamps = [('imports', time.perf_counter())]
    torch.zeros(1, device=device)
    _sync(device)
    stamps.append(('device_start', time.perf_counter()))
    C, sps = tfc['slots'], tfc['sweeps_per_step']
    R, tile_rows = cfg['rows'], cfg['tile_rows']

    spec, cl, shareds = program.build(cfg, C, device)
    labels, values = problem.make_rows(cfg, tfc['generating_clusters'],
                                       seed, device)
    prob = (spec, cl, shareds, values, cfg, tfc, device)
    _sync(device)
    stamps.append(('rows', time.perf_counter()))
    w = min(sps, WARMUP_SWEEPS)
    clock = program.StepClock()
    state, assignments = program.run(
        prob, problem.generator(seed, 'warmup', 'cpu'), 2 * w, w, labels,
        clock)
    _sync(device)
    step_s = (clock.ends[1] - clock.ends[0]) * sps / w
    stamps.append(('warmup', time.perf_counter()))
    phases = {name: t - (stamps[i - 1][1] if i else t0)
              for i, (name, t) in enumerate(stamps)}
    steps = overrides.get('steps') or max(
        MIN_UNPROFILED + 1, int(round(seconds / step_s)))
    profiled = 0
    if trace:
        profiled = min(steps - MIN_UNPROFILED,
                       max(1, int(math.ceil(PROFILE_SECONDS / step_s))))
    start = scrambled_start(assignments, tile_rows, seed, device)
    del state, assignments, clock
    window = tracing.Window(device) if trace else None
    clock = program.StepClock(
        profile_after=steps - profiled if trace else None,
        at_profile=window.start if trace else None)
    graph = program.reset_graph_stats()
    _sync(device)
    t_entry = time.perf_counter()
    setup_s = t_entry - t0
    failure = None
    try:
        state, assignments = program.run(
            prob, problem.generator(seed, 'window', 'cpu'), steps * sps,
            sps, start, clock)
        _sync(device)
    except RuntimeError as e:
        # the runner refuses to go on with no free slot: a failed run
        failure = str(e)
    wall_s = time.perf_counter() - t_entry
    if window is not None and window.prof is not None:
        window.stop()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == 'cuda' else 0)
    done = len(clock.rows) * sps
    lines = []
    dev = {'platform': 'gpu' if device.type == 'cuda' else device.type,
           'kind': (torch.cuda.get_device_name(device)
                    if device.type == 'cuda' else str(device)),
           'count': 1, 'memory_peak_bytes': int(peak)}
    result = {'correct': False, 'attempted': steps * sps,
              'failed': steps * sps - done}
    if failure is not None:
        lines.append('run_gibbs raised: %s' % failure)
        result.update(metrics={}, device=dev, checks={})
        return result, [], lines

    profile = tracing.read(window) if trace else None
    run = types.SimpleNamespace(
        config=cfg, traffic=tfc, slots=C, device_type=device.type,
        setup_s=setup_s, wall_s=wall_s, sweeps=steps * sps,
        sweeps_per_step=sps, step_ends=[t - t_entry for t in clock.ends],
        step_rows=clock.rows, unprofiled_steps=steps - profiled,
        profiled_sweeps=profiled * sps, graph=dict(graph), profile=profile)
    values_out = {}
    for name, unit in names:
        v = readers[name].read(run)
        if v is not None:
            values_out[name] = {'value': float(v), 'unit': unit}
    result['metrics'] = values_out
    if trace:
        if profile is not None:
            dev.update(busy_s=profile['busy_s'], window_s=profile['wall_s'])
            result['breakdown'] = {'device_ops': profile['device_ops'],
                                   'idle_gaps': profile['idle_gaps']}
    result['device'] = dev

    t_check = time.perf_counter()
    groups = program.nonempty_groups(clock)
    out = program.outputs(cfg, state, assignments, clock)
    moved = int((out['assignments'] != start).sum())
    del state, assignments, start
    program.empty_cache(device)
    sample = reference.last_tile_sample(
        R, tile_rows, cfg['check']['sample_rows'],
        problem.generator(seed, 'sample', 'cpu'), device)
    numbers, extra = reference.compare(cfg, values, out, sample)
    limits = window_limits(cfg, steps * sps)
    if keep is not None:
        keep.update(config=cfg, values=values, outputs=out, sample=sample,
                    limits=limits)
    correct, checks = reference.judge(numbers, limits)
    result['correct'] = bool(correct)
    result['card'] = _card(device)
    result['info'] = {
        'steps': steps, 'sweeps_per_step': sps, 'profiled_steps': profiled,
        'warmup_step_s_scaled': step_s, 'wall_s': wall_s,
        'rows_moved': moved, 'groups_last': groups[-1],
        'groups_max': max(groups), 'groups_min': min(groups),
        'setup_phases_s': phases, **extra,
        'check_seconds': time.perf_counter() - t_check}
    lines.append('groups per step: %s' % ' '.join(map(str, groups)))
    ends = [0.0] + run.step_ends
    lines.append('step ms (interval/inside): %s' % ' '.join(
        '%.1f/%.1f' % (1e3 * (b - a), 1e3 * r['seconds'])
        for a, b, r in zip(ends, ends[1:], clock.rows)))
    result['checks'] = {name: {'value': v, 'limit': lim}
                        for name, v, lim in checks}
    return result, checks, lines


def main(argv=None):
    args = parse(argv)
    bench = problem.benchmark()
    cell = problem.workload(bench, args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell['chips']:
        print('gibbsbench: %s needs %d CUDA device(s); this machine has %d'
              % (cell['name'], cell['chips'],
                 torch.cuda.device_count() if torch.cuda.is_available()
                 else 0), file=sys.stderr)
        return 2
    result, checks, lines = measure(bench, cell, args.seed, args.seconds,
                                    args.trace, 'cuda')
    found = forbidden_modules()
    if found:
        print('gibbsbench: the run loaded %s' % ', '.join(found),
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    for name, value, limit in checks:
        print('check %s %r limit %r' % (name, value, limit),
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
