"""Metric readers, one module a metric, found by the metric's name in
BENCHMARK.json (a split quantity's name by its part before the dot):
gibbsbench/metrics/<name>.py holds `read(run)`, which
returns the metric's value or None when the run holds nothing for it to
read (the harness then leaves the metric out of the line).

`run` has: config, traffic (their files as dicts), slots, device_type,
setup_s, wall_s (the window: run_gibbs's entry to its return after a
synchronize), sweeps, sweeps_per_step, step_ends (each step's end, seconds
since the entry), step_rows (the runner's logger rows, whose 'seconds' is
a step's sweeps up to its counts sync), unprofiled_steps (the steps
before a traced run's profiler started; all of them otherwise),
profiled_sweeps, graph (the program's graph counters over the window's
call) and profile (gibbsbench.trace.read of the traced steps, or None)."""

import importlib
import re

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')


def find(name):
    """The reader module of metric `name`: gibbsbench/metrics/<name>.py,
    or for a split quantity `<quantity>.<part>` (one that moves another
    end-to-end metric in some cells) the quantity's reader."""
    module = name.split('.')[0]
    if not NAME.match(name) or not module.isidentifier():
        raise ValueError('not a metric name: %r' % (name,))
    return importlib.import_module('gibbsbench.metrics.' + module)


def unprofiled_sweep_s(run):
    """Seconds a sweep over the steps before the profiler, from the call's
    entry (its capture and state build included, as in sweep_ms)."""
    n = run.unprofiled_steps
    if n < 1:
        return None
    return run.step_ends[n - 1] / (n * run.sweeps_per_step)


def per_profiled_sweep(run, ms):
    if run.profile is None or run.device_type != 'cuda':
        return None
    return ms / run.profiled_sweeps
