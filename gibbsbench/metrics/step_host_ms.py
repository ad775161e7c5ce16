"""The runner's host time a step outside its sweeps, from the step rows'
`host_ms` (distributions_tpu_torch/diagnostics.py spans, each its own time
less that of the spans inside it): everything but `runner.sweeps` and the
graph path's spans inside it (`graph.*`), `runner.counts_sync` and
`runner.stat_cache`, which the rows' `seconds` hold.  The mean over the
steps before the profiler that did not capture, less the last, in whose
logger call the profiler starts."""

from gibbsbench import steps

INSIDE = ('runner.sweeps', 'runner.counts_sync', 'runner.stat_cache')


def read(run):
    rows = [r for r in steps.steady_rows(run, host=True) if 'host_ms' in r]
    return steps.mean(
        sum(ms for name, ms in r['host_ms'].items()
            if name not in INSIDE and not name.startswith('graph.'))
        for r in rows)
