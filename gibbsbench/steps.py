"""What the metric readers take from the program's own instruments: the
runner's step rows (`run.step_rows`) and the span totals in its graph
table (`run.graph['spans']`), both as distributions_tpu_torch/diagnostics.py
documents them.  A program without them (an older one) gives rows without
those keys and a table without 'spans': the readers then return None."""


def steady_rows(run, host=False):
    """The rows of the steps before a traced run's profiler that did not
    capture a graph.  With `host`, without the last of those steps: its
    logger call starts the profiler, which its host spans would count."""
    n = run.unprofiled_steps - (1 if host and run.profiled_sweeps else 0)
    return [r for r in run.step_rows[:max(n, 0)] if not r.get('captured')]


def mean(values):
    values = list(values)
    return sum(values) / len(values) if values else None


def tiles(run):
    return run.config['rows'] // run.config['tile_rows']


def tile_ms(run):
    """The steady steps' tile 0 phase times (dicts of ms), on the card."""
    if run.device_type != 'cuda':
        return []
    return [r['tile_ms'] for r in steady_rows(run) if 'tile_ms' in r]


def per_sweep(run, fn):
    """The mean over the steady steps of fn(tile_ms, tiles): a sweep's
    device ms estimated from tile 0's phases; None without them."""
    n = tiles(run)
    return mean(fn(t, n) for t in tile_ms(run))
