"""Device milliseconds between two steps of one graph: from the previous
step's last CUDA event (after its score and output copies) to this one's
first (before the load of its buffers), the step rows' `device_ms['edge']`;
the mean over the steps before the profiler that did not capture."""

from gibbsbench import steps


def read(run):
    if run.device_type != 'cuda':
        return None
    return steps.mean(r['device_ms']['edge'] for r in steps.steady_rows(run)
                      if 'edge' in r.get('device_ms', {}))
