"""Device milliseconds a profiled sweep outside the score + draw kernels
and their stat stage: the per-tile [C]-sized bookkeeping (mixture.py,
clustering.py, gibbs._build_fused_inputs), the step's score and its
counts copy."""

from gibbsbench.metrics import per_profiled_sweep


def read(run):
    p = run.profile
    if p is None:
        return None
    return per_profiled_sweep(run, p['device_ms'] - p['split_ms']
                              - p['stat_ms'])
