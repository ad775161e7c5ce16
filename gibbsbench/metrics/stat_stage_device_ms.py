"""Device milliseconds a profiled sweep of the stat stage of K1 and K2
(csrc/fused_stats.cuh: stat_partials and stat_reduce)."""

from gibbsbench.metrics import per_profiled_sweep


def read(run):
    p = run.profile
    if p is None or p['stat_ms'] <= 0:
        return None
    return per_profiled_sweep(run, p['stat_ms'])
