"""Device milliseconds a sweep of the fused kernel's launches, its stat
stage included (ops/fused_kernels.py `fused_mixed_score_sample_stats`: K1
or K2): tile 0's `kernel` phase, from CUDA events in the sweep graph, times
the tiles."""

from gibbsbench import steps


def read(run):
    return steps.per_sweep(run, lambda t, n: t['kernel'] * n)
