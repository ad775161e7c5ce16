"""Device milliseconds a sweep of the fused tiles' [C]-sized kernel inputs
(ops/gibbs.py `_fused_tile_inputs`: the clustering scores, the nich and
niw coefficients, the score tables): tile 0's `inputs` phase in the step's
last sweep, from CUDA events in the sweep graph, times the tiles."""

from gibbsbench import steps


def read(run):
    return steps.per_sweep(run, lambda t, n: t['inputs'] * n)
