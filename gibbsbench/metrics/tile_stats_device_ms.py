"""Device milliseconds a sweep of the fused tiles' statistics outside the
kernel (ops/gibbs.py `_fused_sweep_into`): tile 0's `remove` (the cached
sums taken off the state), `sums` (the counts delta and the stacking or
table products after the kernel), `add` and `write` (the assignments and
cache rows) phases times the tiles, and the end-of-sweep state copy; from
CUDA events in the sweep graph."""

from gibbsbench import steps

PHASES = ('remove', 'sums', 'add', 'write')


def read(run):
    return steps.per_sweep(
        run, lambda t, n: sum(t[p] for p in PHASES) * n + t['state_copy'])
