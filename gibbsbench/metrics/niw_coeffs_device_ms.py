"""Device milliseconds a sweep of the niw coefficients inside the fused
tiles' inputs (ops/gibbs.py `_build_fused_inputs`: fused_kernels.
niw_coeffs_v4's posterior, batched inverse and logdet of the slots'
scale matrices): tile 0's `niw_coeffs` mark in the step's last sweep
(`_DeviceClock.niw`, global-timer kernel nodes in the sweep graph), times
the tiles.  None where the rows hold no such mark (a configuration without
niw columns, or a program without the mark)."""

from gibbsbench import steps


def read(run):
    n = steps.tiles(run)
    return steps.mean(t['niw_coeffs'] * n for t in steps.tile_ms(run)
                      if 'niw_coeffs' in t)
