"""The whole sweep's share of the card's f32 peak: a sweep's frozen
operations (gibbsbench/roofline.py) at 67 TFLOP/s, over the traced run's
seconds a sweep before its profiler started."""

from gibbsbench import roofline
from gibbsbench.metrics import unprofiled_sweep_s


def read(run):
    sweep_s = unprofiled_sweep_s(run)
    if sweep_s is None or run.device_type != 'cuda':
        return None
    least = roofline.sweep_ops(run.config, run.slots) \
        / roofline.PEAK_F32_PER_S
    return 100.0 * least / sweep_s
