"""The whole sweep's share of the card's f32 peak on a configuration's niw
rows: as sweep_mfu, a sweep's frozen operations (gibbsbench/roofline.py) at
67 TFLOP/s over the traced run's seconds a sweep before its profiler
started.  None in a configuration without niw columns."""

from gibbsbench.metrics import sweep_mfu


def read(run):
    if not any(b['model'] == 'niw' for b in run.config['blocks']):
        return None
    return sweep_mfu.read(run)
