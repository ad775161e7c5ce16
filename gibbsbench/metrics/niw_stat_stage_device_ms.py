"""Device milliseconds a profiled sweep of K2's stat stage on a
configuration's niw rows (csrc/fused_stats.cuh: stat_partials and
stat_reduce; niw16's 153 float features a row on its run-time rows,
MixedRows<0, 0>).  None in a configuration without niw columns."""

from gibbsbench.metrics import stat_stage_device_ms


def read(run):
    if not any(b['model'] == 'niw' for b in run.config['blocks']):
        return None
    return stat_stage_device_ms.read(run)
