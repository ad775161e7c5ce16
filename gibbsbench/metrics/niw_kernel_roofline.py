"""K2's share of its roofline on a configuration's niw rows (csrc/fused_v3.cu
on csrc/fused_split.cuh; niw16 takes the niw16 shape): the frozen least
time of one tile's launch (gibbsbench/roofline.py counts a niw column of
dimension d at d + 3 d (d + 1) / 2 + 2 operations a cell) over its
profiled device time, score + draw kernel and stat stage.  None in a
configuration without niw columns."""

from gibbsbench import roofline


def read(run):
    if not any(b['model'] == 'niw' for b in run.config['blocks']):
        return None
    return roofline.kernel_share(run)
