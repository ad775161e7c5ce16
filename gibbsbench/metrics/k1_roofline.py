"""K1's share of its roofline (csrc/fused_v2.cu on csrc/fused_split.cuh):
the frozen least time of one tile's launch (gibbsbench/roofline.py) over
the profiled device time of a launch, its stat stage included.  Read in
configurations of nich columns alone, which K1 serves."""

from gibbsbench import roofline


def read(run):
    if any(b['model'] != 'nich' for b in run.config['blocks']):
        return None
    return roofline.kernel_share(run)
