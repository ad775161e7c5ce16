"""K2's share of its roofline (csrc/fused_v3.cu on csrc/fused_split.cuh):
as k1_roofline, in configurations with niw or table columns, which K2
serves."""

from gibbsbench import roofline


def read(run):
    if all(b['model'] == 'nich' for b in run.config['blocks']):
        return None
    return roofline.kernel_share(run)
