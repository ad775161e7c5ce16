"""Nodes of the window call's sweep graph as captured (each kernel launch,
copy, memset and event record of a sweep): the program's
GRAPH_STATS['sweep_graph_nodes'].  Every [C]-sized operation fused away
lowers it, whatever the kernels are named."""


def read(run):
    nodes = run.graph.get('sweep_graph_nodes')
    return float(nodes) if nodes else None
