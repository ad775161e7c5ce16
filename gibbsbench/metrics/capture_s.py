"""Seconds the window's run_gibbs call spent capturing its CUDA graphs
(ops/gibbs.py `_SweepGraph`; `GRAPH_STATS['capture_seconds']`)."""


def read(run):
    if not run.graph.get('captures'):
        return None
    return float(run.graph['capture_seconds'])
