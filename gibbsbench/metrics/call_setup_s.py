"""Seconds of the window's run_gibbs call before its first step: the
`runner.setup` span (placement, init or resume, the state build), from
the span totals of the program's graph table."""


def read(run):
    setup = (run.graph.get('spans') or {}).get('runner.setup')
    return None if setup is None else setup['seconds']
