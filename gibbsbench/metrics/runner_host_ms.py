"""The runner's own host time a step (inference/runner.py, diagnostics.py,
debug.py): the time from the call's entry to the end of the last
unprofiled step, less the steps' own seconds as the runner's logger rows
give them (the sweeps up to the step's counts sync), over those steps."""


def read(run):
    n = run.unprofiled_steps
    if n < 1:
        return None
    inside = sum(r['seconds'] for r in run.step_rows[:n])
    return 1e3 * (run.step_ends[n - 1] - inside) / n
