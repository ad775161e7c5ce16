"""Milliseconds a sweep: the window's wall, from run_gibbs's entry to its
return after a synchronize, over the sweeps it ran.  What a user waits
for a chain to pay."""


def read(run):
    return 1e3 * run.wall_s / run.sweeps
