"""Seconds from the harness's start to the window's: imports, the card's
start, the kernels' load (their build in a checkout's first run), the
rows made from the seed and the warm-up call."""


def read(run):
    return run.setup_s
