"""Percent of the profiled steps' wall in which the card ran nothing:
100 x (1 - the union of its operations' times over the wall)."""


def read(run):
    p = run.profile
    if p is None or run.device_type != 'cuda':
        return None
    return 100.0 * (1.0 - p['busy_s'] / p['wall_s'])
