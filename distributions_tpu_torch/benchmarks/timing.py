"""Timing for the measurement entry points: CUDA events on the card, the
host clock on the CPU (where the entry points only run as small tests;
every result names its device)."""

import os
import subprocess
import time

import torch


def int_env(name, default):
    return int(os.environ.get(name, default))


def median_ms(fn, reps, device, batch=1):
    """Median milliseconds of `fn` over `reps` runs after one warm-up run:
    by CUDA events on a CUDA device, by the host clock otherwise.  With
    `batch` > 1 a run is `batch` calls back to back, divided by `batch`:
    for calls short enough that the host's time to issue one would
    otherwise count."""
    device = torch.device(device)
    fn()
    times = []
    for _ in range(reps):
        if device.type == 'cuda':
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(batch):
                fn()
            b.record()
            torch.cuda.synchronize(device)
            times.append(a.elapsed_time(b) / batch)
        else:
            t0 = time.perf_counter()
            for _ in range(batch):
                fn()
            times.append(1e3 * (time.perf_counter() - t0) / batch)
    times.sort()
    return times[len(times) // 2]


def graphs_line(graphs):
    """The '# graphs: ...' line the sweep benchmarks print before their
    result."""
    return ('# graphs: %d captured in %.3f s (%d sweep replays, %d score '
            'graphs, pools %d bytes, %d first calls of a key eager)' % (
                graphs['captures'], graphs['capture_seconds'],
                graphs['replays'], graphs['score_captures'],
                graphs['pool_bytes'], graphs['first_uses']))


def device_name(device):
    """The device a result was measured on: for a card its name and power
    limit as nvidia-smi gives them."""
    device = torch.device(device)
    if device.type != 'cuda':
        return str(device)
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            check=True, timeout=60)
        return out.stdout.strip().splitlines()[device.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(device)


def stamp_lines(argv):
    """Run the command `argv` and print each line of its standard output
    after the seconds since the command started, as '[12.3] line': the
    time at which each phase of a script that prints a line a phase
    ended.  Returns the command's exit code.

        python3 distributions_tpu_torch/benchmarks/timing.py \\
            python3 -u chip_smoke.py
    """
    t0 = time.time()
    with subprocess.Popen(argv, stdout=subprocess.PIPE, text=True) as proc:
        for line in proc.stdout:
            print('[%.1f] %s' % (time.time() - t0, line), end='', flush=True)
    return proc.returncode


if __name__ == '__main__':
    import sys
    sys.exit(stamp_lines(sys.argv[1:]))
