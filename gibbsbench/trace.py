"""The traced run's profiler window and its reading.

The window opens after the card has gone idle, a pad away from the
profiled work, and closes a pad after it: a window closed right after the
work can lose its last kernels, and the card's timestamps can run a few
percent fast against the host's, so the closing pad grows with the work
(max(0.1 s, a quarter of the profiled wall)).

Kernel names are a frozen list: the slot-split score + draw kernels of K1
and K2 (csrc/fused_split.cuh; the sequential walks of csrc/fused_v2.cu and
csrc/fused_v3.cu beside them) and their stat stage (csrc/fused_stats.cuh).
A kernel that a later change renames counts as bookkeeping."""

import bisect
import time

import numpy as np
import torch

SPLIT_KERNELS = ('split_score_sample', 'fused_v2_score_sample',
                 'fused_v3_score_sample')
STAT_KERNELS = ('stat_partials', 'stat_reduce')
PAD_SECONDS = 0.1
PAD_SHARE = 0.25
# idle gaps shorter than this are summed under one label, not looked up
GAP_LOOKUP_US = 20.0
TOP = 10


def pad(wall_seconds):
    return max(PAD_SECONDS, PAD_SHARE * wall_seconds)


def _sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


class Window:
    """A torch.profiler window over the work between start() and stop()."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t0 = None
        self.wall_s = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.device(self.device).type == 'cuda':
            activities.append(ProfilerActivity.CUDA)
        _sync(self.device)
        self.prof = profile(activities=activities)
        self.prof.start()
        time.sleep(PAD_SECONDS)
        self.t0 = time.perf_counter()

    def stop(self):
        _sync(self.device)
        self.wall_s = time.perf_counter() - self.t0
        time.sleep(pad(self.wall_s))
        self.prof.stop()


def _union(intervals):
    """Merged [start, end] intervals of sorted (start, end) pairs."""
    merged = []
    for a, b in intervals:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _label_gaps(gaps, cpu):
    """Seconds of idle device time by what the host ran then: the
    innermost host operation around each gap's middle."""
    out = {}
    if cpu:
        cpu.sort()
        starts = np.array([c[0] for c in cpu])
        ends = np.array([c[1] for c in cpu])
    for a, b in gaps:
        us = b - a
        if us < GAP_LOOKUP_US:
            label = 'between kernels (< %g us)' % GAP_LOOKUP_US
        else:
            mid = 0.5 * (a + b)
            label = 'host: no operation'
            if cpu:
                hi = bisect.bisect_right(starts, mid)
                inside = np.nonzero(ends[:hi] >= mid)[0]
                if inside.size:
                    spans = ends[inside] - starts[inside]
                    label = 'host: ' + cpu[inside[np.argmin(spans)]][2]
        out[label] = out.get(label, 0.0) + us / 1e6
    return out


def read(window):
    """The closed window's device time by kernel family, busy seconds (the
    union of the device's operations), the top device operations and the
    idle gaps by host activity.  None when the device ran nothing (a
    profile on the CPU)."""
    from torch.autograd import DeviceType
    dev, cpu = [], []
    for e in window.prof.events():
        span = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CPU:
            cpu.append(span + (e.name[:80],))
        elif span[1] > span[0]:
            dev.append(span + (e.name,))
    if not dev:
        return None
    by_name = {}
    split_launches = 0
    for a, b, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3
        if any(k in name for k in SPLIT_KERNELS):
            split_launches += 1
    total_ms = sum(by_name.values())
    split_ms = sum(ms for n, ms in by_name.items()
                   if any(k in n for k in SPLIT_KERNELS))
    stat_ms = sum(ms for n, ms in by_name.items()
                  if any(k in n for k in STAT_KERNELS))
    dev.sort()
    busy = _union([(a, b) for a, b, _ in dev])
    busy_s = sum(b - a for a, b in busy) / 1e6
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    idle = sorted(_label_gaps(gaps, cpu).items(), key=lambda kv: -kv[1])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {'device_ms': total_ms, 'split_ms': split_ms, 'stat_ms': stat_ms,
            'split_launches': split_launches, 'busy_s': busy_s,
            'wall_s': window.wall_s,
            'span_s': (busy[-1][1] - busy[0][0]) / 1e6,
            'device_ops': [[n[:120], ms / 1e3] for n, ms in ops[:TOP]],
            'idle_gaps': [[n, s] for n, s in idle[:TOP]]}
