"""Observability (distributions_tpu.diagnostics): per-sweep summaries of a
mixture state, cross-chain convergence statistics, a profiler trace
context, a structured sweep logger, and the named host spans of the
runner's steps.

How an operator reads a run:
- The step rows: `run_gibbs` returns its `SweepLogger`, one row a step;
  `logger.save(filename)` writes them as a json stream.  Each row holds
  `seconds` (the step's sweeps up to its counts sync, time.perf_counter)
  and `host_ms`, the step's host time in ms by span name, each span's own
  time less that of the spans inside it.  On the card a fused or graphed
  step adds `device_ms` (CUDA events on the stream: `load`, `sweeps` a
  sweep, `score`, and `edge`, the device time from the previous step's
  last event to this one's first), `tile_ms` (tile 0's phases in the
  step's last sweep: `remove`, `inputs`, `kernel`, `sums`, `add`,
  `write`, the end-of-sweep `state_copy` and the whole `sweep`; with niw
  blocks also `niw_coeffs`, the niw coefficients inside `inputs`) and, in
  a step that captured its graph, `captured: true`.
- The span totals: `ops.gibbs.reset_graph_stats()` returns the process's
  table of graph counters, whose `spans` entry holds each span name's
  `count`, `seconds` and `self_seconds` since the table was last reset.
- A timeline: `with diagnostics.trace(logdir):` writes a Chrome trace in
  which the runner's spans (`SPAN_NAMES`) are host operators around the
  operators they ran; while a profiler records, each span enters a
  profiler range (`_record_function`), and otherwise none."""

import collections
import contextlib
import functools
import os
import threading
import time

import numpy as np
import torch


def sweep_stats(spec, cl_model, shareds, state, counts=None, score=None):
    """Summary dict of a mixture state (host-side scalars).

    counts: optional host copy of state.counts.  score: an already
    computed joint-score scalar tensor (the fused sweeps compute it at the
    end of a step)."""
    from distributions_tpu_torch import mixture as mx
    if counts is None:
        counts = state.counts.cpu().numpy()
    counts = np.asarray(counts)
    row = {
        'sample_size': int(counts.sum()),
        'nonempty_groups': int((counts > 0).sum()),
        'alive_groups': int(state.alive.sum()),
        'largest_group': int(counts.max()),
    }
    if score is None:
        score = mx.score_data(spec, cl_model, shareds, state)
    row['score_data'] = float(score)
    return row


def rhat(chains):
    """Split-R-hat over a [n_chains, n_samples] scalar trace."""
    x = np.asarray(chains, np.float64)
    n_chains, n = x.shape
    half = n // 2
    x = np.concatenate([x[:, :half], x[:, half:2 * half]], axis=0)
    m, n = x.shape
    chain_means = x.mean(axis=1)
    chain_vars = x.var(axis=1, ddof=1)
    W = chain_vars.mean()
    B = n * chain_means.var(ddof=1)
    var_plus = (n - 1) / n * W + B / n
    return float(np.sqrt(var_plus / W)) if W > 0 else float('inf')


def ess(chain):
    """Effective sample size of a scalar [n_samples] trace via initial
    positive autocorrelation sums (Geyer)."""
    x = np.asarray(chain, np.float64)
    n = x.size
    x = x - x.mean()
    acov = np.correlate(x, x, mode='full')[n - 1:] / n
    if acov[0] == 0:
        return float(n)
    rho = acov / acov[0]
    total = 0.0
    for t in range(1, n - 2, 2):
        pair = rho[t] + rho[t + 1]
        if pair < 0:
            break
        total += pair
    return float(n / (1.0 + 2.0 * total))


@contextlib.contextmanager
def trace(logdir):
    """Profile everything inside the context with `torch.profiler` (CPU
    activity, and CUDA activity when a card is there) and write a Chrome
    trace JSON, `trace.json`, into `logdir` (view it in Perfetto or
    chrome://tracing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    t0 = time.time()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))
    print('trace written to {} ({:.2f}s)'.format(logdir, time.time() - t0))


# the keys of a runner's row that follow the clocks, or whether the step ran
# from a graph: two runs of one chain agree on all the others
CLOCK_KEYS = ('time', 'seconds', 'host_ms', 'device_ms', 'tile_ms',
              'captured')


class SweepLogger(object):
    """Minimal structured per-sweep logger: collects dict rows and dumps
    them to a json-stream file (io.stream) for offline analysis."""

    def __init__(self):
        self.rows = []

    def log(self, sweep, **fields):
        row = {'sweep': int(sweep), 'time': time.time()}
        row.update(fields)
        self.rows.append(row)
        return row

    def save(self, filename):
        from distributions_tpu_torch.io.stream import json_stream_dump
        json_stream_dump(self.rows, filename)


# The names a span may take: the runner's call and its set-up (placement,
# init or resume, the state build); a step and its parts (the sweeps, the
# host copy of the counts that syncs the step, and the host work between
# steps); and inside `runner.sweeps` the graph path's load of its buffers,
# its captures, the launch of a step's replays and the score replay.
SPAN_NAMES = (
    'runner.call', 'runner.setup',
    'runner.step', 'runner.growth', 'runner.stat_cache', 'runner.sweeps',
    'runner.counts_sync', 'runner.validate', 'runner.sweep_stats',
    'runner.hypers', 'runner.checkpoint',
    'graph.load', 'graph.capture', 'graph.replays', 'graph.score')
# spans kept in the ring (`SPAN_RING`): (name, start ns, end ns, parent
# name or None, step), on time.perf_counter_ns
RING_SIZE = 4096
SPAN_RING = collections.deque(maxlen=RING_SIZE)
# {name: {'count', 'seconds', 'self_seconds'}} over the process, since the
# last `reset_spans()` (ops.gibbs.GRAPH_STATS['spans'])
SPAN_TOTALS = {}
_OPEN = threading.local()


class span(object):
    """`with diagnostics.span(name) as s:` times the block as the span
    `name` (one of SPAN_NAMES): its start and end on time.perf_counter_ns,
    the span it opened inside and the step it belongs to go into
    SPAN_RING, and its count, duration and self time (the duration less
    that of the spans opened directly inside it) into SPAN_TOTALS.
    `step` (the step's first sweep index in the runner) names the step for
    this span and the spans inside it, which inherit it otherwise.  After
    the block, `s.seconds` is its duration; `s.self_ms` ({name: ms}) sums
    the self times of the spans closed inside a span opened with `step`,
    and its own once it closes.  While a torch profiler records, the span
    also enters `_record_function(name)`."""

    __slots__ = ('name', 'step', 'parent', 'self_ms', 'start', 'end',
                 'child_ns', '_record')

    def __init__(self, name, step=None):
        if name not in SPAN_NAMES:
            raise ValueError('not a span name: %r' % (name,))
        self.name, self.step = name, step

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        if self.step is not None:
            self.self_ms = {}
        elif self.parent is not None:
            self.step, self.self_ms = self.parent.step, self.parent.self_ms
        else:
            self.self_ms = None
        self.child_ns = 0
        self._record = None
        if torch.autograd._profiler_enabled():
            self._record = _record_function(self.name)
            self._record.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        _stack().pop()
        if self._record is not None:
            self._record.__exit__(*exc)
        ns = self.end - self.start
        own = ns - self.child_ns
        if self.parent is not None:
            self.parent.child_ns += ns
        total = SPAN_TOTALS.get(self.name)
        if total is None:
            total = SPAN_TOTALS[self.name] = {
                'count': 0, 'seconds': 0.0, 'self_seconds': 0.0}
        total['count'] += 1
        total['seconds'] += ns / 1e9
        total['self_seconds'] += own / 1e9
        if self.self_ms is not None:
            self.self_ms[self.name] = self.self_ms.get(self.name, 0.0) \
                + own / 1e6
        SPAN_RING.append((self.name, self.start, self.end,
                          None if self.parent is None else self.parent.name,
                          self.step))
        return False

    @property
    def seconds(self):
        return (self.end - self.start) / 1e9


def _record_function(name):
    """A profiler range `name` that the trace shows as a host operator.
    `torch.profiler.record_function` makes a user annotation instead,
    which the profiler also lays over the device's timeline as a device
    event as long as the kernels launched inside it: device time that no
    kernel spent, and no idle gap left between the kernels."""
    return torch._C._profiler._RecordFunctionFast(name)


def _stack():
    stack = getattr(_OPEN, 'stack', None)
    if stack is None:
        stack = _OPEN.stack = []
    return stack


def spanned(name):
    """Decorator: each call of the function is the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def reset_spans():
    """Empty SPAN_TOTALS and SPAN_RING."""
    SPAN_TOTALS.clear()
    SPAN_RING.clear()
