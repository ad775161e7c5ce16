"""Observability (distributions_tpu.diagnostics): per-sweep summaries of a
mixture state, cross-chain convergence statistics, a profiler trace
context, and a structured sweep logger."""

import contextlib
import os
import time

import numpy as np


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
