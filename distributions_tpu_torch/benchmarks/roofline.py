"""Roofline calibration of the card (benchmarks/roofline.py of the JAX
package): the rates that a kernel's operation counts and bytes divide by
to give the least time it could take.

- `vpu_rate(op)`: evaluations per second of one f32 op, from the slope of
  B2's time (`bench_kernels.roofline_chain`) between chain depths K = 1
  and K = 9, so that the load, the store and the loop do not enter.  The
  rate is a throughput at full occupancy (one element per thread, 128 Ki
  warps at the default size), not a latency.  Each chain step is
  op(renorm(y)): the rows of log, exp, log1p, rsqrt, fast_log and fast_exp
  include one add or multiply; `philox` is one Philox4x32-10 block (four
  words) with a multiply and an add.
- `mma_rate()`: tensor-core FLOP/s of B3 (`roofline_mma`, bf16 operands,
  f32 sums), and beside it `torch.matmul` on the same operands, its calls
  replayed from one CUDA graph on the card.
- `hbm_rate()`: bytes per second of B4 (`roofline_copy`, read + write),
  and beside it `torch.add(x, 1)`, both timed as calls back to back.

The library calls are yardsticks only; nothing in the port calls them.

    python -m distributions_tpu_torch.benchmarks.roofline [--json out.json]

Sizes: ROOFLINE_ROWS x ROOFLINE_WIDTH elements (4096 x 1024), ROOFLINE_T
(256), ROOFLINE_N (1024), ROOFLINE_STEPS (512), ROOFLINE_MB (512),
ROOFLINE_REPS (5).
"""

import argparse
import json

import torch

from distributions_tpu_torch import config
from distributions_tpu_torch.benchmarks.timing import (device_name, int_env,
                                                       median_ms)
from distributions_tpu_torch.ops import bench_kernels as bk

# hbm_rate times this many calls back to back
COPY_BATCH = 10

OPS = ('add', 'mul', 'fma', 'log', 'exp', 'log1p', 'rsqrt', 'fast_log',
       'fast_exp', 'philox')


def vpu_rate(op, device=None, K0=1, K1=9, rows=None, width=None, T=None,
             reps=None):
    """{'evals_per_sec': the slope-isolated rate, 'chained_per_sec': all
    evaluations at depth K1 over its time, 'ms': {K: ms}, 'midpoint': the
    time at the middle depth as a share of the way from K0 to K1 (0.5 when
    the time is linear in K)}."""
    device = config.resolve_device(device)
    rows = int_env('ROOFLINE_ROWS', 4096) if rows is None else rows
    width = int_env('ROOFLINE_WIDTH', 1024) if width is None else width
    T = int_env('ROOFLINE_T', 256) if T is None else T
    reps = int_env('ROOFLINE_REPS', 5) if reps is None else reps
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((rows, width), generator=gen, device=device).abs() + 0.5
    Km = (K0 + K1) // 2
    ms = {K: median_ms(lambda: bk.roofline_chain(x, op, T, K), reps, device)
          for K in (K0, Km, K1)}
    evals = float(rows) * width * T
    slope = (ms[K1] - ms[K0]) / (K1 - K0) / 1e3
    return {'evals_per_sec': evals / slope if slope > 0 else float('nan'),
            'chained_per_sec': evals * K1 / (ms[K1] / 1e3), 'ms': ms,
            'midpoint': (ms[Km] - ms[K0]) / (ms[K1] - ms[K0])
            if ms[K1] != ms[K0] else float('nan')}


def matmul_graph_ms(a, b, launches, reps):
    """Milliseconds of `launches` calls `torch.matmul(a, b, out=c)`
    captured in one CUDA graph, by CUDA events around its replay: what the
    card takes for the library's products, without the host's time to
    issue them one by one.  Warmed up on a side stream before the
    capture, as graph capture requires."""
    device = a.device
    c = torch.empty((a.shape[0], b.shape[1]), dtype=a.dtype, device=device)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(3):
            torch.matmul(a, b, out=c)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            torch.matmul(a, b, out=c)
    return median_ms(graph.replay, reps, device)


def mma_rate(device=None, N=None, steps=None, reps=None):
    """B3 and `torch.matmul` on [N, N] bf16 operands: 4 N^3 steps
    floating-point operations either way.  On the card the library's
    2 steps products are timed as one CUDA graph; on the CPU as a loop of
    calls."""
    device = config.resolve_device(device)
    N = int_env('ROOFLINE_N', 1024) if N is None else N
    steps = int_env('ROOFLINE_STEPS', 512) if steps is None else steps
    reps = int_env('ROOFLINE_REPS', 5) if reps is None else reps
    gen = torch.Generator(device=device).manual_seed(1)
    a, b = (torch.randn((N, N), generator=gen, device=device).to(
        torch.bfloat16) for _ in range(2))
    flops = 4.0 * N ** 3 * steps
    ms = median_ms(lambda: bk.roofline_mma(a, b, steps), reps, device)

    def library():
        for _ in range(2 * steps):
            torch.matmul(a, b)
    lib_ms = (matmul_graph_ms(a, b, 2 * steps, reps)
              if torch.device(device).type == 'cuda'
              else median_ms(library, reps, device))
    return {'flops_per_sec': flops / (ms / 1e3), 'ms': ms, 'N': N,
            'steps': steps, 'launches_per_call': 1,
            'library_flops_per_sec': flops / (lib_ms / 1e3),
            'library_ms': lib_ms}


def hbm_rate(device=None, mb=None, reps=None):
    """B4 and `torch.add(x, 1)` over `mb` MB of f32: read + write bytes per
    second."""
    device = config.resolve_device(device)
    mb = int_env('ROOFLINE_MB', 512) if mb is None else mb
    reps = int_env('ROOFLINE_REPS', 5) if reps is None else reps
    x = torch.zeros(mb * (1 << 20) // 4, dtype=torch.float32, device=device)
    nbytes = 2.0 * x.numel() * 4
    # calls of a few tenths of a ms, timed back to back (both alike)
    ms = median_ms(lambda: bk.roofline_copy(x), reps, device, COPY_BATCH)
    lib_ms = median_ms(lambda: torch.add(x, 1), reps, device, COPY_BATCH)
    return {'bytes_per_sec': nbytes / (ms / 1e3), 'ms': ms, 'mb': mb,
            'library_bytes_per_sec': nbytes / (lib_ms / 1e3),
            'library_ms': lib_ms}


def measure(device=None, ops=OPS):
    """All the rates, as one flat dict (the keys of the JAX script's JSON,
    with `mma` for `mxu`), plus `slots_<op>`: the fma rate over the
    op's rate."""
    device = config.resolve_device(device)
    results = {'device': device_name(device)}
    detail = {}
    for op in ops:
        detail[op] = vpu_rate(op, device)
        results['vpu_%s_ops_per_sec' % op] = detail[op]['evals_per_sec']
    if 'fma' in detail:
        for op in ops:
            results['slots_%s' % op] = (
                detail['fma']['evals_per_sec'] / detail[op]['evals_per_sec'])
    mma = mma_rate(device)
    results['mma_bf16_flops_per_sec'] = mma['flops_per_sec']
    results['matmul_bf16_flops_per_sec'] = mma['library_flops_per_sec']
    hbm = hbm_rate(device)
    results['hbm_bytes_per_sec'] = hbm['bytes_per_sec']
    results['hbm_torch_add_bytes_per_sec'] = hbm['library_bytes_per_sec']
    results['detail'] = dict(detail, mma=mma, hbm=hbm)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--json', default=None, help='also write the rates here')
    ap.add_argument('--device', default=None,
                    help="default: the package's default device, the card")
    args = ap.parse_args(argv)
    results = measure(args.device)
    print('device:', results['device'])
    for op in OPS:
        d = results['detail'][op]
        print('vpu %-8s slope-isolated %.3e evals/s  (chained %.3e/s, '
              '%.1f slots, midpoint %.2f)'
              % (op, d['evals_per_sec'], d['chained_per_sec'],
                 results['slots_%s' % op], d['midpoint']))
    mma, hbm = results['detail']['mma'], results['detail']['hbm']
    print('mma bf16->f32 matmul: %.3e FLOP/s  [%.2f ms]; torch.matmul '
          '%.3e FLOP/s  [%.2f ms]' % (mma['flops_per_sec'], mma['ms'],
                                      mma['library_flops_per_sec'],
                                      mma['library_ms']))
    print('hbm stream copy (r+w): %.3e B/s  [%.3f ms]; torch.add %.3e B/s  '
          '[%.3f ms]' % (hbm['bytes_per_sec'], hbm['ms'],
                         hbm['library_bytes_per_sec'], hbm['library_ms']))
    print(json.dumps({k: v for k, v in results.items() if k != 'detail'}))
    if args.json:
        with open(args.json, 'w') as fh:
            json.dump(results, fh, indent=1)
        print('wrote', args.json)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
