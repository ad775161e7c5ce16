"""The control of the comparison that decides `correct`: the plain
reference put in the program's place and computed in bfloat16, the
precision below the float32 the configurations state, on the rows and
assignments of a real run.  It has to come out as not correct.

    python3 -m gibbsbench.control --workload <cell> --seeds 1,2,3 \
        --seconds <s>

For each seed, in one process: one run of the cell as gibbsbench.run
makes it (its set-up, a window of --seconds), the program's compared
numbers, then the control's: the last tile's sampled rows drawn by the
reference in bfloat16 from the same tile-removed state, and the counts,
statistics and joint score of the result in bfloat16.  One JSON line a
seed; the benchmark's own runs never run this."""

import argparse
import json
import sys
import time

from gibbsbench import problem, reference, run


def control_numbers(keep, seed):
    """The compared numbers of the control on a run's rows and final
    assignments (`keep` as run.measure fills it)."""
    cfg, values, out, sample = (keep['config'], keep['values'],
                                keep['outputs'], keep['sample'])
    low = reference.control_outputs(
        cfg, values, out['assignments'], out['counts'].shape[0], sample,
        problem.generator(seed, 'control', 'cpu'))
    numbers, _ = reference.compare(cfg, values, low, sample)
    return numbers


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--seconds', type=float, required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('gibbsbench.control: needs a CUDA device', file=sys.stderr)
        return 2
    bench = problem.benchmark()
    cell = problem.workload(bench, args.workload)
    for seed in (int(s) for s in args.seeds.split(',')):
        keep = {}
        result, _, _ = run.measure(bench, cell, seed, args.seconds, 0,
                                   'cuda', t_start=time.perf_counter(),
                                   keep=keep)
        t = time.perf_counter()
        low = control_numbers(keep, seed)
        print(json.dumps({
            'workload': cell['name'], 'seed': seed,
            'program': {k: v['value'] for k, v in result['checks'].items()},
            'control': low, 'limits': keep['limits'],
            'program_correct': result['correct'],
            'control_correct': reference.judge(low, keep['limits'])[0],
            'control_seconds': time.perf_counter() - t,
            'info': result['info'], 'metrics': result['metrics']}),
            flush=True)
        del keep
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
