"""How many groups the JAX package's documented runner configurations
hold on the card, from the JAX runner's 7C/8 generating clusters and from
3C/4, and whether the port's runner refuses to go on.

Run from the root of the repo on a machine with a CUDA card:

    python3 chip_reference_occupancy.py

For each configuration of chip_smoke.REF_CONFIGS (bench_runner's nich2 at
1024 and 8192 slots, one nich column, the bb model; 1,048,576 rows, tiles
of 131,072, 50 sweeps a step, warm from the generating labels,
grow_headroom=0, 'gumbel') and each fraction, one JSON line: the groups
after each step, the step seconds, and the runner's RuntimeError when a
step ended with no free slot.  chip_smoke.py runs each configuration from
the fraction in REF_CONFIGS; this script is the record of why.
"""
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import chip_smoke as cs  # noqa: E402

FRACTIONS = ((7, 8), (3, 4))


def occupancy(port, model, cols, C, steps, frac):
    import torch
    spec, py, shareds, values, labels, n_true = cs.reference_problem(
        port, model, cols, C, frac)
    log = port['diagnostics'].SweepLogger()
    refused = None
    t0 = time.time()
    try:
        port['runner'].run_gibbs(
            spec, py, shareds, values, torch.Generator().manual_seed(0),
            steps * cs.REF_SPS, block=cs.REF_BLOCK, use_pallas=True,
            sampling='gumbel', initial_assignments=labels, grow_headroom=0.0,
            sweeps_per_step=cs.REF_SPS, log=log)
    except RuntimeError as e:
        # the runner's documented refusal: a step ended with no free slot
        refused = str(e)
    torch.cuda.synchronize()
    return {'model': model, 'cols': cols, 'slots': C, 'fraction': frac,
            'generating_clusters': n_true,
            'groups_after_each_step': [r['nonempty_groups']
                                       for r in log.rows],
            'step_seconds': [r['seconds'] for r in log.rows],
            'refused': refused, 'seconds': round(time.time() - t0, 2)}


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_reference_occupancy.py: no CUDA device', file=sys.stderr)
        return 2
    from distributions_tpu_torch import diagnostics
    from distributions_tpu_torch.benchmarks import bench_runner
    from distributions_tpu_torch.inference import runner
    port = {'diagnostics': diagnostics, 'runner': runner,
            'bench_runner': bench_runner}
    print('nvidia-smi: %s' % cs.smi(), flush=True)
    for name, model, cols, C, steps, _ in cs.REF_CONFIGS:
        for frac in FRACTIONS:
            print(json.dumps(dict(occupancy(port, model, cols, C, steps,
                                            frac), config=name)),
                  flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
