"""Does torch.profiler see every kernel of replayed CUDA-graph sweeps?

Run from the root of the repo on a machine with a CUDA card:

    REPS=110 MAINS=2 python3 chip_profile_window.py

It builds K1 and K2, captures the graph of one niw2mix sweep at
chip_smoke.py's full width (1,048,576 rows x 1024 slots, 16 tiles), and
profiles a call of 5 replayed sweeps REPS times in two ways, in turns:

  unpadded  the profiler's window opened just before the call and closed as
            soon as the card has synchronised after it;
  padded    chip_smoke.profile_sweep, whose window opens and closes
            chip_smoke.PROFILE_PAD_SECONDS away from the call.

Each line of chiprun_out/profile_window.log is one profile: the count of
score + sample kernels (K2's `split_score_sample`) the profiler saw against
5 x 16, and for the unpadded ones the count of device events and where the
first and last K2 launch stand among them.  The first three short and the
first three whole unpadded profiles are written out event by event
(chiprun_out/profile_window_{short,whole}N.json: name, 'cpu' or 'dev',
start and end in us).  Then chip_smoke.run_main, whose last step is
profiled the padded way, runs MAINS times on the same problem.
"""
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import chip_smoke as cs  # noqa: E402

OUT_DIR = os.path.join(HERE, 'chiprun_out')
REPS = int(os.environ.get('REPS', '40'))
MAINS = int(os.environ.get('MAINS', '2'))
SWEEPS = 5
DUMPS = 3


def out(log, obj):
    line = json.dumps(obj)
    print(line, flush=True)
    log.write(line + '\n')
    log.flush()


def dump(prof, tag):
    from torch.autograd import DeviceType
    rows = [[e.name[:40],
             'cpu' if e.device_type == DeviceType.CPU else 'dev',
             e.time_range.start, e.time_range.end]
            for e in sorted(prof.events(), key=lambda e: e.time_range.start)
            if e.device_type != DeviceType.CPU or 'cuda' in e.name]
    with open(os.path.join(OUT_DIR, 'profile_window_%s.json' % tag),
              'w') as f:
        json.dump(rows, f)


def unpadded(sweep, kname, dumped):
    """One profile of sweep() with the window closed as soon as the card
    has synchronised."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sweep()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events()
                 if e.device_type != DeviceType.CPU),
                key=lambda e: e.time_range.start)
    ks = [i for i, e in enumerate(ev) if 'split_score_sample' in e.name]
    res = {'kernel_calls': cs.device_profile(
               prof, 1.0, ('split_score_sample', kname)).get('kernel_calls'),
           'device_events': len(ev)}
    if ks:
        res.update(first_k_index=ks[0], last_k_from_end=len(ev) - 1 - ks[-1])
    tag = 'whole' if len(ks) == SWEEPS * 16 else 'short'
    if dumped[tag] < DUMPS:
        dumped[tag] += 1
        dump(prof, '%s%d' % (tag, dumped[tag]))
    return res


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_profile_window.py: no CUDA device', file=sys.stderr)
        return 2
    from distributions_tpu_torch import (clustering, config, diagnostics,
                                         mixture, random, testing)
    from distributions_tpu_torch.inference import runner
    from distributions_tpu_torch.models import MODULES, base, nich
    from distributions_tpu_torch.ops import fused_kernels, gibbs
    port = {'cl': clustering, 'config': config, 'diagnostics': diagnostics,
            'mx': mixture, 'random': random, 'testing': testing,
            'runner': runner, 'base': base, 'nich': nich, 'models': MODULES,
            'fk': fused_kernels, 'gibbs': gibbs}
    os.makedirs(OUT_DIR, exist_ok=True)
    log = open(os.path.join(OUT_DIR, 'profile_window.log'), 'w')
    out(log, {'nvidia_smi': cs.smi(), 'torch': torch.__version__,
              'cuda': torch.version.cuda, 'reps': REPS,
              'pad_seconds': cs.PROFILE_PAD_SECONDS})
    fused_kernels.build('fused_v2')
    fused_kernels.build('fused_v3')
    X, labels = cs.flagship_data()
    mixed = testing.mixed_problem(cs.ROWS, cs.SLOTS, seed=0, kind='niw2mix',
                                  n_clusters=cs.TRUE_CLUSTERS)
    (spec, py, shareds, values, an, block, _,
     kname) = cs.graph_problems(port, X, labels, mixed)['niw2mix']
    tiles = cs.ROWS // block
    state = mixture.state_from_assignments(spec, py, shareds, values, an)
    cache = gibbs.build_stat_cache(spec, shareds, values, block, an)
    gen = torch.Generator().manual_seed(3)

    def call():
        return gibbs.sweep_blocked_pallas_fused_mixed(
            spec, py, shareds, state, values, an, block, 2048, gen, cache,
            sampling='gumbel', n_sweeps=SWEEPS)
    # the key's first call runs eagerly, the second captures
    call()
    call()
    torch.cuda.synchronize()
    want = SWEEPS * tiles
    dumped = {'whole': 0, 'short': 0}
    totals = {'unpadded': [0, 0], 'padded': [0, 0]}
    for rep in range(REPS):
        for way in ('unpadded', 'padded'):
            if way == 'unpadded':
                res = unpadded(call, kname, dumped)
            else:
                p = cs.profile_sweep(call, ('split_score_sample', kname))
                res = {'kernel_calls': p.get('kernel_calls'),
                       'device_busy_share': p.get('device_busy_share')}
            seen = (res['kernel_calls'] or {}).get('split_score_sample')
            totals[way][0] += 1
            totals[way][1] += seen != want
            out(log, dict(res, way=way, rep=rep, want=want,
                          whole=seen == want))
    out(log, {'short_profiles': {k: '%d of %d' % (v[1], v[0])
                                 for k, v in totals.items()}})
    mspec, mpy, mshareds = testing.build_problem(
        mixed, MODULES, mixture.make_spec, clustering.PitmanYor.from_dict)
    for rep in range(MAINS):
        try:
            main = cs.run_main(
                port, fused_kernels.fused_mixed_score_sample_stats, mspec,
                mpy, mshareds, mixed['values'], mixed['labels'],
                cs.BLOCK_MIXED)[3]
            out(log, {'run_main': rep, 'whole': True,
                      'kernel_calls': main['last_step_profile'].get(
                          'kernel_calls'),
                      'ms_per_sweep': main['ms_per_sweep']})
        except AssertionError as e:
            out(log, {'run_main': rep, 'whole': False, 'error': str(e)})
    return 0


if __name__ == '__main__':
    sys.exit(main())
