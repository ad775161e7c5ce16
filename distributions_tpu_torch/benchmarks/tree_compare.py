"""Two trees of this repository on one card: the fused kernels K1, K2, K3,
K1's phases B5 and the v1 kernels K4 and K5 at the main path's shapes in
every sampling mode, held to each other bit for bit, with their times,
the runner's ms per sweep and the v1 sweeps' ms per sweep.

    python -m distributions_tpu_torch.benchmarks.tree_compare OLD [NEW]

OLD and NEW are checkouts (a `git archive` of a commit unpacked somewhere
will do); NEW defaults to this one.  The inputs are made once, on the CPU,
by this checkout: one nich2 tile of 131,072 rows x 1024 slots (K1, B5,
K4), one niw2mix tile of 65,536 x 1024 (K2, and K3 on its four shards of
256 slots), nichbbddgp and bbddgp tiles of 65,536 x 1024 (K5), and the
same sizes off the main path (WIDE_K1: nich tiles of one block of 3 or 4
columns and of blocks (2, 3); WIDE_K2: niw d = 3 + nich + bb and niw d =
4; WIDE_K4: nich tiles of one block of 1, 3, 4 and 8 columns, the last on
the wide shape; WIDE_K5: the mixed layouts nich_gp_bb, dd_bb, dpd_nich and
bnb; K5_RANDOM: random inputs of 3 nich and 5 table columns, on the wide
shape); the '_host' noise is drawn on the card from a seeded generator.
Then four processes run in turn, OLD, NEW, NEW, OLD, each importing the
package of its own tree and building its kernels from its own sources:

- every output of K1 and K2 in 'argmax', 'gumbel', 'gumbel_host', 'cdf',
  'cdf_host' and their '_fast' forms (draws and every stat sum; the stat
  sums are hashed apart, bitwise within a tree, and held across the trees
  within rtol 1e-5 / atol 1e-3, count tables exactly, since a redesigned
  stat stage may sum in another order), of K3 in
  'argmax', 'gumbel', 'gumbel_host' and their '_fast' forms on each shard
  (draws and best scores), of B5's 'noop', 'score_max', 'score_bits' and
  'score_<mode>' phases, and of K4, K5 and B1 (2048 rows of random
  scores, 4 iterations) in 'argmax', 'gumbel' and 'gumbel_host', each as a
  SHA-256 of its bytes; off the main path, K1 and K2 in WIDE_MODES, B5's
  phases, K3's 'argmax', 'gumbel' and 'gumbel_host' on each shard, and K4
  and K5 in those three modes;
- median CUDA-event milliseconds of K1, K2, K3 (shard 0), K4 and K5 in
  'gumbel' and of every B5 phase named above in 'gumbel', on the main
  path's layouts and off them; the device milliseconds a launch of K1's
  and K2's stat stage by the profiler (the kernels of the stage inside a
  K1 / K2 launch, STAT_KERNELS) at STAT_ROWS rows of the nich2 and
  niw2mix tiles;
- benchmarks.bench_runner at each model of TREE_COMPARE_RUNNER (a comma
  list, default 'nich,niw2mix': the `main` and `main_mixed` runner
  configurations; RUNNER_* from the environment; empty for none), and the
  v1 sweeps of chip_smoke.py's `paths_v1` (gibbs.sweep_blocked_pallas on
  nich2 and sweep_blocked_pallas_mixed on nichbbddgp, 1,048,576 rows x
  1024 slots, V1_SWEEPS sweeps after one to warm up).

Prints one JSON line per process, then one with the verdict: for each
output whether all four runs agree, each tree's times (two runs each) and
ms per sweep.  Exits 1 when an output differs (a stat sum: beyond its
tolerance across the trees, or at all within one).  Needs one card.
"""

import hashlib
import json
import os
import subprocess
import sys
import time

K1_ROWS, K2_ROWS, SLOTS, SHARDS = 131072, 65536, 1024, 4
MODES = ('argmax', 'gumbel', 'gumbel_host', 'cdf', 'cdf_host')
ALL_MODES = MODES + tuple(m + '_fast' for m in MODES)
PAIR_MODES = ('argmax', 'gumbel', 'gumbel_host', 'argmax_fast',
              'gumbel_fast', 'gumbel_host_fast')
# K4, K5 and B1 (which share the draw code of csrc/fused_common.cuh)
V1_MODES = ('argmax', 'gumbel', 'gumbel_host')
B1_ROWS = 2048
PHASES = ('noop', 'score_max', 'score_bits')
TIMED_PHASES = PHASES + ('score_gumbel', 'full_gumbel')
# layouts off the main path, each kernel timed and hashed on them too: K1
# on one block of 3 or 4 nich columns and on two blocks (2, 3); K2 (and K3
# on shard 0) on niw d = 3 + nich + bb and on niw d = 4 (the wide shape)
WIDE_K1 = ((3,), (4,), (2, 3))
WIDE_K2 = ('niw3_nich_bb', 'niw4')
WIDE_MODES = ('argmax', 'gumbel', 'gumbel_host', 'cdf')
# K4 on one nich block of 1, 3, 4 (exact shapes) and 8 columns (the wide
# shape); K5 on the mixed layouts beside the main path's, and on random
# inputs of (nich columns, table columns, V) = K5_RANDOM (the wide shape)
WIDE_K4 = ((1,), (3,), (4,), (8,))
WIDE_K5 = ('nich_gp_bb', 'dd_bb', 'dpd_nich', 'bnb')
K5_RANDOM = (3, 5, 6)
V1_KINDS = ('nichbbddgp', 'bbddgp')
V1_ROWS = 1048576
V1_SWEEPS = 3
# the stat stage of K1 and K2 (its rounding order may differ between the
# trees: float sums are held to each other within SUM_RTOL / SUM_ATOL,
# count tables exactly, and each tree's two runs bitwise), timed at these
# rows of the nich2 and niw2mix tiles by the profiler's device time
STAT_ROWS = (16384, 65536, 131072)
STAT_KERNELS = ('stat_partials', 'stat_reduce')
STAT_REPS = 20
SUM_RTOL, SUM_ATOL = 1e-5, 1e-3
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def make_inputs(path):
    """The kernels' inputs, made on the CPU by this checkout's package,
    saved to `path`."""
    import torch
    from distributions_tpu_torch import testing
    d = main_path_inputs(kinds=('niw2mix',) + V1_KINDS + WIDE_K2 + WIDE_K5)
    d['niw2mix %d' % STAT_ROWS[-1]] = mixed_tile_inputs('niw2mix',
                                                        STAT_ROWS[-1])
    for groups in WIDE_K1 + WIDE_K4:
        if 'k1 %s' % (groups,) not in d:
            d['k1 %s' % (groups,)] = nich_tile_inputs(groups)
    d['k5 random'] = dict(zip(
        ('values', 'table_idx', 'cl_scores', 'v1_coeffs', 'v1_tables'),
        testing.v1_random_inputs(K2_ROWS, SLOTS, *K5_RANDOM, seed=3)))
    torch.save(d, path)


def nich_tile_inputs(groups=(2,), rows=K1_ROWS, slots=SLOTS):
    """A K1 tile on the CPU (values, cl_scores, coeffs, col_groups;
    v1_coeffs for one block): `rows` rows of blobs in sum(groups)
    dimensions around 7/8 of `slots` centres, one nich block of
    {mu 0, kappa 0.1, sigmasq 0.01, nu 1} per group, its state from the
    generating labels."""
    import numpy as np
    import torch
    from distributions_tpu_torch import clustering as cl, mixture as mx
    from distributions_tpu_torch.models import nich
    from distributions_tpu_torch.ops import fused_kernels as fk
    cpu = torch.device('cpu')
    rng = np.random.RandomState(0)
    n_true = slots // 8 * 7
    F = sum(groups)
    labels = rng.randint(0, n_true, rows)
    centers = rng.randn(n_true, F).astype(np.float32)
    values = torch.from_numpy(
        (centers[labels] + 0.1 * rng.randn(rows, F)).astype(np.float32))
    spec = mx.make_spec([(nich, c) for c in groups], capacity=slots)
    shareds = tuple(nich.shared_from_dict(
        {'mu': 0., 'kappa': 0.1, 'sigmasq': 0.01, 'nu': 1.}, device=cpu)
        for _ in groups)
    py = cl.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.1}, device=cpu)
    cuts = np.cumsum((0,) + tuple(groups))
    state = mx.state_from_assignments(
        spec, py, shareds,
        tuple(values[:, a:b].contiguous() for a, b in zip(cuts, cuts[1:])),
        torch.from_numpy(labels))
    out = dict(values=values,
               cl_scores=cl.score_value(py, state.counts, state.alive,
                                        state.sample_size),
               coeffs=torch.cat([fk.nich_coeffs_v2(shareds[i],
                                                   state.groups[i])
                                 for i in range(len(groups))]).contiguous(),
               col_groups=tuple(groups))
    if len(groups) == 1:
        out['v1_coeffs'] = fk.nich_coeffs(shareds[0],
                                          state.groups[0]).contiguous()
    return out


def main_path_inputs(kinds=('niw2mix',)):
    """K1's nich2 tile ('k1': values, cl_scores, coeffs, v1_coeffs) and
    K2's tile of each mixed layout in `kinds` (its arguments by name; K5's
    v1_coeffs and v1_tables too where it has no niw block), on the
    CPU."""
    import torch
    from distributions_tpu_torch import clustering as cl, mixture as mx
    from distributions_tpu_torch import testing
    from distributions_tpu_torch.models import MODULES
    from distributions_tpu_torch.ops import gibbs
    out = {'k1': nich_tile_inputs((2,))}
    for kind in kinds:
        out[kind] = mixed_tile_inputs(kind)
    return out


def mixed_tile_inputs(kind, rows=K2_ROWS, slots=SLOTS):
    """K2's tile of `rows` rows of the mixed layout `kind` against the state
    of its rows in `slots` slots, on the CPU: its arguments by name, and
    K5's v1_coeffs and v1_tables where it has no niw block."""
    import torch
    from distributions_tpu_torch import clustering as cl, mixture as mx
    from distributions_tpu_torch import testing
    from distributions_tpu_torch.models import MODULES
    from distributions_tpu_torch.ops import gibbs
    cpu = torch.device('cpu')
    problem = testing.mixed_problem(rows, slots, seed=0, kind=kind,
                                    n_clusters=slots // 8 * 7)
    spec, py, shareds = testing.build_problem(
        problem, MODULES, mx.make_spec, cl.PitmanYor.from_dict, device=cpu)
    vals = tuple(torch.from_numpy(v) for v in problem['values'])
    state = mx.state_from_assignments(
        spec, py, shareds, vals, torch.from_numpy(problem['labels']))
    lay = gibbs._mixed_static_layout(spec, vals)
    coeffs, qcoeffs, tables = gibbs._build_fused_inputs(spec, lay, shareds,
                                                        state)
    out = dict(
        values=lay.nich_vals, table_idx=lay.table_idx,
        cl_scores=cl.score_value(py, state.counts, state.alive,
                                 state.sample_size),
        coeffs=coeffs, tables=tables, qvalues=lay.quad_vals,
        qcoeffs=qcoeffs,
        col_groups=tuple(spec.blocks[i].cols for i in lay.nich_blocks),
        quad_groups=tuple(lay.quad_groups), table_vs=tuple(lay.table_vs))
    if not lay.quad_groups:
        out['v1_coeffs'], out['v1_tables'] = gibbs._build_v1_inputs(
            spec, lay, shareds, state)
    return out


def digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:24]


def v1_sweeps(dev):
    """ms per sweep (CUDA events over V1_SWEEPS sweeps, after one to warm
    up) of gibbs.sweep_blocked_pallas (K4) on nich2 and
    gibbs.sweep_blocked_pallas_mixed (K5) on nichbbddgp, V1_ROWS rows x
    SLOTS slots from the generating labels: chip_smoke.py's `paths_v1`."""
    import numpy as np
    import torch
    from distributions_tpu_torch import clustering as cl, mixture as mx
    from distributions_tpu_torch import testing
    from distributions_tpu_torch.models import MODULES, nich
    from distributions_tpu_torch.ops import gibbs

    def ms_per_sweep(sweep, state, assignments):
        sweep(state, assignments)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(V1_SWEEPS):
            state, assignments = sweep(state, assignments)
        b.record()
        torch.cuda.synchronize(dev)
        return a.elapsed_time(b) / V1_SWEEPS

    n_true = SLOTS // 8 * 7
    rng = np.random.RandomState(0)
    labels = rng.randint(0, n_true, V1_ROWS)
    centers = rng.randn(n_true, 2).astype(np.float32)
    X = centers[labels] + 0.1 * rng.randn(V1_ROWS, 2).astype(np.float32)
    spec = mx.make_spec([(nich, 2)], capacity=SLOTS)
    shareds = (nich.shared_from_dict(
        {'mu': 0., 'kappa': 0.1, 'sigmasq': 0.01, 'nu': 1.}, device=dev),)
    py = cl.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.1}, device=dev)
    values = (torch.as_tensor(X, device=dev),)
    a0 = torch.as_tensor(labels, device=dev)
    gen = torch.Generator().manual_seed(2)
    out = {'nich2': ms_per_sweep(
        lambda st, an: gibbs.sweep_blocked_pallas(
            spec, py, shareds, st, values, an, K1_ROWS, generator=gen),
        mx.state_from_assignments(spec, py, shareds, values, a0), a0)}
    problem = testing.mixed_problem(V1_ROWS, SLOTS, seed=0,
                                    kind='nichbbddgp', n_clusters=n_true)
    spec, py, shareds = testing.build_problem(
        problem, MODULES, mx.make_spec, cl.PitmanYor.from_dict, device=dev)
    values = tuple(torch.as_tensor(v, device=dev) for v in problem['values'])
    a0 = torch.as_tensor(problem['labels'], device=dev)
    supports = gibbs._block_supports(spec, values)
    out['nichbbddgp'] = ms_per_sweep(
        lambda st, an: gibbs.sweep_blocked_pallas_mixed(
            spec, py, shareds, st, values, an, K2_ROWS, gen,
            supports=supports),
        mx.state_from_assignments(spec, py, shareds, values, a0), a0)
    return out


def stat_stage_ms(call):
    """Device milliseconds a call of the stat stage that `call` (a K1 or
    K2 launch) runs after its draw: the profiler's device time of the
    kernels named STAT_KERNELS (the parent's fused_v2_stat_partials ...
    too) over STAT_REPS calls, the window opened and closed 0.1 s away
    from the work."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.1)
        for _ in range(STAT_REPS):
            call()
        torch.cuda.synchronize()
        time.sleep(0.1)
    us = sum(getattr(e, 'self_device_time_total',
                     getattr(e, 'self_cuda_time_total', 0))
             for e in prof.key_averages()
             if any(name in e.key for name in STAT_KERNELS))
    return us / 1e3 / STAT_REPS


def sums_agree(old, new, key):
    """The stat sums of one K1 or K2 output of two trees: float sums
    within SUM_RTOL / SUM_ATOL, K2's count tables (its second output)
    exactly."""
    import torch
    for i, (a, b) in enumerate(zip(old, new)):
        if a.shape != b.shape:
            return False
        exact = key.startswith('K2') and i == 1
        if not (torch.equal(a, b) if exact else
                torch.allclose(a, b, rtol=SUM_RTOL, atol=SUM_ATOL)):
            return False
    return True


def worker(tree, inputs, out):
    """One tree's run; writes its JSON to `out`."""
    import torch
    from distributions_tpu_torch.benchmarks import bench_runner
    from distributions_tpu_torch.benchmarks.timing import median_ms
    from distributions_tpu_torch.ops import bench_kernels as bk
    from distributions_tpu_torch.ops import fused_kernels as fk
    dev = torch.device('cuda')
    t0 = time.time()
    fk.build_all()
    build_s = time.time() - t0
    d = torch.load(inputs)

    def on_card(t):
        return {k: (v.to(dev) if isinstance(v, torch.Tensor) else v)
                for k, v in t.items()}
    k1 = on_card(d['k1'])
    k1_wide = {groups: on_card(d['k1 %s' % (groups,)]) for groups in WIDE_K1}
    gen = torch.Generator(device=dev).manual_seed(11)

    def noise(B, C):
        u = torch.rand((B, C), generator=gen, device=dev)
        return {'gumbel_host': -torch.log(-torch.log(u.clamp_min(1e-30))),
                'cdf_host': torch.rand((B, 1), generator=gen, device=dev)}
    n1, n2 = noise(K1_ROWS, SLOTS), noise(K2_ROWS, SLOTS)

    def nz(table, mode):
        return table.get(mode.replace('_fast', ''))

    def mixed_args(t):
        return ((t['values'], t['table_idx'], t['cl_scores'], t['coeffs'],
                 torch.clamp(t['tables'], min=-1e30)
                 if t['tables'] is not None else None, t['col_groups']),
                dict(qvalues=t['qvalues'], qcoeffs=t['qcoeffs'],
                     quad_groups=t['quad_groups'], table_vs=t['table_vs']))
    mixed = {kind: mixed_args(on_card(d[kind]))
             for kind in ('niw2mix',) + WIDE_K2}
    CL = SLOTS // SHARDS

    def shard(kind, a):
        args, kwargs = mixed[kind]

        def cut(x):
            return None if x is None else x[:, a:a + CL].contiguous()
        return ((args[0], args[1], args[2][a:a + CL].contiguous(),
                 cut(args[3]), cut(args[4]), args[5]),
                dict(kwargs, qcoeffs=cut(kwargs['qcoeffs']), slot_offset=a,
                     total_slots=SLOTS))

    def k1_args(t):
        return (t['values'], t['cl_scores'], t['coeffs'], t['col_groups'])

    def k1_call(mode, t=k1):
        return fk.fused_score_sample_stats(5, *k1_args(t), sampling=mode,
                                           noise=nz(n1, mode))

    def k2_call(mode, kind='niw2mix'):
        args, kwargs = mixed[kind]
        return fk.fused_mixed_score_sample_stats(
            5, *args, sampling=mode, noise=nz(n2, mode), **kwargs)

    shards = {(kind, a): shard(kind, a) for kind in mixed
              for a in range(0, SLOTS, CL)}
    shard_noise = {a: n2['gumbel_host'][:, a:a + CL].contiguous()
                   for a in range(0, SLOTS, CL)}

    def k3_call(mode, a, kind='niw2mix'):
        args, kwargs = shards[kind, a]
        return fk.fused_score_sample_pair(
            5, *args, sampling=mode,
            noise=shard_noise[a] if nz(n2, mode) is not None else None,
            **kwargs)

    def b5_call(phase, t=k1):
        mode = phase.split('_', 1)[1] if phase.startswith(
            ('score_', 'full_')) and phase not in PHASES else None
        return bk.fused_phase(phase, 5, *k1_args(t),
                              noise=None if mode is None else nz(n1, mode))

    # K4's tiles ('' the main path's) and K5's ('' nichbbddgp)
    k4_tiles = {'': k1}
    k4_tiles.update({' %s' % (groups,): on_card(d['k1 %s' % (groups,)])
                     for groups in WIDE_K4})
    k5_tiles = {'': on_card(d[V1_KINDS[0]])}
    k5_tiles.update({' ' + kind: on_card(d[kind])
                     for kind in V1_KINDS[1:] + WIDE_K5})
    k5_tiles[' random'] = on_card(d['k5 random'])

    def k4_call(mode, t):
        return fk.nich_score_sample(
            5, t['values'], t['cl_scores'], t['v1_coeffs'], sampling=mode,
            noise=n1['gumbel_host'] if mode == 'gumbel_host' else None)

    def k5_call(mode, t):
        tables = t['v1_tables']
        return fk.mixed_score_sample(
            5, t['values'], t['table_idx'], t['cl_scores'], t['v1_coeffs'],
            None if tables is None else torch.clamp(tables, min=-1e30),
            sampling=mode,
            noise=n2['gumbel_host'] if mode == 'gumbel_host' else None)
    b1_scores = torch.randn((B1_ROWS, SLOTS), generator=gen, device=dev)
    b1_noise = n1['gumbel_host'][:B1_ROWS].contiguous()

    hashes = {}
    sums = {}

    def k12(key, out):
        # the draws bitwise; the stat sums kept for the comparison across
        # trees (their bits within a tree)
        hashes[key] = digest(out[0])
        hashes[key + ' sums'] = digest(*out[1:])
        sums[key] = [t.cpu() for t in out[1:]]
    for mode in V1_MODES:
        for name, t in k4_tiles.items():
            hashes['K4%s %s' % (name, mode)] = digest(k4_call(mode, t))
        for name, t in k5_tiles.items():
            hashes['K5%s %s' % (name, mode)] = digest(k5_call(mode, t))
        hashes['B1 ' + mode] = digest(*bk.sampler_gumbel(
            5, b1_scores, 4, mode,
            b1_noise if mode == 'gumbel_host' else None, all_draws=True))
    for mode in ALL_MODES:
        k12('K1 ' + mode, k1_call(mode))
        k12('K2 ' + mode, k2_call(mode))
    for mode in PAIR_MODES:
        for a in range(0, SLOTS, CL):
            hashes['K3 %s slot_offset %d' % (mode, a)] = digest(
                *k3_call(mode, a))
    for phase in PHASES + tuple('score_' + m for m in ALL_MODES):
        hashes['B5 ' + phase] = digest(b5_call(phase))
    for groups, t in k1_wide.items():
        for mode in WIDE_MODES:
            k12('K1 %s %s' % (groups, mode), k1_call(mode, t))
        for phase in PHASES + ('score_gumbel',):
            hashes['B5 %s %s' % (groups, phase)] = digest(b5_call(phase, t))
    for kind in WIDE_K2:
        for mode in WIDE_MODES:
            k12('K2 %s %s' % (kind, mode), k2_call(mode, kind))
        for mode in PAIR_MODES[:3]:
            for a in range(0, SLOTS, CL):
                hashes['K3 %s %s slot_offset %d' % (kind, mode, a)] = \
                    digest(*k3_call(mode, a, kind))
    ms = {'K1 gumbel': median_ms(lambda: k1_call('gumbel'), 7, dev),
          'K2 gumbel': median_ms(lambda: k2_call('gumbel'), 7, dev),
          'K3 gumbel': median_ms(lambda: k3_call('gumbel', 0), 7, dev)}
    for phase in TIMED_PHASES:
        ms['B5 ' + phase] = median_ms(lambda: b5_call(phase), 7, dev)
    for groups, t in k1_wide.items():
        ms['K1 %s gumbel' % (groups,)] = median_ms(
            lambda: k1_call('gumbel', t), 7, dev)
    for kind in WIDE_K2:
        ms['K2 %s gumbel' % kind] = median_ms(
            lambda: k2_call('gumbel', kind), 7, dev)
        ms['K3 %s gumbel' % kind] = median_ms(
            lambda: k3_call('gumbel', 0, kind), 7, dev)
    for name, t in k4_tiles.items():
        ms['K4%s gumbel' % name] = median_ms(lambda: k4_call('gumbel', t), 7,
                                             dev)
    for name, t in k5_tiles.items():
        ms['K5%s gumbel' % name] = median_ms(lambda: k5_call('gumbel', t), 7,
                                             dev)
    # the stat stage inside K1 and K2 at STAT_ROWS rows of their tiles
    big = mixed_args(on_card(d['niw2mix %d' % STAT_ROWS[-1]]))

    def rows_of(x, r):
        return x[:r].contiguous() if isinstance(x, torch.Tensor) else x
    for r in STAT_ROWS:
        ms['K1 stat stage %d' % r] = stat_stage_ms(
            lambda: fk.fused_score_sample_stats(
                5, k1['values'][:r], k1['cl_scores'], k1['coeffs'], (2,),
                sampling='gumbel'))
        args, kwargs = big
        args = (rows_of(args[0], r), rows_of(args[1], r)) + args[2:]
        kwargs = dict(kwargs, qvalues=rows_of(kwargs['qvalues'], r))
        ms['K2 stat stage %d' % r] = stat_stage_ms(
            lambda: fk.fused_mixed_score_sample_stats(
                5, *args, sampling='gumbel', **kwargs))
    runner = {}
    models = os.environ.get('TREE_COMPARE_RUNNER', 'nich,niw2mix')
    for model in filter(None, models.split(',')):
        os.environ['RUNNER_MODEL'] = model
        r = bench_runner.run(dev)
        runner[model] = {'ms_per_sweep': r['ms_per_sweep'],
                         'ms_per_sweep_of_each_run':
                             r['ms_per_sweep_of_each_run']}
    torch.save(sums, out + '.sums.pt')
    with open(out, 'w') as f:
        json.dump({'tree': tree, 'build_seconds': build_s, 'hashes': hashes,
                   'ms': ms, 'runner': runner, 'v1_sweeps': v1_sweeps(dev),
                   'device': bench_runner.device_name(dev)}, f)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == '--worker':
        worker(*argv[1:4])
        return 0
    if not 1 <= len(argv) <= 2:
        print(__doc__, file=sys.stderr)
        return 2
    trees = [os.path.abspath(t) for t in (argv + [ROOT])[:2]]
    work = os.path.join(ROOT, 'build', 'tree_compare')
    os.makedirs(work, exist_ok=True)
    inputs = os.path.join(work, 'inputs.pt')
    make_inputs(inputs)
    runs = []
    for i, tree in enumerate((trees[0], trees[1], trees[1], trees[0])):
        out = os.path.join(work, 'run%d.json' % i)
        env = dict(os.environ, PYTHONPATH=tree)
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        '--worker', tree, inputs, out], cwd=tree, env=env,
                       check=True)
        with open(out) as f:
            runs.append(json.load(f))
        print(json.dumps(dict(runs[-1], role=('old', 'new')[i in (1, 2)])),
              flush=True)
    import torch
    keys = sorted(runs[0]['hashes'])
    sum_keys = [k for k in keys if k.endswith(' sums')]
    # every output bitwise across the four runs, but the stat sums: those
    # bitwise within each tree, and within tolerance across the trees
    differ = [k for k in keys if k not in sum_keys
              and len({r['hashes'].get(k) for r in runs}) != 1]
    differ += [k for k in sum_keys
               if len({runs[i]['hashes'].get(k) for i in (0, 3)}) != 1
               or len({runs[i]['hashes'].get(k) for i in (1, 2)}) != 1]
    sums = [torch.load(os.path.join(work, 'run%d.json.sums.pt' % i))
            for i in (0, 1)]
    sums_differ = [k for k in sorted(sums[0])
                   if not sums_agree(sums[0][k], sums[1].get(k, []), k)]
    trees_bitwise = [k for k in sum_keys
                     if runs[0]['hashes'][k] == runs[1]['hashes'].get(k)]
    verdict = {
        'outputs': len(keys), 'outputs_that_differ': differ,
        'bitwise_equal': not differ,
        'stat_sums_outside_tolerance': sums_differ,
        'stat_sums_bitwise_across_trees': len(trees_bitwise),
        'stat_sums_compared': len(sum_keys),
        'ms': {k: {'old': [runs[0]['ms'][k], runs[3]['ms'][k]],
                   'new': [runs[1]['ms'][k], runs[2]['ms'][k]]}
               for k in runs[0]['ms']},
        'runner_ms_per_sweep': {
            m: {'old': [runs[0]['runner'][m]['ms_per_sweep'],
                        runs[3]['runner'][m]['ms_per_sweep']],
                'new': [runs[1]['runner'][m]['ms_per_sweep'],
                        runs[2]['runner'][m]['ms_per_sweep']]}
            for m in runs[0]['runner']},
        'v1_ms_per_sweep': {
            m: {'old': [runs[0]['v1_sweeps'][m], runs[3]['v1_sweeps'][m]],
                'new': [runs[1]['v1_sweeps'][m], runs[2]['v1_sweeps'][m]]}
            for m in runs[0]['v1_sweeps']},
        'device': runs[0]['device'], 'trees': trees}
    print(json.dumps(verdict), flush=True)
    return 1 if differ or sums_differ else 0


if __name__ == '__main__':
    if len(sys.argv) > 2 and sys.argv[1] == '--worker':
        # import the package of the tree under test, not of this checkout
        sys.path[0] = os.path.abspath(sys.argv[2])
    raise SystemExit(main())
