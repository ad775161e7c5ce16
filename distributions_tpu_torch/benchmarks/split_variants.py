"""The compile-time design variants of the slot-split walk
(csrc/fused_split.cuh) on one card: K1, K1's phases B5, K2, K3, K4 and K5
at the main path's shapes, each variant built as a library of its own
(`fused_kernels.build(name, defines)`), its outputs held bit for bit to
the default's, its times and its occupancy.

    python -m distributions_tpu_torch.benchmarks.split_variants [KERNEL ...]

KERNELs (K1, B5, K2, K2bb, K3, K4, K5; all by default) pick the kernels
timed, and so the libraries built.

Variants: the default (each warp walks one slice, two rows a thread), the
lane mapping (a row's eight slices on lanes of one warp, merged by warp
shuffles: SPLIT_LANE_SLICES=1), one, three and four rows a thread
(SPLIT_ROWS), and __launch_bounds__ with a minimum of resident blocks
(SPLIT_MIN_BLOCKS; without one ptxas picks the registers by itself),
the wide shape in place of the exact shapes of the main path's layouts
(SPLIT_WIDE_ONLY=1), and table rows read one slot a load where the default
reads four (SPLIT_TABLE_VEC=0).
Inputs: tree_compare's nich2 tile (131,072 x 1024; K1, B5, K4) and
niw2mix, bbddgp and nichbbddgp tiles (65,536 x 1024; K2 on the first two,
K3 on the niw2mix tile's first 256 slots, K5 on the last two), and bb
tiles of one table column (131,072 x 1024 and x 8192; K2bb: K2 on the
folded shape).  Every
variant runs twice, in the order given and then in reverse, each time in a
process of its own (two libraries with the same kernel names must not meet
in one process), timed by median CUDA-event milliseconds of 7 launches.  Prints one JSON line per
variant, then a summary; exits 1 when a variant's outputs differ from the
default's.  Needs one card.
"""

import json
import sys

from distributions_tpu_torch.benchmarks import tree_compare

VARIANTS = (('warp slices, 2 rows', ()),
            ('warp slices, 2 rows, >= 1 block an SM', ('SPLIT_MIN_BLOCKS=1',)),
            ('lane slices, 2 rows', ('SPLIT_LANE_SLICES=1',)),
            ('warp slices, 1 row', ('SPLIT_ROWS=1',)),
            ('warp slices, 3 rows', ('SPLIT_ROWS=3',)),
            ('warp slices, 4 rows', ('SPLIT_ROWS=4',)),
            ('warp slices, 4 rows, >= 1 block an SM',
             ('SPLIT_ROWS=4', 'SPLIT_MIN_BLOCKS=1')),
            ('warp slices, 4 rows, >= 3 blocks an SM',
             ('SPLIT_ROWS=4', 'SPLIT_MIN_BLOCKS=3')),
            ('warp slices, 2 rows, >= 6 blocks an SM',
             ('SPLIT_MIN_BLOCKS=6',)),
            ('wide shape for every layout', ('SPLIT_WIDE_ONLY=1',)),
            ('table rows one slot a load', ('SPLIT_TABLE_VEC=0',)))
# kernel -> the library that holds it
KERNEL_LIBS = {'K1': 'fused_v2', 'B5': 'fused_v2', 'K2': 'fused_v3',
               'K2bb': 'fused_v3', 'K3': 'fused_v3', 'K4': 'score_sample_v1',
               'K5': 'score_sample_v1'}
# K2bb's tiles: rows and slots
BB_TILES = ((131072, 1024), (131072, 8192))


def libs(kernels):
    return sorted({KERNEL_LIBS[k] for k in kernels})


def use(fk, defines, kernels):
    """Make the variant the library that this process's wrappers launch:
    a worker process runs one variant only."""
    for name in libs(kernels):
        fk._LIBRARIES[(name, ())] = fk.build(name, defines)


def calls(fk, bk, data, dev, kernels=tuple(KERNEL_LIBS)):
    """name -> a launch returning its outputs, for the kernels named."""
    return {name: fn for name, fn in all_calls(fk, bk, data, dev).items()
            if name.split()[0] in kernels}


def all_calls(fk, bk, data, dev):
    """name -> a launch returning its outputs, for every kernel."""
    import torch
    k1 = {k: (v.to(dev) if isinstance(v, torch.Tensor) else v)
          for k, v in data['k1'].items()}
    k1_args = (k1['values'], k1['cl_scores'], k1['coeffs'], (2,))
    out = {}
    for mode in ('gumbel', 'argmax'):
        out['K1 ' + mode] = (lambda m: lambda: fk.fused_score_sample_stats(
            5, *k1_args, sampling=m))(mode)
    for phase in ('score_max', 'score_bits', 'score_gumbel'):
        out['B5 ' + phase] = (lambda p: lambda: (bk.fused_phase(
            p, 5, *k1_args),))(phase)
    for kind in ('niw2mix', 'bbddgp'):
        k2 = {k: (v.to(dev) if isinstance(v, torch.Tensor) else v)
              for k, v in data[kind].items()}
        args = (k2['values'], k2['table_idx'], k2['cl_scores'],
                k2['coeffs'], torch.clamp(k2['tables'], min=-1e30),
                k2['col_groups'])
        kwargs = dict(qvalues=k2['qvalues'], qcoeffs=k2['qcoeffs'],
                      quad_groups=k2['quad_groups'],
                      table_vs=k2['table_vs'])
        for mode in ('gumbel', 'argmax'):
            out['K2 %s %s' % (kind, mode)] = (
                lambda m, a, kw: lambda: fk.fused_mixed_score_sample_stats(
                    5, *a, sampling=m, **kw))(mode, args, kwargs)
        if kind == 'niw2mix':
            CL = tree_compare.SLOTS // tree_compare.SHARDS

            def cut(x):
                return None if x is None else x[:, :CL].contiguous()
            s_args = args[:2] + (args[2][:CL].contiguous(), cut(args[3]),
                                 cut(args[4]), args[5])
            s_kwargs = dict(kwargs, qcoeffs=cut(kwargs['qcoeffs']))
            out['K3 niw2mix gumbel'] = lambda: fk.fused_score_sample_pair(
                5, *s_args, sampling='gumbel', **s_kwargs)
    for rows, slots in BB_TILES:
        t = {k: (v.to(dev) if isinstance(v, torch.Tensor) else v)
             for k, v in data['bb %d' % slots].items()}
        args = (None, t['table_idx'], t['cl_scores'], None,
                torch.clamp(t['tables'], min=-1e30), ())
        for mode in ('gumbel', 'argmax'):
            out['K2bb %d %s' % (slots, mode)] = (
                lambda m, a, tv: lambda: fk.fused_mixed_score_sample_stats(
                    5, *a, sampling=m, table_vs=tv))(mode, args,
                                                      t['table_vs'])
    for mode in ('gumbel', 'argmax'):
        out['K4 ' + mode] = (lambda m: lambda: (fk.nich_score_sample(
            5, k1['values'], k1['cl_scores'], k1['v1_coeffs'],
            sampling=m),))(mode)
    for kind in ('nichbbddgp', 'bbddgp'):
        t = data[kind]
        args = tuple(None if x is None else x.to(dev) for x in (
            t['values'], t['table_idx'], t['cl_scores'], t['v1_coeffs'],
            torch.clamp(t['v1_tables'], min=-1e30)))
        for mode in ('gumbel', 'argmax'):
            out['K5 %s %s' % (kind, mode)] = (
                lambda m, a: lambda: (fk.mixed_score_sample(
                    5, *a, sampling=m),))(mode, args)
    return out


def worker(defines, inputs, out, kernels):
    """One variant in a process of its own (libraries with the same kernel
    names must not meet in one process): times, digests, occupancy."""
    import torch
    from distributions_tpu_torch.benchmarks.timing import median_ms
    from distributions_tpu_torch.ops import bench_kernels as bk
    from distributions_tpu_torch.ops import fused_kernels as fk
    dev = torch.device('cuda')
    use(fk, defines, kernels)
    data = torch.load(inputs)
    r = {'ms': {}, 'digests': {}}
    for name, fn in calls(fk, bk, data, dev, kernels).items():
        r['ms'][name] = median_ms(fn, 7, dev)
        r['digests'][name] = tree_compare.digest(*fn())
    C = tree_compare.SLOTS
    mixed = data['niw2mix']
    layout = (mixed['col_groups'], mixed['quad_groups'], mixed['table_vs'])
    occupancy = {
        'K1': lambda: fk.split_occupancy('fused_v2', C, (2,)),
        'K2 niw2mix': lambda: fk.split_occupancy('fused_v3', C, *layout),
        'K3 niw2mix': lambda: fk.split_occupancy(
            'fused_v3', C // tree_compare.SHARDS, *layout),
        'K2bb 1024': lambda: fk.split_occupancy('fused_v3', 1024, (), (),
                                                (2,)),
        'K2bb 8192': lambda: fk.split_occupancy('fused_v3', 8192, (), (),
                                                (2,)),
        'K4': lambda: fk.split_occupancy('score_sample_v1', C, (2,)),
        'K5 nichbbddgp': lambda: fk.split_occupancy(
            'score_sample_v1', C, (1,), (), data['nichbbddgp']['table_vs']),
        'K5 bbddgp': lambda: fk.split_occupancy(
            'score_sample_v1', C, (), (), data['bbddgp']['table_vs'])}
    r['occupancy'] = {name: fn() for name, fn in occupancy.items()
                      if name.split()[0] in kernels}
    with open(out, 'w') as f:
        json.dump(r, f)


def main(argv=None):
    import os
    import subprocess
    import torch
    from distributions_tpu_torch.benchmarks.timing import device_name
    from distributions_tpu_torch.ops import fused_kernels as fk
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == '--worker':
        worker(tuple(json.loads(argv[1])), argv[2], argv[3],
               tuple(json.loads(argv[4])))
        return 0
    kernels = tuple(argv) or tuple(KERNEL_LIBS)
    unknown = set(kernels) - set(KERNEL_LIBS)
    if unknown:
        print(__doc__, file=sys.stderr)
        return 2
    # every variant's compilers at once
    jobs = [fk._start_build(name, defines) for _, defines in VARIANTS
            for name in libs(kernels)]
    for job in jobs:
        fk._finish_build(*job)
    work = os.path.join(tree_compare.ROOT, 'build', 'split_variants')
    os.makedirs(work, exist_ok=True)
    inputs = os.path.join(work, 'inputs.pt')
    data = tree_compare.main_path_inputs(
        kinds=('niw2mix', 'bbddgp', 'nichbbddgp'))
    for rows, slots in BB_TILES:
        data['bb %d' % slots] = tree_compare.mixed_tile_inputs('bb', rows,
                                                               slots)
    torch.save(data, inputs)
    results = {label: {'defines': list(defines), 'ms': {}}
               for label, defines in VARIANTS}
    digests = {}
    differ = []
    for i, (label, defines) in enumerate(VARIANTS
                                         + tuple(reversed(VARIANTS))):
        out = os.path.join(work, 'run%d.json' % i)
        subprocess.run([sys.executable, '-m', __spec__.name, '--worker',
                        json.dumps(list(defines)), inputs, out,
                        json.dumps(list(kernels))],
                       cwd=tree_compare.ROOT, check=True)
        with open(out) as f:
            run = json.load(f)
        r = results[label]
        for name, ms in run['ms'].items():
            r['ms'].setdefault(name, []).append(ms)
            if digests.setdefault(name, run['digests'][name]) != \
                    run['digests'][name]:
                differ.append((label, name))
        r['occupancy'] = run['occupancy']
    for label, _ in VARIANTS:
        print(json.dumps(dict(results[label], variant=label)), flush=True)
    print(json.dumps({'variants': len(VARIANTS),
                      'outputs_that_differ': differ,
                      'bitwise_equal': not differ,
                      'device': device_name(torch.device('cuda'))}),
          flush=True)
    return 1 if differ else 0


if __name__ == '__main__':
    sys.exit(main())
