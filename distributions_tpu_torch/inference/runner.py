"""Production Gibbs runner (distributions_tpu.inference.runner): runs
blocked collapsed-Gibbs sweeps in steps with periodic checkpoints and
resume, grows capacity between steps, validates invariants and logs one
row per step.

With `mesh=` the sweeps run row-sharded over a `parallel.sharding` mesh,
and the values may come as `sharding.RowSharded` (each process holding
only its own rows).  Every `hyper_every` sweeps the hyperparameters of the
feature blocks and of the clustering prior are resampled, from grids
(`inference/hypers.py`) or by slice sampling (`inference/slice.py`).
Checkpoints are one file (`io/checkpoint.py`) or, with
`checkpoint_format='orbax'`, a sharded directory
(`io/checkpoint_orbax.py`).
"""

import os
import time

import numpy as np
import torch

from distributions_tpu_torch import clustering, config, debug, diagnostics
from distributions_tpu_torch import mixture as mx
from distributions_tpu_torch.inference import hypers as _hypers
from distributions_tpu_torch.inference import slice as _slice
from distributions_tpu_torch.io import checkpoint, checkpoint_orbax
from distributions_tpu_torch.ops import fused_kernels as fk
from distributions_tpu_torch.ops import gibbs
from distributions_tpu_torch.parallel import distributed, sharding


def _leaves(obj):
    """Every tensor and numpy array in nested tuples, lists and dicts, and
    the shards of a RowSharded."""
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        yield obj
    elif isinstance(obj, sharding.RowSharded):
        yield from obj.shards
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _leaves(x)
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from _leaves(x)


def _place(spec, cl_model, shareds, values, initial_assignments, device):
    """Put the run's inputs on one device.  Tensors (and the shards of a
    RowSharded) stay where they are, and they must all share one device,
    which must be `device` when one is named; numpy arrays, lists and
    dicts go to that device (`config.default_device()` when nothing names
    one)."""
    found = []
    for t in _leaves((cl_model, shareds, values, initial_assignments)):
        if isinstance(t, torch.Tensor) and not any(
                config.same_device(t.device, d) for d in found):
            found.append(t.device)
    if device is not None:
        device = torch.device(device)
        found = [d for d in found if not config.same_device(d, device)]
        if found:
            raise ValueError('run_gibbs(device=%s) was given tensors on %s'
                             % (device, found[0]))
    elif len(found) > 1:
        raise ValueError('run_gibbs was given tensors on several devices: '
                         '%s' % ', '.join(str(d) for d in found))
    elif found:
        device = found[0]
    else:
        device = config.default_device()

    def tensor(x):
        if isinstance(x, (torch.Tensor, sharding.RowSharded)):
            return x
        return torch.as_tensor(np.asarray(x)).to(device)

    if isinstance(cl_model, dict):
        cls = (clustering.LowEntropy if 'dataset_size' in cl_model
               else clustering.PitmanYor)
        cl_model = cls.from_dict(cl_model, device=device)
    else:
        cl_model = type(cl_model)(*(tensor(x) for x in cl_model))
    shareds = tuple(
        b.module.shared_from_dict(sh, device=device) if isinstance(sh, dict)
        else type(sh)(*(tensor(x) for x in sh))
        for b, sh in zip(spec.blocks, shareds))
    values = tuple(tensor(v) for v in values)
    if initial_assignments is not None:
        initial_assignments = tensor(initial_assignments)
    return device, cl_model, shareds, values, initial_assignments


def _int32(assignments):
    if isinstance(assignments, sharding.RowSharded):
        return sharding.RowSharded(
            [a.to(torch.int32) for a in assignments.shards],
            assignments.n_rows, assignments.mesh)
    return assignments.to(torch.int32)


def _stat_cache(spec, shareds, values, block, assignments, mesh):
    """gibbs.build_stat_cache; for RowSharded rows, each local shard's
    cache of its own tiles as RowSharded leaves (the shard-major tile
    order `sharding.sharded_sweep_fused` cuts)."""
    if not isinstance(assignments, sharding.RowSharded):
        return gibbs.build_stat_cache(spec, shareds, values, block,
                                      assignments)
    parts = [gibbs.build_stat_cache(spec, shareds,
                                    tuple(v.shards[i] for v in values),
                                    block, a)
             for i, a in enumerate(assignments.shards)]
    n_tiles = assignments.n_rows // block

    def rows(xs):
        return sharding.RowSharded(xs, n_tiles, mesh)
    return (rows([p[0] for p in parts]),
            tuple(rows([p[1][b] for p in parts])
                  for b in range(len(spec.blocks))))


def _grid_on(grid, device):
    """A grid of Shareds or clustering models (a NamedTuple of leaves with
    a leading [G] axis: tensors, numpy arrays or lists) on `device`."""
    return type(grid)(*(
        x.to(device) if isinstance(x, torch.Tensor)
        else torch.as_tensor(np.asarray(x)).to(device) for x in grid))


def _hyper_moves(stats, generator, spec, shareds, cl_model, state, device,
                 hyper_grids, hyper_slice, cl_grid, cl_slice, hyper_sample):
    """The step's hyperparameter moves, in run_gibbs's order, each noted in
    the step's logger row `stats`.  Returns (shareds, cl_model)."""
    for block_idx, grid in (hyper_grids or {}).items():
        shareds, idx, _ = _hypers.grid_step_feature(
            generator, spec, block_idx, shareds, state,
            _grid_on(grid, device), sample=hyper_sample)
        stats['hyper_%d' % block_idx] = int(idx)
    for block_idx, cfg in (hyper_slice or {}).items():
        if isinstance(cfg, dict):
            kw = dict(cfg)
            params = tuple(kw.pop('params'))
        else:
            params, width = cfg
            params, kw = tuple(params), {'width': width}
        shareds, _ = _slice.slice_step_feature(
            generator, spec, block_idx, shareds, state, params, **kw)
        stats['hyper_slice_%d' % block_idx] = 1
    if cl_grid is not None:
        cl_model, idx, _ = _hypers.grid_step_clustering(
            generator, _grid_on(cl_grid, device), state, sample=hyper_sample)
        stats['hyper_cl'] = int(idx)
    elif cl_slice:
        kw = cl_slice if isinstance(cl_slice, dict) else {}
        cl_model, _ = _slice.slice_step_clustering(
            generator, cl_model, state, **kw)
        stats['hyper_cl_alpha'] = float(cl_model.alpha)
        stats['hyper_cl_d'] = float(cl_model.d)
    return shareds, cl_model


def _unfused_sweep(spec, use_pallas):
    """The sweeps of a step that the fused gate refused, as (spec,
    cl_model, shareds, state, values, assignments, block, generator, k) ->
    (state, assignments, the joint score): k sweeps in one call, on the
    card the replays of one CUDA graph, with the step's score from the
    static state.  With use_pallas the v1 score + sample sweep that serves
    the spec (K4 for nich-only, K5 without niw blocks; 'gumbel', as
    `gibbs.sweep_blocked_pallas` and `sweep_blocked_pallas_mixed` draw by
    default), else the plain sweep."""
    kernel = None
    if use_pallas and fk.supports_pallas(spec):
        kernel = 'K4'
    elif use_pallas and all(
            b.module is not fk.niw_mod
            and hasattr(b.module, 'score_value_batch') for b in spec.blocks):
        kernel = 'K5'

    def sweeps(spec, cl_model, shareds, state, values, assignments, block,
               generator, k):
        if kernel is None:
            return gibbs._plain_run(spec, cl_model, shareds, state, values,
                                    assignments, block, generator, k, True)
        return gibbs._v1_run(spec, values, None, kernel, block, 256,
                             'gumbel', k, True, cl_model, shareds, state,
                             assignments, generator)
    return sweeps


@diagnostics.spanned('runner.call')
def run_gibbs(spec, cl_model, shareds, values, generator, passes,
              block=4096, checkpoint_path=None, checkpoint_every=10,
              resume=True, init='prior', use_pallas=False,
              grow_headroom=0.125, log=None, mesh=None, sampling='gumbel',
              block_rows=2048, hyper_grids=None, cl_grid=None,
              hyper_every=10, hyper_sample=True,
              checkpoint_format='npz', hyper_slice=None, cl_slice=False,
              sweeps_per_step=1, initial_assignments=None, device=None):
    """Run `passes` blocked collapsed-Gibbs sweeps with checkpoint and
    resume.

    generator: the `torch.Generator` all randomness comes from (the JAX
    runner's `key`).  init: 'prior' (each row seated by the clustering
    prior alone) | 'sequential' (each row from the running posterior
    predictive: a loop of R single-row steps, for small R) | 'random:K'
    (uniform over the first K slots); or pass `initial_assignments` ([R]
    int) to warm-start, which overrides `init`.

    checkpoint_path: written every `checkpoint_every` sweeps and at the
    end (`checkpoint_every=0` writes only the final one), in the
    `checkpoint_format`: 'npz', one file (io.checkpoint: npz blobs in a
    protobuf envelope, which rank 0 writes from gathered rows), or
    'orbax', a sharded directory (io.checkpoint_orbax: every rank writes
    its own row shards; a `torch.distributed.checkpoint` directory, not
    orbax's format).  With `resume` and an existing checkpoint the run
    continues from it: state, assignments, the generator's state (set on
    `generator`, which must be of the device type it was saved from), the
    sweep index, the logger rows, and the saved shareds and clustering
    model; an 'orbax' resume first calls `checkpoint_orbax.recover`,
    which puts back a checkpoint left at a sibling by a crash in the
    middle of an overwrite.  Steps are clamped so that every checkpoint
    boundary is a step edge, and the fused stat cache is rebuilt from the
    assignments after every checkpoint, as a resumed run must rebuild it:
    a run interrupted at a checkpoint and resumed with the same settings
    equals the uninterrupted run bitwise.

    device: where the chain runs.  `values`, `initial_assignments`, the
    shareds and the clustering model may be tensors, numpy arrays, lists
    or (shareds, clustering model) dicts: what is not a tensor goes to
    `device`, which defaults to the device of the tensors given and, with
    none given, to `config.default_device()` (the card).  Tensors on
    another device than the rest raise ValueError.

    use_pallas=True runs each step through a fused kernel
    (`gibbs.sweep_blocked_pallas_fused_mixed`: K2, or K1 for a nich-only
    spec) when every block is nich, niw or a discrete model with score
    tables (`fused_kernels.supports_mixed_pallas`) and R is a multiple of
    `block`.  On the card each of its sweeps is the replay of one CUDA
    graph of all the tiles, and the step's joint score another; the
    '_host' sampling modes run eagerly.  The graph is captured at the
    first step and kept from step to step: a step copies the state, the
    stat cache and, after a hyper move, the new shareds and clustering
    model into its buffers; a grown capacity captures it anew; the run
    frees it when it ends (`gibbs.GRAPH_STATS` counts captures and
    replays).  A spec that fails that gate takes the v1 score + sample
    sweeps where they serve it: `gibbs.sweep_blocked_pallas` (K4) for a
    nich-only spec, `gibbs.sweep_blocked_pallas_mixed` (K5) for a spec
    without niw blocks, else the plain `gibbs.sweep_blocked` (also the
    path of use_pallas=False); on the card their sweeps too are replays
    of one CUDA graph, a step's k sweeps one call.

    Hyperparameter moves, every `hyper_every` (>= 1) sweeps, in this
    order: each block in `hyper_grids` ({block index: a Shared with a
    leading grid axis [G]}) is resampled from its grid
    (`hypers.grid_step_feature`; hyper_sample=False takes the argmax);
    each block in `hyper_slice` ({block index: (param names, width) or a
    dict of `slice.slice_step_feature` keywords with 'params'}) by slice
    sampling; the clustering prior from `cl_grid` (a model with leaves
    [G], e.g. `hypers.make_py_grid`) or, with `cl_slice` (True or a dict
    of `slice.slice_step_clustering` keywords), by slice sampling.  The
    clustering moves take a Pitman-Yor prior only: with a LowEntropy
    prior, `cl_grid` or `cl_slice` raises ValueError.  Steps
    are clamped to `hyper_every` edges, the logger row of such a step
    gains `hyper_<block>`, `hyper_slice_<block>`, `hyper_cl`,
    `hyper_cl_alpha` and `hyper_cl_d`, the fused stat cache is rebuilt
    after the move, and the new shareds and clustering model go into the
    checkpoint and come back on resume.  Under a process group every rank
    draws the same move from its generator; nothing is broadcast.
    mesh: a `parallel.sharding` mesh (`sharding.make_mesh(4)` in one
    process, `distributed.make_global_mesh()` over a process group) runs
    the sweeps row-sharded: on a 1-D 'rows' mesh with R a multiple of
    shards * block and the fused gate above,
    `sharding.sharded_sweep_fused` with the stat cache; otherwise
    `sharding.sharded_sweep_blocked` sweep by sweep.  Under a process
    group every rank calls run_gibbs with the same arguments and a
    generator in the same state.  `values` (and `initial_assignments`) are
    either full tensors, of which each rank uses its rows, or
    `sharding.RowSharded` cut over `mesh` (each process holding only its
    own row shards, `distributed.global_rows_from_host_data`): R is then
    their `n_rows`, and the run returns RowSharded assignments.  With a
    mesh the initial state is built from the assignments by one sum over
    'rows' (`sharding.sharded_state_from_assignments`), so a run fed
    RowSharded values equals the run fed the full values bitwise.
    'random:K' and 'prior' draw the full [R] vector from the generator
    and each shard takes its rows; 'sequential' needs every row in one
    place and refuses RowSharded values with ValueError, and so does the
    fused path of a spec with discrete blocks (their value supports must
    be known on every rank).  A full `initial_assignments` with RowSharded
    values is cut likewise.
    sweeps_per_step: whole sweeps per step; validation, logging and the
    capacity-growth check happen at step boundaries, with one logger row
    per step.  Capacity doubles when
    fewer than `grow_headroom * capacity` slots are free, and the fused
    stat cache is then rebuilt.  A step that ends with no free slot at all
    raises RuntimeError: the sweeps inside it may have refused new groups
    (the JAX runner goes on in silence), so size `grow_headroom` for what
    a step can add.

    Returns (state, assignments, logger)."""
    if checkpoint_format not in ('npz', 'orbax'):
        raise ValueError('unknown checkpoint_format %r'
                         % (checkpoint_format,))
    hyper_active = bool(hyper_grids or hyper_slice or cl_grid is not None
                        or cl_slice)
    if hyper_active and int(hyper_every) < 1:
        raise ValueError('hyper_every must be >= 1 when hyperparameter '
                         'moves are asked for, got %r' % (hyper_every,))
    if sweeps_per_step < 1:
        raise ValueError('sweeps_per_step must be >= 1')
    logger = log or diagnostics.SweepLogger()
    with diagnostics.span('runner.setup'):
        dev, cl_model, shareds, values, initial_assignments = _place(
            spec, cl_model, shareds, values, initial_assignments, device)
        row_sharded = isinstance(values[0], sharding.RowSharded)
        if row_sharded and mesh is None:
            raise ValueError('RowSharded values need the mesh they are cut '
                             'over')
        if isinstance(initial_assignments, sharding.RowSharded) \
                and not row_sharded:
            raise ValueError('RowSharded initial_assignments need RowSharded '
                             'values')
        R = values[0].n_rows if row_sharded else int(values[0].shape[0])
        if (cl_grid is not None or cl_slice) and not isinstance(
                cl_model, clustering.PitmanYor):
            # the clustering moves resample Pitman-Yor {alpha, d}; the feature
            # moves (hyper_grids, hyper_slice) do not read the prior
            raise ValueError('cl_grid and cl_slice resample a Pitman-Yor '
                             'prior; got %s' % type(cl_model).__name__)

        def in_form(full):
            # a full [R] vector in the form of the run's rows
            return sharding.cut_rows(full, mesh) if row_sharded else full

        def state_of(assignments):
            if mesh is None:
                return mx.state_from_assignments(spec, cl_model, shareds,
                                                 values, assignments)
            return sharding.sharded_state_from_assignments(
                spec, cl_model, shareds, values, assignments, mesh)

        start_pass = 0
        if (resume and checkpoint_path and checkpoint_format == 'orbax'
                and checkpoint_orbax.recover(checkpoint_path)):
            loaded = checkpoint_orbax.load_sharded(
                checkpoint_path, spec, shareds,
                mesh=mesh if row_sharded else None, n_rows=R, extended=True)
            state, assignments = loaded.state, loaded.assignments
            start_pass, spec = loaded.sweep, loaded.spec
            if loaded.generator is not None:
                checkpoint.restore_generator(generator, loaded.generator)
            if loaded.logger_rows and not logger.rows:
                logger.rows = loaded.logger_rows
            if loaded.shareds is not None:
                shareds = loaded.shareds
            if loaded.cl_model is not None:
                cl_model = loaded.cl_model
        elif (resume and checkpoint_path and checkpoint_format == 'npz'
                and os.path.exists(checkpoint_path)):
            state, assignments, saved, start_pass, rows = \
                checkpoint.load_extended(checkpoint_path, spec, shareds)
            assignments = in_form(assignments)
            # a checkpoint written after capacity growth holds the grown state
            spec = spec._replace(capacity=int(state.counts.shape[0]))
            if saved is not None:
                checkpoint.restore_generator(generator, saved)
            if rows and not logger.rows:
                logger.rows = rows
            saved_shareds, saved_cl = checkpoint.load_hypers(
                checkpoint_path, spec, device=dev)
            if saved_shareds is not None:
                shareds = saved_shareds
            if saved_cl is not None:
                cl_model = saved_cl
        elif initial_assignments is not None:
            assignments = _int32(initial_assignments)
            if row_sharded and not isinstance(assignments,
                                              sharding.RowSharded):
                assignments = in_form(assignments)
            state = state_of(assignments)
        elif init == 'prior':
            state0 = mx.init(spec, shareds)
            if mesh is None:
                state, assignments = gibbs.prior_init(
                    spec, cl_model, shareds, state0, values, generator)
            else:
                assignments = in_form(gibbs.prior_seating(
                    cl_model, state0, R, generator))
                state = state_of(assignments)
        elif init.startswith('random'):
            k0 = int(init.split(':')[1]) if ':' in init else 64
            assignments = in_form(torch.randint(
                0, min(k0, spec.capacity), (R,), generator=generator,
                device=generator.device).to(device=dev, dtype=torch.int32))
            state = state_of(assignments)
        elif init == 'sequential':
            if row_sharded:
                raise ValueError("init='sequential' assigns the rows one "
                                 'after another and needs them all in one '
                                 'place; RowSharded values take prior or '
                                 'random:K')
            state, assignments = gibbs.sequential_init(
                spec, cl_model, shareds, mx.init(spec, shareds), values,
                generator)
        else:
            raise ValueError("init must be 'prior', 'sequential' or "
                             "'random:K', got %r" % (init,))
        # the first step's growth check reads this host copy: it ends the
        # set-up on the card
        counts_host = state.counts.cpu().numpy()

    def save(at_sweep):
        if checkpoint_format == 'orbax':
            # collective: every rank writes its own row shards
            checkpoint_orbax.save_sharded(
                checkpoint_path, state, assignments=assignments,
                generator=generator, sweep=at_sweep, logger_rows=logger.rows,
                force=True, shareds=shareds, cl_model=cl_model, spec=spec,
                mesh=mesh)
            return
        # the state is replicated and the assignments are gathered: rank
        # 0's view is the whole chain
        full = assignments
        if row_sharded:
            full = torch.from_numpy(distributed.gather_rows(assignments))
        if mesh is None or distributed.process_index() == 0:
            checkpoint.save(checkpoint_path, state, assignments=full,
                            generator=generator, sweep=at_sweep,
                            logger_rows=logger.rows, shareds=shareds,
                            cl_model=cl_model, spec=spec)
        if mesh is not None:
            # no rank goes on (or resumes) before the file is whole
            distributed.barrier()

    # the fused steps reuse one key: capture its sweep graph at the first
    # step, and free it when the run ends
    with gibbs.sweep_graph_session():
        cache = None
        sweep = start_pass
        while sweep < passes:
            with diagnostics.span('runner.step', step=sweep) as step:
                with diagnostics.span('runner.growth'):
                    if mx.needs_growth(spec, state, grow_headroom,
                                       counts=counts_host):
                        spec, state = mx.grow_capacity(spec, state,
                                                       2 * spec.capacity)
                        cache = None
                        # the sweep graph of the old capacity is of no more
                        # use: free its memory before the next step captures
                        # the new one
                        gibbs.release_sweep_graphs()
                # the fused gate keeps what the algorithm needs; the JAX
                # runner's TPU-only conditions (capacity % 128, block % 512,
                # the VMEM cap of auto_block_rows) do not apply to the CUDA
                # kernel
                fused_ok = (use_pallas and fk.supports_mixed_pallas(spec)
                            and R % block == 0)
                if mesh is not None:
                    fused_ok = (fused_ok
                                and mesh.axis_names == (sharding.ROWS,)
                                and R % (mesh.size * block) == 0)
                # every hyper and checkpoint boundary lands on a step edge
                k = min(sweeps_per_step, passes - sweep)
                if hyper_active:
                    k = min(k, hyper_every - sweep % hyper_every)
                if checkpoint_path and checkpoint_every:
                    k = min(k, checkpoint_every - sweep % checkpoint_every)

                step_score = None
                t0 = time.perf_counter()
                if fused_ok and cache is None:
                    with diagnostics.span('runner.stat_cache'):
                        cache = _stat_cache(spec, shareds, values, block,
                                            assignments, mesh)
                with diagnostics.span('runner.sweeps'):
                    if fused_ok and mesh is not None:
                        state, assignments, cache, step_score = \
                            sharding.sharded_sweep_fused(
                                spec, cl_model, shareds, state, values,
                                assignments, generator, mesh, block, cache,
                                block_rows=min(block_rows, block),
                                sampling=sampling, n_sweeps=k,
                                with_score=True)
                    elif fused_ok:
                        state, assignments, cache, step_score = \
                            gibbs.sweep_blocked_pallas_fused_mixed(
                                spec, cl_model, shareds, state, values,
                                assignments, block, min(block_rows, block),
                                generator, cache, sampling=sampling,
                                n_sweeps=k, with_score=True)
                    elif mesh is not None:
                        for _ in range(k):
                            state, assignments = \
                                sharding.sharded_sweep_blocked(
                                    spec, cl_model, shareds, state, values,
                                    assignments, generator, mesh, block)
                    else:
                        state, assignments, step_score = _unfused_sweep(
                            spec, use_pallas)(spec, cl_model, shareds, state,
                                              values, assignments, block,
                                              generator, k)
                # the host copy of the [C] counts is the step's sync point
                with diagnostics.span('runner.counts_sync'):
                    counts_host = state.counts.cpu().numpy()
                dt = time.perf_counter() - t0
                # the card's events of the step's sweeps (none for the
                # mesh's plain sweeps, which take no static run)
                times = None
                if fused_ok or mesh is None:
                    times = gibbs.step_times(dev)
                sweep += k
                if int((counts_host > 0).sum()) >= spec.capacity:
                    # growth is only checked between steps: a step that ends
                    # with no free slot may have refused new groups along the
                    # way
                    raise RuntimeError(
                        'no free slot is left after sweep %d (capacity %d): '
                        'the chain may have been truncated within the step; '
                        'raise grow_headroom or the capacity, or lower '
                        'sweeps_per_step' % (sweep, spec.capacity))

                with diagnostics.span('runner.validate'):
                    debug.validate_state(spec, state)
                    if config.DEBUG_LEVEL >= 1:
                        debug.validate_assignments(
                            spec, state,
                            torch.from_numpy(distributed.gather_rows(
                                assignments)) if row_sharded else assignments)
                with diagnostics.span('runner.sweep_stats'):
                    stats = diagnostics.sweep_stats(
                        spec, cl_model, shareds, state, counts=counts_host,
                        score=step_score)
                stats['seconds'] = round(dt, 4)
                if sweeps_per_step > 1:
                    stats['sweeps'] = k
                if hyper_active and sweep % hyper_every == 0:
                    with diagnostics.span('runner.hypers'):
                        shareds, cl_model = _hyper_moves(
                            stats, generator, spec, shareds, cl_model, state,
                            dev, hyper_grids, hyper_slice, cl_grid, cl_slice,
                            hyper_sample)
                    # the cache's raw sums were built under the old shareds
                    # (dpd's value tables depend on them): rebuild it next
                    # sweep
                    cache = None
                if times is not None:
                    stats.update(times)
                # the spans closed so far; runner.checkpoint's and the
                # step's own time join this dict when the step ends
                stats['host_ms'] = step.self_ms
                logger.log(sweep - 1, **stats)

                if checkpoint_path and checkpoint_every \
                        and sweep % checkpoint_every == 0 and sweep < passes:
                    with diagnostics.span('runner.checkpoint'):
                        save(sweep)
                    # a run resumed from this file rebuilds the cache from
                    # the assignments; do the same, so that both continue
                    # alike
                    cache = None
    if checkpoint_path:
        with diagnostics.span('runner.checkpoint'):
            save(passes)
    logger.final_shareds = shareds
    logger.final_cl_model = cl_model
    return state, assignments, logger

