"""Sharded checkpoints for large and multi-process runs (the counterpart of
distributions_tpu.io.checkpoint_orbax; the module's name and
`run_gibbs(checkpoint_format='orbax')` are kept so that callers find it).

The on-disk format is `torch.distributed.checkpoint` (DCP), not orbax's:
neither package reads the other's directories.  Like the JAX package's,
this is an operational checkpoint, not the exchange format: io.checkpoint
writes the files both packages read.

io/checkpoint.py puts the whole chain in one file, which rank 0 writes
from gathered rows.  Here every process writes only its own row shards of
the assignments, under keys that carry their global row range, the
replicated state goes in once, and a load re-lays the rows onto any mesh
(or onto none) by reading the shard keys that overlap each local shard.

A checkpoint is a directory holding a DCP checkpoint of
  state/counts, state/alive, state/sample_size,
  state/groups/<block>/<field>      the replicated MixtureState
  assignments/<start>:<stop>        one entry per row shard
  rng_key                           the generator state, packed as
                                    io.checkpoint packs it (int64 words)
and `meta.json` (sweep, logger rows, capacity, hypers), which rank 0
writes last: a directory is complete once meta.json exists.
"""

import json
import os
import re
import shutil
import warnings
from collections import namedtuple

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from distributions_tpu_torch import mixture as mx
from distributions_tpu_torch.io import checkpoint as _ck
from distributions_tpu_torch.parallel import distributed, sharding

LoadedCheckpoint = namedtuple('LoadedCheckpoint', [
    'state', 'assignments', 'generator', 'sweep', 'logger_rows',
    'shareds', 'cl_model', 'spec'])

_SHARD_KEY = re.compile(r'^assignments/(\d+):(\d+)$')


def _quietly(fn, *args, **kwargs):
    """dcp.save / dcp.load: collective under a process group, local
    without one (DCP's warning that it then assumes one process is
    dropped)."""
    with warnings.catch_warnings():
        warnings.filterwarnings('ignore',
                                message='torch.distributed is disabled')
        return fn(*args, **kwargs)


def _complete(path):
    """A checkpoint directory is complete once meta.json exists: rank 0
    writes it after every rank's shards are on disk."""
    return os.path.isdir(path) and os.path.exists(
        os.path.join(path, 'meta.json'))


def _siblings(path):
    return path + '.tmp-orbax', path + '.stale'


def recover(path):
    """Recover from a crash in the middle of an overwrite (see
    save_sharded): when nothing is at `path` but a COMPLETE checkpoint
    sits at the `.tmp-orbax` (newer) or `.stale` (previous) sibling, it is
    renamed into place and the other sibling removed.  Returns True iff a
    complete checkpoint is at `path` afterwards.

    Something at `path` that is not a complete checkpoint is left alone:
    recover returns False, or raises FileExistsError when a complete
    sibling would need that name.  (The JAX package deletes such a
    directory.)  Under a process group rank 0 does the renames and every
    rank gets its outcome."""
    path = os.path.abspath(path)
    if not distributed.is_multiprocess():
        return _recover_local(path)
    outcome = [None]
    if distributed.process_index() == 0:
        try:
            outcome[0] = _recover_local(path)
        except OSError as e:
            outcome[0] = e
    dist.broadcast_object_list(outcome, src=0)
    if isinstance(outcome[0], Exception):
        raise outcome[0]
    return outcome[0]


def _recover_local(path):
    if _complete(path):
        return True
    found = [s for s in _siblings(path) if _complete(s)]
    if os.path.lexists(path):
        if found:
            raise FileExistsError(
                '%s is not a complete checkpoint (it has no meta.json), and '
                'the complete checkpoint at %s needs its name: move it away '
                'to resume' % (path, found[0]))
        return False
    if not found:
        return False
    os.rename(found[0], path)
    # the remaining sibling is obsolete (the .stale copy after recovering
    # the newer .tmp-orbax, or a partial .tmp-orbax)
    for left in _siblings(path):
        if os.path.isdir(left):
            shutil.rmtree(left)
    return True


def _state_entries(state):
    out = {'state/counts': state.counts, 'state/alive': state.alive,
           'state/sample_size': state.sample_size}
    for b, group in enumerate(state.groups):
        for field, leaf in zip(group._fields, group):
            out['state/groups/%d/%s' % (b, field)] = leaf
    return out


def _assignment_entries(assignments, mesh):
    """{'assignments/<start>:<stop>': shard} for the row shards this
    process holds: a RowSharded's own shards, a full tensor cut by `mesh`,
    or the whole tensor when there is no mesh."""
    if isinstance(assignments, sharding.RowSharded):
        ranges = sharding.local_row_ranges(assignments.mesh,
                                           assignments.n_rows)
        shards = assignments.shards
    else:
        assignments = torch.as_tensor(assignments)
        n_rows = assignments.shape[0]
        ranges = [(0, n_rows)] if mesh is None \
            else sharding.local_row_ranges(mesh, n_rows)
        shards = [assignments[a:b] for a, b in ranges]
    return {'assignments/%d:%d' % (a, a + s.shape[0]): s
            for (a, _), s in zip(ranges, shards)}


def save_sharded(path, state, assignments=None, generator=None, sweep=None,
                 logger_rows=None, force=False, shareds=None, cl_model=None,
                 spec=None, mesh=None):
    """Write a sharded checkpoint directory at `path`.  Collective: under
    a process group every rank calls it with the same replicated state.

    state: the replicated MixtureState, or a component-sharded one (the
    list that `sharding.shard_state_components` and the component-sharded
    sweeps return, with its `mesh`), which is written whole: joined in
    one process, gathered over the ranks of 'components' under a process
    group (`sharding.unshard_state_components`), as the JAX function saves
    a state of any sharding.  `load_sharded` returns the full state,
    which `shard_state_components` cuts again.

    assignments: a `sharding.RowSharded` (each rank writes its shards), a
    full [R] tensor cut by `mesh` (each rank writes its own row shards), or
    with no mesh a full tensor written whole.  generator: its state goes
    in as io.checkpoint stores it.  shareds / cl_model (with spec, which
    defines their dict schemas) go into meta.json through
    io.checkpoint's json form, so runs that resample hyperparameters
    resume with them; meta.json also records the capacity, so a load
    adopts a capacity that grew during the run.

    `path` must not exist unless force=True, which replaces a complete
    checkpoint atomically: the new one is written whole to
    `<path>.tmp-orbax`, then swapped in by two renames (old ->
    `<path>.stale`, new -> path) and the stale copy deleted, so a crash at
    any point leaves a complete checkpoint at `path` or at a sibling
    (`recover` puts it back).  Something at `path` that is not a complete
    checkpoint is never replaced: FileExistsError."""
    path = os.path.abspath(path)
    if shareds is not None and spec is None:
        raise ValueError('saving the shareds needs the spec')
    if isinstance(state, list):
        if mesh is None:
            raise ValueError('a component-sharded state is saved with its '
                             'mesh')
        state = sharding.unshard_state_components(state, mesh)
    rank0 = distributed.process_index() == 0
    exists = os.path.lexists(path)
    if exists and not force:
        raise FileExistsError('%s exists; pass force=True to replace it'
                              % path)
    if exists and not _complete(path):
        raise FileExistsError('%s is not a complete checkpoint (it has no '
                              'meta.json); refusing to replace it' % path)
    dest = _siblings(path)[0] if exists else path
    if rank0 and exists and os.path.lexists(dest):
        shutil.rmtree(dest)     # a partial write of a crashed save
    distributed.barrier()

    entries = _state_entries(state)
    if assignments is not None:
        entries.update(_assignment_entries(assignments, mesh))
    if generator is not None:
        entries['rng_key'] = torch.tensor(
            _ck._generator_to_words(generator), dtype=torch.int64)
    _quietly(dcp.save, entries, storage_writer=dcp.FileSystemWriter(dest))
    if rank0:
        meta = {'sweep': int(sweep or 0), 'logger_rows': logger_rows or [],
                'capacity': int(state.counts.shape[0])}
        if shareds is not None:
            meta['hypers'] = json.loads(
                _ck._hypers_to_json(shareds, cl_model, spec).decode())
        tmp = os.path.join(dest, 'meta.json.tmp')
        with open(tmp, 'w') as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(dest, 'meta.json'))
    distributed.barrier()
    if exists:
        if rank0:
            stale = _siblings(path)[1]
            if os.path.lexists(stale):
                shutil.rmtree(stale)
            os.rename(path, stale)
            os.rename(dest, path)
            shutil.rmtree(stale)
        distributed.barrier()


def _read_meta(path):
    name = os.path.join(path, 'meta.json')
    if not os.path.exists(name):
        return None
    with open(name) as f:
        return json.load(f)


def load_sharded(path, spec, shareds, mesh=None, n_rows=None,
                 extended=False):
    """Restore (state, assignments, SavedGenerator or None, sweep,
    logger_rows) from a sharded checkpoint.

    The state comes back replicated, on the shareds' device.  With
    mesh=None the assignments come back as one [R] tensor; with a mesh as
    a `sharding.RowSharded` of this process's row shards, whatever mesh
    they were saved from: each local shard reads the saved shard keys
    that overlap its row range.  n_rows: R, when known (checked against
    the checkpoint).  Assignments, generator and sweep are None / None /
    0 when the checkpoint has none.

    A checkpoint written after the capacity grew holds the grown state:
    extended=True returns a LoadedCheckpoint with the spec at the saved
    capacity and the saved hyperparameters (shareds / cl_model, None when
    the checkpoint has none); without it a capacity other than
    spec.capacity raises ValueError."""
    path = os.path.abspath(path)
    meta = _read_meta(path)
    if meta and meta.get('capacity') and \
            int(meta['capacity']) != spec.capacity:
        if not extended:
            raise ValueError(
                'checkpoint capacity %d != spec.capacity %d (the run grew '
                'mid-flight); call load_sharded(..., extended=True) and use '
                'the returned spec' % (int(meta['capacity']), spec.capacity))
        spec = spec._replace(capacity=int(meta['capacity']))
    saved_shareds, saved_cl = None, None
    template = mx.init(spec, shareds)
    dev = template.counts.device
    if meta and meta.get('hypers') is not None:
        saved_shareds, saved_cl = _ck._hypers_from_json(
            json.dumps(meta['hypers']).encode(), spec, device=dev)
        # dpd: the group tables' shapes follow the shareds
        template = mx.init(spec, saved_shareds)

    stored = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    target = {k: torch.empty_like(v)
              for k, v in _state_entries(template).items()}
    pieces = sorted((int(m.group(1)), int(m.group(2)), k)
                    for k, m in ((k, _SHARD_KEY.match(k)) for k in stored)
                    if m)
    ranges = []
    if pieces:
        total = max(b for _, b, _ in pieces)
        if n_rows is not None and int(n_rows) != total:
            raise ValueError('the checkpoint holds %d rows, not %d'
                             % (total, n_rows))
        ranges = [(0, total)] if mesh is None \
            else sharding.local_row_ranges(mesh, total)
        for a, b, k in pieces:
            if any(a < hi and lo < b for lo, hi in ranges):
                target[k] = torch.empty(
                    tuple(stored[k].size), dtype=stored[k].properties.dtype,
                    device=dev)
    if 'rng_key' in stored:
        target['rng_key'] = torch.empty(tuple(stored['rng_key'].size),
                                        dtype=torch.int64)
    _quietly(dcp.load, target, storage_reader=dcp.FileSystemReader(path))

    groups = tuple(
        type(g)(*(target['state/groups/%d/%s' % (b, f)] for f in g._fields))
        for b, g in enumerate(template.groups))
    state = mx.MixtureState(counts=target['state/counts'],
                            alive=target['state/alive'],
                            sample_size=target['state/sample_size'],
                            groups=groups)
    assignments = None
    if pieces:
        shards = []
        for lo, hi in ranges:
            parts = [target[k][max(lo, a) - a:min(hi, b) - a]
                     for a, b, k in pieces if a < hi and lo < b]
            shard = torch.cat(parts)
            if shard.shape[0] != hi - lo:
                raise ValueError('the checkpoint does not cover rows '
                                 '[%d, %d)' % (lo, hi))
            shards.append(shard)
        assignments = shards[0] if mesh is None else sharding.RowSharded(
            shards, total, mesh)
    saved = None
    if 'rng_key' in target:
        saved = _ck._words_to_generator(
            [int(w) for w in target['rng_key'].tolist()])
    sweep, rows = 0, []
    if meta:
        sweep, rows = int(meta['sweep']), meta['logger_rows']
    if extended:
        return LoadedCheckpoint(state, assignments, saved, sweep, rows,
                                saved_shareds, saved_cl, spec)
    return state, assignments, saved, sweep, rows
