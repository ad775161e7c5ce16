"""Multi-process execution (distributions_tpu.parallel.distributed):
`torch.distributed` process groups, global meshes whose 'rows' axis spans
the processes, and per-process data loading.

One process drives one device.  `initialize` joins the process group
(NCCL when the port's default device is a card, gloo when it is the CPU);
nothing here runs at import, and the in-process meshes of
`parallel.sharding` need none of it.  A global mesh holds one process
group per axis line (`dist.new_group`), through which the sweeps'
`psum` / `pmax` / `pmin` end in `all_reduce`.

Reproducibility: the sweeps fold tile, row-shard and component indices
into their seeds, never the rank, so an N-shard run gives the same draws
whether the N shards live in one process or in several, as long as every
rank passes a `torch.Generator` in the same state
(tests/test_torch_distributed.py holds two gloo processes to the
in-process mesh).
"""

import datetime

import numpy as np
import torch
import torch.distributed as dist

from distributions_tpu_torch import config
from distributions_tpu_torch.parallel import sharding as _sharding

ROWS = _sharding.ROWS
COMPONENTS = _sharding.COMPONENTS


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, local_device_ids=None, timeout=None):
    """Join (or create) the process group.

    coordinator_address: 'host:port' of rank 0 (any free port);
    num_processes and process_id: the world size and this process's rank.
    Nothing is read from the environment: pass all three.  The backend
    follows `config.default_device()`: NCCL for a card (local_device_ids,
    when given, names this process's card and makes it the current
    device), gloo for the CPU.  timeout: seconds for the group's
    collectives (the backend's default when None)."""
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError('initialize needs coordinator_address, '
                         'num_processes and process_id')
    on_card = config.default_device().type == 'cuda'
    if on_card and local_device_ids:
        torch.cuda.set_device(int(local_device_ids[0]))
    kwargs = {}
    if timeout is not None:
        kwargs['timeout'] = datetime.timedelta(seconds=float(timeout))
    dist.init_process_group(
        backend='nccl' if on_card else 'gloo',
        init_method='tcp://%s' % coordinator_address,
        world_size=int(num_processes), rank=int(process_id), **kwargs)


def shutdown():
    """Leave the process group that `initialize` joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count():
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index():
    return dist.get_rank() if dist.is_initialized() else 0


def is_multiprocess():
    return process_count() > 1


def make_process_mesh(axis_names, local_shape, process_shape):
    """A mesh whose axis `a` has process_shape[a] processes holding
    local_shape[a] shards each.  The processes form a row-major grid over
    the axes (rank = the row-major index of its place), and every line of
    ranks along an axis gets a process group of its own; every rank must
    make the same call.  Needs `initialize`."""
    if not dist.is_initialized():
        raise RuntimeError('make_process_mesh needs distributed.initialize')
    process_shape = tuple(int(p) for p in process_shape)
    world = dist.get_world_size()
    if int(np.prod(process_shape)) != world:
        raise ValueError('a process grid %s needs %d ranks, the group has %d'
                         % (process_shape, int(np.prod(process_shape)),
                            world))
    grid = np.arange(world).reshape(process_shape)
    rank = dist.get_rank()
    place = tuple(int(i[0]) for i in np.nonzero(grid == rank))
    groups = {}
    for ax, name in enumerate(axis_names):
        lines = np.moveaxis(grid, ax, -1).reshape(-1, process_shape[ax])
        for line in lines:
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[name] = group
    return _sharding.Mesh(axis_names, local_shape, process_shape, place,
                          groups)


def make_global_mesh(axis_name=ROWS, shards_per_process=1):
    """1-D global mesh named 'rows' over every process: the data-parallel
    axis.  Shard order is (process, local shard), so each process owns a
    contiguous row range."""
    return make_process_mesh((axis_name,), (shards_per_process,),
                             (process_count(),))


def make_global_mesh_2d(components_per_host=None, rows_per_host=1):
    """2-D ('rows' x 'components') global mesh: components sharded WITHIN
    each process (the pair reduce of every tile stays local), rows over
    the processes (which exchange only the per-tile stat sums)."""
    return make_process_mesh(
        (ROWS, COMPONENTS), (rows_per_host, components_per_host or 1),
        (process_count(), 1))


def host_row_slice(n_rows, mesh=None):
    """The contiguous [start, stop) global-row range this process owns
    under a 'rows'-sharded layout: what a per-process data loader should
    read.  n_rows must divide evenly over the processes of 'rows'."""
    if mesh is None:
        n_proc, index = process_count(), process_index()
    else:
        n_proc = mesh.process_shape.get(ROWS, 1)
        index = mesh.process_index.get(ROWS, 0)
    if n_rows % n_proc != 0:
        raise ValueError('%d rows do not divide over %d processes'
                         % (n_rows, n_proc))
    per = n_rows // n_proc
    return index * per, (index + 1) * per


def global_rows_from_host_data(local_values, n_rows, mesh, axis_name=ROWS):
    """Global row-sharded arrays from each process's local row shard
    (loaded via `host_row_slice`), without gathering: every leaf becomes a
    `sharding.RowSharded` holding this process's rows, cut into its row
    shards, on `config.default_device()`.

    local_values: tuple of [local_R, ...] numpy arrays or tensors."""
    n_local = mesh.local_shape.get(axis_name, 1)
    out = []
    for v in local_values:
        v = v if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v))
        v = v.to(config.default_device())
        start, stop = host_row_slice(n_rows, mesh)
        if v.shape[0] != stop - start or v.shape[0] % n_local != 0:
            raise ValueError('this process holds rows [%d, %d) in %d '
                             'shards, got %d rows'
                             % (start, stop, n_local, v.shape[0]))
        out.append(_sharding.RowSharded(torch.chunk(v, n_local, dim=0),
                                        n_rows, mesh))
    return tuple(out)


def replicate(tree, mesh):
    """A host-local tree (state, hyperparameters) with numpy leaves as
    tensors on `config.default_device()`: a replicated value is one copy
    per process."""
    dev = config.default_device()

    def leaf(a):
        if isinstance(a, (torch.Tensor, np.ndarray, np.generic)):
            return torch.as_tensor(a).to(dev)
        if isinstance(a, tuple) and hasattr(a, '_fields'):
            return type(a)(*(leaf(x) for x in a))
        if isinstance(a, (tuple, list)):
            return type(a)(leaf(x) for x in a)
        return a
    return leaf(tree)


def gather_rows(array):
    """A 'rows'-sharded array as one numpy array on every process
    (checkpointing, diagnostics).  A full tensor is just copied."""
    if isinstance(array, _sharding.RowSharded):
        array = _sharding._unshard_rows(
            array.mesh,
            _sharding._shard_rows(array.mesh, array), None)
    return torch.as_tensor(array).cpu().numpy()


def barrier():
    """Wait for every process of the group (a no-op in one process)."""
    if is_multiprocess():
        dist.barrier()


def sync(tree):
    """Wait for the device work behind `tree`'s tensors."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return tree
