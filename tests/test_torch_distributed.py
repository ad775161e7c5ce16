"""parallel/distributed.py: two real processes of a `torch.distributed`
group with gloo, spawned from here, against the in-process mesh of the same
shape.  The sweeps fold tile, row-shard and component indices into their
seeds, never the rank, so the draws must be the same: assignments and
counts exactly, the score within rtol 1e-5 / atol 1e-3 (`all_reduce` may
add in another order than the in-process mesh; with one row shard per rank
the sums have two terms and are equal too)."""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from distributions_tpu_torch import config, mixture as mx
from distributions_tpu_torch.ops import gibbs
from distributions_tpu_torch.parallel import distributed, sharding

torch.set_num_threads(1)
config.set_default_device('cpu')

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_multiprocess_worker as worker   # noqa: E402

MODES = ('blocked', 'host_rows', 'fused', '2d', '2d_fused',
         '2d_components_over_processes',
         '2d_components_over_processes_fused', 'runner')


def _free_port():
    s = socket.socket()
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_group(nproc, out_dir, timeout=150):
    """Spawn the ranks; kill them all when one fails or time runs out."""
    port = _free_port()
    env = dict(os.environ)
    for name in ('XLA_FLAGS', 'JAX_PLATFORMS'):
        env.pop(name, None)
    logs = [open(os.path.join(out_dir, 'rank%d.log' % p), 'w+')
            for p in range(nproc)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, 'torch_multiprocess_worker.py'),
         str(p), str(nproc), str(port), out_dir],
        env=env, stdout=logs[p], stderr=subprocess.STDOUT)
        for p in range(nproc)]
    deadline = time.time() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = any(p.poll() not in (None, 0) for p in procs)
            if failed or time.time() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read()[-3000:])
        f.close()
    assert all(p.returncode == 0 for p in procs), \
        'workers failed or timed out:\n' + '\n---\n'.join(outs)


@pytest.fixture(scope='module')
def two_processes(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp('group'))
    _run_group(2, out_dir)
    return np.load(os.path.join(out_dir, 'result.npz'))


@pytest.fixture(scope='module')
def one_process(tmp_path_factory):
    return worker.run_modes(worker.IN_PROCESS,
                            str(tmp_path_factory.mktemp('local')))


@pytest.mark.parametrize('mode', MODES)
def test_two_processes_equal_the_in_process_mesh(two_processes, one_process,
                                                 mode):
    """The analogs of tests/test_multiprocess.py: the row-sharded sweep
    (also from per-process rows), the fused one, the 2-D sweeps with rows
    and then components cut over the processes, and run_gibbs(mesh=...)."""
    got, want = two_processes, one_process
    np.testing.assert_array_equal(got[mode + '_an'], want[mode + '_an'])
    np.testing.assert_array_equal(got[mode + '_counts'],
                                  want[mode + '_counts'])
    assert got[mode + '_counts'].sum() == worker.R
    np.testing.assert_allclose(float(got[mode + '_score']),
                               want[mode + '_score'], rtol=1e-5, atol=1e-3)


def test_two_process_runner_checkpoints_and_resumes(two_processes,
                                                    one_process):
    got = two_processes
    assert bool(got['checkpoint_written'])
    assert got['runner_sweeps'].tolist() == [1, 3]
    # a resumed run equals the uninterrupted one bitwise, under the process
    # group as under the in-process mesh
    assert bool(got['resume_bitwise']) and bool(one_process['resume_bitwise'])
    assert float(got['fused_with_score']) == pytest.approx(
        one_process['fused_with_score'], rel=1e-5)


def test_host_rows_equal_full_rows(one_process):
    """Sweeps fed RowSharded values and assignments draw what sweeps fed
    the full arrays draw."""
    np.testing.assert_array_equal(one_process['host_rows_an'],
                                  one_process['blocked_an'])


def test_without_a_group():
    assert distributed.process_count() == 1
    assert distributed.process_index() == 0
    assert not distributed.is_multiprocess()
    assert distributed.host_row_slice(64) == (0, 64)
    distributed.barrier()
    with pytest.raises(ValueError, match='coordinator_address'):
        distributed.initialize()
    with pytest.raises(RuntimeError, match='initialize'):
        distributed.make_global_mesh()
    with pytest.raises(ValueError, match='do not divide'):
        distributed.host_row_slice(7, sharding.Mesh(('rows',), (1,), (2,),
                                                    (1,)))
    assert distributed.host_row_slice(
        8, sharding.Mesh(('rows',), (1,), (2,), (1,))) == (4, 8)
    a = np.arange(6, dtype=np.int32)
    np.testing.assert_array_equal(distributed.gather_rows(torch.from_numpy(a)),
                                  a)
    tree = distributed.replicate((a, {'k': 1}, [a.astype(np.float32)]), None)
    assert isinstance(tree[0], torch.Tensor) and tree[0].dtype == torch.int32
    assert tree[1] == {'k': 1} and tree[2][0].dtype == torch.float32
    assert distributed.sync(tree) is tree
    mesh = sharding.make_mesh(2)
    rows, = distributed.global_rows_from_host_data((a,), 6, mesh)
    assert [s.tolist() for s in rows.shards] == [[0, 1, 2], [3, 4, 5]]
    np.testing.assert_array_equal(distributed.gather_rows(rows), a)
    with pytest.raises(ValueError, match='this process holds'):
        distributed.global_rows_from_host_data((a[:4],), 6, mesh)


def test_a_group_of_one_rank_in_this_process():
    """`initialize` at world size 1 (gloo): the global mesh holds a process
    group per axis and its sweep equals the single-device fused sweep."""
    spec, py, shareds, X, labels = worker.problem(seed=1)
    values = (torch.from_numpy(X),)
    a0 = torch.from_numpy(labels)
    st0 = mx.state_from_assignments(spec, py, shareds, values, a0)
    cache = gibbs.build_stat_cache(spec, shareds, values, 16, a0)
    distributed.initialize('localhost:%d' % _free_port(), 1, 0, timeout=30)
    try:
        assert torch.distributed.get_backend() == 'gloo'
        mesh = distributed.make_global_mesh(shards_per_process=2)
        assert mesh.size == 2 and sharding.ROWS in mesh.groups
        mesh2 = distributed.make_global_mesh_2d(components_per_host=2)
        assert set(mesh2.groups) == {'rows', 'components'}
        st, an, _ = sharding.sharded_sweep_fused(
            spec, py, shareds, st0, values, a0,
            torch.Generator().manual_seed(2), mesh, 16, cache,
            sampling='gumbel')
    finally:
        distributed.shutdown()
    assert not torch.distributed.is_initialized()
    want = sharding.sharded_sweep_fused(
        spec, py, shareds, st0, values, a0, torch.Generator().manual_seed(2),
        sharding.make_mesh(2), 16, cache, sampling='gumbel')
    assert torch.equal(an, want[1]) and torch.equal(st.counts, want[0].counts)
