"""Worker of tests/test_torch_distributed.py: one rank of a
`torch.distributed` group on the CPU (gloo).

    python torch_multiprocess_worker.py RANK WORLD PORT OUT_DIR

Every rank joins the group at localhost:PORT, drives the sharded sweeps
and `run_gibbs(mesh=...)` on global meshes (`run_modes`), and rank 0 writes
the results to OUT_DIR/result.npz.  The test imports `run_modes` too and
calls it with in-process meshes of the same shapes: the two must agree.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from distributions_tpu_torch import clustering, config       # noqa: E402
from distributions_tpu_torch import mixture as mx            # noqa: E402
from distributions_tpu_torch.inference import runner         # noqa: E402
from distributions_tpu_torch.models import nich              # noqa: E402
from distributions_tpu_torch.ops import gibbs                # noqa: E402
from distributions_tpu_torch.parallel import distributed, sharding  # noqa: E402

R, C = 64, 32
ROWS, COMPONENTS = sharding.ROWS, sharding.COMPONENTS

# mesh makers of the two forms, by the name `run_modes` asks for
IN_PROCESS = {
    'rows': lambda: sharding.make_mesh(2),
    '2d': lambda: sharding.make_mesh_2d(2, 4),
    '2d_components_over_processes': lambda: sharding.make_mesh_2d(2, 4),
}
PROCESS_GROUP = {
    # 2 ranks x 1 row shard
    'rows': distributed.make_global_mesh,
    # rows over the ranks, 4 component shards within each
    '2d': lambda: distributed.make_global_mesh_2d(components_per_host=4),
    # components over the ranks (2 x 2 shards each), both row shards local
    '2d_components_over_processes': lambda: distributed.make_process_mesh(
        (ROWS, COMPONENTS), (2, 2), (1, 2)),
}


def problem(seed=0):
    """tests/test_multiprocess.py::_problem."""
    rng = np.random.RandomState(seed)
    spec = mx.make_spec([(nich, 2)], capacity=C, empties=1)
    shareds = (nich.shared_from_dict(
        {'mu': 0., 'kappa': 0.1, 'sigmasq': 1.0, 'nu': 1.}),)
    py = clustering.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.1})
    centers = rng.randn(3, 2) * 3
    labels = rng.randint(0, 3, R)
    X = (centers[labels] + 0.3 * rng.randn(R, 2)).astype(np.float32)
    return spec, py, shareds, X, labels.astype(np.int32)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def run_modes(meshes, tmp_dir):
    """Every sharded path on the meshes `meshes` makes; a dict of numpy
    results."""
    spec, py, shareds, X, labels = problem()
    values = (torch.from_numpy(X),)
    a0 = torch.from_numpy(labels)
    st0 = mx.state_from_assignments(spec, py, shareds, values, a0)
    out = {}

    def keep(name, state, assignments):
        out[name + '_an'] = assignments.numpy()
        out[name + '_counts'] = state.counts.numpy()
        out[name + '_score'] = float(mx.score_data(spec, py, shareds, state))

    # the row-sharded blocked sweep, 4 sweeps
    mesh = meshes['rows']()
    gen, st, an = _gen(42), st0, a0
    for _ in range(4):
        st, an = sharding.sharded_sweep_blocked(spec, py, shareds, st, values,
                                                an, gen, mesh, 4)
    keep('blocked', st, an)

    # the same from each process's own rows only
    lo, hi = distributed.host_row_slice(R, mesh)
    rv = distributed.global_rows_from_host_data((X[lo:hi],), R, mesh)
    ra, = distributed.global_rows_from_host_data((labels[lo:hi],), R, mesh)
    gen, st = _gen(42), st0
    for _ in range(4):
        st, ra = sharding.sharded_sweep_blocked(spec, py, shareds, st, rv, ra,
                                                gen, mesh, 4)
    keep('host_rows', st, torch.from_numpy(distributed.gather_rows(ra)))

    # the row-sharded fused sweep, with its kernel's own noise
    cache = gibbs.build_stat_cache(spec, shareds, values, 8, a0)
    st, an, _, score = sharding.sharded_sweep_fused(
        spec, py, shareds, st0, values, a0, _gen(7), mesh, 8, cache,
        sampling='gumbel', n_sweeps=2, with_score=True)
    keep('fused', st, an)
    out['fused_with_score'] = float(score)

    # 2-D sweeps, rows over the processes and then components over them
    for name in ('2d', '2d_components_over_processes'):
        mesh2 = meshes[name]()
        gen, st, an = _gen(5), st0, a0
        for _ in range(3):
            st, an = sharding.sharded_sweep_2d(spec, py, shareds, st, values,
                                               an, gen, mesh2, 8,
                                               sampling='argmax')
        keep(name, st, an)
        st, an = sharding.sharded_sweep_2d_fused(
            spec, py, shareds, st0, values, a0, _gen(6), mesh2, 8,
            sampling='gumbel')
        keep(name + '_fused', st, an)

    # the runner with a checkpoint, and a resumed run against it
    common = dict(block=8, use_pallas=True, sampling='gumbel',
                  checkpoint_every=2, sweeps_per_step=2,
                  initial_assignments=a0)

    def run(passes, name, seed, resume):
        return runner.run_gibbs(
            spec, py, shareds, values, _gen(seed), passes, mesh=mesh,
            checkpoint_path=os.path.join(tmp_dir, name), resume=resume,
            **common)
    st, an, log = run(4, 'full.ckpt', 3, False)
    keep('runner', st, an)
    out['runner_sweeps'] = np.array([r['sweep'] for r in log.rows])
    run(2, 'crash.ckpt', 3, False)
    st_b, an_b, log_b = run(4, 'crash.ckpt', 999, True)
    out['resume_bitwise'] = np.array(
        torch.equal(an, an_b) and torch.equal(st.counts, st_b.counts)
        and all(torch.equal(x, y)
                for x, y in zip(st.groups[0], st_b.groups[0]))
        and log.rows[-1]['score_data'] == log_b.rows[-1]['score_data'])
    out['checkpoint_written'] = np.array(
        os.path.exists(os.path.join(tmp_dir, 'full.ckpt')))
    return out


def main():
    rank, world, port = (int(x) for x in sys.argv[1:4])
    out_dir = sys.argv[4]
    torch.set_num_threads(1)
    config.set_default_device('cpu')
    distributed.initialize('localhost:%d' % port, world, rank, timeout=60)
    try:
        assert distributed.process_count() == world
        assert distributed.process_index() == rank
        out = run_modes(PROCESS_GROUP, out_dir)
        if rank == 0:
            np.savez(os.path.join(out_dir, 'result.npz'), **out)
    finally:
        distributed.shutdown()


if __name__ == '__main__':
    main()
