"""Worker of tests/test_torch_sharded_step.py: one rank of a
`torch.distributed` group on the CPU (gloo).

    python torch_psum_worker.py RANK WORLD PORT OUT_DIR

Every rank joins the group at localhost:PORT and reduces a tree of
tensors of several dtypes and shapes (a 0-d count, [C] and [C, 2, 3]
floats, [C] ints, a None leaf) over a global 'rows' mesh with
`Mesh.psum`, `pmax` and `pmin`, which pack the tree into one
`all_reduce` per dtype, and compares each result bitwise with one
`all_reduce` per tensor.  It writes 'equal 3' to OUT_DIR/rank<RANK>.txt
when all three agree and exits non-zero otherwise."""

import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from distributions_tpu_torch import config                   # noqa: E402
from distributions_tpu_torch.parallel import (distributed,  # noqa: E402
                                              sharding)

C = 37


def tree(rank):
    """The rank's tree: f32 values with many bits, so that a sum in
    another order would show."""
    g = torch.Generator().manual_seed(100 + rank)
    return (torch.tensor(rank + 3, dtype=torch.int32),
            (torch.randn(C, generator=g) * 1e4,
             torch.randint(-50, 50, (C,), generator=g, dtype=torch.int32)),
            None,
            torch.randn(C, 2, 3, generator=g) / 3)


def per_leaf(t, op):
    def leaf(x):
        x = x.clone()
        dist.all_reduce(x, op=op)
        return x
    return sharding._tree_map(leaf, t)


def bits(t):
    """The bytes of every tensor of `t`, in order."""
    out = []
    sharding._tree_map(lambda x: out.append(
        x.reshape(-1).view(torch.uint8).tolist()) or x, t)
    return out


def main():
    rank, world, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4])
    config.set_default_device('cpu')
    torch.set_num_threads(1)
    distributed.initialize('localhost:%d' % port, world, rank, timeout=60)
    try:
        mesh = distributed.make_global_mesh()
        x = tree(rank)
        n_equal = 0
        for name, op in (('psum', dist.ReduceOp.SUM),
                         ('pmax', dist.ReduceOp.MAX),
                         ('pmin', dist.ReduceOp.MIN)):
            packed = getattr(mesh, name)([x], sharding.ROWS)[0]
            want = per_leaf(x, op)
            if packed[2] is not None or bits(packed) != bits(want):
                raise AssertionError('%s: the packed all_reduce differs'
                                     % name)
            n_equal += 1
        with open(os.path.join(out_dir, 'rank%d.txt' % rank), 'w') as f:
            f.write('equal %d\n' % n_equal)
    finally:
        distributed.shutdown()


if __name__ == '__main__':
    main()
