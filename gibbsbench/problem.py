"""The benchmark's inputs: its files found by name, and the rows made from
`--seed` on the device.

- gibbsbench/configs/<config>.json: a deployment's model (the feature
  blocks and their hyperparameters, the prior), its rows and tile rows,
  how its rows are generated, and the limits of the comparison that
  decides `correct`.
- gibbsbench/traffic/<traffic>.json: the load put on it: `slots` (the
  capacity), `generating_clusters`, `sweeps_per_step`, `sampling`.

The rows follow the JAX package's runner benchmark (every cluster's
center drawn around 0 and rows drawn around their cluster's center, or
every cluster a coin and rows its flips; or columns of noise that carry
no cluster), drawn with a torch.Generator on the device from the seed.
"""

import json
import os

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# independent streams of one seed
STREAMS = ('data', 'warmup', 'window', 'start', 'sample', 'control')


def sub_seed(seed, stream):
    """A 63-bit seed of `stream` from the run's seed (any whole number)."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1),
                                 STREAMS.index(stream)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed, stream, device):
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, stream))
    return g


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(root, 'BENCHMARK.json')


def workload(bench, name):
    for w in bench['workloads']:
        if w['name'] == name:
            return w
    raise KeyError('no workload %r in BENCHMARK.json' % (name,))


def config(name):
    return load_json(HERE, 'configs', name + '.json')


def traffic(name):
    return load_json(HERE, 'traffic', name + '.json')


def block_shape(block, R):
    """A block's values shape: [R, cols], or [R, cols, d] for niw."""
    if block['model'] == 'niw':
        return (R, block['cols'], len(block['shared']['mu']))
    return (R, block['cols'])


def make_rows(cfg, n_clusters, seed, device):
    """(generating labels [R] int32, values: a tensor per block) of the
    configuration's rows, from `seed`."""
    R = cfg['rows']
    g = generator(seed, 'data', device)
    labels = torch.randint(0, n_clusters, (R,), generator=g, device=device)
    values = []
    for block in cfg['blocks']:
        shape = block_shape(block, R)
        data = block['data']
        kind = data['kind']
        if kind == 'blobs':
            centers = data['center_scale'] * torch.randn(
                (n_clusters,) + shape[1:], generator=g, device=device)
            v = centers[labels] + data['noise'] * torch.randn(
                shape, generator=g, device=device)
        elif kind == 'normal':
            v = data['scale'] * torch.randn(shape, generator=g,
                                            device=device)
        elif kind == 'bernoulli':
            v = torch.rand(shape, generator=g, device=device) < data['p']
        elif kind == 'coins':
            # each cluster's heads probability uniform on (0, 1), a row
            # each column a flip of its cluster's coin
            heads = torch.rand((n_clusters,) + shape[1:], generator=g,
                               device=device)
            v = torch.rand(shape, generator=g, device=device) < heads[labels]
        else:
            raise ValueError('unknown data kind %r' % (kind,))
        values.append(v)
    return labels.to(torch.int32), tuple(values)
