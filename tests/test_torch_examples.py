"""The port's two examples, examples/mixture/main_torch.py and
examples/gmm_backends_torch.py, at small sizes on the CPU.

The mixture example runs all five strategies at examples/mixture/test.py's
shrunk size (200 points, capacity 32, tiles of 50); its image helpers are
held to main.py's: `default_image` exactly, `synthesize_image` of one
state to within 1 of 255 per pixel (float32 exp and sum in two libraries,
then a truncation to uint8); the CLI writes its images where --out says
and leaves the tracked examples/mixture/results/*.png as they were.  The
backends example runs every backend on 96 rows with short chains: each
reports a time and a purity, and the collapsed ones find the blobs
(purity > 0.9).
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributions_tpu import mixture as jmx
from distributions_tpu.models import nich as jnich
from distributions_tpu_torch import config, mixture as tmx

torch.set_num_threads(1)
config.set_default_device('cpu')

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'examples')


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


demo = _load(os.path.join(EXAMPLES, 'mixture', 'main_torch.py'),
             'mixture_main_torch')
jdemo = _load(os.path.join(EXAMPLES, 'mixture', 'main.py'),
              'mixture_main_jax')
backends = _load(os.path.join(EXAMPLES, 'gmm_backends_torch.py'),
                 'gmm_backends_torch')


def _small_model():
    model = demo.ImageModel()
    model.spec = model.spec._replace(capacity=32)
    return model


def test_mixture_example_all_strategies(monkeypatch):
    monkeypatch.setattr(demo, 'BLOCK', 50)
    generator = torch.Generator().manual_seed(0)
    image = demo.default_image(32, 32)
    X = demo.sample_from_image(generator, image, 200)
    assert X.shape == (200, 2) and X.dtype == np.float32
    assert X.min() >= -1.0 and X.max() <= 1.0
    model = _small_model()
    for name in demo.STRATEGIES:
        state, assignments = demo.STRATEGIES[name](model, X, generator)
        counts = state.counts.numpy()
        assert counts.sum() >= 200, (name, counts.sum())
        a = assignments.numpy()
        assert len(a) >= 200 and (np.bincount(a, minlength=32)
                                  == counts).all(), name
        img = demo.synthesize_image(model, state, 32, 32)
        assert img.shape == (32, 32) and img.dtype == np.uint8


def test_image_helpers_match_the_jax_example():
    np.testing.assert_array_equal(demo.default_image(),
                                  jdemo.default_image())
    np.testing.assert_array_equal(demo.default_image(32, 48),
                                  jdemo.default_image(32, 48))
    X = demo.load_dataset()[:300]
    rng = np.random.RandomState(0)
    assignments = rng.randint(0, 12, len(X)).astype(np.int32)
    model = _small_model()
    state = tmx.state_from_assignments(
        model.spec, model.clustering, model.shareds,
        (torch.from_numpy(X),), torch.from_numpy(assignments))
    jmodel = jdemo.ImageModel()
    jmodel.spec = jmodel.spec._replace(capacity=32)
    jstate = jmx.MixtureState(
        counts=jnp.asarray(state.counts.numpy()),
        alive=jnp.asarray(state.alive.numpy()),
        sample_size=jnp.asarray(state.sample_size.numpy()),
        groups=(jnich.Group(*(jnp.asarray(x.numpy())
                              for x in state.groups[0])),))
    got = demo.synthesize_image(model, state, 40, 40)
    want = jdemo.synthesize_image(jmodel, jstate, 40, 40)
    assert got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_mixture_cli_writes_only_where_told(tmp_path):
    tracked = os.path.join(EXAMPLES, 'mixture', 'results')
    before = {f: open(os.path.join(tracked, f), 'rb').read()
              for f in sorted(os.listdir(tracked))}
    assert demo.RESULTS != tracked
    out = tmp_path / 'out'
    demo.main(['gibbs', '--samples', '500', '--passes', '1', '--cpu',
               '--out', str(out)])
    names = sorted(os.listdir(out))
    assert [n.split('.')[0] for n in names] == ['gibbs', 'original']
    after = {f: open(os.path.join(tracked, f), 'rb').read()
             for f in sorted(os.listdir(tracked))}
    assert after == before


def test_mixture_dataset_is_the_tracked_one():
    X = demo.load_dataset()
    assert X.shape == (10000, 2) and X.dtype == np.float32
    _, X2 = demo.create_dataset(torch.Generator(), 1000)
    np.testing.assert_array_equal(X2, X[:1000])


def test_gmm_backends_example_small():
    short = {'gibbs_sweeps': 10, 'mh_sweeps': 10,
             'hmc': {'num_samples': 10, 'num_warmup': 10, 'num_leapfrog': 4},
             'nuts': {'num_samples': 5, 'num_warmup': 5, 'max_depth': 3},
             'advi': {'num_steps': 30}}
    results = backends.run(rows=96, lengths=short)
    assert sorted(results) == sorted(['collapsed gibbs', 'mh sweep', 'hmc',
                                      'nuts', 'advi', 'smc'])
    for name, (seconds, purity) in results.items():
        assert seconds >= 0 and 1.0 / 3 <= purity <= 1.0, name
    for name in ('collapsed gibbs', 'smc'):
        assert results[name][1] > 0.9, (name, results[name])


@pytest.mark.parametrize('flag', [[], ['--cpu']])
def test_gmm_backends_cli_parses(flag, monkeypatch):
    seen = {}
    monkeypatch.setattr(backends, 'run', lambda rows: seen.update(rows=rows))
    backends.main(['--rows', '64'] + flag)
    assert seen == {'rows': 64}
    assert config.default_device().type == 'cpu'
