"""The port's model samplers and group dicts against distributions_tpu:
`group_to_dict` / `group_from_dict` on the same values through both
packages, and `sample_value` / `sample_group` by goodness of fit against
the model's own scores, in the manner of tests/test_models.py (the streams
differ from JAX's by design)."""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from distributions_tpu import util
from distributions_tpu_torch import config, testing
from distributions_tpu_torch.models import MODULES, base

torch.set_num_threads(1)
config.set_default_device('cpu')

SAMPLE_COUNT = 1000
MIN_GOODNESS_OF_FIT = 1e-3
CASES = [(name, i) for name, module in sorted(MODULES.items())
         for i in range(len(module.EXAMPLES))]
cases = pytest.mark.parametrize('name,idx', CASES,
                                ids=['%s-%d' % c for c in CASES])
DISCRETE = [c for c in CASES if MODULES[c[0]].Value in (bool, int)]


def _jax(name):
    return importlib.import_module('distributions_tpu.models.' + name)


def _shared(name, example, gen=None, realize=False):
    """The example's Shared; dpd observes the example's values (and
    optionally realizes its sticks), as tests/test_models.py loads it."""
    module = MODULES[name]
    shared = module.shared_from_dict(example['shared'])
    if name == 'dpd':
        for v in example['values']:
            shared = module.shared_add_value(gen, shared, v)
        if realize:
            shared = module.shared_realize(gen, shared)
    return shared


def _value(name, v):
    return torch.as_tensor(np.asarray(v, np.float32 if name in (
        'nich', 'niw') else None))


def _group(name, shared, values):
    module = MODULES[name]
    group = module.group_init(shared)
    for v in values:
        group = module.add_value(shared, group, _value(name, v))
    return group


def _py(v):
    v = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    if v.ndim:
        return v
    return bool(v) if v.dtype == bool else int(v)


@cases
def test_group_dicts_match_jax(name, idx):
    """group_to_dict of a group holding the example's values equals the
    JAX package's, and group_from_dict brings it back."""
    module, jmod = MODULES[name], _jax(name)
    example = module.EXAMPLES[idx]
    gen = torch.Generator().manual_seed(0)
    shared = _shared(name, example, gen)
    group = _group(name, shared, example['values'])
    extra = (shared,) if name == 'dpd' else ()
    dumped = module.group_to_dict(group, *extra)
    if name == 'dpd':
        jshared = jmod.shared_from_dict(module.shared_to_dict(shared),
                                        cap=int(module.capacity(shared)))
        jextra = (jshared,)
    else:
        jshared = jmod.shared_from_dict(example['shared'])
        jextra = ()
    jgroup = jmod.group_init(jshared)
    for v in example['values']:
        jgroup = jmod.add_value(jshared, jgroup, jnp.asarray(
            np.asarray(v, np.float32 if name in ('nich', 'niw') else None)))
    want = jmod.group_to_dict(jgroup, *jextra)
    assert set(dumped) == set(want)
    for key in want:
        np.testing.assert_allclose(
            np.asarray(dumped[key] if not isinstance(dumped[key], dict)
                       else sorted(dumped[key].items()), np.float64),
            np.asarray(want[key] if not isinstance(want[key], dict)
                       else sorted(want[key].items()), np.float64),
            rtol=1e-6, atol=1e-5)
    again = module.group_to_dict(module.group_from_dict(dumped, *extra),
                                 *extra)
    assert str(again) == str(dumped)


@cases
def test_sample_value_matches_score_value(name, idx):
    """sample_value against score_value, from the prior and from a group
    holding the example's values (tests/test_models.py's sampler test)."""
    module = MODULES[name]
    example = module.EXAMPLES[idx]
    gen = torch.Generator().manual_seed(1)
    shared = _shared(name, example, gen, realize=True)
    for values in ([], example['values']):
        group = _group(name, shared, values)
        samples = [module.sample_value(gen, shared, group)
                   for _ in range(SAMPLE_COUNT)]
        if module.Value in (bool, int):
            pys = [_py(s) for s in samples]
            probs = {v: math.exp(float(module.score_value(
                shared, group, torch.as_tensor(v)))) for v in set(pys)}
            gof = util.discrete_goodness_of_fit(pys, probs)
        elif module.Value is float:
            x = torch.stack(samples)
            probs = np.exp(module.score_value(shared, group, x).numpy())
            gof = util.density_goodness_of_fit(
                x.numpy().astype(np.float64), probs.astype(np.float64))
        else:
            # niw: the Mahalanobis distance under the student-t predictive
            # is an F(d, dof) variable
            x = torch.stack(samples).double().numpy()
            post = module.plus_group(shared, group)
            d = x.shape[-1]
            dof = float(post.nu) - d + 1.0
            kappa = float(post.kappa)
            sigma = (post.psi.double().numpy() * (kappa + 1.0)
                     / (kappa * dof))
            diff = x - post.mu.double().numpy()
            maha = np.einsum('nd,de,ne->n', diff, np.linalg.inv(sigma), diff)
            gof = util.unif01_goodness_of_fit(
                scipy.stats.f.cdf(maha / d, d, dof))
        assert gof > MIN_GOODNESS_OF_FIT, (name, len(values), gof)


@pytest.mark.parametrize('name,idx', DISCRETE,
                         ids=['%s-%d' % c for c in DISCRETE])
def test_sample_group_matches_score_data(name, idx):
    """Pairs from sample_group against exp(score_data) of their group
    (the discrete models, whose pairs can be enumerated;
    tests/test_models.py)."""
    module = MODULES[name]
    example = module.EXAMPLES[idx]
    gen = torch.Generator().manual_seed(3)
    shared = _shared(name, example, gen, realize=True)
    samples, probs = [], {}
    for _ in range(SAMPLE_COUNT):
        pair = tuple(_py(v) for v in module.sample_group(gen, shared, 2))
        samples.append(pair)
        if pair not in probs:
            probs[pair] = math.exp(float(module.score_data(
                shared, _group(name, shared, pair))))
    gof = util.discrete_goodness_of_fit(samples, probs)
    assert gof > MIN_GOODNESS_OF_FIT, (name, gof)


@cases
def test_large_sample_group_matches_predictive(name, idx):
    """`testing.sample_group_z`, the check chip_smoke.py makes at 65,536
    values, at 8192: the last 512 values of one sample_group against the
    predictive of its first 4096, |z| < 5 in every bin."""
    module = MODULES[name]
    example = module.EXAMPLES[idx]
    gen = torch.Generator().manual_seed(4)
    shared = _shared(name, example, gen, realize=True)
    values = module.sample_group(gen, shared, 8192)
    assert values.shape[0] == 8192
    assert testing.sample_group_z(module, shared, values, 512, 4096) < 5.0


def test_generic_sample_group_draws_params_once():
    """base.generic_sample_group: one parameter draw, then iid values."""
    calls = []

    def init(gen, shared):
        calls.append(1)
        return torch.tensor(0.25)

    def evaluate(gen, shared, p, shape):
        return torch.full(shape, float(p))
    out = base.generic_sample_group(init, evaluate, torch.Generator(), None,
                                    5)
    assert calls == [1] and out.tolist() == [0.25] * 5
