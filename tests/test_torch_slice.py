"""The port's slice-sampling moves (inference/slice.py).  They draw from
another stream than the JAX package's, so they are held in distribution,
as tests/test_slice.py holds the JAX package: `slice_1d` against known
densities, the clustering and feature steps against numerically
integrated posteriors of the objectives, and those objectives against the
JAX package's at the same points."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from distributions_tpu import clustering as jcl
from distributions_tpu.models import nich as jnich
from distributions_tpu_torch import clustering as tcl, config
from distributions_tpu_torch import mixture as tmx
from distributions_tpu_torch.inference import slice as sl
from distributions_tpu_torch.models import dd, nich, niw

torch.set_num_threads(1)
config.set_default_device('cpu')


def _chain(seed, x0, logp, n, **kw):
    gen = torch.Generator().manual_seed(seed)
    xs = []
    x = x0
    for _ in range(n):
        x = sl.slice_1d(gen, x, logp, **kw)
        xs.append(x)
    return np.asarray(xs)


def test_slice_1d_standard_normal():
    xs = _chain(0, 0.3, lambda x: -0.5 * x * x, 3000, width=2.0)
    d, p = scipy.stats.kstest(xs[300::3], 'norm')
    assert p > 1e-3, (d, p)


def test_slice_1d_respects_bounds():
    xs = _chain(1, 0.5, lambda x: -0.5 * x * x, 3000, width=1.5, lo=0.0)
    assert (xs >= 0).all()
    d, p = scipy.stats.kstest(xs[300::3], scipy.stats.halfnorm().cdf)
    assert p > 1e-3, (d, p)


def test_slice_1d_null_move_on_an_exhausted_shrink_budget():
    """With no shrink step allowed the move falls back to x0; a tensor
    objective is read as a float."""
    gen = torch.Generator().manual_seed(2)
    assert sl.slice_1d(gen, 0.7, lambda x: torch.tensor(-x * x),
                       max_shrink=0) == 0.7
    calls = []

    def logp(x):
        calls.append(x)
        return -0.5 * x * x
    sl.slice_1d(gen, 0.0, logp, width=0.5)
    assert len(calls) <= 3 + 16 + 32


def _counts_state(counts):
    counts = torch.as_tensor(counts, dtype=torch.int32)
    return tmx.MixtureState(counts=counts, alive=counts > -1,
                            sample_size=counts.sum().to(torch.int32),
                            groups=())


def _cdf_on(grid, scores):
    p = np.exp(scores - scores.max())
    cdf_grid = np.cumsum(p / p.sum())
    return lambda x: np.interp(x, grid, cdf_grid, left=0.0, right=1.0)


def test_slice_clustering_matches_numeric_posterior():
    counts = np.zeros(32, np.int32)
    counts[:5] = [40, 25, 18, 10, 7]
    state = _counts_state(counts)
    model = tcl.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.0})
    gen = torch.Generator().manual_seed(2)
    las = []
    for _ in range(1500):
        model, (la, _) = sl.slice_step_clustering(gen, model, state,
                                                  n_steps=1, sample_d=False)
        las.append(la)
    assert float(model.d) == 0.0
    # the target: flat in log alpha, scored by the port's score_counts,
    # which equals the JAX package's on the same grid
    grid = np.linspace(-4, 5, 400)
    scores = tcl.score_counts(
        tcl.PitmanYor(alpha=torch.exp(torch.from_numpy(grid).float()),
                      d=torch.zeros(400)), state.counts).numpy()
    want = np.asarray([float(jcl.score_counts(
        jcl.PitmanYor(alpha=float(np.exp(g)), d=0.0),
        jnp.asarray(counts, jnp.float32))) for g in grid[::40]])
    np.testing.assert_allclose(scores[::40], want, rtol=1e-5, atol=1e-4)
    d, p = scipy.stats.kstest(np.asarray(las)[300::2], _cdf_on(grid, scores))
    assert p > 1e-3, (d, p, np.mean(las))


def test_slice_clustering_with_d():
    counts = np.zeros(16, np.int32)
    counts[:6] = [30, 20, 12, 6, 3, 1]
    state = _counts_state(counts)
    model = tcl.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.3})
    gen = torch.Generator().manual_seed(5)
    alphas, ds = [], []
    for _ in range(300):
        model, _ = sl.slice_step_clustering(gen, model, state, n_steps=1)
        alphas.append(float(model.alpha))
        ds.append(float(model.d))
    alphas, ds = np.asarray(alphas), np.asarray(ds)
    assert np.isfinite(alphas).all() and np.isfinite(ds).all()
    assert (ds >= 0).all() and (ds < 1).all()
    assert np.unique(np.round(alphas, 6)).size > 100
    assert np.unique(np.round(ds, 6)).size > 100


def _nich_state(X, assignments, capacity=8):
    spec = tmx.make_spec([(nich, X.shape[1])], capacity=capacity)
    shared = nich.shared_from_dict(
        {'mu': 0., 'kappa': 1.0, 'sigmasq': 1.0, 'nu': 1.})
    py = tcl.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.0})
    state = tmx.state_from_assignments(
        spec, py, (shared,), (torch.from_numpy(X),),
        torch.from_numpy(assignments))
    return spec, shared, state


def test_slice_feature_nich_sigmasq():
    """Slice-resampled sigmasq follows the numeric posterior over log
    sigmasq of the block's score_data, which equals the JAX package's."""
    rng = np.random.RandomState(0)
    X = (2.5 * rng.randn(200, 1)).astype(np.float32)
    a = rng.randint(0, 4, 200).astype(np.int32)
    spec, shared, state = _nich_state(X, a)
    gen = torch.Generator().manual_seed(3)
    sh = shared
    lss = []
    for _ in range(1200):
        (sh,), _ = sl.slice_step_feature(gen, spec, 0, (sh,), state,
                                         ('sigmasq',), width=1.5)
        lss.append(math.log(float(sh.sigmasq)))
    assert float(sh.mu) == 0.0 and float(sh.kappa) == 1.0
    grid = np.linspace(-3, 5, 300)
    lifted = nich.Shared(
        mu=torch.zeros(300, 1, 1), kappa=torch.ones(300, 1, 1),
        sigmasq=torch.exp(torch.from_numpy(grid).float())[:, None, None],
        nu=torch.ones(300, 1, 1))
    scores = nich.score_data(lifted, state.groups[0]).sum((1, 2)).numpy()
    jgroup = jnich.Group(*(jnp.asarray(x.numpy()) for x in state.groups[0]))
    want = np.asarray([float(jnp.sum(jnich.score_data(
        jnich.shared_from_dict({'mu': 0., 'kappa': 1.0,
                                'sigmasq': float(np.exp(g)), 'nu': 1.}),
        jgroup))) for g in grid[::30]])
    np.testing.assert_allclose(scores[::30], want, rtol=1e-5, atol=1e-3)
    d, p = scipy.stats.kstest(np.asarray(lss)[200::2], _cdf_on(grid, scores))
    assert p > 1e-3, (d, p, np.mean(lss))


def test_slice_feature_bounds_override():
    rng = np.random.RandomState(0)
    X = (100.0 + rng.randn(100, 1)).astype(np.float32)
    spec, sh, state = _nich_state(X, np.zeros(100, np.int32))
    gen = torch.Generator().manual_seed(1)
    for _ in range(30):
        _, sh = sl.slice_step_feature(gen, spec, 0, (sh,), state, ('mu',),
                                      width=20.0)
    assert float(sh.mu) > 50.0, float(sh.mu)
    _, sh = sl.slice_step_feature(gen, spec, 0, (sh,), state, ('kappa',),
                                  bounds={'kappa': (-1.0, 1.0)})
    assert math.exp(-1.0) - 1e-6 <= float(sh.kappa) <= math.exp(1.0) + 1e-5


def test_slice_feature_dd_alphas_vector_with_a_prior():
    """A vector leaf moves coordinate by coordinate, and a prior in the
    sampled coordinate keeps concentrations off the improper ridge."""
    rng = np.random.RandomState(1)
    spec = tmx.make_spec([(dd, 1)], capacity=8)
    shared = dd.shared_from_dict({'alphas': [1.0, 1.0]})
    X = rng.choice(2, size=(150, 1), p=[0.8, 0.2]).astype(np.int32)
    a = rng.randint(0, 3, 150).astype(np.int32)
    py = tcl.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.0})
    state = tmx.state_from_assignments(spec, py, (shared,),
                                       (torch.from_numpy(X),),
                                       torch.from_numpy(a))
    gen = torch.Generator().manual_seed(7)
    sh = shared
    las = []
    for _ in range(400):
        _, sh = sl.slice_step_feature(
            gen, spec, 0, (sh,), state, ('alphas',), width=1.5,
            priors={'alphas': lambda x: -0.5 * (x / 2.0) ** 2})
        las.append(np.log(sh.alphas.numpy()))
    las = np.asarray(las)
    assert sh.alphas.shape == (2,)
    assert np.unique(np.round(las[:, 0], 6)).size > 100
    assert np.unique(np.round(las[:, 1], 6)).size > 100
    assert abs(las[100:].mean()) < 4.0 and las.max() < 10.0


def test_slice_step_feature_refuses_niw_psi():
    """The JAX package moves psi entry by entry and can leave it
    indefinite; the port refuses the field."""
    spec = tmx.make_spec([(niw, 1)], capacity=4)
    shared = niw.shared_from_dict({'mu': np.zeros(2), 'kappa': 1.0,
                                   'psi': np.eye(2), 'nu': 3.0})
    state = tmx.init(spec, (shared,))
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match='psi'):
        sl.slice_step_feature(gen, spec, 0, (shared,), state, ('psi',))
    with pytest.raises(ValueError, match='no hyperparameter'):
        sl.slice_step_feature(gen, spec, 0, (shared,), state, ('sigmasq',))
    # the other fields move, mu coordinate by coordinate
    X = np.random.RandomState(0).randn(64, 1, 2).astype(np.float32) + 3.0
    py = tcl.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.0})
    state = tmx.state_from_assignments(
        spec, py, (shared,), (torch.from_numpy(X),),
        torch.zeros(64, dtype=torch.int32))
    (new,), _ = sl.slice_step_feature(gen, spec, 0, (shared,), state,
                                      ('mu', 'kappa'))
    assert new.mu.shape == (2,) and not torch.equal(new.mu, shared.mu)
    assert torch.equal(new.psi, shared.psi)
