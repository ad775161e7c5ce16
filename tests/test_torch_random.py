"""The port's samplers (distributions_tpu_torch.random) and the rest of
its special functions, against distributions_tpu.random /
distributions_tpu.special: the deterministic functions on the same numpy
inputs through both packages, the samplers by goodness of fit in the
manner of tests/test_random.py (the streams differ from JAX's by design:
a `torch.Generator` replaces the key)."""

import numpy as np
import pytest
import scipy.stats
import torch

import jax.numpy as jnp

from distributions_tpu import random as jr, special as js, util
from distributions_tpu_torch import config, random as tr
from distributions_tpu_torch import special as ts

torch.set_num_threads(1)
config.set_default_device('cpu')

# the same f32 formulas; log, lgamma and log1p differ by ulps between torch
# and XLA
RTOL, ATOL = 1e-5, 1e-5
MIN_GOODNESS_OF_FIT = 1e-3
# z-tests of moments over n draws: |z| < 5 against the closed form
Z_MAX = 5.0


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _z_mean(x, mean, var):
    x = np.asarray(x, np.float64)
    return abs(x.mean() - mean) / np.sqrt(var / x.size)


# -- special.py leftovers ---------------------------------------------------

def test_special_leftovers_match_jax():
    rng = np.random.RandomState(0)
    x = (rng.randn(64) * 5).astype(np.float32)
    y = (rng.randn(64) * 5).astype(np.float32)
    n = rng.randint(0, 12, 16).astype(np.float32)
    _close(ts.log_sum_exp(torch.from_numpy(x), torch.from_numpy(y)),
           js.log_sum_exp(x, y))
    _close(ts.factorial(torch.from_numpy(n)), js.factorial(n), rtol=2e-5)
    _close(ts.log1p_exp(torch.from_numpy(x)), js.log1p_exp(x))
    scores = np.stack([x, y, np.full(64, -np.inf, np.float32)])
    likes, total = ts.scores_to_likelihoods(torch.from_numpy(scores))
    jl, jt = js.scores_to_likelihoods(scores)
    _close(likes, jl)
    _close(total, jt)
    b = np.abs(x) + 0.1
    _close(ts.stick(torch.from_numpy(b)), js.stick(b))
    big = np.array([1e39, -1e39, np.inf, 3.0], np.float64)
    _close(ts.clip_finite(torch.from_numpy(big)),
           js.clip_finite(jnp.asarray(big, jnp.float32)), rtol=0, atol=0)
    coeffs = [0.5, -1.0, 2.0, 0.25]
    _close(ts.poly_eval(coeffs, torch.from_numpy(x)),
           js.poly_eval(coeffs, jnp.asarray(x)), rtol=1e-5, atol=1e-3)
    grid = x.reshape(8, 8)
    for axis in (0, 1):
        _close(ts.lax_cumlogsumexp(torch.from_numpy(grid), axis),
               js.lax_cumlogsumexp(grid, axis))


@pytest.mark.parametrize('n', [0, 1, 2, 5, 17, 31, 32, 40, 100])
def test_log_stirling1_row_matches_jax(n):
    got = ts.log_stirling1_row(n).numpy()
    want = np.asarray(js.log_stirling1_row(n))
    assert got.shape == want.shape == (n + 1,)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    _close(got[fin], want[fin])


# -- deterministic scorers --------------------------------------------------

@pytest.mark.parametrize('d', [1, 2, 3])
def test_score_student_t_matches_jax(d):
    rng = np.random.RandomState(d)
    x = rng.randn(20, d).astype(np.float32)
    mu = rng.randn(d).astype(np.float32)
    a = rng.randn(d, d)
    sigma = (a @ a.T + d * np.eye(d)).astype(np.float32)
    for nu in (1.5, 5.0, 80.0):
        _close(tr.score_student_t(torch.from_numpy(x), nu,
                                  torch.from_numpy(mu),
                                  torch.from_numpy(sigma)),
               jr.score_student_t(x, nu, mu, sigma), rtol=1e-5, atol=2e-5)


def test_score_student_t_matches_scipy():
    nu, mu, sigma = 5.0, 1.0, 2.0
    xs = np.linspace(-3, 5, 20).astype(np.float32)
    ours = tr.score_student_t(torch.from_numpy(xs[:, None]), nu,
                              torch.tensor([mu]), torch.tensor([[sigma ** 2]]))
    _close(ours, scipy.stats.t.logpdf(xs, nu, loc=mu, scale=sigma),
           rtol=1e-5, atol=1e-5)


def test_score_from_scores_matches_jax():
    rng = np.random.RandomState(1)
    scores = (rng.randn(6, 9) * 3).astype(np.float32)
    scores[2, 4] = -np.inf
    choice = rng.randint(0, 9, 6)
    choice[2] = 3
    _close(tr.score_from_scores(torch.from_numpy(scores),
                                torch.from_numpy(choice)),
           jr.score_from_scores(scores, choice))


def test_sample_prob_from_scores():
    scores = torch.tensor([0.1, 0.7, -0.3])
    probs = util.scores_to_probs(scores.numpy())
    for seed in range(5):
        choice, prob = tr.sample_prob_from_scores(_gen(seed), scores)
        np.testing.assert_allclose(float(prob), probs[int(choice)],
                                   rtol=1e-5)


# -- categorical samplers ---------------------------------------------------

def test_seed_determinism():
    a = tr.sample_gamma(_gen(42), 2.0, 3.0, shape=(10,))
    b = tr.sample_gamma(_gen(42), 2.0, 3.0, shape=(10,))
    assert torch.equal(a, b)


@pytest.mark.parametrize('fn', ['discrete', 'from_scores', 'discrete_log'])
def test_categorical_gof(fn):
    probs = np.array([0.1, 0.3, 0.05, 0.55])
    n = 20000
    if fn == 'discrete':
        x = tr.sample_discrete(_gen(), torch.from_numpy(probs), (n,))
    else:
        scores = torch.from_numpy(np.log(probs).astype(np.float32) + 7.0)
        draw = (tr.sample_from_scores if fn == 'from_scores'
                else tr.sample_discrete_log)
        x = draw(_gen(), scores, shape=(n,))
    counts = np.bincount(x.numpy(), minlength=4)
    assert util.multinomial_goodness_of_fit(probs, counts, n) \
        > MIN_GOODNESS_OF_FIT


def test_categorical_zero_mass_and_batches():
    scores = torch.tensor([0.0, float('-inf'), 1.0, float('-inf')])
    x = tr.sample_from_scores(_gen(), scores, shape=(1000,))
    assert set(x.tolist()) <= {0, 2}
    x = tr.sample_discrete(_gen(), torch.tensor([0.5, 0.0, 0.5]), (1000,))
    assert 1 not in set(x.tolist())
    out = tr.sample_from_scores(_gen(), torch.randn(5, 8))
    assert out.shape == (5,) and ((out >= 0) & (out < 8)).all()


def test_unif_int_bernoulli_normal():
    n = 100000
    u = tr.sample_unif01(_gen(), (n,))
    assert u.dtype == torch.float32 and 0 <= float(u.min()) < 1e-3
    assert _z_mean(u, 0.5, 1 / 12) < Z_MAX
    k = tr.sample_int(_gen(1), 3, 9, (n,))
    assert k.dtype == torch.int32 and int(k.min()) == 3 and int(k.max()) == 8
    b = tr.sample_bernoulli(_gen(2), 0.3, (n,))
    assert b.dtype == torch.bool and _z_mean(b, 0.3, 0.21) < Z_MAX
    z = tr.sample_normal(_gen(3), 1.5, 2.0, (n,))
    assert _z_mean(z, 1.5, 4.0) < Z_MAX
    assert _z_mean(tr.sample_std_normal(_gen(4), (n,)) ** 2, 1.0, 2.0) \
        < Z_MAX
    # batched parameters broadcast to the draw's shape
    assert tr.sample_normal(_gen(), torch.zeros(3), 1.0).shape == (3,)


# -- continuous samplers: moments -------------------------------------------

@pytest.mark.parametrize('alpha,scale', [(2.5, 1.7), (0.3, 1.0)])
def test_gamma_moments(alpha, scale):
    x = tr.sample_gamma(_gen(), alpha, scale, shape=(200000,))
    assert _z_mean(x, alpha * scale, alpha * scale ** 2) < Z_MAX
    assert abs(float(x.var()) / (alpha * scale ** 2) - 1) < 0.05


@pytest.mark.parametrize('a,b', [(2.0, 5.0), (0.2, 0.3), (1.0, 100.0)])
def test_beta_moments(a, b):
    x = tr.sample_beta(_gen(), a, b, shape=(200000,))
    assert torch.isfinite(x).all() and float(x.min()) >= 0
    mean = a / (a + b)
    var = a * b / ((a + b) ** 2 * (a + b + 1))
    assert _z_mean(x, mean, var) < Z_MAX


def test_beta_tiny_shapes_stay_finite():
    """Shapes far below 1 underflow a direct gamma ratio to 0 / 0; the
    log-space draw keeps every value in [0, 1]."""
    x = tr.sample_beta(_gen(), 1e-3, 1e-3, shape=(10000,))
    assert torch.isfinite(x).all()
    # Beta(eps, eps) puts half its mass near each end
    assert _z_mean(x > 0.5, 0.5, 0.25) < Z_MAX
    safe = tr.sample_beta_safe(_gen(), 1e-3, 1e-3, shape=(1000,))
    # the clip's bounds as float32
    assert float(safe.min()) >= float(np.float32(1e-6))
    assert float(safe.max()) <= float(np.float32(1 - 1e-6))


def test_chisq_moments():
    nu = 3.7
    x = tr.sample_chisq(_gen(), nu, shape=(200000,))
    assert _z_mean(x, nu, 2 * nu) < Z_MAX


def test_negative_binomial_gof():
    p, r, n = 0.4, 3, 20000
    x = tr.sample_negative_binomial(_gen(), p, r, shape=(n,)).numpy()
    support = np.arange(0, 30)
    probs = scipy.stats.nbinom.pmf(support, r, p)
    gof = util.discrete_goodness_of_fit(
        np.clip(x, 0, 29).tolist(),
        {int(k): float(v) for k, v in zip(support, probs)})
    assert gof > MIN_GOODNESS_OF_FIT, gof


def test_poisson_gof():
    lam, n = 3.3, 20000
    x = tr.sample_poisson(_gen(), lam, shape=(n,))
    assert x.dtype == torch.int32
    support = np.arange(0, 25)
    probs = scipy.stats.poisson.pmf(support, lam)
    gof = util.discrete_goodness_of_fit(
        np.clip(x.numpy(), 0, 24).tolist(),
        {int(k): float(v) for k, v in zip(support, probs)})
    assert gof > MIN_GOODNESS_OF_FIT, gof


def test_dirichlet():
    p = tr.sample_dirichlet(_gen(), torch.tensor([1.0, 0.0, 2.0]))
    assert float(p[1]) == 0.0
    np.testing.assert_allclose(float(p.sum()), 1.0, rtol=1e-6)
    alphas = torch.tensor([0.5, 2.0, 3.5])
    x = tr.sample_dirichlet(_gen(1), alphas, shape=(100000,))
    a0 = float(alphas.sum())
    for k, a in enumerate(alphas.tolist()):
        m = a / a0
        assert _z_mean(x[:, k], m, m * (1 - m) / (a0 + 1)) < Z_MAX
    safe = tr.sample_dirichlet_safe(_gen(2), torch.tensor([0.0, 1.0]))
    assert float(safe[0]) >= 0 and abs(float(safe.sum()) - 1) < 1e-6


def test_student_t_sampler_matches_scorer():
    nu, mu = 5.0, 0.5
    sigma = torch.tensor([[1.5]])
    x = tr.sample_student_t(_gen(), nu, torch.tensor([mu]), sigma,
                            shape=(5000,))
    probs = np.exp(tr.score_student_t(x, nu, torch.tensor([mu]),
                                      sigma).numpy())
    gof = util.density_goodness_of_fit(x[:, 0].numpy().astype(np.float64),
                                       probs.astype(np.float64))
    assert gof > MIN_GOODNESS_OF_FIT, gof


# -- Wishart family -----------------------------------------------------------

def _z_matrix(samples, mean, var):
    """Largest |z| of the entrywise sample means against `mean` with the
    entrywise variances `var`."""
    s = samples.numpy().astype(np.float64)
    return float(np.max(np.abs(s.mean(0) - mean) / np.sqrt(var / len(s))))


def test_wishart_moments():
    nu = 7.0
    lam = np.array([[2.0, 0.3, 0.0], [0.3, 1.0, 0.1], [0.0, 0.1, 0.5]])
    s = tr.sample_wishart(_gen(), nu, torch.tensor(lam, dtype=torch.float32),
                          shape=(40000,))
    assert s.shape == (40000, 3, 3)
    # Var(S_ij) = nu (Lambda_ij^2 + Lambda_ii Lambda_jj)
    var = nu * (lam ** 2 + np.outer(np.diag(lam), np.diag(lam)))
    assert _z_matrix(s, nu * lam, var) < Z_MAX


def test_inverse_wishart_and_niw_moments():
    nu, d = 10.0, 2
    S = np.array([[2.0, 0.3], [0.3, 1.0]])
    x = tr.sample_inverse_wishart(_gen(), nu, torch.tensor(
        S, dtype=torch.float32), shape=(40000,))
    mean = S / (nu - d - 1)
    # Var(X_ij) of the inverse Wishart
    p = nu - d
    var = ((p + 1) * S ** 2 + (p - 1) * np.outer(np.diag(S), np.diag(S))) \
        / (p * (p - 1) ** 2 * (p - 3))
    assert _z_matrix(x, mean, var) < Z_MAX
    mu0 = np.array([1.0, -2.0])
    mu, cov = tr.sample_normal_inverse_wishart(
        _gen(1), torch.tensor(mu0, dtype=torch.float32), 2.0,
        torch.tensor(S, dtype=torch.float32), nu, shape=(40000,))
    assert mu.shape == (40000, 2) and cov.shape == (40000, 2, 2)
    # E[mu] = mu0, Var(mu_i) = E[Sigma_ii] / kappa0
    assert _z_matrix(mu, mu0, np.diag(mean) / 2.0) < Z_MAX
    assert _z_matrix(cov, mean, var) < Z_MAX
    one_mu, one_cov = tr.sample_normal_inverse_wishart(
        _gen(2), torch.zeros(3), 2.0, torch.eye(3), 5.0)
    assert one_mu.shape == (3,) and one_cov.shape == (3, 3)
    assert (torch.linalg.eigvalsh(one_cov) > 0).all()


def test_multivariate_normal_moments():
    mu = np.array([0.5, -1.0])
    cov = np.array([[1.0, 0.6], [0.6, 2.0]])
    x = tr.sample_multivariate_normal(
        _gen(), torch.tensor(mu, dtype=torch.float32),
        torch.tensor(cov, dtype=torch.float32), shape=(100000,))
    assert _z_matrix(x, mu, np.diag(cov)) < Z_MAX
    c = np.cov(x.numpy().T)
    np.testing.assert_allclose(c, cov, atol=0.05)


# -- stick, urn, partitions ---------------------------------------------------

def test_sample_stick():
    w = tr.sample_stick(_gen(), 2.0, capacity=128)
    np.testing.assert_allclose(float(w.sum()), 1.0, rtol=1e-5)
    assert (w >= 0).all()
    # E[w_0] = 1 / (1 + gamma)
    first = torch.stack([tr.sample_stick(_gen(s), 2.0, capacity=8)[0]
                         for s in range(2000)])
    assert _z_mean(first, 1 / 3, 2 / (9 * 4)) < Z_MAX


def test_sample_pair_from_urn():
    pairs = [tr.sample_pair_from_urn(_gen(s), 5) for s in range(2000)]
    assert all(i != j and 0 <= i < 5 and 0 <= j < 5 for i, j in pairs)
    counts = np.zeros((5, 5))
    for i, j in pairs:
        counts[i, j] += 1
    probs = np.full(20, 1 / 20)
    off = counts[~np.eye(5, dtype=bool)]
    assert util.multinomial_goodness_of_fit(probs, off, 2000) \
        > MIN_GOODNESS_OF_FIT


def test_sample_partition_from_counts():
    items = list('abcdefg')
    part = tr.sample_partition_from_counts(_gen(), items, [3, 0, 4])
    assert [len(p) for p in part] == [3, 0, 4]
    assert sorted(sum(part, [])) == items
    with pytest.raises(ValueError, match='sum'):
        tr.sample_partition_from_counts(_gen(), items, [3])
