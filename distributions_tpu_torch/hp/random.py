"""Double-precision numpy samplers for the hp flavor.

Independent second implementation (role of reference
distributions/hp/random.pyx).  Entropy discipline: every sampler takes an
explicit `numpy.random.Generator` first argument (the analog of the
reference's explicit `rng_t&`, doc/overview.rst:213-221); a module-level
`global_rng` mirrors the reference's global instance for the class facade.

No jax imports allowed in this package.
"""

import numpy as np

from distributions_tpu_torch.hp.special import scores_to_likelihoods

global_rng = np.random.default_rng(0)


def seed(s):
    """Reseed the flavor-global generator (reference distributions/rng.py)."""
    global global_rng
    global_rng = np.random.default_rng(s)
    return global_rng


def sample_unif01(rng, shape=None):
    return rng.random() if shape is None else rng.random(shape)


def sample_bernoulli(rng, prob, shape=None):
    u = sample_unif01(rng, shape)
    return bool(u < prob) if shape is None else (u < prob)


def sample_normal(rng, mu=0.0, sigma=1.0, shape=None):
    return rng.normal(mu, sigma) if shape is None else \
        rng.normal(mu, sigma, shape)


def sample_chisq(rng, nu, shape=None):
    return rng.chisquare(nu) if shape is None else rng.chisquare(nu, shape)


def sample_gamma(rng, alpha, beta=1.0, shape=None):
    """beta is the SCALE (matches the core's sample_gamma convention)."""
    return rng.gamma(alpha, beta) if shape is None else \
        rng.gamma(alpha, beta, shape)


def sample_beta(rng, alpha, beta, shape=None):
    return rng.beta(alpha, beta) if shape is None else \
        rng.beta(alpha, beta, shape)


def sample_poisson(rng, lam, shape=None):
    return int(rng.poisson(lam)) if shape is None else rng.poisson(lam, shape)


def sample_negative_binomial(rng, p, r, shape=None):
    """# failures before the r-th success, success prob p (matches
    numpy's convention and the core's sample_negative_binomial)."""
    out = rng.negative_binomial(r, p, shape)
    return int(out) if shape is None else out


def sample_dirichlet(rng, alphas):
    alphas = np.asarray(alphas, np.float64)
    mask = alphas > 0
    out = np.zeros(alphas.shape, np.float64)
    if mask.any():
        out[mask] = rng.dirichlet(alphas[mask])
    return out


def sample_discrete(rng, probs, total=None):
    """Linear-scan CDF draw (reference random.hpp:300-313)."""
    probs = np.asarray(probs, np.float64)
    t = probs.sum() if total is None else total
    u = rng.random() * t
    acc = np.cumsum(probs)
    return int(np.searchsorted(acc, u, side='right').clip(0, len(probs) - 1))


def sample_from_scores(rng, scores):
    """Categorical draw from unnormalized log scores."""
    probs, total = scores_to_likelihoods(scores)
    return sample_discrete(rng, probs, total)


sample_discrete_log = sample_from_scores


def sample_prob_from_scores(rng, scores):
    """(choice, prob of that choice) — reference random.hpp:369-376."""
    probs, total = scores_to_likelihoods(scores)
    choice = sample_discrete(rng, probs, total)
    return choice, float(probs[choice] / total)


def sample_student_t(rng, dof, mu, sigma):
    """Multivariate student-t via scipy."""
    from scipy.stats import multivariate_t
    return multivariate_t.rvs(loc=np.asarray(mu, np.float64),
                              shape=np.asarray(sigma, np.float64),
                              df=float(dof), random_state=rng)


def sample_wishart(rng, nu, Lambda):
    from scipy.stats import wishart
    return wishart.rvs(df=float(nu), scale=np.asarray(Lambda, np.float64),
                       random_state=rng)


def sample_inverse_wishart(rng, nu, S):
    from scipy.stats import invwishart
    return invwishart.rvs(df=float(nu), scale=np.asarray(S, np.float64),
                          random_state=rng)


def sample_multivariate_normal(rng, mu, cov):
    return rng.multivariate_normal(np.asarray(mu, np.float64),
                                   np.asarray(cov, np.float64),
                                   method='cholesky')


def sample_normal_inverse_wishart(rng, mu0, kappa0, psi0, nu0):
    """(mu, Sigma) ~ NIW: Sigma ~ IW(psi, nu); mu | Sigma ~ N(mu0,
    Sigma/kappa) (reference random.hpp:249-259)."""
    sigma = sample_inverse_wishart(rng, nu0, psi0)
    sigma = np.atleast_2d(np.asarray(sigma, np.float64))
    mu = sample_multivariate_normal(
        rng, mu0, sigma / float(kappa0))
    return mu, sigma
