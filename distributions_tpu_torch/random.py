"""Samplers and density functions (distributions_tpu.random).

Entropy comes from an explicit `torch.Generator` wherever the JAX package
takes a `jax.random` key; a sampler consumes it in order, so the streams
differ from JAX's and only the laws match.  `torch.distributions` is not
used: its `sample()` draws from the global generator.

Devices: a sampler draws on `device` when given, else on the device of its
first tensor parameter, else on `config.default_device()`.  A generator on
another device gives one seed (`draw_seed`), and a generator on the drawing
device seeded with it does the drawing.

Laws, from the generator's uniforms, normals, standard gammas
(`torch._standard_gamma`) and Poisson draws (`torch.poisson`):
  gamma(alpha, scale)   scale * G, G ~ Gamma(alpha, 1)
  chisq(nu)             2 G, G ~ Gamma(nu / 2, 1)
  beta(a, b)            X / (X + Y), X ~ Gamma(a), Y ~ Gamma(b), formed as
                        sigmoid(log X - log Y); for a shape below 1 the
                        gamma is drawn as G(a + 1) U^(1/a) in log space,
                        so that small shapes do not underflow to 0 / 0
  dirichlet(alphas)     gammas normalised over the last axis (log space as
                        for beta); a zero alpha gets zero mass
  negative_binomial     Poisson(L), L ~ Gamma(r, (1 - p) / p): failures
                        before the r-th success, P(x) ~ p^r (1 - p)^x
  categorical           gumbel-argmax over log-probabilities
  Wishart               Bartlett: A lower-triangular with A_ii^2 ~
                        chisq(nu - i) and standard normals below the
                        diagonal; W = L A A^T L^T for Lambda = L L^T
"""

import torch

from distributions_tpu_torch.config import default_device, same_device

_MASK64 = (1 << 64) - 1
_TINY = torch.finfo(torch.float32).tiny


def draw_seed(generator):
    """One 62-bit seed from `generator` (the port's analog of splitting a
    fresh key off a `jax.random` key)."""
    return int(torch.randint(0, 1 << 62, (1,), generator=generator,
                             device=generator.device))


def fold_seed(seed, index):
    """Mix an index into a seed (splitmix64 finaliser): per-(sweep, tile)
    seeds from one per-sweep seed, as the JAX package splits a sweep key
    into tile keys.  Returns a 62-bit int."""
    z = (int(seed) + (int(index) + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 2


def sweep_seeds(generator, n_tiles):
    """The seeds of one sweep's tiles, [n_tiles] int64 on the host: one
    `draw_seed(generator)`, folded with each tile index (`fold_seed`), in
    the order the fused sweep takes them, so that a sweep consumes the
    generator alike whether its tiles run eagerly or from a CUDA graph.
    A sharded sweep takes the table of its global tiles, n_tiles = row
    shards x tiles per shard: row shard i reads entry i * T + t at its
    tile t, the fold of the sweep seed by the global tile index that the
    sharded sweeps have always used."""
    seed = draw_seed(generator)
    return torch.tensor([fold_seed(seed, t) for t in range(n_tiles)],
                        dtype=torch.int64)


def device_generator(seed, device):
    """A `torch.Generator` on `device` seeded with `seed`."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def gumbel_noise(generator, shape, device):
    """Standard Gumbel noise -log(-log u), u uniform on (0, 1), drawn from
    `generator` (whose device must be `device`)."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    u = torch.clamp(u, min=_TINY)
    return -torch.log(-torch.log(u))


# -- devices and parameters -------------------------------------------------

def _device(params, device):
    if device is not None:
        return torch.device(device)
    for p in params:
        if isinstance(p, torch.Tensor):
            return p.device
    return default_device()


def _on(generator, device):
    """`generator` when it draws on `device`, else a generator on `device`
    seeded from it."""
    if same_device(generator.device, device):
        return generator
    return device_generator(draw_seed(generator), device)


def _prep(generator, params, shape, device):
    """(generator on the drawing device, float32 params broadcast to the
    draw's shape, that shape)."""
    dev = _device(params, device)
    ts = [torch.as_tensor(p, device=dev).to(torch.float32) for p in params]
    if shape is None:
        shape = torch.broadcast_shapes(*(t.shape for t in ts))
    shape = tuple(shape)
    return (_on(generator, dev),
            [t.expand(shape).contiguous() for t in ts], shape)


def _log_standard_gamma(generator, alpha):
    """log G, G ~ Gamma(alpha, 1), for `alpha` of any positive size: below
    1 as log G(alpha + 1) + log(U) / alpha, which keeps tiny gammas
    finite in log space."""
    small = alpha < 1.0
    g = torch._standard_gamma(torch.where(small, alpha + 1.0, alpha),
                              generator=generator)
    u = torch.clamp(torch.rand(alpha.shape, generator=generator,
                               device=alpha.device), min=_TINY)
    boost = torch.where(small, torch.log(u) / alpha, torch.zeros_like(u))
    return torch.log(g) + boost


# ---------------------------------------------------------------------------
# basic samplers

def sample_unif01(generator, shape=(), device=None):
    dev = _device((), device)
    return torch.rand(tuple(shape), generator=_on(generator, dev),
                      device=dev)


def sample_int(generator, low, high, shape=(), device=None):
    """Uniform int32 in [low, high)."""
    dev = _device((), device)
    return torch.randint(int(low), int(high), tuple(shape),
                         generator=_on(generator, dev), device=dev,
                         dtype=torch.int32)


def sample_bernoulli(generator, prob, shape=None, device=None):
    gen, (p,), shape = _prep(generator, (prob,), shape, device)
    return torch.rand(shape, generator=gen, device=p.device) < p


def sample_normal(generator, mu=0.0, sigma=1.0, shape=None, device=None):
    gen, (mu, sigma), shape = _prep(generator, (mu, sigma), shape, device)
    return mu + sigma * torch.randn(shape, generator=gen, device=mu.device)


def sample_std_normal(generator, shape=(), device=None):
    dev = _device((), device)
    return torch.randn(tuple(shape), generator=_on(generator, dev),
                       device=dev)


def sample_chisq(generator, nu, shape=None, device=None):
    gen, (nu,), _ = _prep(generator, (nu,), shape, device)
    return 2.0 * torch._standard_gamma(0.5 * nu, generator=gen)


def sample_gamma(generator, alpha, beta=1.0, shape=None, device=None):
    """Gamma with shape `alpha` and SCALE `beta` (numpy's convention)."""
    gen, (alpha, beta), _ = _prep(generator, (alpha, beta), shape, device)
    return torch._standard_gamma(alpha, generator=gen) * beta


def sample_beta(generator, alpha, beta, shape=None, device=None):
    gen, (a, b), _ = _prep(generator, (alpha, beta), shape, device)
    return torch.sigmoid(_log_standard_gamma(gen, a)
                         - _log_standard_gamma(gen, b))


def sample_beta_safe(generator, alpha, beta, min_value=1e-6, shape=None,
                     device=None):
    """Beta clipped away from {0, 1}."""
    p = sample_beta(generator, alpha, beta, shape, device)
    return torch.clamp(p, min_value, 1.0 - min_value)


def sample_poisson(generator, lam, shape=None, device=None):
    gen, (lam,), _ = _prep(generator, (lam,), shape, device)
    return torch.poisson(lam, generator=gen).to(torch.int32)


def sample_negative_binomial(generator, p, r, shape=None, device=None):
    """Failures before the r-th success at success probability p, P(x) ~
    p^r (1 - p)^x (scipy's nbinom), as a gamma-Poisson mixture."""
    gen, (p, r), _ = _prep(generator, (p, r), shape, device)
    lam = torch._standard_gamma(r, generator=gen) * ((1.0 - p) / p)
    return torch.poisson(lam, generator=gen).to(torch.int32)


def sample_dirichlet(generator, alphas, shape=None, device=None):
    """Dirichlet over the last axis of `alphas` (leading axes batch);
    zero alphas get zero mass.  `shape`, when given, is the batch shape
    the alphas broadcast to."""
    dev = _device((alphas,), device)
    alphas = torch.as_tensor(alphas, device=dev).to(torch.float32)
    if shape is not None:
        alphas = alphas.expand(tuple(shape) + alphas.shape[-1:])
    alphas = alphas.contiguous()
    logg = _log_standard_gamma(_on(generator, dev),
                               torch.clamp(alphas, min=1e-30))
    logg = torch.where(alphas > 0, logg,
                       torch.full_like(logg, float('-inf')))
    return torch.softmax(logg, dim=-1)


def sample_dirichlet_safe(generator, alphas, min_value=1e-6, device=None):
    alphas = torch.as_tensor(alphas).to(torch.float32)
    return sample_dirichlet(generator, alphas + min_value, device=device)


# ---------------------------------------------------------------------------
# categorical sampling from scores, the Gibbs inner primitive

def sample_from_scores(generator, scores, shape=None):
    """Categorical draw from log-scores over the last axis (gumbel-argmax),
    batched over all leading axes; `shape` (optional) is the shape of the
    draws, which the leading axes broadcast to.  Returns int64 indices."""
    gen = _on(generator, scores.device)
    if shape is None:
        g = gumbel_noise(gen, scores.shape, scores.device)
    else:
        g = gumbel_noise(gen, tuple(shape) + scores.shape[-1:],
                         scores.device)
    return torch.argmax(scores + g, dim=-1)


def sample_discrete_log(generator, scores, shape=None):
    return sample_from_scores(generator, scores, shape=shape)


def sample_discrete(generator, probs, shape=None, device=None):
    """Draw from (possibly unnormalised) probabilities over the last
    axis; a zero probability is never drawn."""
    dev = _device((probs,), device)
    probs = torch.as_tensor(probs, device=dev).to(torch.float32)
    logits = torch.where(probs > 0,
                         torch.log(torch.clamp(probs, min=1e-38)),
                         torch.full_like(probs, float('-inf')))
    return sample_from_scores(generator, logits, shape=shape)


def _log_normalize(scores):
    m = torch.amax(scores, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    lse = torch.log(torch.exp(scores - m).sum(-1, keepdim=True)) + m
    return scores - lse


def sample_prob_from_scores(generator, scores):
    """A draw and the probability of that draw: (choice, prob)."""
    scores = torch.as_tensor(scores).to(torch.float32)
    choice = sample_from_scores(generator, scores)
    logp = _log_normalize(scores)
    return choice, torch.exp(logp.gather(-1, choice[..., None])[..., 0])


def score_from_scores(scores, choice):
    """Log-probability of `choice` under the normalised `scores`; no
    entropy is consumed."""
    scores = torch.as_tensor(scores).to(torch.float32)
    logp = _log_normalize(scores)
    choice = torch.as_tensor(choice, device=scores.device).to(torch.int64)
    return logp.gather(-1, choice[..., None])[..., 0]


def sample_pair_from_urn(generator, n):
    """An ordered pair (i, j) of distinct indices from range(n), as Python
    ints."""
    ij = torch.randint(0, 1 << 62, (2,), generator=generator,
                       device=generator.device).tolist()
    i = ij[0] % n
    j = ij[1] % (n - 1)
    return i, j + 1 if j >= i else j


# ---------------------------------------------------------------------------
# student-t

def score_student_t(x, nu, mu, sigma):
    """Multivariate student-t log density (Murphy 2007, Eq. 313): `sigma`
    a [d, d] scale matrix, batched over the leading axes of `x`."""
    from distributions_tpu_torch.special import lgamma_nu
    x = torch.as_tensor(x).to(torch.float32)
    dev = x.device
    mu = torch.as_tensor(mu, device=dev).to(torch.float32)
    sigma = torch.as_tensor(sigma, device=dev).to(torch.float32)
    p = mu.shape[-1]
    z = x - mu
    chol = torch.linalg.cholesky(sigma)
    chol = chol.expand(z.shape[:-1] + chol.shape[-2:])
    sol = torch.linalg.solve_triangular(chol, z[..., None], upper=False)
    mahal = (sol[..., 0] * sol[..., 0]).sum(-1)
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    nu = torch.as_tensor(nu, device=dev).to(torch.float32)
    # lgamma((nu + p)/2) - lgamma(nu/2) = sum_i lgamma_nu(nu + i)
    lg_ratio = sum(lgamma_nu(nu + i) for i in range(p))
    return (lg_ratio
            - 0.5 * (p * torch.log(nu * torch.pi) + logdet
                     + (nu + p) * torch.log1p(mahal / nu)))


score_mv_student_t = score_student_t


def sample_student_t(generator, dof, mu, sigma, shape=()):
    """Multivariate student-t draws mu + z sqrt(dof / chisq(dof)), z ~
    N(0, sigma); `shape` leads the draws' shape."""
    mu = torch.as_tensor(mu).to(torch.float32)
    dev = mu.device
    gen = _on(generator, dev)
    shape = tuple(shape)
    chol = torch.linalg.cholesky(
        torch.as_tensor(sigma, device=dev).to(torch.float32))
    z = torch.randn(shape + mu.shape, generator=gen, device=dev) @ chol.mT
    x = sample_chisq(gen, dof, shape + (1,), device=dev)
    dof = torch.as_tensor(dof, device=dev).to(torch.float32)
    return mu + z * torch.sqrt(dof / x)


# ---------------------------------------------------------------------------
# Wishart family; `shape` leads the draws' shape

def _bartlett(generator, nu, d, shape=(), device=None):
    """Lower-triangular Bartlett factors A [*shape, d, d] with A A^T ~
    W(nu, I)."""
    dev = _device((nu,), device)
    gen = _on(generator, dev)
    shape = tuple(shape)
    nu = torch.as_tensor(nu, device=dev).to(torch.float32)
    half = (0.5 * (nu - torch.arange(d, dtype=torch.float32, device=dev))
            ).expand(shape + (d,)).contiguous()
    chis = torch.sqrt(2.0 * torch._standard_gamma(half, generator=gen))
    normals = torch.randn(shape + (d, d), generator=gen, device=dev)
    return torch.tril(normals, -1) + torch.diag_embed(chis)


def sample_wishart(generator, nu, Lambda, shape=()):
    """S ~ Wishart(nu, Lambda) by the Bartlett decomposition."""
    Lambda = torch.as_tensor(Lambda).to(torch.float32)
    d = Lambda.shape[-1]
    ch = torch.linalg.cholesky(Lambda)
    la = ch @ _bartlett(generator, nu, d, shape, device=Lambda.device)
    return la @ la.mT


def sample_inverse_wishart(generator, nu, S, shape=()):
    """X ~ IW(nu, S), X = W(nu, S^-1)^-1: with S = L L^T and Bartlett A,
    X = L A^-T A^-1 L^T."""
    S = torch.as_tensor(S).to(torch.float32)
    d = S.shape[-1]
    chol_S = torch.linalg.cholesky(S)
    a = _bartlett(generator, nu, d, shape, device=S.device)
    eye = torch.eye(d, dtype=torch.float32, device=S.device).expand_as(a)
    inv_a = torch.linalg.solve_triangular(a, eye, upper=False)
    m = chol_S @ inv_a.mT
    return m @ m.mT


def sample_multivariate_normal(generator, mu, cov, shape=()):
    """mu + z L^T, z standard normal, cov = L L^T."""
    mu = torch.as_tensor(mu).to(torch.float32)
    chol = torch.linalg.cholesky(
        torch.as_tensor(cov, device=mu.device).to(torch.float32))
    z = torch.randn(tuple(shape) + mu.shape,
                    generator=_on(generator, mu.device), device=mu.device)
    return mu + z @ chol.mT


def sample_normal_inverse_wishart(generator, mu0, kappa0, psi0, nu0,
                                  shape=()):
    """(mu, Sigma) ~ NIW: Sigma ~ IW(nu0, psi0), mu ~ N(mu0,
    Sigma / kappa0)."""
    mu0 = torch.as_tensor(mu0).to(torch.float32)
    dev = mu0.device
    gen = _on(generator, dev)
    cov = sample_inverse_wishart(gen, nu0, torch.as_tensor(
        psi0, device=dev), shape)
    kappa0 = torch.as_tensor(kappa0, device=dev).to(torch.float32)
    chol = torch.linalg.cholesky(cov / kappa0)
    z = torch.randn(tuple(shape) + mu0.shape[-1:] + (1,), generator=gen,
                    device=dev)
    return mu0 + (chol @ z)[..., 0], cov


# ---------------------------------------------------------------------------
# stick breaking

def sample_stick(generator, gamma, capacity=64, device=None):
    """Truncated DP stick-breaking: `capacity` weights that sum to 1,
    fracs_k ~ Beta(1, gamma), w_k = fracs_k prod_{j<k} (1 - fracs_j)."""
    fracs = sample_beta(generator, 1.0, gamma, (capacity,),
                        device=_device((gamma,), device))
    log_rest = torch.cat([torch.zeros(1, device=fracs.device),
                          torch.cumsum(torch.log1p(-fracs[:-1]), 0)])
    betas = fracs * torch.exp(log_rest)
    return betas / betas.sum()


def sample_partition_from_counts(generator, items, counts):
    """A random partition of `items` (a list) into groups of the given
    sizes, as lists."""
    if sum(counts) != len(items):
        raise ValueError('counts do not sum to the item count')
    order = torch.randperm(len(items), generator=generator,
                           device=generator.device).tolist()
    partition = []
    i = 0
    for c in counts:
        partition.append([items[order[j]] for j in range(i, i + c)])
        i += c
    return partition
