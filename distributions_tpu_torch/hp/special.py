"""Double-precision special functions for the hp flavor.

This module is part of the INDEPENDENT second implementation of the model
API (the role the reference's Cython `hp` flavor plays next to `dbg` and
`lp`: distributions/hp/special.pyx).  It deliberately shares no code with
`distributions_tpu_torch.special` — everything here is numpy/scipy float64,
so flavor-agreement tests (tests/test_torch_flavors.py) cross-check two
implementations that can only agree if the transcribed math agrees.

No torch or jax imports allowed in this package (enforced by a test).
"""

import numpy as np
from scipy import special as _sp


def gammaln(x):
    return _sp.gammaln(np.asarray(x, np.float64))


def betaln(x, y):
    return _sp.betaln(np.asarray(x, np.float64), np.asarray(y, np.float64))


# reference naming (include/distributions/special.hpp:173-189)
log_beta = betaln


def log_binom(n, k):
    n = np.asarray(n, np.float64)
    k = np.asarray(k, np.float64)
    return gammaln(n + 1.0) - gammaln(k + 1.0) - gammaln(n - k + 1.0)


def log_factorial(n):
    return gammaln(np.asarray(n, np.float64) + 1.0)


def lgamma_nu(nu):
    """lgamma((nu+1)/2) - lgamma(nu/2) — the student-t normalizer ratio
    (reference include/distributions/special.hpp:239-273).  Float64 needs
    no cancellation trick; the direct difference is exact enough."""
    nu = np.asarray(nu, np.float64)
    return _sp.gammaln(0.5 * (nu + 1.0)) - _sp.gammaln(0.5 * nu)


def lmultigamma(d, a):
    """Multivariate log-gamma via scipy (the core derives it from the sum
    formula; scipy.special.multigammaln is an independent code path)."""
    a = np.asarray(a, np.float64)
    if a.ndim == 0:
        return _sp.multigammaln(float(a), int(d))
    return np.vectorize(lambda x: _sp.multigammaln(float(x), int(d)))(a)


def logsumexp(scores, axis=-1, keepdims=False):
    return _sp.logsumexp(np.asarray(scores, np.float64), axis=axis,
                         keepdims=keepdims)


def log_sum_exp(x, y):
    return np.logaddexp(np.asarray(x, np.float64), np.asarray(y, np.float64))


def scores_to_likelihoods(scores):
    """Max-subtracted exp (reference random.hpp:352); returns (likelihoods,
    total) like the reference's in-place overwrite + returned total."""
    scores = np.asarray(scores, np.float64)
    probs = np.exp(scores - scores.max())
    return probs, probs.sum()


def log_stirling1_row(n):
    """Row n of log |Stirling numbers of the first kind|, computed EXACTLY
    for any n via the integer recurrence s(n,k) = s(n-1,k-1) +
    (n-1) s(n-1,k) in python bignums (the reference caches exact rows
    below 32 and switches to an asymptotic above:
    src/special.cc:55-130).  Exact at every n is the hp flavor's
    double-precision luxury; the agreement test bounds the core's
    approximation against this."""
    n = int(n)
    row = [1]
    for m in range(1, n + 1):
        prev = row
        row = [0] * (m + 1)
        for k in range(1, m + 1):
            row[k] = (prev[k - 1] if k - 1 < len(prev) else 0) \
                + (m - 1) * (prev[k] if k < len(prev) else 0)
        if m == 1:
            row[0] = 0
    out = np.full(n + 1, -np.inf, np.float64)
    for k, v in enumerate(row):
        if v > 0:
            out[k] = _log_of_bigint(v)
    return out


def _log_of_bigint(v):
    """log of an arbitrarily large python int without overflow."""
    bits = v.bit_length()
    if bits <= 1000:
        return float(np.log(float(v)))
    shift = bits - 900
    return float(np.log(float(v >> shift))) + shift * float(np.log(2.0))
