"""Statistical goodness-of-fit utilities for the test suite.

Role (not code) follows reference distributions/util.py: samplers are
validated against their scorers by Pearson chi-squared tests on binned
counts.  Implementations here are vectorized numpy/scipy — they evaluate
*statistics of* device computations host-side, never device computations
themselves.

Conventions shared with the reference harness so tolerances carry over:
the chi-squared statistic normalizes each cell by the binomial variance
N p (1-p) (not the classic N p), continuous samples are reduced to
uniforms via the spacings transform, and discrete supports are truncated
to the highest-probability cells when the tail is too thin for the
chi-squared approximation.
"""

import numpy as np
import scipy.stats


def scores_to_probs(scores):
    """Normalized probabilities from unnormalized log scores."""
    scores = np.asarray(scores, dtype=np.float64)
    probs = np.exp(scores - scores.max())
    return probs / probs.sum()


def score_to_empirical_kl(score, count):
    """KL(empirical || model) implied by a total log score of `count`
    iid samples."""
    count = float(count)
    return -score / count - np.log(count)


def multinomial_goodness_of_fit(probs, counts, total_count, truncated=False):
    """P-value of a Pearson chi-squared test of multinomial counts
    against cell probabilities, with binomial per-cell variance.

    `truncated=True` means `counts` covers only part of the support, so
    counts need not sum to `total_count` and no degree of freedom is
    spent on the sum constraint.  Returns a p-value in [0, 1] (0.0 /
    +inf conventions for impossible outcomes follow the test harness's
    expectations).
    """
    probs = np.asarray(probs, dtype=np.float64)
    counts = np.asarray(counts, dtype=np.float64)
    assert probs.shape == counts.shape
    assert truncated or int(total_count) == int(counts.sum())

    if np.any(probs >= 1.0):
        # a certain cell: fit is perfect iff all mass landed there
        assert np.all(probs <= 1.0), 'bad probability: %g' % probs.max()
        return 1.0 if counts[probs == 1.0] == total_count else 0.0
    support = probs > 0
    if np.any(counts[~support] > 0):
        return float('inf')  # observed an impossible outcome

    p = probs[support]
    c = counts[support]
    mean = total_count * p
    variance = mean * (1.0 - p)
    assert variance.min() > 1, (
        'goodness of fit is inaccurate; use more samples')
    chi_squared = np.sum((c - mean) ** 2 / variance)
    dof = int(support.sum()) - (0 if truncated else 1)
    return float(scipy.stats.chi2.sf(chi_squared, dof))


def unif01_goodness_of_fit(samples):
    """GoF of samples against Uniform[0, 1]: equal-width bins + chi^2."""
    samples = np.asarray(samples, dtype=np.float64)
    assert samples.min() >= 0.0 and samples.max() <= 1.0
    bin_count = int(round(len(samples) ** (1.0 / 3.0)))
    assert bin_count >= 7, 'imprecise test, use more samples'
    edges = np.linspace(0.0, 1.0, bin_count + 1)
    counts, _ = np.histogram(samples, bins=edges)
    probs = np.full(bin_count, 1.0 / bin_count)
    return multinomial_goodness_of_fit(probs, counts, len(samples))


def density_goodness_of_fit(samples, probs):
    """GoF of continuous samples against their own densities via the
    spacings transform: if x_(i) are order statistics with density f,
    then 1 - exp(-n * gap_i * f) is approximately Uniform[0, 1]."""
    samples = np.asarray(samples, dtype=np.float64)
    probs = np.asarray(probs, dtype=np.float64)
    assert samples.shape == probs.shape and samples.ndim == 1
    assert len(samples) > 100, 'imprecision; use more samples'
    order = np.argsort(samples)
    x = samples[order]
    f = probs[order]
    gaps = np.diff(x)
    density = np.sqrt(f[1:] * f[:-1])  # geometric mean over each gap
    u = 1.0 - np.exp(-len(samples) * gaps * density)
    return unif01_goodness_of_fit(u)


def discrete_goodness_of_fit(samples, probs_dict, truncate_beyond=8):
    """GoF of discrete samples against a {value: prob} table, truncating
    to the `truncate_beyond` highest-probability cells (and dropping
    cells whose expected variance is too small for chi^2)."""
    samples = [s.item() if hasattr(s, 'item') else s for s in samples]
    n = len(samples)
    assert n > 100, 'imprecision; use more samples'
    values, probs = zip(*probs_dict.items())
    index = {v: i for i, v in enumerate(values)}
    idx = np.fromiter((index[s] for s in samples), dtype=np.int64, count=n)
    counts = np.bincount(idx, minlength=len(values))
    probs = np.asarray(probs, dtype=np.float64)

    order = np.argsort(-probs, kind='stable')
    probs, counts = probs[order], counts[order]
    truncated = bool(truncate_beyond) and truncate_beyond < len(probs)
    if truncated:
        probs, counts = probs[:truncate_beyond], counts[:truncate_beyond]
    # keep only cells with enough expected variance for the chi^2
    # approximation; dropping any makes the test truncated
    ok = probs * (1.0 - probs) * n > 1
    truncated = truncated or not ok.all()
    return multinomial_goodness_of_fit(
        probs[ok], counts[ok], n, truncated=truncated)


def bin_samples(samples, k=10, support=()):
    """Equal-fill binning via the empirical cdf; returns (counts,
    bin_ranges[k, 2]).  Optional `support` pins the outer edges."""
    x = np.sort(np.asarray(samples).ravel())
    n = len(x)
    q, r = divmod(n, k)
    edges = np.arange(k + 1) * q + np.minimum(np.arange(k + 1), r)
    counts = np.diff(edges)
    lo = x[edges[:-1]]
    hi = np.concatenate([x[edges[1:-1]], x[-1:]])
    bin_ranges = np.stack([lo, hi], axis=1).astype(float)
    if support:
        bin_ranges[0, 0] = support[0]
        bin_ranges[-1, 1] = support[1]
    return counts, bin_ranges


def histogram(samples, bin_count=None):
    samples = np.asarray(samples, dtype=np.int64)
    if bin_count is None:
        bin_count = int(samples.max()) + 1
    return np.bincount(samples, minlength=bin_count)
