"""The port's special functions against distributions_tpu.special."""

import numpy as np
import pytest
import torch

from distributions_tpu import special as jsp
from distributions_tpu_torch import config
from distributions_tpu_torch import special as tsp

torch.set_num_threads(1)
config.set_default_device('cpu')

# rtol 1e-5: torch.lgamma and XLA's lgamma differ by a few ulps, and the
# direct branches difference two such values.  atol 1e-6 covers values
# near the zeros of lgamma (x = 1, 2), where only absolute error means
# anything.
RTOL, ATOL = 1e-5, 1e-6


@pytest.mark.parametrize('nu', [0.3, 1.0, 3.5, 31.0, 63.9, 64.0, 64.1, 100.0,
                                1e3, 1e5, 1e7])
def test_lgamma_nu_both_branches(nu):
    x = np.array([nu, nu * 0.999], np.float32)
    np.testing.assert_allclose(
        tsp.lgamma_nu(torch.from_numpy(x)).numpy(),
        np.asarray(jsp.lgamma_nu(x)), rtol=RTOL, atol=ATOL)


def test_lgamma_nu_asymptotic_branch_does_not_cancel():
    # at nu = 1e7 the naive difference loses every f32 bit; the asymptotic
    # branch keeps 0.5 log(nu / 2)
    nu = np.float32(1e7)
    got = float(tsp.lgamma_nu(nu))
    assert abs(got - 0.5 * np.log(nu / 2.0)) < 1e-5 * abs(got)


def test_gammaln():
    x = np.array([0.1, 0.5, 1, 1.5, 2, 10, 63, 64, 65, 1e4, 1e6],
                 np.float32)
    np.testing.assert_allclose(tsp.gammaln(torch.from_numpy(x)).numpy(),
                               np.asarray(jsp.gammaln(x)), rtol=RTOL,
                               atol=ATOL)


def test_logsumexp_all_neg_inf_rows():
    rng = np.random.RandomState(0)
    x = rng.randn(4, 6).astype(np.float32) * 10
    x[1] = -np.inf
    x[2, :3] = -np.inf
    got = tsp.logsumexp(torch.from_numpy(x), axis=1).numpy()
    want = np.asarray(jsp.logsumexp(x, axis=1))
    assert got[1] == -np.inf and want[1] == -np.inf
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        tsp.logsumexp(torch.from_numpy(x), axis=0, keepdims=True).numpy(),
        np.asarray(jsp.logsumexp(x, axis=0, keepdims=True)), rtol=RTOL,
        atol=ATOL)


@pytest.mark.parametrize('y', [0.0, 0.5, 3.0, 100.0])
def test_lgamma_ratio_both_branches(y):
    x = np.array([0.1, 0.5, 1, 2, 10, 50, 63, 64, 65, 100, 1e4, 1e6],
                 np.float32)
    np.testing.assert_allclose(
        tsp.lgamma_ratio(torch.from_numpy(x), y).numpy(),
        np.asarray(jsp.lgamma_ratio(x, np.float32(y))), rtol=RTOL, atol=ATOL)


# log_beta and its users: rtol 1e-5 in f32.  Below max(x, y) = 64 both
# packages difference three lgammas of magnitude up to lgamma(128) ~ 490,
# whose f32 ulp is 3e-5, and torch's and XLA's lgamma differ by an ulp: so
# atol is two such ulps.  Above 64 the cancellation-safe branch keeps the
# terms small.
BETA_RTOL, BETA_ATOL = 1e-5, 6e-5


@pytest.mark.parametrize('y', [0.3, 1.0, 7.5, 63.0, 64.0, 500.0])
def test_log_beta_both_branches(y):
    x = np.array([0.1, 0.5, 1, 2, 10, 50, 63.9, 64, 65, 100, 1e4, 1e6],
                 np.float32)
    yy = np.full_like(x, y)
    np.testing.assert_allclose(
        tsp.log_beta(torch.from_numpy(x), torch.from_numpy(yy)).numpy(),
        np.asarray(jsp.log_beta(x, yy)), rtol=BETA_RTOL, atol=BETA_ATOL)


def test_log_binom():
    n = np.array([1, 5, 20, 100, 1000, 1e5, 1e6], np.float32)
    for frac in (0.0, 0.25, 0.5, 1.0):
        k = np.floor(n * frac).astype(np.float32)
        got = tsp.log_binom(torch.from_numpy(n), torch.from_numpy(k)).numpy()
        # a result of magnitude up to ~7e5: one f32 ulp of it is 0.06
        np.testing.assert_allclose(got, np.asarray(jsp.log_binom(n, k)),
                                   rtol=BETA_RTOL, atol=BETA_ATOL)


def test_log_factorial():
    n = np.array([0, 1, 2, 5, 20, 170, 1e4], np.float32)
    np.testing.assert_allclose(
        tsp.log_factorial(torch.from_numpy(n)).numpy(),
        np.asarray(jsp.log_factorial(n)), rtol=BETA_RTOL, atol=BETA_ATOL)
    assert tsp.log_factorial(torch.tensor([3], dtype=torch.int32)).dtype \
        == torch.float32


@pytest.mark.parametrize('d', [1, 2, 3, 4])
def test_lmultigamma(d):
    a = np.array([0.5 * d + 0.1, 0.5 * d + 1, 5, 50, 1e3], np.float32)
    np.testing.assert_allclose(
        tsp.lmultigamma(d, torch.from_numpy(a)).numpy(),
        np.asarray(jsp.lmultigamma(d, a)), rtol=BETA_RTOL, atol=BETA_ATOL)
