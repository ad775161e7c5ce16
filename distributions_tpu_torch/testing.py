"""Helpers shared by the port's tests and chip_smoke.py: seeded numpy
problems, the comparisons the kernel is held to (near-tie accounting
for draws that should match, z-tests for draws that should match in
distribution), and the check that a sweep is capturable (`HostReads`)."""

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

NICH_SHARED = {'mu': 0., 'kappa': 0.1, 'sigmasq': 1.0, 'nu': 1.}
PY = {'alpha': 1.0, 'd': 0.1}


def nich_problem(R, cols=2, n_clusters=8, seed=0, spread=3.0, noise=0.3):
    """Blob data for a nich mixture, made with numpy from `seed`:
    (values [R, cols] f32, generating labels [R] int32)."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_clusters, cols) * spread
    labels = rng.randint(0, n_clusters, R)
    values = (centers[labels] + noise * rng.randn(R, cols)).astype(
        np.float32)
    return values, labels.astype(np.int32)


NIW_SHARED = {'kappa': 1.0}   # mu = 0, psi = I, nu = d + 1 are added per d
DPD_SHARED = {'gamma': 1.0, 'alpha': 1.0,
              'betas': {0: 0.2, 1: 0.15, 2: 0.15, 3: 0.15, 4: 0.1, 5: 0.1}}

# kind -> blocks as (model name, niw dimension or None); every block has
# one column
MIXED_KINDS = {
    'nich_gp_bb': (('nich', None), ('gp', None), ('bb', None)),
    'dd_bb': (('dd', None), ('bb', None)),
    'niw2': (('niw', 2),),
    'niw3_nich_bb': (('niw', 3), ('nich', None), ('bb', None)),
    'niw4': (('niw', 4),),
    'dpd_nich': (('dpd', None), ('nich', None)),
    'bnb': (('bnb', None),),
    # the two layouts timed at full width (data and hypers of the JAX
    # package's profile_mixed.py)
    'niw2mix': (('niw', 2), ('nich', None), ('bb', None)),
    'bbddgp': (('bb', None), ('dd', None), ('gp', None)),
    # bbddgp with a nich column in front: the v1 mixed sweep's layout
    'nichbbddgp': (('nich', None), ('bb', None), ('dd', None), ('gp', None)),
    # one table column alone: K2's folded shape (bb: 2 values, dd: 4)
    'bb': (('bb', None),),
    'dd': (('dd', None),),
    # niw columns past d = 4: K2's niw16 shape (one column of d = 16) and
    # its wide shape of d <= 16 (every other layout with such a column)
    'niw5': (('niw', 5),),
    'niw8': (('niw', 8),),
    'niw13': (('niw', 13),),
    'niw16': (('niw', 16),),
    'niw16_nich': (('niw', 16), ('nich', None)),
}


def _niw_shared(d):
    return dict(NIW_SHARED, mu=np.zeros(d), psi=np.eye(d), nu=d + 1.0)


def mixed_problem(R, C, seed=0, kind='nich_gp_bb', n_clusters=3):
    """A mixed-model clustering problem made with numpy from `seed`, in a
    form both packages can build from: a dict with

      blocks    [(model name, cols, shared dict, shared_from_dict kwargs)]
      values    per block [R, 1] (or [R, 1, d] for niw) numpy arrays
      labels    [R] int32 generating labels in [0, n_clusters)
      capacity  C

    The small kinds are separated clusters (as tests/test_fused_mixed.py
    builds them); 'niw2mix', 'bbddgp' and 'nichbbddgp' follow
    profile_mixed.py."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, n_clusters, R)
    wide = kind in ('niw2mix', 'bbddgp', 'nichbbddgp')
    blocks, values = [], []
    for name, d in MIXED_KINDS[kind]:
        kwargs = {}
        if name == 'nich':
            shared = dict(NICH_SHARED)
            if wide:
                v = rng.randn(R, 1)
            else:
                v = (4.0 * labels / max(n_clusters - 1, 1) - 2.0)[:, None] \
                    + 0.4 * rng.randn(R, 1)
            v = v.astype(np.float32)
        elif name == 'niw':
            shared = _niw_shared(d)
            if wide:
                centers = 3.0 * rng.randn(n_clusters, d)
                v = centers[labels] + 0.3 * rng.randn(R, d)
            else:
                v = (3.0 * (labels - (n_clusters - 1) / 2.0))[:, None] \
                    + 0.5 * rng.randn(R, d)
            v = v[:, None, :].astype(np.float32)
        elif name == 'bb':
            shared = {'alpha': 0.5, 'beta': 0.5}
            v = (rng.rand(R) < (0.4 if wide else 0.3))[:, None]
        elif name == 'dd':
            shared = {'alphas': [1.0, 0.5, 2.0, 1.5]}
            if wide:
                v = rng.randint(0, 4, (R, 1))
            else:
                v = np.where(labels % 3 == 0, rng.randint(0, 2, R),
                             rng.randint(2, 4, R))[:, None]
            v = v.astype(np.int32)
        elif name == 'gp':
            if wide:
                shared = {'alpha': 2.0, 'inv_beta': 1.0}
                v = rng.poisson(1.0 + (labels % 16))
            else:
                shared = {'alpha': 1.0, 'inv_beta': 0.5}
                v = rng.poisson(np.where(labels % 3 == 0, 2., 9.))
            v = v[:, None].astype(np.int32)
        elif name == 'dpd':
            shared = dict(DPD_SHARED)
            kwargs = {'cap': 16}
            v = np.where(labels % 3 == 0, rng.randint(0, 3, R),
                         rng.randint(3, 6, R))[:, None].astype(np.int32)
        elif name == 'bnb':
            shared = {'alpha': 1.0, 'beta': 4.0, 'r': 2}
            p = 0.2 + 0.6 * (labels % 8) / 8.0
            v = rng.negative_binomial(2, 1.0 - p)[:, None].astype(np.int32)
        else:
            raise ValueError('unknown model %r' % (name,))
        blocks.append((name, 1, shared, kwargs))
        values.append(v)
    return {'blocks': blocks, 'values': tuple(values),
            'labels': labels.astype(np.int32), 'capacity': int(C)}


def build_problem(problem, models, make_spec, cl_from_dict, **kwargs):
    """(spec, clustering model, shareds) of a `mixed_problem` in one
    package: `models` maps model names to its modules, `make_spec` and
    `cl_from_dict` are its `mixture.make_spec` and
    `clustering.PitmanYor.from_dict`; kwargs (such as device=) go to the
    factories."""
    spec = make_spec([(models[name], cols)
                      for name, cols, _, _ in problem['blocks']],
                     capacity=problem['capacity'])
    shareds = tuple(models[name].shared_from_dict(raw, **kw, **kwargs)
                    for name, _, raw, kw in problem['blocks'])
    return spec, cl_from_dict(PY, **kwargs), shareds


def v1_random_inputs(B, C, cols, n_tab, V=6, seed=0, device=None):
    """Random inputs of the v1 score + sample kernels, made with numpy from
    `seed`: (values [B, cols], table_idx [B, n_tab] int32, cl_scores [C],
    coeffs [4 * cols, C], tables [n_tab, V, C]) as float32 tensors on
    `device`, None for a kind of column the layout lacks.  The `nich_coeffs`
    rows have negative log coefficients and positive precisions; table
    column j has support max(1, V - j % 3); every tenth slot is dead."""
    rng = np.random.RandomState(seed)
    values = coeffs = idx = tables = None
    if cols:
        values = rng.randn(B, cols)
        coeffs = np.concatenate([
            [rng.randn(C), -np.abs(rng.randn(C)) - 0.1,
             np.abs(rng.randn(C)) + 0.1, rng.randn(C)] for _ in range(cols)])
    if n_tab:
        idx = np.stack([rng.randint(0, max(1, V - j % 3), B)
                        for j in range(n_tab)], 1)
        tables = rng.randn(n_tab, V, C)
    cl_scores = rng.randn(C)
    cl_scores[::10] = -np.inf

    def put(x, dtype=torch.float32):
        return None if x is None else torch.as_tensor(
            np.ascontiguousarray(x), dtype=dtype, device=device)
    return (put(values), put(idx, torch.int32), put(cl_scores), put(coeffs),
            put(tables))


def mismatches(scores, got, want):
    """(number of rows whose draws differ, largest score gap between the
    two drawn slots over those rows).  A gap at f32 rounding level marks
    a near-tie."""
    scores = torch.as_tensor(scores)
    got = torch.as_tensor(got, device=scores.device).long()
    want = torch.as_tensor(want, device=scores.device).long()
    bad = got != want
    n = int(bad.sum())
    if n == 0:
        return 0, 0.0
    rows = scores[bad]
    gap = (rows.gather(1, got[bad][:, None])
           - rows.gather(1, want[bad][:, None])).abs()
    return n, float(gap.max())


def softmax_ztest(draws, scores, min_expected=20.0):
    """Largest |z| of the slot frequencies of `draws` against the softmax
    of `scores` [B, C], over slots expecting more than `min_expected`
    draws (as tests/test_tpu_pallas.py does)."""
    p = torch.softmax(torch.as_tensor(scores).to(torch.float64), dim=1)
    C = p.shape[1]
    counts = torch.bincount(torch.as_tensor(draws, device=p.device).long(),
                            minlength=C).to(torch.float64)
    expected = p.sum(0)
    var = torch.clamp((p * (1 - p)).sum(0), min=1e-9)
    z = (counts - expected) / var.sqrt()
    big = expected > min_expected
    return float(z[big].abs().max())


def _bin_z(counts, probs, n, min_expected=20.0):
    """Largest |z| of bin counts against bin probabilities over n draws;
    bins expected to hold fewer than `min_expected` draws are pooled."""
    counts = np.asarray(counts, np.float64)
    probs = np.asarray(probs, np.float64)
    small = probs * n < min_expected
    if small.any():
        counts = np.append(counts[~small], counts[small].sum())
        probs = np.append(probs[~small], probs[small].sum())
    keep = (probs > 0) & (probs < 1)
    z = (counts[keep] - n * probs[keep]) / np.sqrt(
        n * probs[keep] * (1 - probs[keep]))
    return float(np.abs(z).max()) if z.size else 0.0


def sample_group_z(module, shared, values, n_test, n_fit):
    """Holds `sample_group` draws against the model's own predictive
    score.  The draws are exchangeable, so given the first n_fit values
    each of the last n_test follows the posterior predictive of a group
    built from the first ones; with n_test small beside n_fit the last
    ones are nearly independent given the first.  n_fit stays modest
    because the f32 predictive of the count models (gp, bnb) differences
    lgammas of the group's sums, which lose accuracy as the sums grow.
    Returns the
    largest |z| of their bin counts against the predictive's bin
    probabilities: the support values of a discrete model (its tail
    pooled) from `score_value_batch`; for nich 8 bins around the
    predictive's centre, integrated from exp(score_value_batch) on a fine
    grid; for niw the probability integral transform of the Mahalanobis
    distance, an F(d, dof) variable (tests/test_models.py's check), in 10
    bins."""
    name = module.__name__.rsplit('.', 1)[-1]
    fit, test = values[:n_fit], values[-n_test:]
    dev = values.device
    group = module.from_values_grouped(
        shared, fit, torch.zeros(fit.shape[0], dtype=torch.int32,
                                 device=dev), 1)
    if name == 'niw':
        import scipy.stats
        post = module.plus_group(shared, group)
        d = values.shape[-1]
        dof = float(post.nu[0]) - d + 1.0
        kappa = float(post.kappa[0])
        mu = post.mu[0].double().cpu().numpy()
        sigma = (post.psi[0].double().cpu().numpy() * (kappa + 1.0)
                 / (kappa * dof))
        diff = test.double().cpu().numpy() - mu
        maha = np.einsum('nd,de,ne->n', diff, np.linalg.inv(sigma), diff)
        u = scipy.stats.f.cdf(maha / d, d, dof)
        counts = np.bincount(np.minimum((u * 10).astype(int), 9),
                             minlength=10)
        return _bin_z(counts, np.full(10, 0.1), n_test)
    if name == 'nich':
        post = module.plus_group(shared, group)
        mu = float(post.mu[0])
        scale = float(torch.sqrt((1 + post.kappa[0]) / post.kappa[0]
                                 * post.sigmasq[0]))
        edges = mu + scale * np.array([-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0])
        probs = []
        for lo, hi in zip(edges[:-1], edges[1:]):
            grid = torch.linspace(lo, hi, 4001, dtype=torch.float32,
                                  device=dev)
            dens = torch.exp(module.score_value_batch(shared, group, grid)[
                :, 0]).double().cpu().numpy()
            x = grid.double().cpu().numpy()
            probs.append(float(((dens[1:] + dens[:-1]) / 2
                                * np.diff(x)).sum()))
        inner = np.array(probs)
        probs = np.concatenate([[0.0], inner, [0.0]])
        probs[0] = probs[-1] = (1.0 - inner.sum()) / 2   # t is symmetric
        idx = np.searchsorted(edges, test.double().cpu().numpy())
        return _bin_z(np.bincount(idx, minlength=8), probs, n_test)
    # discrete: every support value, the tail pooled
    t = test.to(torch.int64).cpu().numpy()
    if name == 'bb':
        support = np.array([0, 1])
    elif name == 'dd':
        support = np.arange(module.dim(shared))
    elif name == 'dpd':
        support = module.shared_to_dict(shared)['betas']
        support = np.array(sorted(support) + (
            [module.OTHER] if float(shared.beta0) > 0 else []))
    else:
        support = np.arange(int(t.max()) + 1)
    sup = torch.as_tensor(support, device=dev)
    if name == 'bb':
        sup = sup.to(torch.bool)
    probs = torch.exp(module.score_value_batch(shared, group, sup)[:, 0]
                      ).double().cpu().numpy()
    counts = np.array([(t == v).sum() for v in support])
    tail = max(0.0, 1.0 - probs.sum())
    return _bin_z(np.append(counts, n_test - counts.sum()),
                  np.append(probs, tail), n_test)


class HostReads(TorchDispatchMode):
    """Records the ops that would read the device back or copy from the
    host on the card, which a CUDA graph's capture refuses: `.item()` and
    friends, data-dependent shapes, and any operand that is neither one of
    the `known` storages (the run's inputs, by `data_ptr()`) nor made by
    an earlier op.  `paused` leaves the ops out while it is set (a kernel
    wrapper's own host work, which differs on the card)."""

    SYNCS = ('_local_scalar_dense', 'nonzero', 'unique', 'masked_select',
             'lift_fresh', '_linalg_check_errors')

    def __init__(self, known):
        super().__init__()
        self.known = set(known)
        self.found = []
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.paused:
            name = str(func)
            if any(s in name for s in self.SYNCS):
                self.found.append(name)
            for t in tree_flatten((args, kwargs))[0]:
                if isinstance(t, torch.Tensor) and t.numel() and (
                        t.untyped_storage().data_ptr() not in self.known):
                    self.found.append('%s of a host tensor %s'
                                      % (name, tuple(t.shape)))
        self.note(out)
        return out

    def note(self, out):
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self.known.add(t.untyped_storage().data_ptr())
