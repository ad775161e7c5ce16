"""Continuous hyperparameter inference (distributions_tpu.inference.slice):
univariate slice sampling (Neal 2003, stepping out and shrinkage) of the
objectives that `inference/hypers.py` scores on a grid: a feature block's
`score_data` and the clustering model's `score_counts`.  Positive
parameters are sampled in log space; the target is exp(logprob) times a
flat prior in the sampled coordinate.

Where the JAX package runs the loops inside one program
(`lax.while_loop`), the port runs them in Python on host scalars: every
evaluation of the objective is a handful of [C]-sized tensor operations
and one read of a scalar from the device.  One `slice_1d` move evaluates
the objective at most 3 + max_step_out + max_shrink = 51 times.
"""

import math
from functools import partial

import torch

from distributions_tpu_torch import clustering as _cl


def slice_1d(generator, x0, logp, width=1.0, lo=-math.inf, hi=math.inf,
             max_step_out=16, max_shrink=32):
    """One univariate slice-sampling transition from x0 under logp.

    Stepping out with interval width `width`, truncated to [lo, hi];
    shrinkage until acceptance, at most max_shrink times, after which the
    move falls back to x0: a null move, never an invalid one.  logp takes
    a float and returns a float or a 0-d tensor.  All the move's random
    numbers are drawn from `generator` at once.  Returns the new x as a
    float."""
    dev = generator.device
    u = torch.rand(2 + max_shrink, generator=generator, device=dev,
                   dtype=torch.float64).tolist()
    j_left = int(torch.randint(0, max_step_out + 1, (1,), generator=generator,
                               device=dev))
    x0 = float(x0)

    def f(x):
        return float(logp(x))
    y = f(x0) + math.log(max(u[0], 1e-38))

    left = max(x0 - width * u[1], lo)
    right = min(left + width, hi)
    # stepping out (Neal's fig. 3), the budget split at random between sides
    j = 0
    while j < j_left and left > lo and f(left) > y:
        left = max(left - width, lo)
        j += 1
    j = 0
    while j < max_step_out - j_left and right < hi and f(right) > y:
        right = min(right + width, hi)
        j += 1
    for it in range(max_shrink):
        x1 = left + u[2 + it] * (right - left)
        if f(x1) > y:
            return x1
        if x1 < x0:
            left = x1
        else:
            right = x1
    return x0


def _sigmoid(t):
    return 1.0 / (1.0 + math.exp(-t))


def slice_step_clustering(generator, model, state, n_steps=2,
                          w_log_alpha=1.0, w_logit_d=1.5, sample_d=True,
                          d_max=0.9999):
    """Resample Pitman-Yor {alpha, d} by slice sampling against the
    current partition (`clustering.score_counts` of state.counts): alpha
    in log space on [-10, 12], d in logit space (d in [0, d_max));
    sample_d=False holds d fixed.

    Returns (new model, (log_alpha, logit_d) final coordinates).  A
    LowEntropy model has no hyperparameter and raises ValueError."""
    if not isinstance(model, _cl.PitmanYor):
        raise ValueError('slice_step_clustering resamples Pitman-Yor '
                         '{alpha, d}; got %s' % type(model).__name__)
    counts = state.counts
    dev = counts.device

    def model_at(alpha, d):
        return type(model)(
            alpha=torch.tensor(alpha, dtype=torch.float32, device=dev),
            d=torch.tensor(d, dtype=torch.float32, device=dev))

    def logp_a(log_alpha, d):
        return _cl.score_counts(model_at(math.exp(log_alpha), d), counts)

    def logp_d(logit_d, alpha):
        return _cl.score_counts(model_at(alpha, d_max * _sigmoid(logit_d)),
                                counts)

    la = math.log(float(model.alpha))
    d = float(model.d)
    td = math.log(max(d / d_max, 1e-6) / max(1.0 - d / d_max, 1e-6))
    for _ in range(n_steps):
        la = slice_1d(generator, la,
                      partial(logp_a, d=d_max * _sigmoid(td) if sample_d
                              else d),
                      width=w_log_alpha, lo=-10.0, hi=12.0)
        if sample_d:
            td = slice_1d(generator, td, partial(logp_d, alpha=math.exp(la)),
                          width=w_logit_d, lo=-12.0, hi=12.0)
    new_d = d_max * _sigmoid(td) if sample_d else d
    return model_at(math.exp(la), new_d), (la, td)


# Shared leaves sampled on the identity scale; every other leaf is positive
# and sampled in log space
_IDENTITY_PARAMS = ('mu',)


def _slice_param_sweep(generator, shared, group, width, lo, hi, module, name,
                       ident, prior_fn=None):
    """One coordinate-wise slice pass over every coordinate of Shared leaf
    `name` (a scalar, a [cols] leaf or a vector such as dd's `alphas`).
    Returns the new shared."""
    leaf0 = torch.as_tensor(getattr(shared, name)).to(torch.float32)
    flat = leaf0.reshape(-1).tolist()

    def with_leaf(values):
        leaf = torch.tensor(values, dtype=torch.float32,
                            device=leaf0.device).reshape(leaf0.shape)
        return shared._replace(**{name: leaf})

    for c in range(len(flat)):
        def logp_at(x, c=c):
            trial = list(flat)
            trial[c] = x if ident else math.exp(x)
            lp = float(module.score_data(with_leaf(trial), group).sum())
            if prior_fn is not None:
                lp = lp + float(prior_fn(x))
            return lp
        x0 = flat[c] if ident else math.log(max(flat[c], 1e-30))
        x0 = min(max(x0, lo), hi)
        x1 = slice_1d(generator, x0, logp_at, width=width, lo=lo, hi=hi)
        flat[c] = x1 if ident else math.exp(x1)
    return with_leaf(flat)


def slice_step_feature(generator, spec, block_idx, shareds, state, params,
                       n_steps=1, width=1.0, bounds=None, priors=None):
    """Resample Shared leaves of block `block_idx` by coordinate-wise slice
    sampling of the block's `score_data` (the objective that
    `hypers.grid_step_feature` scores on a grid).

    params: the Shared field names to resample.  A leaf may be a scalar, a
    [cols] leaf or a vector (dd's `alphas`: coordinate by coordinate).
    Positive fields are sampled in log space, `mu` on the identity scale.
    niw's `psi` is refused with ValueError: a coordinate-wise move does
    not keep a matrix positive definite.

    bounds: optional {name: (lo, hi)} in the SAMPLED coordinate (log space
    for positive fields); by default identity fields are unbounded and
    log-space fields lie in [-45, 45].  The start is clipped into the
    bounds.  priors: optional {name: callable(x) -> log density} in the
    sampled coordinate, added to the objective.  Concentration parameters
    need one or the other: a Dirichlet or Beta `score_data` tends to a
    constant as the concentrations grow in the data's proportions, so the
    flat-in-log posterior has an improper ridge and the chain walks to the
    upper bound.

    Returns (new shareds tuple, the block's new shared)."""
    block = spec.blocks[block_idx]
    group = state.groups[block_idx]
    shared = shareds[block_idx]
    if 'psi' in params:
        raise ValueError("slice_step_feature does not resample 'psi': a "
                         'coordinate-wise move does not keep it positive '
                         'definite')
    for name in params:
        if name not in shared._fields:
            raise ValueError('%s has no hyperparameter %r'
                             % (block.module.__name__, name))
    for _ in range(n_steps):
        for name in params:
            ident = name in _IDENTITY_PARAMS
            if bounds is not None and name in bounds:
                lo, hi = bounds[name]
            elif ident:
                lo, hi = -math.inf, math.inf
            else:
                lo, hi = -45.0, 45.0
            shared = _slice_param_sweep(
                generator, shared, group, float(width), float(lo), float(hi),
                block.module, name, ident, (priors or {}).get(name))
    new_shareds = tuple(
        shared if i == block_idx else s for i, s in enumerate(shareds))
    return new_shareds, shared
