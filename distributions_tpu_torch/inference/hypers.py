"""Hyperparameter inference (distributions_tpu.inference.hypers):
grid-based empirical Bayes over Shared hyperparameters and the clustering
prior.  Every few sweeps a feature block's hyperparameters, or the
clustering model's, are scored on a grid against the current groups, and
one categorical draw (or the argmax) picks the new setting.

Randomness comes from a `torch.Generator` in place of a `jax.random` key:
a sampled step draws one seed from it (`random.draw_seed`) and samples on
the scores' device; an argmax step draws nothing.
"""

import torch

from distributions_tpu_torch import clustering as _cl, mixture as mx
from distributions_tpu_torch.config import resolve_device
from distributions_tpu_torch.random import (device_generator, draw_seed,
                                            sample_from_scores)


def _pick(generator, scores, sample):
    if sample:
        gen = device_generator(draw_seed(generator), scores.device)
        return sample_from_scores(gen, scores)
    return torch.argmax(scores)


def grid_step_feature(generator, spec, block_idx, shareds, state, grid_shared,
                      sample=True):
    """Resample (or argmax) block `block_idx`'s Shared from a grid.

    grid_shared: a Shared of that block's model whose leaves carry a
    leading grid axis [G].  Returns (new shareds tuple, chosen index as a
    0-d int64 tensor, grid scores [G])."""
    scores = mx.block_score_data_grid(spec.blocks[block_idx], grid_shared,
                                      state.groups[block_idx])
    idx = _pick(generator, scores, sample)
    chosen = type(grid_shared)(*(leaf[idx] for leaf in grid_shared))
    new_shareds = tuple(
        chosen if i == block_idx else s for i, s in enumerate(shareds))
    return new_shareds, idx, scores


def grid_step_clustering(generator, cl_grid, state, sample=True):
    """Resample the clustering prior's hyperparameters from a grid of
    models (leaves [G], such as `make_py_grid` builds) against the current
    partition.  Returns (chosen model, index, grid scores [G])."""
    scores = _cl.score_counts(cl_grid, state.counts)
    idx = _pick(generator, scores, sample)
    chosen = type(cl_grid)(*(leaf[idx] for leaf in cl_grid))
    return chosen, idx, scores


def make_py_grid(alphas, ds, device=None):
    """Cartesian Pitman-Yor grid: a model with leaves [len(alphas) *
    len(ds)], alpha-major."""
    device = resolve_device(device)
    alphas = torch.as_tensor(alphas, dtype=torch.float32, device=device)
    ds = torch.as_tensor(ds, dtype=torch.float32, device=device)
    A, D = torch.meshgrid(alphas, ds, indexing='ij')
    return _cl.PitmanYor(alpha=A.reshape(-1), d=D.reshape(-1))
