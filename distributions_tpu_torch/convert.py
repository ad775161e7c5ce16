"""Carry state between the JAX package and the port.

The functions here take the JAX package's objects with numpy leaves (for
example `jax.tree_util.tree_map(np.asarray, state)`), and return the
port's objects with tensors on a given device (`config.default_device()`
when none is named).  Leaves keep their dtypes: dpd's int32 slots, bool
masks and niw's [d, d] psi go across as they are.  Model modules are
matched by their `NAME` ('NormalInverseChiSq' -> models.nich).
`to_numpy` is the inverse direction: it turns every tensor of a port
object into a numpy array and keeps the containers.  Nothing here
imports JAX.
"""

import numpy as np
import torch

from distributions_tpu_torch import clustering, mixture as mx
from distributions_tpu_torch.config import resolve_device
from distributions_tpu_torch.models import MODULES

_BY_NAME = {m.NAME: m for m in MODULES.values()}


def tensor(a, device=None):
    """A numpy-like leaf as a tensor of the same dtype on `device`."""
    return torch.from_numpy(np.array(a, copy=True)).to(
        resolve_device(device))


def module(ref_module):
    """The port's model module for a module with the same NAME."""
    return _BY_NAME[ref_module.NAME]


def spec(ref_spec):
    """A MixtureSpec whose blocks name the port's modules."""
    return mx.make_spec([(module(b.module), b.cols) for b in ref_spec.blocks],
                        capacity=ref_spec.capacity, empties=ref_spec.empties)


def cl_model(ref_model, device=None):
    """PitmanYor (or LowEntropy) with tensor leaves."""
    cls = getattr(clustering, type(ref_model).__name__)
    return cls(*(tensor(leaf, device) for leaf in ref_model))


def shareds(ref_spec, ref_shareds, device=None):
    """Per-block Shared NamedTuples with tensor leaves."""
    return tuple(
        module(b.module).Shared(*(tensor(leaf, device) for leaf in sh))
        for b, sh in zip(ref_spec.blocks, ref_shareds))


def state(ref_spec, ref_state, device=None):
    """A MixtureState with tensor leaves (int32 counts, bool alive, int32
    sample_size, per-block Groups)."""
    groups = tuple(
        module(b.module).Group(*(tensor(leaf, device) for leaf in g))
        for b, g in zip(ref_spec.blocks, ref_state.groups))
    return mx.MixtureState(counts=tensor(ref_state.counts, device),
                           alive=tensor(ref_state.alive, device),
                           sample_size=tensor(ref_state.sample_size, device),
                           groups=groups)


def sharded_state(ref_spec, ref_state, mesh, device=None):
    """A component-sharded state of the JAX package (gathered: numpy
    leaves of the full [C], whose `n_comp` contiguous ranges are the
    shards, each with its own alive mask) as the port's sharded state: the
    list, per local shard of `mesh`, of its range's MixtureState.  The cut
    is pure slicing, so every shard's leaves cross over as they are;
    `parallel.sharding.unshard_state_components` plus `to_numpy` is the
    way back."""
    from distributions_tpu_torch.parallel import sharding
    return sharding.shard_state_components(
        state(ref_spec, ref_state, device), mesh)


def cache(ref_cache, device=None):
    """A fused-sweep stat cache (counts_delta [T, C], per-block sums)."""
    cd, sums = ref_cache
    return tensor(cd, device), tuple(tensor(s, device) for s in sums)


def to_numpy(obj):
    """Every tensor in `obj` (nested tuples / NamedTuples) as numpy."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, tuple) and hasattr(obj, '_fields'):
        return type(obj)(*(to_numpy(x) for x in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_numpy(x) for x in obj)
    return obj
