"""Compat mixture pieces: MixtureIdTracker and the per-model feature
Mixture slave (reference include/distributions/mixture.hpp:170-521,
lp/mixture.pyx:40-60; distributions_tpu.compat.mixture)."""

import warnings

import numpy as np
import torch

from distributions_tpu_torch.models import base


class MixtureIdTracker(object):
    """Packed <-> global id bijection surviving swap-compaction
    (reference mixture.hpp:460-521)."""

    def __init__(self):
        self._packed_to_global = []
        self._global_to_packed = {}
        self._next_global = 0

    def init(self, group_count=0):
        self._packed_to_global = []
        self._global_to_packed = {}
        self._next_global = 0
        for _ in range(group_count):
            self.add_group()

    def __len__(self):
        return len(self._packed_to_global)

    def add_group(self):
        globalid = self._next_global
        self._next_global += 1
        self._global_to_packed[globalid] = len(self._packed_to_global)
        self._packed_to_global.append(globalid)

    def remove_group(self, packedid):
        # swap-with-back, mirroring Packed_::packed_remove
        removed_global = self._packed_to_global[packedid]
        del self._global_to_packed[removed_global]
        back_global = self._packed_to_global.pop()
        if packedid < len(self._packed_to_global):
            self._packed_to_global[packedid] = back_global
            self._global_to_packed[back_global] = packedid

    def packed_to_global(self, packedid):
        return self._packed_to_global[packedid]

    def global_to_packed(self, globalid):
        return self._global_to_packed[globalid]


class FeatureMixture(object):
    """Per-feature mixture slave: a packed list of scalar groups with
    vectorized scoring (reference MixtureSlave, mixture.hpp:344-450).

    The groups are kept stacked, one [K] container on the Shared's device,
    so that `score_value` scores all of them in one `score_value_batch`
    call and one copy back; a row op reads and writes one slot.

    Construct via `compat.models.<name>.Mixture()`."""

    _core = None  # functional model module, set by subclass
    _row_op_warned = False
    _ROW_OP_WARN_AT = 20000

    def __init__(self):
        self._stack = None
        self._row_ops = 0

    def _count_row_op(self):
        """One-time heads-up for migrating users: the reference's per-row
        loop idiom (remove/score/sample/add each row from Python) launches
        a few device operations and waits for one result per call, far
        slower than the batched sweeps."""
        self._row_ops += 1
        if (self._row_ops >= self._ROW_OP_WARN_AT
                and not FeatureMixture._row_op_warned):
            FeatureMixture._row_op_warned = True
            warnings.warn(
                'distributions_tpu_torch.compat: %d per-row mixture ops '
                'executed one at a time; this migration path is far slower '
                'than the batched sweeps — port hot loops to '
                'distributions_tpu_torch.ops.gibbs.sweep_blocked.'
                % self._row_ops, RuntimeWarning, stacklevel=3)

    def __len__(self):
        return 0 if self._stack is None else int(self._stack[0].shape[0])

    def clear(self):
        self._stack = None

    def _append(self, data):
        if self._stack is None:
            self._stack = base.group_stack([data])
        else:
            self._stack = type(data)(*(
                torch.cat([a, b.unsqueeze(0)])
                for a, b in zip(self._stack, data)))

    def append(self, group):
        self._append(group._data)

    def init(self, shared):
        pass  # nothing to precompute

    def add_group(self, shared):
        self._append(self._core.group_init(shared._data))

    def remove_group(self, shared, groupid):
        """Swap-with-back: the last group moves into `groupid`."""
        last = len(self) - 1
        leaves = []
        for a in self._stack:
            if groupid < last:
                a[groupid] = a[last]
            leaves.append(a[:last])
        self._stack = type(self._stack)(*leaves) if last else None

    def _update(self, fn, shared, groupid, value):
        self._count_row_op()
        sub = fn(shared._data, base.group_take(self._stack, groupid), value)
        for a, s in zip(self._stack, sub):
            a[groupid] = s

    def add_value(self, shared, groupid, value):
        self._update(self._core.add_value, shared, groupid, value)

    def remove_value(self, shared, groupid, value):
        self._update(self._core.remove_value, shared, groupid, value)

    def score_value(self, shared, value, scores_accum):
        """Accumulate per-group scores into scores_accum (numpy float32),
        matching the reference's accumulate contract
        (mixture.hpp:416-425)."""
        v = torch.as_tensor(np.asarray(value), device=self._stack[0].device)
        v = v[None] if v.dim() else v.reshape(1)
        out = self._core.score_value_batch(shared._data, self._stack, v)
        scores_accum[:len(self)] += out[0].cpu().numpy()
        return scores_accum

    def score_value_group(self, shared, groupid, value):
        return float(self._core.score_value(
            shared._data, base.group_take(self._stack, groupid), value))

    def score_data(self, shared):
        """The groups' scores summed in float64 in slot order."""
        if self._stack is None:
            return 0.0
        per = self._core.score_data(shared._data, self._stack)
        return float(sum(per.cpu().numpy().tolist()))


def make_feature_mixture(core):
    return type('Mixture', (FeatureMixture,), {'_core': core})
