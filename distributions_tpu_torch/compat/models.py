"""Class-based model facade: one submodule-like namespace per model with
`Shared`, `Group`, `Sampler`, `Mixture`, `sample_group`, `NAME`,
`EXAMPLES`, `Value` (the reference's feature-model API,
doc/overview.rst:51-157), generated from the port's functional core modules
(distributions_tpu.compat.models).

Groups and Shareds hold scalar (unbatched) containers of tensors on
`config.default_device()`; scoring and sampling delegate to the functional
core with the generator of compat.rng.global_rng.  Values come back as
Python numbers (numpy arrays for vectors), so `dump()` dicts equal the JAX
facade's.
"""

import types

import numpy as np
import torch

from distributions_tpu_torch.compat.mixture import make_feature_mixture
from distributions_tpu_torch.compat.rng import get_generator
from distributions_tpu_torch.models import MODULES as _CORE, dpd as _dpd


class _SharedBase(object):
    _core = None

    def __init__(self):
        self._data = None

    # -- reference SharedIoMixin surface (mixins.py:61-105) --
    def load(self, raw):
        self._data = self._core.shared_from_dict(raw)

    def dump(self):
        return self._core.shared_to_dict(self._data)

    @classmethod
    def from_dict(cls, raw):
        self = cls()
        self.load(raw)
        return self

    # -- reference SharedMixin surface (mixins.py:33-58) --
    def add_value(self, value):
        fn = getattr(self._core, 'shared_add_value', None)
        if fn is not None:
            self._data = fn(get_generator(), self._data, value)

    def add_repeated_value(self, value, count=1):
        for _ in range(int(count)):
            self.add_value(value)

    def remove_value(self, value):
        fn = getattr(self._core, 'shared_remove_value', None)
        if fn is not None:
            self._data = fn(get_generator(), self._data, value)

    def realize(self):
        fn = getattr(self._core, 'shared_realize', None)
        if fn is not None:
            self._data = fn(get_generator(), self._data)

    def plus_group(self, group):
        fn = getattr(self._core, 'plus_group', None)
        if fn is None:
            raise AttributeError('no plus_group for this model')
        post = type(self)()
        post._data = fn(self._data, group._data)
        return post


class _GroupBase(object):
    _core = None

    def __init__(self):
        self._data = None

    def _shared_arg(self, shared):
        """() or (shared's data,): dpd's groups are read and written
        against the Shared's value table."""
        if self._core is not _dpd:
            return ()
        assert shared is not None, 'this model needs shared to load or dump'
        return (shared._data,)

    def init(self, shared):
        self._data = self._core.group_init(shared._data)

    def load(self, raw, shared=None):
        self._data = self._core.group_from_dict(raw,
                                                *self._shared_arg(shared))

    def dump(self, shared=None):
        return self._core.group_to_dict(self._data,
                                        *self._shared_arg(shared))

    @classmethod
    def from_dict(cls, raw, shared=None):
        self = cls()
        self.load(raw, shared)
        return self

    @classmethod
    def from_values(cls, shared, values=()):
        self = cls()
        self.init(shared)
        for value in values:
            self.add_value(shared, value)
        return self

    def add_value(self, shared, value):
        self._data = self._core.add_value(shared._data, self._data, value)

    def add_repeated_value(self, shared, value, count):
        self._data = self._core.add_repeated_value(
            shared._data, self._data, value, count)

    def remove_value(self, shared, value):
        self._data = self._core.remove_value(shared._data, self._data, value)

    def merge(self, shared, source):
        self._data = self._core.merge(shared._data, self._data, source._data)

    def score_value(self, shared, value):
        return float(self._core.score_value(shared._data, self._data, value))

    def score_data(self, shared):
        return float(self._core.score_data(shared._data, self._data))

    def sample_value(self, shared):
        out = self._core.sample_value(get_generator(), shared._data,
                                      self._data)
        return _pyvalue(out)


class _SamplerBase(object):
    _core = None

    def init(self, shared, group=None):
        self._params = self._core.sampler_init(
            get_generator(), shared._data,
            None if group is None else group._data)

    def eval(self, shared):
        return _pyvalue(self._core.sampler_eval(
            get_generator(), shared._data, self._params))


def _pyvalue(x):
    """A draw as the reference hands it out: bool, int or float for a
    scalar, a numpy array for a vector."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    arr = np.asarray(x)
    if arr.ndim > 0:
        return arr
    if arr.dtype == bool:
        return bool(arr)
    if np.issubdtype(arr.dtype, np.integer):
        return int(arr)
    return float(arr)


def _make_namespace(name, core):
    mod = types.ModuleType('distributions_tpu_torch.compat.models.' + name)
    mod.NAME = core.NAME
    mod.EXAMPLES = core.EXAMPLES
    mod.Value = core.Value
    mod.Shared = type('Shared', (_SharedBase,), {'_core': core})
    mod.Group = type('Group', (_GroupBase,), {'_core': core})
    mod.Sampler = type('Sampler', (_SamplerBase,), {'_core': core})

    def sample_group(shared, size):
        values = core.sample_group(get_generator(), shared._data, size)
        return [_pyvalue(v) for v in values.detach().cpu().numpy()]

    mod.sample_group = sample_group
    mod.Mixture = make_feature_mixture(core)
    mod._core = core
    return mod


_NAMESPACES = {name: _make_namespace(name, core)
               for name, core in _CORE.items()}

bb = _NAMESPACES['bb']
bnb = _NAMESPACES['bnb']
dd = _NAMESPACES['dd']
dpd = _NAMESPACES['dpd']
gp = _NAMESPACES['gp']
nich = _NAMESPACES['nich']
niw = _NAMESPACES['niw']

MODULES = _NAMESPACES
