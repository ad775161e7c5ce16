"""Protobuf (de)serialization for model Shareds/Groups and clustering models
(distributions_tpu.io.protobuf), wire-compatible with the JAX package and
the reference.

The messages are hand-written classes over `io.wire`, not generated code:
the port does not import `google.protobuf`.  Field names and numbers are
those of `schema.proto` (a copy of the JAX package's schema, kept beside
this module as its documentation).  The schema is proto2, and the encoding
gives the bytes `schema_pb2` gives:

- explicit presence: a scalar that was set is written, zero or not;
- repeated scalars are unpacked, one tag per element;
- `float` is fixed32 (values are rounded to float32 when set), the integer
  kinds are varints (a negative int32 as ten bytes);
- fields go out in field-number order.

Parsing also accepts packed repeated fields, as any protobuf parser must,
and skips fields it does not know.

Functions are keyed by the model's short name; loads build the port's
containers on `config.default_device()`, with int32 counts
and float32 statistics."""

import struct

import numpy as np

from distributions_tpu_torch import clustering as _clustering
from distributions_tpu_torch.io import wire
from distributions_tpu_torch.models import bb, bnb, dd, dpd, gp, nich, niw

FLOAT, UINT32, UINT64, INT32, MESSAGE = (
    'float', 'uint32', 'uint64', 'int32', 'message')
_RANGES = {UINT32: (0, (1 << 32) - 1), UINT64: (0, (1 << 64) - 1),
           INT32: (-(1 << 31), (1 << 31) - 1)}


def _f32(x):
    return struct.unpack('<f', struct.pack('<f', float(x)))[0]


def _check(kind, value):
    """`value` as the Python value a field of `kind` holds."""
    if kind == FLOAT:
        return _f32(value)
    value = int(value)
    lo, hi = _RANGES[kind]
    if not lo <= value <= hi:
        raise ValueError('%d out of range for %s' % (value, kind))
    return value


def _from_varint(kind, value):
    if kind == INT32:
        value &= 0xFFFFFFFF
        return value - (1 << 32) if value >> 31 else value
    if kind == UINT32:
        return value & 0xFFFFFFFF
    return value


class _Repeated(list):
    """A repeated scalar field: a list whose `append` / `extend` check and
    convert each element as the field's kind requires."""

    def __init__(self, kind):
        super().__init__()
        self._kind = kind

    def append(self, value):
        super().append(_check(self._kind, value))

    def extend(self, values):
        super().extend(_check(self._kind, v) for v in values)


class Message(object):
    """Base of the hand-written proto2 messages.  `FIELDS` holds
    (number, name, kind, repeated, message class or None) in field-number
    order."""

    FIELDS = ()

    def __init__(self):
        self.Clear()

    def _spec(self, name):
        for f in self.FIELDS:
            if f[1] == name:
                return f
        raise AttributeError('%s has no field %r'
                             % (type(self).__name__, name))

    def Clear(self):
        object.__setattr__(self, '_present', set())
        for _, name, kind, repeated, cls in self.FIELDS:
            if repeated:
                value = _Repeated(kind)
            elif kind == MESSAGE:
                value = cls()
            else:
                value = 0.0 if kind == FLOAT else 0
            object.__setattr__(self, name, value)

    def __setattr__(self, name, value):
        _, _, kind, repeated, _ = self._spec(name)
        if repeated or kind == MESSAGE:
            raise AttributeError('assignment to the %s field %r is not '
                                 'allowed' % ('repeated' if repeated
                                              else 'message', name))
        object.__setattr__(self, name, _check(kind, value))
        self._present.add(name)

    def _set_anything(self):
        return bool(self._present) or any(
            len(getattr(self, f[1])) if f[3]
            else f[2] == MESSAGE and getattr(self, f[1])._set_anything()
            for f in self.FIELDS)

    def HasField(self, name):
        _, _, kind, repeated, _ = self._spec(name)
        if repeated:
            raise ValueError('HasField of the repeated field %r' % name)
        if kind == MESSAGE:
            return getattr(self, name)._set_anything()
        return name in self._present

    def SerializeToString(self):
        out = bytearray()
        for number, name, kind, repeated, _ in self.FIELDS:
            if kind == MESSAGE:
                if self.HasField(name):
                    wire.put_bytes_field(
                        out, number, getattr(self, name).SerializeToString())
                continue
            if repeated:
                values = getattr(self, name)
            elif name in self._present:
                values = (getattr(self, name),)
            else:
                continue
            for v in values:
                if kind == FLOAT:
                    wire.put_varint(out, (number << 3) | wire.FIXED32)
                    out += struct.pack('<f', v)
                else:
                    wire.put_varint_field(out, number, int(v))
        return bytes(out)

    def MergeFromString(self, data):
        by_number = {f[0]: f for f in self.FIELDS}
        for number, wire_kind, value in wire.fields(data):
            if number not in by_number:
                continue
            _, name, kind, repeated, _ = by_number[number]
            if kind == MESSAGE:
                if wire_kind != wire.BYTES:
                    raise ValueError('field %r: wire type %d'
                                     % (name, wire_kind))
                getattr(self, name).MergeFromString(value)
                continue
            if kind == FLOAT:
                if wire_kind == wire.FIXED32:
                    values = struct.unpack(
                        '<f', value.to_bytes(4, 'little'))
                elif wire_kind == wire.BYTES and repeated:
                    values = struct.unpack('<%df' % (len(value) // 4), value)
                else:
                    raise ValueError('field %r: wire type %d'
                                     % (name, wire_kind))
            elif wire_kind == wire.VARINT or (
                    wire_kind == wire.BYTES and repeated):
                values = [_from_varint(kind, v)
                          for v in wire.repeated_varints(wire_kind, value)]
            else:
                raise ValueError('field %r: wire type %d' % (name, wire_kind))
            if repeated:
                getattr(self, name).extend(values)
            else:
                setattr(self, name, values[-1])
        return len(data)

    def ParseFromString(self, data):
        self.Clear()
        return self.MergeFromString(data)

    @classmethod
    def FromString(cls, data):
        message = cls()
        message.MergeFromString(data)
        return message


def _field(number, name, kind, repeated=False, cls=None):
    return (number, name, kind, repeated, cls)


def _message(name, *fields):
    """A Message subclass with the given `_field`s."""
    return type(name, (Message,), {'FIELDS': fields})


# -- the messages of schema.proto --------------------------------------------

class Clustering(Message):
    PitmanYor = _message('PitmanYor', _field(1, 'alpha', FLOAT),
                         _field(2, 'd', FLOAT))
    LowEntropy = _message('LowEntropy', _field(1, 'dataset_size', UINT64))
    FIELDS = (_field(1, 'pitman_yor', MESSAGE, cls=PitmanYor),
              _field(2, 'low_entropy', MESSAGE, cls=LowEntropy))


class BetaBernoulli(object):
    Shared = _message('Shared', _field(1, 'alpha', FLOAT),
                      _field(2, 'beta', FLOAT))
    Group = _message('Group', _field(1, 'heads', UINT64),
                     _field(2, 'tails', UINT64))


class DirichletDiscrete(object):
    Shared = _message('Shared', _field(1, 'alphas', FLOAT, True))
    Group = _message('Group', _field(1, 'counts', UINT64, True))


class DirichletProcessDiscrete(object):
    Shared = _message('Shared', _field(1, 'gamma', FLOAT),
                      _field(2, 'alpha', FLOAT),
                      _field(3, 'values', UINT32, True),
                      _field(4, 'betas', FLOAT, True),
                      _field(5, 'counts', UINT64, True))
    Group = _message('Group', _field(1, 'keys', UINT32, True),
                     _field(2, 'values', UINT64, True))


class GammaPoisson(object):
    Shared = _message('Shared', _field(1, 'alpha', FLOAT),
                      _field(2, 'inv_beta', FLOAT))
    Group = _message('Group', _field(1, 'count', UINT64),
                     _field(2, 'sum', UINT64), _field(3, 'log_prod', FLOAT))


class BetaNegativeBinomial(object):
    Shared = _message('Shared', _field(1, 'alpha', FLOAT),
                      _field(2, 'beta', FLOAT), _field(3, 'r', UINT64))
    Group = _message('Group', _field(1, 'count', UINT64),
                     _field(2, 'sum', UINT64))


class NormalInverseChiSq(object):
    Shared = _message('Shared', _field(1, 'mu', FLOAT),
                      _field(2, 'kappa', FLOAT), _field(3, 'sigmasq', FLOAT),
                      _field(4, 'nu', FLOAT))
    Group = _message('Group', _field(1, 'count', UINT64),
                     _field(2, 'mean', FLOAT),
                     _field(3, 'count_times_variance', FLOAT))


class NormalInverseWishart(object):
    Shared = _message('Shared', _field(1, 'mu', FLOAT, True),
                      _field(2, 'kappa', FLOAT), _field(3, 'psi', FLOAT, True),
                      _field(4, 'nu', FLOAT))
    Group = _message('Group', _field(1, 'count', INT32),
                     _field(2, 'sum_x', FLOAT, True),
                     _field(3, 'sum_xxT', FLOAT, True))


MESSAGES = {
    'bb': BetaBernoulli,
    'bnb': BetaNegativeBinomial,
    'dd': DirichletDiscrete,
    'dpd': DirichletProcessDiscrete,
    'gp': GammaPoisson,
    'nich': NormalInverseChiSq,
    'niw': NormalInverseWishart,
}


def _host(x):
    return x.detach().cpu().numpy()


def _int32(v):
    """A uint32 from the wire as the int32 the models hold."""
    return np.int32(np.uint32(v)).item()


# -- Shared -----------------------------------------------------------------

def shared_dump(name, shared, message=None):
    if message is None:
        message = MESSAGES[name].Shared()
    message.Clear()
    if name in ('bb', 'bnb'):
        message.alpha = float(shared.alpha)
        message.beta = float(shared.beta)
        if name == 'bnb':
            message.r = int(shared.r)
    elif name == 'dd':
        message.alphas.extend(_host(shared.alphas).tolist())
    elif name == 'dpd':
        message.gamma = float(shared.gamma)
        message.alpha = float(shared.alpha)
        act = _host(dpd.active_mask(shared))
        message.values.extend(int(v) & 0xFFFFFFFF
                              for v in _host(shared.values)[act])
        message.betas.extend(_host(shared.betas)[act].tolist())
        message.counts.extend(_host(shared.counts)[act].tolist())
    elif name == 'gp':
        message.alpha = float(shared.alpha)
        message.inv_beta = float(shared.inv_beta)
    elif name == 'nich':
        message.mu = float(shared.mu)
        message.kappa = float(shared.kappa)
        message.sigmasq = float(shared.sigmasq)
        message.nu = float(shared.nu)
    elif name == 'niw':
        message.mu.extend(_host(shared.mu).tolist())
        message.kappa = float(shared.kappa)
        message.psi.extend(_host(shared.psi).ravel().tolist())
        message.nu = float(shared.nu)
    else:
        raise KeyError(name)
    return message


def shared_load(name, message, cap=None):
    if name == 'bb':
        module, raw = bb, {'alpha': message.alpha, 'beta': message.beta}
    elif name == 'bnb':
        module, raw = bnb, {'alpha': message.alpha, 'beta': message.beta,
                            'r': message.r}
    elif name == 'dd':
        module, raw = dd, {'alphas': list(message.alphas)}
    elif name == 'dpd':
        raw = {
            'gamma': message.gamma, 'alpha': message.alpha,
            'betas': {_int32(v): b
                      for v, b in zip(message.values, message.betas)},
            'counts': {_int32(v): c
                       for v, c in zip(message.values, message.counts)},
        }
        return dpd.shared_from_dict(raw, cap or dpd.DEFAULT_CAPACITY)
    elif name == 'gp':
        module, raw = gp, {'alpha': message.alpha,
                           'inv_beta': message.inv_beta}
    elif name == 'nich':
        module, raw = nich, {'mu': message.mu, 'kappa': message.kappa,
                             'sigmasq': message.sigmasq, 'nu': message.nu}
    elif name == 'niw':
        d = len(message.mu)
        psi = np.asarray(list(message.psi), np.float32).reshape(d, d)
        module, raw = niw, {'mu': list(message.mu), 'kappa': message.kappa,
                            'psi': psi, 'nu': message.nu}
    else:
        raise KeyError(name)
    return module.shared_from_dict(raw)


# -- Group ------------------------------------------------------------------

def group_dump(name, group, message=None, shared=None):
    if message is None:
        message = MESSAGES[name].Group()
    message.Clear()
    if name == 'bb':
        message.heads = int(group.heads)
        message.tails = int(group.tails)
    elif name == 'bnb':
        message.count = int(group.count)
        message.sum = int(group.sum)
    elif name == 'dd':
        message.counts.extend(_host(group.counts).tolist())
    elif name == 'dpd':
        assert shared is not None, 'dpd group_dump needs shared'
        for v, c in zip(_host(shared.values), _host(group.counts)):
            if c != 0:
                message.keys.append(int(v) & 0xFFFFFFFF)
                message.values.append(int(c))
    elif name == 'gp':
        message.count = int(group.count)
        message.sum = int(group.sum)
        message.log_prod = float(group.log_prod)
    elif name == 'nich':
        message.count = int(group.count)
        message.mean = float(group.mean)
        message.count_times_variance = float(group.count_times_variance)
    elif name == 'niw':
        message.count = int(group.count)
        message.sum_x.extend(_host(group.sum_x).tolist())
        message.sum_xxT.extend(_host(group.sum_xxT).ravel().tolist())
    else:
        raise KeyError(name)
    return message


def group_load(name, message, shared=None):
    if name == 'bb':
        module, raw = bb, {'heads': message.heads, 'tails': message.tails}
    elif name == 'bnb':
        module, raw = bnb, {'count': message.count, 'sum': message.sum}
    elif name == 'gp':
        module, raw = gp, {'count': message.count, 'sum': message.sum,
                           'log_prod': message.log_prod}
    elif name == 'dd':
        module, raw = dd, {'counts': list(message.counts)}
    elif name == 'dpd':
        assert shared is not None, 'dpd group_load needs shared'
        raw = {'counts': {_int32(k): v
                          for k, v in zip(message.keys, message.values)}}
        return dpd.group_from_dict(raw, shared)
    elif name == 'nich':
        module, raw = nich, {
            'count': message.count, 'mean': message.mean,
            'count_times_variance': message.count_times_variance}
    elif name == 'niw':
        d = len(message.sum_x)
        sum_xxT = np.asarray(list(message.sum_xxT), np.float32).reshape(d, d)
        module, raw = niw, {'count': message.count,
                            'sum_x': list(message.sum_x), 'sum_xxT': sum_xxT}
    else:
        raise KeyError(name)
    return module.group_from_dict(raw)



# -- Clustering -------------------------------------------------------------

def clustering_dump(model, message=None):
    if message is None:
        message = Clustering()
    message.Clear()
    if isinstance(model, _clustering.PitmanYor):
        message.pitman_yor.alpha = float(model.alpha)
        message.pitman_yor.d = float(model.d)
    else:
        message.low_entropy.dataset_size = int(model.dataset_size)
    return message


def clustering_load(message):
    if message.HasField('pitman_yor'):
        return _clustering.PitmanYor.from_dict(
            {'alpha': message.pitman_yor.alpha, 'd': message.pitman_yor.d})
    return _clustering.LowEntropy.from_dict(
        {'dataset_size': message.low_entropy.dataset_size})
