"""Checkpoint and resume for mixture states
(distributions_tpu.io.checkpoint): the full inference state (counts, alive
mask, per-block suff stats, assignments, generator state, sweep index,
logger rows, hyperparameters) in one file.

The payload is a protobuf envelope, `MixtureCheckpoint` of the JAX
package's io/schema.proto, whose array contents ride npz byte blobs,
written through the length-prefixed stream container.  The envelope is
encoded and decoded by io/wire.py: the port imports neither
`google.protobuf` nor a generated `schema_pb2`.  The JAX package reads the
files written here and the reverse, all but the generator state: field 5
holds a `jax.random` key there and a packed `torch.Generator` state here,
and each package ignores (loads as None) a key of the other kind.

Resume contract: the envelope carries the generator state, the number of
completed sweeps and the SweepLogger rows, so that
`inference.runner.run_gibbs` continues at sweep t+1 with the identical
stream of sweep seeds and unbroken sweep numbering.
"""

import io as _io
import json
from typing import NamedTuple

import numpy as np
import torch

from distributions_tpu_torch import clustering as _cl, mixture as mx
from distributions_tpu_torch.io import wire
from distributions_tpu_torch.io.stream import (protobuf_stream_dump,
                                               protobuf_stream_load)


class MixtureCheckpoint(object):
    """The fields of schema.proto's MixtureCheckpoint.  Writers fill 3, 4,
    5, 7, 8, 9, 10; 1, 2 and 6 are the legacy per-element encoding and
    are only read."""

    def __init__(self):
        self.counts = []            # 1  repeated uint64 (legacy)
        self.alive = []             # 2  repeated bool (legacy)
        self.sample_size = None     # 3  uint64
        self.feature_blocks = []    # 4  repeated bytes, per-block npz
        self.rng_key = []           # 5  repeated uint32
        self.assignments = []       # 6  repeated int64 (legacy)
        self.arrays = None          # 7  bytes, npz: counts, alive[, assignments]
        self.sweep = None           # 8  uint64, completed sweeps
        self.logger_rows = None     # 9  bytes, json
        self.hypers = None          # 10 bytes, json

    def SerializeToString(self):
        out = bytearray()
        for v in self.counts:
            wire.put_varint_field(out, 1, v)
        for v in self.alive:
            wire.put_varint_field(out, 2, bool(v))
        if self.sample_size is not None:
            wire.put_varint_field(out, 3, self.sample_size)
        for blob in self.feature_blocks:
            wire.put_bytes_field(out, 4, blob)
        for v in self.rng_key:
            wire.put_varint_field(out, 5, v)
        for v in self.assignments:
            wire.put_varint_field(out, 6, v)
        if self.arrays is not None:
            wire.put_bytes_field(out, 7, self.arrays)
        if self.sweep is not None:
            wire.put_varint_field(out, 8, self.sweep)
        if self.logger_rows is not None:
            wire.put_bytes_field(out, 9, self.logger_rows)
        if self.hypers is not None:
            wire.put_bytes_field(out, 10, self.hypers)
        return bytes(out)

    @classmethod
    def FromString(cls, data):
        msg = cls()
        for number, kind, value in wire.fields(data):
            if number == 1:
                msg.counts += wire.repeated_varints(kind, value)
            elif number == 2:
                msg.alive += [bool(v)
                              for v in wire.repeated_varints(kind, value)]
            elif number == 3:
                msg.sample_size = value
            elif number == 4:
                msg.feature_blocks.append(value)
            elif number == 5:
                msg.rng_key += wire.repeated_varints(kind, value)
            elif number == 6:
                msg.assignments += [
                    wire.signed64(v)
                    for v in wire.repeated_varints(kind, value)]
            elif number == 7:
                msg.arrays = value
            elif number == 8:
                msg.sweep = value
            elif number == 9:
                msg.logger_rows = value
            elif number == 10:
                msg.hypers = value
        return msg


# -- the generator's state as the key ----------------------------------------

_KEY_MAGIC = 0x67656E31
_KEY_KINDS = ('cpu', 'cuda')


class SavedGenerator(NamedTuple):
    """A `torch.Generator` state as a checkpoint holds it."""
    kind: str             # the generator's device type, 'cpu' or 'cuda'
    state: torch.Tensor   # generator.get_state(), a uint8 tensor


def _generator_to_words(generator):
    """uint32 words [magic, device kind, byte count, state bytes packed
    little-endian four to a word]."""
    state = generator.get_state().cpu().numpy().tobytes()
    padded = state + b'\0' * (-len(state) % 4)
    words = np.frombuffer(padded, '<u4')
    return [_KEY_MAGIC, _KEY_KINDS.index(generator.device.type),
            len(state)] + [int(w) for w in words]


def _words_to_generator(words):
    """A SavedGenerator, or None for no key or a key of another kind (a
    `jax.random` key of the JAX package)."""
    if len(words) < 3 or words[0] != _KEY_MAGIC \
            or words[1] >= len(_KEY_KINDS):
        return None
    data = np.asarray(words[3:], '<u4').tobytes()[:words[2]]
    return SavedGenerator(
        _KEY_KINDS[words[1]],
        torch.from_numpy(np.frombuffer(data, np.uint8).copy()))


def restore_generator(generator, saved):
    """Set `generator` to a checkpoint's SavedGenerator.  A state saved
    from a generator of another device type raises ValueError: the two
    kinds of generator are different streams."""
    if saved.kind != generator.device.type:
        raise ValueError(
            'the checkpoint holds the state of a %s generator and cannot '
            'continue on a %s generator' % (saved.kind,
                                            generator.device.type))
    generator.set_state(saved.state)


# -- arrays -------------------------------------------------------------------

def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _pack_arrays(**arrays):
    buf = _io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _pack_tree(group):
    """A Group's leaves in field order, as arr_0, arr_1, ... of an npz."""
    buf = _io.BytesIO()
    np.savez(buf, *[_np(leaf) for leaf in group])
    return buf.getvalue()


def _unpack_tree(data, like):
    with np.load(_io.BytesIO(data)) as z:
        leaves = [torch.from_numpy(z['arr_%d' % i]).to(t.device)
                  for i, t in enumerate(like)]
    return type(like)(*leaves)


def _hypers_to_json(shareds, cl_model, spec):
    """json blob of the current shareds and clustering model, so that a
    resume restores resampled hyperparameters (the spec's block modules
    define the dict schemas)."""
    def default(o):
        return o.tolist() if hasattr(o, 'tolist') else float(o)

    dumped = []
    for block, shared in zip(spec.blocks, shareds):
        if hasattr(block.module, 'shared_to_state_dict'):
            # dpd: the form that keeps the slot order
            raw = block.module.shared_to_state_dict(shared)
            raw['__state_dict__'] = True
        else:
            raw = block.module.shared_to_dict(shared)
        dumped.append(raw)
    blob = {'shareds': dumped}
    if cl_model is not None:
        blob['cl_kind'] = ('py' if isinstance(cl_model, _cl.PitmanYor)
                           else 'le')
        blob['cl'] = cl_model.to_dict()
    return json.dumps(blob, default=default).encode()


def _hypers_from_json(data, spec, device=None):
    """(shareds tuple, cl_model or None) from the hypers blob."""
    blob = json.loads(data.decode())

    def intkeys(raw):
        # json turns dict keys into str; dpd's betas and counts are keyed
        # by value
        return {k: ({int(a): b for a, b in v.items()}
                    if isinstance(v, dict) else v)
                for k, v in raw.items()}

    shareds = []
    for block, raw in zip(spec.blocks, blob['shareds']):
        raw = intkeys(raw)
        if raw.pop('__state_dict__', False):
            shareds.append(block.module.shared_from_state_dict(
                raw, device=device))
        else:
            shareds.append(block.module.shared_from_dict(raw, device=device))
    cl_model = None
    if 'cl' in blob:
        cls = _cl.PitmanYor if blob['cl_kind'] == 'py' else _cl.LowEntropy
        cl_model = cls.from_dict(blob['cl'], device=device)
    return tuple(shareds), cl_model


# -- messages -----------------------------------------------------------------

def state_to_message(state, assignments=None, generator=None, sweep=None,
                     logger_rows=None, shareds=None, cl_model=None,
                     spec=None):
    msg = MixtureCheckpoint()
    arrays = {'counts': _np(state.counts), 'alive': _np(state.alive)}
    if assignments is not None:
        arrays['assignments'] = _np(assignments)
    msg.arrays = _pack_arrays(**arrays)
    msg.sample_size = int(state.sample_size)
    for group in state.groups:
        msg.feature_blocks.append(_pack_tree(group))
    if generator is not None:
        msg.rng_key = _generator_to_words(generator)
    if sweep is not None:
        msg.sweep = int(sweep)
    if logger_rows is not None:
        msg.logger_rows = json.dumps(logger_rows).encode()
    if shareds is not None:
        if spec is None:
            raise ValueError('saving the shareds needs the spec')
        msg.hypers = _hypers_to_json(shareds, cl_model, spec)
    return msg


def message_to_state(msg, spec, shareds):
    """(state, assignments or None, SavedGenerator or None), the tensors
    on the shareds' device."""
    template = mx.init(spec, shareds)
    dev = template.counts.device
    if msg.arrays:
        with np.load(_io.BytesIO(msg.arrays)) as z:
            counts = z['counts']
            alive = z['alive']
            assignments = z['assignments'] if 'assignments' in z.files \
                else None
    else:  # legacy per-element encoding (fields 1, 2, 6)
        counts = np.asarray(msg.counts, np.int64)
        alive = np.asarray(msg.alive, bool)
        assignments = np.asarray(msg.assignments, np.int64) \
            if msg.assignments else None

    def tensor(a, dtype):
        return torch.from_numpy(np.asarray(a).astype(dtype)).to(dev)
    groups = tuple(_unpack_tree(data, like)
                   for data, like in zip(msg.feature_blocks, template.groups))
    state = mx.MixtureState(
        counts=tensor(counts, np.int32), alive=tensor(alive, bool),
        sample_size=torch.tensor(int(msg.sample_size or 0),
                                 dtype=torch.int32, device=dev),
        groups=groups)
    if assignments is not None:
        assignments = tensor(assignments, np.int32)
    return state, assignments, _words_to_generator(msg.rng_key)


def save(filename, state, assignments=None, generator=None, sweep=None,
         logger_rows=None, shareds=None, cl_model=None, spec=None):
    msg = state_to_message(state, assignments, generator, sweep=sweep,
                           logger_rows=logger_rows, shareds=shareds,
                           cl_model=cl_model, spec=spec)
    protobuf_stream_dump([msg.SerializeToString()], filename)


def _load_message(filename):
    stream = protobuf_stream_load(filename)
    try:
        data = next(stream)
    finally:
        stream.close()
    return MixtureCheckpoint.FromString(data)


def load(filename, spec, shareds):
    """(state, assignments, SavedGenerator or None)."""
    return message_to_state(_load_message(filename), spec, shareds)


def load_extended(filename, spec, shareds):
    """(state, assignments, SavedGenerator or None, sweep, logger_rows):
    sweep is the number of completed sweeps (0 for a legacy checkpoint),
    logger_rows a list of dicts ([] for a legacy one)."""
    msg = _load_message(filename)
    state, assignments, saved = message_to_state(msg, spec, shareds)
    rows = json.loads(msg.logger_rows.decode()) if msg.logger_rows else []
    return state, assignments, saved, int(msg.sweep or 0), rows


def load_hypers(filename, spec, device=None):
    """(shareds tuple or None, cl_model or None): the hyperparameters the
    checkpoint was written with; (None, None) when it holds none."""
    msg = _load_message(filename)
    if not msg.hypers:
        return None, None
    return _hypers_from_json(msg.hypers, spec, device=device)
