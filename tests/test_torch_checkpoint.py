"""The port's io/stream.py, io/wire.py and io/checkpoint.py against the JAX
package's: the same bytes on disk for the stream containers, and a
`MixtureCheckpoint` envelope that either package reads from the other
(all but the generator state, which is a `jax.random` key there and a
`torch.Generator` state here)."""

import functools
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributions_tpu import clustering as jcl, mixture as jmx
from distributions_tpu.io import checkpoint as jckpt, schema_pb2
from distributions_tpu.io import stream as jstream
from distributions_tpu_torch import clustering as tcl, config, convert
from distributions_tpu_torch import diagnostics, mixture as tmx, testing
from distributions_tpu_torch.io import checkpoint as tckpt
from distributions_tpu_torch.io import stream as tstream, wire
from distributions_tpu_torch.models import MODULES

torch.set_num_threads(1)
config.set_default_device('cpu')

KINDS = ('nich_gp_bb', 'dd_bb', 'niw3_nich_bb', 'dpd_nich', 'bnb')
ROWS = [{'sweep': 0, 'time': 1.5, 'score_data': -12.25, 'sample_size': 64},
        {'sweep': 1, 'time': 2.5, 'score_data': -11.0, 'sample_size': 64}]


@functools.lru_cache(maxsize=None)
def _problem(kind):
    """A 64-row state of `kind` in both packages (all seven models over
    KINDS)."""
    jmodels = {name: importlib.import_module('distributions_tpu.models.'
                                             + name) for name in MODULES}
    p = testing.mixed_problem(64, 16, seed=5, kind=kind)
    jspec, jpy, jsh = testing.build_problem(p, jmodels, jmx.make_spec,
                                            jcl.PitmanYor.from_dict)
    jst = jmx.state_from_assignments(
        jspec, jpy, jsh, tuple(jnp.asarray(v) for v in p['values']),
        jnp.asarray(p['labels']))
    spec, py, sh = testing.build_problem(p, MODULES, tmx.make_spec,
                                         tcl.PitmanYor.from_dict)
    st = tmx.state_from_assignments(
        spec, py, sh, tuple(torch.from_numpy(v) for v in p['values']),
        torch.from_numpy(p['labels']))
    return dict(p=p, jspec=jspec, jpy=jpy, jsh=jsh, jst=jst, spec=spec, py=py,
                sh=sh, st=st)


def _leaves(obj):
    return jax.tree_util.tree_leaves(
        convert.to_numpy(obj) if not isinstance(obj, jmx.MixtureState)
        else jax.tree_util.tree_map(np.asarray, obj))


def _states_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# -- io/wire.py ---------------------------------------------------------------

def test_wire_varints_and_fields():
    out = bytearray()
    values = [0, 1, 127, 128, 300, 2 ** 32 - 1, 2 ** 63, 2 ** 64 - 1]
    for v in values:
        wire.put_varint(out, v)
    pos, got = 0, []
    while pos < len(out):
        v, pos = wire.get_varint(out, pos)
        got.append(v)
    assert got == values
    msg = bytearray()
    wire.put_varint_field(msg, 6, -3)          # int64: two's complement
    wire.put_bytes_field(msg, 4, b'abc')
    wire.put_bytes_field(msg, 5, bytes(out[:5]))      # a packed repeated
    fields = list(wire.fields(bytes(msg)))
    assert [(n, k) for n, k, _ in fields] == [(6, 0), (4, 2), (5, 2)]
    assert wire.signed64(fields[0][2]) == -3
    assert fields[1][2] == b'abc'
    assert wire.repeated_varints(*fields[2][1:]) == [0, 1, 127, 128]
    assert wire.repeated_varints(0, 9) == [9]
    with pytest.raises(ValueError):
        list(wire.fields(b'\x22\x05ab'))       # truncated bytes field
    with pytest.raises(ValueError):
        wire.get_varint(b'\x80', 0)


# -- io/checkpoint.py ---------------------------------------------------------

@pytest.mark.parametrize('kind', KINDS)
def test_checkpoint_round_trip(kind, tmp_path):
    """save -> load_extended gives back every leaf exactly, the
    assignments, the sweep index, the logger rows and the generator's
    state; load_hypers gives back the shareds and the clustering model."""
    q = _problem(kind)
    path = str(tmp_path / 'state.ckpt')
    gen = torch.Generator().manual_seed(17)
    torch.rand(3, generator=gen)
    a = torch.from_numpy(q['p']['labels'])
    tckpt.save(path, q['st'], assignments=a, generator=gen, sweep=7,
               logger_rows=ROWS, shareds=q['sh'], cl_model=q['py'],
               spec=q['spec'])
    want_next = torch.rand(4, generator=gen)
    st, an, saved, sweep, rows = tckpt.load_extended(path, q['spec'],
                                                     q['sh'])
    _states_equal(st, q['st'])
    assert torch.equal(an, a) and an.dtype == torch.int32
    assert sweep == 7 and rows == ROWS
    other = torch.Generator().manual_seed(999)
    tckpt.restore_generator(other, saved)
    assert torch.equal(torch.rand(4, generator=other), want_next)
    st3, an3, saved3 = tckpt.load(path, q['spec'], q['sh'])
    _states_equal(st3, q['st'])
    assert torch.equal(saved3.state, saved.state) and saved3.kind == 'cpu'
    sh, py = tckpt.load_hypers(path, q['spec'])
    for got, want in zip(_leaves(sh), _leaves(q['sh'])):
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert py.to_dict() == q['py'].to_dict()


def test_restore_generator_rejects_another_kind():
    saved = tckpt.SavedGenerator('cuda', torch.zeros(16, dtype=torch.uint8))
    with pytest.raises(ValueError, match='cuda generator'):
        tckpt.restore_generator(torch.Generator(), saved)


@pytest.mark.parametrize('kind', KINDS)
def test_wire_parity_port_bytes_parse_as_schema_pb2(kind):
    """The port's bytes parsed by the JAX package's generated schema_pb2:
    every written field (3, 4, 5, 7, 8, 9, 10) reads back, and re-encoding
    there and decoding here gives the same message."""
    q = _problem(kind)
    gen = torch.Generator().manual_seed(1)
    msg = tckpt.state_to_message(
        q['st'], torch.from_numpy(q['p']['labels']), gen, sweep=3,
        logger_rows=ROWS, shareds=q['sh'], cl_model=q['py'], spec=q['spec'])
    data = msg.SerializeToString()
    ref = schema_pb2.MixtureCheckpoint.FromString(data)
    assert ref.sample_size == 64 and ref.sweep == 3
    assert list(ref.feature_blocks) == msg.feature_blocks
    assert list(ref.rng_key) == msg.rng_key and len(msg.rng_key) > 3
    assert ref.arrays == msg.arrays
    assert json.loads(ref.logger_rows) == ROWS
    assert ref.hypers == msg.hypers
    assert not ref.counts and not ref.alive and not ref.assignments
    back = tckpt.MixtureCheckpoint.FromString(ref.SerializeToString())
    assert vars(back) == vars(msg)
    # canonical encoding: fields in number order, so the bytes agree too
    assert ref.SerializeToString() == data


@pytest.mark.parametrize('kind', KINDS)
def test_checkpoints_cross_load(kind, tmp_path):
    """A checkpoint written by the JAX package loads in the port and the
    reverse: state (the npz leaves of each Group are in the field order
    both packages share), assignments, sweep, logger rows and hypers; not
    the key, which each package reads as None from the other."""
    q = _problem(kind)
    labels = q['p']['labels']
    ref_path = str(tmp_path / 'ref.ckpt')
    jckpt.save(ref_path, q['jst'], assignments=jnp.asarray(labels),
               key=jax.random.PRNGKey(3), sweep=4, logger_rows=ROWS,
               shareds=q['jsh'], cl_model=q['jpy'], spec=q['jspec'])
    st, an, saved, sweep, rows = tckpt.load_extended(ref_path, q['spec'],
                                                     q['sh'])
    _states_equal(st, q['jst'])
    np.testing.assert_array_equal(an.numpy(), labels)
    assert saved is None and sweep == 4 and rows == ROWS
    sh, py = tckpt.load_hypers(ref_path, q['spec'])
    for got, want in zip(_leaves(sh), _leaves(q['sh'])):
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert py.to_dict() == q['py'].to_dict()

    port_path = str(tmp_path / 'port.ckpt')
    tckpt.save(port_path, q['st'], assignments=torch.from_numpy(labels),
               sweep=4, logger_rows=ROWS, shareds=q['sh'], cl_model=q['py'],
               spec=q['spec'])
    jst, jan, jkey, jsweep, jrows = jckpt.load_extended(
        port_path, q['jspec'], q['jsh'])
    _states_equal(q['st'], jst)
    np.testing.assert_array_equal(np.asarray(jan), labels)
    assert jkey is None and jsweep == 4 and jrows == ROWS
    jsh, jpy = jckpt.load_hypers(port_path, q['jspec'])
    for got, want in zip(jax.tree_util.tree_leaves(jsh),
                         jax.tree_util.tree_leaves(q['jsh'])):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-6)
    assert jpy.to_dict() == q['jpy'].to_dict()


def test_legacy_fields_are_read(tmp_path):
    """Fields 1, 2 and 6 (per-element counts, alive, assignments), packed
    or not, load when the npz `arrays` payload is absent."""
    q = _problem('nich_gp_bb')
    labels = q['p']['labels']
    ref = schema_pb2.MixtureCheckpoint()
    ref.counts.extend(int(c) for c in q['st'].counts)
    ref.alive.extend(bool(a) for a in q['st'].alive)
    ref.assignments.extend(int(a) for a in labels)
    ref.sample_size = 64
    for group in q['st'].groups:
        ref.feature_blocks.append(tckpt._pack_tree(group))
    path = str(tmp_path / 'legacy.ckpt')
    tstream.protobuf_stream_dump([ref.SerializeToString()], path)
    st, an, saved, sweep, rows = tckpt.load_extended(path, q['spec'],
                                                     q['sh'])
    _states_equal(st, q['st'])
    np.testing.assert_array_equal(an.numpy(), labels)
    assert saved is None and sweep == 0 and rows == []
    assert tckpt.load_hypers(path, q['spec']) == (None, None)
    # a packed encoding of the same repeated fields, and a negative int64
    packed = bytearray()
    body = bytearray()
    for c in (3, 0, 500):
        wire.put_varint(body, c)
    wire.put_bytes_field(packed, 1, bytes(body))
    wire.put_varint_field(packed, 6, -1)
    msg = tckpt.MixtureCheckpoint.FromString(bytes(packed))
    assert msg.counts == [3, 0, 500] and msg.assignments == [-1]


def test_checkpoint_hypers_dpd_roundtrip(tmp_path):
    """dpd's value-keyed betas/counts dicts survive the json hypers blob
    in slot order (tests/test_runner.py's test of the same name)."""
    from distributions_tpu_torch.models import dpd
    spec = tmx.make_spec([(dpd, 1)], capacity=16, empties=1)
    shared = dpd.shared_from_dict(
        {'gamma': 0.5, 'alpha': 0.5,
         'betas': {2: 0.25, 10: 0.5, 1: 0.25},
         'counts': {2: 1, 10: 2, 1: 4}}, cap=16)
    state = tmx.init(spec, (shared,))
    path = str(tmp_path / 'dpd.ckpt')
    tckpt.save(path, state, spec=spec, shareds=(shared,))
    loaded, cl = tckpt.load_hypers(path, spec)
    assert cl is None
    assert dpd.shared_to_dict(loaded[0]) == dpd.shared_to_dict(shared)
    assert torch.equal(loaded[0].values, shared.values)
    assert float(loaded[0].beta0) == float(shared.beta0)
    # the state dict is the JAX package's, key for key
    from distributions_tpu.models import dpd as jdpd
    jshared = jdpd.shared_from_dict(
        {'gamma': 0.5, 'alpha': 0.5,
         'betas': {2: 0.25, 10: 0.5, 1: 0.25},
         'counts': {2: 1, 10: 2, 1: 4}}, cap=16)
    assert dpd.shared_to_state_dict(shared) \
        == jdpd.shared_to_state_dict(jshared)
    with pytest.raises(ValueError, match='needs the spec'):
        tckpt.save(path, state, shareds=(shared,))


# -- io/stream.py and SweepLogger.save ----------------------------------------

@pytest.mark.parametrize('ext', ['', '.gz', '.bz2'])
def test_stream_containers_match_the_jax_package(ext, tmp_path):
    items = [{'a': 1, 'b': [1.5, None]}, 'text', [1, 2, 3]]
    blobs = [b'', b'\x00\x01\x02', b'x' * 1000]
    ours, theirs = (str(tmp_path / (n + '.json' + ext))
                    for n in ('ours', 'theirs'))
    tstream.json_stream_dump(items, ours)
    jstream.json_stream_dump(items, theirs)
    assert list(tstream.json_stream_load(theirs)) == items
    assert list(jstream.json_stream_load(ours)) == items
    with tstream.open_compressed(ours, 'rb') as f, \
            jstream.open_compressed(theirs, 'rb') as g:
        assert f.read() == g.read()
    ours, theirs = (str(tmp_path / (n + '.pbs' + ext))
                    for n in ('ours', 'theirs'))
    tstream.protobuf_stream_dump(blobs, ours)
    jstream.protobuf_stream_dump(blobs, theirs)
    assert list(tstream.protobuf_stream_load(theirs)) == blobs
    assert list(jstream.protobuf_stream_load(ours)) == blobs
    tstream.json_dump({'k': items}, str(tmp_path / ('d.json' + ext)))
    assert tstream.json_load(str(tmp_path / ('d.json' + ext))) == {'k': items}


def test_sweep_logger_save_and_costream(tmp_path):
    log = diagnostics.SweepLogger()
    log.log(0, score_data=-1.0)
    log.log(1, score_data=-0.5)
    path = str(tmp_path / 'sub' / 'log.json.gz')
    log.save(path)
    assert list(jstream.json_stream_load(path)) == log.rows
    with pytest.raises(IOError):
        tstream.json_dump([1], str(tmp_path / 'plain.json'))
        tstream.json_stream_load(str(tmp_path / 'plain.json'))
    co = tstream.json_costream_dump(str(tmp_path / 'co.json'))
    next(co)
    co.send({'a': 1})
    co.send({'b': 2})
    co.close()
    assert list(tstream.json_stream_load(str(tmp_path / 'co.json'))) \
        == [{'a': 1}, {'b': 2}]
