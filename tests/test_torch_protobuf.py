"""The port's protobuf codec (`distributions_tpu_torch.io.protobuf`, hand-
written messages over `io/wire.py`) against the JAX package's, which
serializes with the protoc-generated `schema_pb2`: for every EXAMPLES entry
of the seven models and for both clustering priors the same object gives
byte-equal messages, and the JAX bytes load into the port equal to JAX's
own loads (leaf by leaf, exactly: float fields cross as float32).  Also:
packed repeated fields parse, zero-valued scalars keep their presence, and
dpd's negative values survive the uint32 crossing."""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributions_tpu import clustering as jcl
from distributions_tpu.io import protobuf as jpb, schema_pb2
from distributions_tpu.models import MODULES as JM
from distributions_tpu_torch import clustering as tcl, config
from distributions_tpu_torch.io import protobuf as tpb, wire
from distributions_tpu_torch.models import MODULES as TM

torch.set_num_threads(1)
config.set_default_device('cpu')

CASES = [(name, i) for name in sorted(TM) for i in range(len(TM[name]
                                                              .EXAMPLES))]
cases = pytest.mark.parametrize('name,idx', CASES,
                                ids=['%s-%d' % c for c in CASES])


def _port_objects(name, idx):
    """The port's Shared (dpd observing the example's values) and the
    group of the example's values."""
    tm = TM[name]
    ex = tm.EXAMPLES[idx]
    shared = tm.shared_from_dict(ex['shared'])
    if name == 'dpd':
        gen = torch.Generator().manual_seed(idx)
        for v in ex['values']:
            shared = tm.shared_add_value(gen, shared, v)
    group = tm.group_init(shared)
    for v in ex['values']:
        group = tm.add_value(shared, group, v)
    return shared, group


def _to_jax(container, jax_cls):
    assert jax_cls._fields == type(container)._fields
    return jax_cls(*(jnp.asarray(x.numpy()) for x in container))


def _leaves_equal(got, want):
    assert type(got)._fields == type(want)._fields
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.device.type == 'cpu'
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


@cases
def test_messages_are_byte_equal_to_schema_pb2(name, idx):
    tshared, tgroup = _port_objects(name, idx)
    jshared = _to_jax(tshared, JM[name].Shared)
    jgroup = _to_jax(tgroup, JM[name].Group)
    tmsg = tpb.shared_dump(name, tshared)
    jmsg = jpb.shared_dump(name, jshared)
    assert tmsg.SerializeToString() == jmsg.SerializeToString()
    tmsg = tpb.group_dump(name, tgroup, shared=tshared)
    jmsg = jpb.group_dump(name, jgroup, shared=jshared)
    assert tmsg.SerializeToString() == jmsg.SerializeToString()


@cases
def test_jax_bytes_load_equal_to_jax_loads(name, idx):
    tshared, tgroup = _port_objects(name, idx)
    jshared = _to_jax(tshared, JM[name].Shared)
    jgroup = _to_jax(tgroup, JM[name].Group)
    data = jpb.shared_dump(name, jshared).SerializeToString()
    kwargs = {'cap': 16} if name == 'dpd' else {}
    want = jpb.shared_load(name, jpb.MESSAGES[name].Shared.FromString(data),
                           **kwargs)
    got = tpb.shared_load(name, tpb.MESSAGES[name].Shared.FromString(data),
                          **kwargs)
    _leaves_equal(got, want)
    data = jpb.group_dump(name, jgroup, shared=jshared).SerializeToString()
    msg = tpb.MESSAGES[name].Group()
    assert msg.ParseFromString(data) == len(data)
    want = jpb.group_load(name, jpb.MESSAGES[name].Group.FromString(data),
                          shared=jshared)
    _leaves_equal(tpb.group_load(name, msg, shared=tshared), want)


@pytest.mark.parametrize('kind', ['pitman_yor', 'low_entropy'])
def test_clustering_messages_match(kind):
    if kind == 'pitman_yor':
        raws, tcls, jcls = (tcl.PitmanYor.EXAMPLES, tcl.PitmanYor,
                            jcl.PitmanYor)
    else:
        raws, tcls, jcls = (tcl.LowEntropy.EXAMPLES, tcl.LowEntropy,
                            jcl.LowEntropy)
    for raw in raws:
        data = tpb.clustering_dump(tcls.from_dict(raw)).SerializeToString()
        assert data == jpb.clustering_dump(
            jcls.from_dict(raw)).SerializeToString()
        msg = tpb.Clustering.FromString(data)
        assert msg.HasField(kind)
        assert not msg.HasField({'pitman_yor': 'low_entropy',
                                 'low_entropy': 'pitman_yor'}[kind])
        got = tpb.clustering_load(msg)
        want = jpb.clustering_load(schema_pb2.Clustering.FromString(data))
        assert type(got).__name__ == type(want).__name__
        assert got.to_dict() == want.to_dict()


def test_packed_repeated_fields_parse():
    """A packed encoding of every repeated field (built here with
    `io/wire.py`) parses as the unpacked one, in the port and in
    schema_pb2."""
    dd_shared = bytearray()
    wire.put_bytes_field(dd_shared, 1, struct.pack('<3f', 0.5, 1.0, 2.5))
    dd_group = bytearray()
    packed = bytearray()
    for c in (3, 0, 300):
        wire.put_varint(packed, c)
    wire.put_bytes_field(dd_group, 1, bytes(packed))
    dpd_group = bytearray()
    keys, vals = bytearray(), bytearray()
    for k, v in ((0xFFFFFFFD, 2), (7, 5)):
        wire.put_varint(keys, k)
        wire.put_varint(vals, v)
    wire.put_bytes_field(dpd_group, 1, bytes(keys))
    wire.put_bytes_field(dpd_group, 2, bytes(vals))
    for cls, jcls, data, field in [
            (tpb.DirichletDiscrete.Shared, schema_pb2.DirichletDiscrete.Shared,
             dd_shared, 'alphas'),
            (tpb.DirichletDiscrete.Group, schema_pb2.DirichletDiscrete.Group,
             dd_group, 'counts'),
            (tpb.DirichletProcessDiscrete.Group,
             schema_pb2.DirichletProcessDiscrete.Group, dpd_group, 'keys')]:
        got = cls.FromString(bytes(data))
        want = jcls.FromString(bytes(data))
        assert list(getattr(got, field)) == list(getattr(want, field))
        assert got.SerializeToString() == want.SerializeToString()
    group = tpb.DirichletProcessDiscrete.Group.FromString(bytes(dpd_group))
    assert list(group.values) == [2, 5]


def test_zero_scalars_keep_presence():
    """proto2 presence: a zero that was set is written and read back as
    set; one never set is neither."""
    raw = {'mu': 0.0, 'kappa': 1.0, 'sigmasq': 1.0, 'nu': 0.0}
    msg = tpb.shared_dump('nich', TM['nich'].shared_from_dict(raw))
    data = msg.SerializeToString()
    assert data == jpb.shared_dump(
        'nich', JM['nich'].shared_from_dict(raw)).SerializeToString()
    back = tpb.NormalInverseChiSq.Shared.FromString(data)
    assert back.HasField('mu') and back.mu == 0.0 and back.nu == 0.0
    empty = tpb.BetaBernoulli.Group()
    assert not empty.HasField('heads') and empty.SerializeToString() == b''
    group = tpb.group_dump('bb', TM['bb'].group_init(
        TM['bb'].shared_from_dict({'alpha': 1.0, 'beta': 1.0})))
    assert group.SerializeToString() == b'\x08\x00\x10\x00'
    np.testing.assert_array_equal(
        tpb.group_load('bb', group).heads.numpy(), 0)
    assert tpb.clustering_load(tpb.clustering_dump(
        tcl.LowEntropy.from_dict({'dataset_size': 0}))).to_dict() == {
            'dataset_size': 0}


def test_dpd_negative_values_cross_as_uint32():
    raw = {'gamma': 0.5, 'alpha': 2.0, 'betas': {-3: 0.25, 9: 0.5},
           'counts': {-3: 2, 9: 1}}
    tshared = TM['dpd'].shared_from_dict(raw, cap=8)
    tgroup = TM['dpd'].group_from_dict({'counts': {-3: 4, 9: 1}}, tshared)
    jshared = JM['dpd'].shared_from_dict(raw, cap=8)
    for dump, args in [(tpb.shared_dump, (tshared,)),
                       (tpb.group_dump, (tgroup, None, tshared))]:
        msg = dump('dpd', *args)
        field = msg.values if dump is tpb.shared_dump else msg.keys
        assert 0xFFFFFFFD in list(field)
    data = tpb.shared_dump('dpd', tshared).SerializeToString()
    assert data == jpb.shared_dump('dpd', jshared).SerializeToString()
    back = tpb.shared_load('dpd', tpb.DirichletProcessDiscrete.Shared
                           .FromString(data), cap=8)
    assert TM['dpd'].shared_to_dict(back) == TM['dpd'].shared_to_dict(
        tshared)
    gdata = tpb.group_dump('dpd', tgroup, shared=tshared).SerializeToString()
    gback = tpb.group_load('dpd', tpb.DirichletProcessDiscrete.Group
                           .FromString(gdata), shared=back)
    assert TM['dpd'].group_to_dict(gback, back) == {'counts': {-3: 4, 9: 1}}


def test_fields_check_their_values():
    msg = tpb.BetaBernoulli.Group()
    with pytest.raises(ValueError):
        msg.heads = -1
    with pytest.raises(AttributeError):
        msg.alpha = 1.0
    shared = tpb.DirichletDiscrete.Shared()
    with pytest.raises(AttributeError):
        shared.alphas = [1.0]
    shared.alphas.append(0.1)
    assert shared.alphas == [np.float32(0.1).item()]
    with pytest.raises(ValueError):
        tpb.DirichletProcessDiscrete.Group().keys.append(1 << 32)
