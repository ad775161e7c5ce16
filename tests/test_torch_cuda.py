"""The CUDA kernels K1, K2, K3, K4 and K5 against their plain twins, the
sharded sweeps on in-process meshes, and the runner's bitwise resume, on
the card.
Every test here needs an NVIDIA GPU and skips without one.  On a machine
with a GPU and no JAX, run them with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(`-k pair` picks the tests of K3, `-k bench` those of B1-B5, `-k
stat_stage` those of the stat stage of K1 and K2, `-k fused`
the edge tests of the slot-split walk of K1, B5, K2 and K3, `-k v1_split`
those of its v1 form in K4 and K5, `-k on_the_card` the samplers, the
LowEntropy prior and the other moves, `-k "graph or seed_pointer"` the
sweeps replayed from CUDA graphs: fused single-device, row-sharded, 2-D
and on a NCCL group of one rank, the v1 sweeps, the plain sweep and the
chains, the runner on each path; and K1-K5 reading their seed from device
memory.)
"""

import numpy as np
import pytest
import torch

from distributions_tpu_torch import clustering as cl, diagnostics
from distributions_tpu_torch import mixture as mx, testing
from distributions_tpu_torch.models import MODULES, nich
from distributions_tpu_torch.ops import bench_kernels as bk
from distributions_tpu_torch.ops import fused_kernels as fk, gibbs

torch.set_num_threads(1)

pytestmark = pytest.mark.requires_cuda

# stat sums: f32 sums of the same rows in another order
SUM_RTOL, SUM_ATOL = 1e-5, 1e-3


@pytest.fixture(scope='module')
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda', 0)


def _inputs(dev, B, C, seed=0):
    values, labels = testing.nich_problem(B, seed=seed,
                                          n_clusters=min(C - 4, 40))
    spec = mx.make_spec([(nich, 2)], capacity=C)
    sh = (nich.shared_from_dict(testing.NICH_SHARED, device=dev),)
    py = cl.PitmanYor.from_dict(testing.PY, device=dev)
    v = torch.from_numpy(values).to(dev)
    st = mx.state_from_assignments(spec, py, sh, (v,),
                                   torch.from_numpy(labels).to(dev))
    cls = cl.score_value(py, st.counts, st.alive, st.sample_size)
    co = fk.nich_coeffs_v2(sh[0], st.groups[0]).contiguous()
    return v, cls, co


@pytest.mark.parametrize('B,C', [(4096, 128), (3000, 1000), (257, 2500)])
@pytest.mark.parametrize('sampling', ['argmax', 'argmax_fast', 'gumbel_host',
                                      'cdf_host'])
def test_kernel_matches_twin(dev, B, C, sampling):
    v, cls, co = _inputs(dev, B, C)
    g = torch.Generator(device=dev).manual_seed(1)
    noise = None
    if sampling == 'gumbel_host':
        noise = -torch.log(-torch.log(
            torch.rand((B, C), generator=g, device=dev).clamp_min(1e-30)))
    elif sampling == 'cdf_host':
        noise = torch.rand((B, 1), generator=g, device=dev)
    before = fk.fused_score_sample_stats.launches
    a, s = fk.fused_score_sample_stats(0, v, cls, co, (2,),
                                       sampling=sampling, noise=noise)
    assert fk.fused_score_sample_stats.launches == before + 1
    a2, s2 = fk.fused_score_sample_stats_plain(0, v, cls, co, (2,),
                                               sampling=sampling, noise=noise)
    # the kernel repeats the twin's f32 operations in the same order
    assert torch.equal(a, a2)
    torch.testing.assert_close(s, s2, rtol=SUM_RTOL, atol=SUM_ATOL)


@pytest.mark.parametrize('sampling', ['gumbel', 'cdf', 'gumbel_fast'])
def test_kernel_rng_modes(dev, sampling):
    B, C = 8192, 128
    v, cls, co = _inputs(dev, B, C)
    a, s = fk.fused_score_sample_stats(5, v, cls, co, (2,), sampling=sampling)
    a2, s2 = fk.fused_score_sample_stats(5, v, cls, co, (2,),
                                         sampling=sampling)
    assert torch.equal(a, a2) and torch.equal(s, s2)
    scores = fk._score_nich_product(v, co, cls, (2,), torch.log)
    assert testing.softmax_ztest(a, scores) < 5.0


def test_wrapper_rejects_bad_inputs(dev):
    v, cls, co = _inputs(dev, 512, 128)
    with pytest.raises(TypeError):
        fk.fused_score_sample_stats(0, v.double(), cls, co, (2,),
                                    sampling='argmax')
    with pytest.raises(ValueError):
        fk.fused_score_sample_stats(0, v.t().contiguous().t(), cls, co, (2,),
                                    sampling='argmax')
    with pytest.raises(ValueError):
        fk.fused_score_sample_stats(0, v, cls, co[:-1], (2,),
                                    sampling='argmax')
    with pytest.raises(TypeError):
        fk.fused_score_sample_stats(0, v, cls, co, (2,),
                                    sampling='gumbel_host')
    with pytest.raises(ValueError):
        fk.fused_score_sample_stats(0, v, cls.cpu(), co, (2,),
                                    sampling='argmax')


# -- K2 ---------------------------------------------------------------------

def _mixed_inputs(dev, kind, B, C):
    p = testing.mixed_problem(B, C, seed=2, kind=kind,
                              n_clusters=min(C - 4, 40))
    spec, py, sh = testing.build_problem(p, MODULES, mx.make_spec,
                                         cl.PitmanYor.from_dict, device=dev)
    tv = tuple(torch.from_numpy(v).to(dev) for v in p['values'])
    st = mx.state_from_assignments(spec, py, sh, tv,
                                   torch.from_numpy(p['labels']).to(dev))
    lay = gibbs._mixed_static_layout(spec, tv)
    coeffs, qcoeffs, tables = gibbs._build_fused_inputs(spec, lay, sh, st)
    cls = cl.score_value(py, st.counts, st.alive, st.sample_size)
    args = (lay.nich_vals, lay.table_idx, cls, coeffs, tables,
            tuple(spec.blocks[i].cols for i in lay.nich_blocks))
    kwargs = dict(qvalues=lay.quad_vals, qcoeffs=qcoeffs,
                  quad_groups=lay.quad_groups, table_vs=lay.table_vs)
    return args, kwargs, (spec, py, sh, st, tv)


def _noise(dev, sampling, B, C):
    g = torch.Generator(device=dev).manual_seed(1)
    if sampling == 'gumbel_host':
        return -torch.log(-torch.log(
            torch.rand((B, C), generator=g, device=dev).clamp_min(1e-30)))
    if sampling == 'cdf_host':
        return torch.rand((B, 1), generator=g, device=dev)
    return None


@pytest.mark.parametrize('kind,B,C', [
    ('nich_gp_bb', 4096, 128), ('dd_bb', 3000, 1000), ('niw2', 4096, 128),
    ('niw3_nich_bb', 3000, 1000), ('niw4', 257, 1200), ('dpd_nich', 1024, 128),
    ('bnb', 1024, 128), ('niw2mix', 4096, 1024), ('bbddgp', 4096, 1024),
    # one table column (the folded shape); ragged: B no multiple of the
    # thread block's rows, C % 4 != 0, C below the 8 slices
    ('bb', 4096, 1024), ('dd', 4096, 128), ('bb', 3001, 1027),
    ('dd', 257, 6),
    # niw columns past d = 4: one column of d = 16 (the niw16 shape) and
    # the wide shape of d <= 16
    ('niw5', 3001, 1027), ('niw8', 4096, 128), ('niw13', 257, 1200),
    ('niw16', 4096, 1024), ('niw16', 3001, 1027), ('niw16_nich', 2048, 256)])
@pytest.mark.parametrize('sampling', ['argmax', 'argmax_fast', 'gumbel_host',
                                      'cdf_host'])
def test_k2_matches_twin(dev, kind, B, C, sampling):
    args, kwargs, _ = _mixed_inputs(dev, kind, B, C)
    noise = _noise(dev, sampling, B, C)
    before = fk.fused_mixed_score_sample_stats.launches
    got = fk.fused_mixed_score_sample_stats(0, *args, sampling=sampling,
                                            noise=noise, **kwargs)
    torch.cuda.synchronize()
    assert fk.fused_mixed_score_sample_stats.launches == before + 1
    tables = args[4]
    if tables is not None:
        args = args[:4] + (torch.clamp(tables, min=-1e30),) + args[5:]
    want = fk.fused_mixed_score_sample_stats_plain(
        0, *args, sampling=sampling, noise=noise, **kwargs)
    # the kernel repeats the twin's f32 operations in the same order
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=SUM_RTOL, atol=SUM_ATOL)
    # count tables are integers: exactly equal
    assert torch.equal(got[2], want[2])
    torch.testing.assert_close(got[3], want[3], rtol=SUM_RTOL, atol=SUM_ATOL)


@pytest.mark.parametrize('sampling', ['gumbel', 'cdf', 'gumbel_fast'])
def test_k2_rng_modes(dev, sampling):
    B, C = 8192, 128
    args, kwargs, (spec, py, sh, st, tv) = _mixed_inputs(dev, 'niw2mix', B, C)
    a = fk.fused_mixed_score_sample_stats(5, *args, sampling=sampling,
                                          **kwargs)
    b = fk.fused_mixed_score_sample_stats(5, *args, sampling=sampling,
                                          **kwargs)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    scores = mx.score_batch(spec, py, sh, st, tv)
    assert testing.softmax_ztest(a[0], scores) < 5.0


def test_k2_neg_inf_table_entries(dev):
    """-inf table entries are floored: never drawn, never NaN."""
    args, kwargs, _ = _mixed_inputs(dev, 'dd_bb', 2048, 128)
    tables = args[4].clone()
    tables[1, :] = float('-inf')
    tables[:, 5] = float('-inf')
    args = args[:4] + (tables,) + args[5:]
    for sampling in ('argmax', 'cdf', 'gumbel'):
        a, _, tcounts, _ = fk.fused_mixed_score_sample_stats(
            3, *args, sampling=sampling, **kwargs)
        assert int(a.min()) >= 0 and int(a.max()) < 128
        assert not bool((a == 5).any())
        assert int(tcounts.sum()) == 2 * 2048


def test_k2_neg_inf_table_entries_folded(dev):
    """On the folded shape (one bb column) -inf entries are floored into
    the slot records: a row never draws a slot whose entry at its value is
    -inf, and the draws equal the twin's."""
    B, C = 3001, 130
    args, kwargs, _ = _mixed_inputs(dev, 'bb', B, C)
    assert fk.split_shape(args[5], kwargs['quad_groups'],
                          kwargs['table_vs']) == 'table1_folded'
    tables = args[4].clone()
    tables[:, 5] = float('-inf')
    tables[1, ::2] = float('-inf')
    args = args[:4] + (tables,) + args[5:]
    ones = args[1][:, 0] == 1
    noise = _noise(dev, 'gumbel_host', B, C)
    for sampling, nz in (('argmax', None), ('cdf', None), ('gumbel', None),
                         ('gumbel_host', noise)):
        a, _, tcounts, _ = fk.fused_mixed_score_sample_stats(
            3, *args, sampling=sampling, noise=nz, **kwargs)
        assert int(a.min()) >= 0 and int(a.max()) < C
        assert not bool((a == 5).any())
        # value-1 rows only on odd slots
        assert not bool((a[ones] % 2 == 0).any())
        assert int(tcounts.sum()) == B
        if sampling in ('argmax', 'gumbel_host'):
            want = fk.fused_mixed_score_sample_stats_plain(
                3, *args[:4], torch.clamp(tables, min=-1e30), args[5],
                sampling=sampling, noise=nz, **kwargs)
            assert torch.equal(a, want[0])


def test_k2_wrapper_rejects_bad_inputs(dev):
    args, kwargs, _ = _mixed_inputs(dev, 'niw2mix', 512, 128)
    values, table_idx, cls, coeffs, tables, col_groups = args
    with pytest.raises(TypeError):
        fk.fused_mixed_score_sample_stats(
            0, values, table_idx.long(), cls, coeffs, tables, col_groups,
            sampling='argmax', **kwargs)
    with pytest.raises(ValueError):
        fk.fused_mixed_score_sample_stats(
            0, values, table_idx, cls, coeffs, tables[:-1], col_groups,
            sampling='argmax', **kwargs)
    with pytest.raises(ValueError):
        fk.fused_mixed_score_sample_stats(
            0, values, table_idx, cls, coeffs, tables, col_groups,
            sampling='argmax', **dict(kwargs, quad_groups=((1, 5),)))
    with pytest.raises(ValueError):
        fk.fused_mixed_score_sample_stats(
            0, values.cpu(), table_idx, cls, coeffs, tables, col_groups,
            sampling='argmax', **kwargs)


# -- K3 ---------------------------------------------------------------------

def _slot_slice(args, kwargs, a, b):
    """K2's arguments cut to slots [a, b): what one component shard of K3
    takes."""
    values, table_idx, cls, coeffs, tables, col_groups = args

    def cut(x):
        return None if x is None else x[:, a:b].contiguous()
    if tables is not None:
        tables = torch.clamp(tables, min=-1e30)
    return ((values, table_idx, cls[a:b].contiguous(), cut(coeffs),
             cut(tables), col_groups),
            dict(kwargs, qcoeffs=cut(kwargs['qcoeffs'])))


def _pair_reduce(pairs, offsets, C):
    """Largest best, then lowest global slot."""
    best = torch.stack([p[1] for p in pairs])
    ids = torch.stack([p[0].long() + o for p, o in zip(pairs, offsets)])
    top = best.max(0).values
    return torch.where(best == top, ids,
                       torch.full_like(ids, C)).min(0).values.to(torch.int32)


@pytest.mark.parametrize('kind,B,C,cuts', [
    ('niw2mix', 4096, 1024, (0, 256, 512, 768, 1024)),
    ('bbddgp', 4096, 1024, (0, 256, 512, 768, 1024)),
    ('nich_gp_bb', 4096, 128, (0, 128)),
    # ragged: B not a multiple of the thread block, slot ranges that are
    # no multiple of 4 and start at odd offsets
    ('niw3_nich_bb', 3001, 1000, (0, 333, 335, 1000)),
    ('niw4', 257, 1200, (0, 7, 1200)),
    # one table column (the folded shape): ragged rows, shards cut at odd
    # slots and inside a Philox block, fewer slots than slices
    ('bb', 3001, 1027, (0, 333, 335, 1027)),
    ('dd', 257, 1200, (0, 7, 601, 1200)),
    ('bb', 4096, 6, (0, 3, 6))])
@pytest.mark.parametrize('sampling', ['argmax', 'argmax_fast', 'gumbel_host',
                                      'gumbel', 'gumbel_fast'])
def test_pair_kernel_matches_twin_and_k2(dev, kind, B, C, cuts, sampling):
    args, kwargs, _ = _mixed_inputs(dev, kind, B, C)
    noise = _noise(dev, sampling, B, C)
    whole = fk.fused_mixed_score_sample_stats(11, *args, sampling=sampling,
                                              noise=noise, **kwargs)[0]
    pairs = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        s_args, s_kwargs = _slot_slice(args, kwargs, a, b)
        nz = None if noise is None else noise[:, a:b].contiguous()
        before = fk.fused_score_sample_pair.launches
        got = fk.fused_score_sample_pair(11, *s_args, sampling=sampling,
                                         noise=nz, slot_offset=a, **s_kwargs)
        torch.cuda.synchronize()
        assert fk.fused_score_sample_pair.launches == before + 1
        assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
        again = fk.fused_score_sample_pair(11, *s_args, sampling=sampling,
                                           noise=nz, slot_offset=a,
                                           **s_kwargs)
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
        if sampling not in ('gumbel', 'gumbel_fast'):
            # the kernel repeats the twin's f32 operations in the same order
            want = fk.fused_score_sample_pair_plain(
                11, *s_args, sampling=sampling, noise=nz, slot_offset=a,
                **s_kwargs)
            assert torch.equal(got[0], want[0])
            torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=1e-6)
        pairs.append(got)
    # the shards, pair-reduced, draw what K2 draws on the whole slot axis
    assert torch.equal(_pair_reduce(pairs, cuts[:-1], C), whole)


@pytest.mark.parametrize('sampling', ['gumbel', 'gumbel_fast'])
def test_pair_kernel_rng_modes(dev, sampling):
    B, C = 8192, 128
    args, kwargs, (spec, py, sh, st, tv) = _mixed_inputs(dev, 'niw2mix', B, C)
    pairs = []
    for a in (0, 64):
        s_args, s_kwargs = _slot_slice(args, kwargs, a, a + 64)
        pairs.append(fk.fused_score_sample_pair(
            5, *s_args, sampling=sampling, slot_offset=a, **s_kwargs))
    draws = _pair_reduce(pairs, (0, 64), C)
    assert testing.softmax_ztest(draws, mx.score_batch(spec, py, sh, st,
                                                       tv)) < 5.0


def test_pair_wrapper_rejects_bad_inputs(dev):
    args, kwargs, _ = _mixed_inputs(dev, 'niw2mix', 512, 128)
    values, table_idx, cls, coeffs, tables, col_groups = args

    def call(*a, sampling='argmax', **kw):
        return fk.fused_score_sample_pair(0, *a, sampling=sampling,
                                          **dict(kwargs, **kw))
    with pytest.raises(TypeError):
        call(values.double(), table_idx, cls, coeffs, tables, col_groups)
    with pytest.raises(ValueError):
        call(values.cpu(), table_idx, cls, coeffs, tables, col_groups)
    with pytest.raises(ValueError):
        call(values, table_idx, cls, coeffs, tables, col_groups,
             qvalues=kwargs['qvalues'].t().contiguous().t())
    with pytest.raises(ValueError):
        call(values, table_idx, cls, coeffs, tables[:-1], col_groups)
    with pytest.raises(ValueError):
        call(values, table_idx, cls, coeffs, tables, col_groups,
             sampling='cdf')
    with pytest.raises(ValueError):
        call(values, table_idx, cls, coeffs, tables, col_groups,
             slot_offset=-4)
    with pytest.raises(TypeError):
        call(values, table_idx, cls, coeffs, tables, col_groups,
             sampling='gumbel_host')


def test_pair_sweeps_on_the_card(dev):
    """The 2-D sweeps on an in-process mesh on the card: K3 launches =
    tiles x shards, 'argmax' fused equals 'argmax' plain but for near-ties,
    and a 1 x 1 mesh
    in 'gumbel' equals the single-device fused sweep draw for draw."""
    from distributions_tpu_torch.parallel import sharding
    R, C, block = 4096, 128, 512
    _, _, (spec, py, sh, st, tv) = _mixed_inputs(dev, 'niw3_nich_bb', R, C)
    p = testing.mixed_problem(R, C, seed=2, kind='niw3_nich_bb',
                              n_clusters=min(C - 4, 40))
    a0 = torch.from_numpy(p['labels']).to(dev)
    mesh = sharding.make_mesh_2d(2, 4)
    fk.fused_score_sample_pair.launches = 0
    st_f, an_f = sharding.sharded_sweep_2d_fused(
        spec, py, sh, st, tv, a0, torch.Generator().manual_seed(0), mesh,
        block, sampling='argmax')
    assert fk.fused_score_sample_pair.launches == (R // 2 // block) * 8
    st_x, an_x = sharding.sharded_sweep_2d(
        spec, py, sh, st, tv, a0, torch.Generator().manual_seed(0), mesh,
        block, sampling='argmax')
    assert an_f.device.type == 'cuda'
    # the plain sweep scores with the models' score_value_batch formulas,
    # K3 with the product-form coefficient rows: equal to f32 rounding, so
    # an 'argmax' draw may differ at a near-tie only
    differ = int((an_f != an_x).sum())
    moved = int((st_f.counts - st_x.counts).abs().sum())
    # (a third of these rows change slot in the sweep: close competition)
    assert differ <= R // 100 and moved <= 2 * differ, (differ, moved)

    # one shard, one seed: K3 + the one-hot stats against K2's own sums
    one = sharding.make_mesh_2d(1, 1)
    _, an_1 = sharding.sharded_sweep_2d_fused(
        spec, py, sh, st, tv, a0, torch.Generator().manual_seed(4), one,
        block, sampling='gumbel')
    cache = gibbs.build_stat_cache(spec, sh, tv, block, a0)
    _, an_k2, _ = gibbs.sweep_blocked_pallas_fused_mixed(
        spec, py, sh, st, tv, a0, block, 256,
        torch.Generator().manual_seed(4), cache, sampling='gumbel')
    # the same seeds and counters; the states differ by f32 rounding of
    # the stat sums only, so at most a few near-tie rows may differ
    assert int((an_1 != an_k2).sum()) <= R // 1000


# -- K4 and K5 ----------------------------------------------------------------

def _v1_inputs(dev, kind, B, C):
    """K5's inputs (K4's when the kind is 'nich2') for B rows against the
    state of those rows."""
    if kind == 'nich2':
        v, cls, _ = _inputs(dev, B, C)
        values, labels = testing.nich_problem(B, seed=0,
                                              n_clusters=min(C - 4, 40))
        spec = mx.make_spec([(nich, 2)], capacity=C)
        sh = (nich.shared_from_dict(testing.NICH_SHARED, device=dev),)
        py = cl.PitmanYor.from_dict(testing.PY, device=dev)
        st = mx.state_from_assignments(spec, py, sh, (v,),
                                       torch.from_numpy(labels).to(dev))
        return (v, None, cls, fk.nich_coeffs(sh[0], st.groups[0]).contiguous(),
                None), (spec, py, sh, st, (v,))
    _, _, (spec, py, sh, st, tv) = _mixed_inputs(dev, kind, B, C)
    lay = gibbs._mixed_static_layout(spec, tv)
    cls = cl.score_value(py, st.counts, st.alive, st.sample_size)
    coeffs, tables = gibbs._build_v1_inputs(spec, lay, sh, st)
    return (lay.nich_vals, lay.table_idx, cls, coeffs, tables), \
        (spec, py, sh, st, tv)


@pytest.mark.parametrize('kind,B,C', [
    ('nich2', 4096, 128), ('nich2', 3000, 1000), ('nich2', 257, 2500),
    ('nich_gp_bb', 4096, 128), ('dd_bb', 3000, 1000), ('dpd_nich', 1024, 128),
    ('bnb', 1024, 128), ('bbddgp', 4096, 1024)])
@pytest.mark.parametrize('sampling', ['argmax', 'gumbel_host'])
def test_v1_kernels_match_twins(dev, kind, B, C, sampling):
    args, _ = _v1_inputs(dev, kind, B, C)
    noise = _noise(dev, sampling, B, C)
    if kind == 'nich2':
        wrapper, plain = fk.nich_score_sample, fk.nich_score_sample_plain
        args = (args[0], args[2], args[3])
    else:
        wrapper, plain = fk.mixed_score_sample, fk.mixed_score_sample_plain
    before = wrapper.launches
    got = wrapper(0, *args, sampling=sampling, noise=noise)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = plain(0, *args, sampling=sampling, noise=noise)
    # the kernel repeats the twin's f32 operations in the same order
    assert torch.equal(got, want)


@pytest.mark.parametrize('kind', ['nich2', 'nich_gp_bb', 'dd_bb'])
def test_v1_kernels_rng_mode(dev, kind):
    B, C = 8192, 128
    args, (spec, py, sh, st, tv) = _v1_inputs(dev, kind, B, C)
    a = fk.mixed_score_sample(5, *args)
    assert torch.equal(a, fk.mixed_score_sample(5, *args))
    if kind == 'nich2':
        b = fk.nich_score_sample(5, args[0], args[2], args[3])
        assert torch.equal(a, b)
    scores = mx.score_batch(spec, py, sh, st, tv)
    assert testing.softmax_ztest(a, scores) < 5.0


def test_v1_wrappers_reject_bad_inputs(dev):
    args, _ = _v1_inputs(dev, 'nich_gp_bb', 512, 128)
    values, idx, cls, coeffs, tables = args
    with pytest.raises(TypeError):
        fk.mixed_score_sample(0, values, idx.long(), cls, coeffs, tables)
    with pytest.raises(ValueError):
        fk.mixed_score_sample(0, values, idx, cls, coeffs[:-1], tables)
    with pytest.raises(ValueError):
        fk.mixed_score_sample(0, values, idx, cls, coeffs, tables[:, :, :-1])
    with pytest.raises(ValueError):
        fk.nich_score_sample(0, values, cls.cpu(), coeffs)
    with pytest.raises(TypeError):
        fk.nich_score_sample(0, values, cls, coeffs, sampling='gumbel_host')
    with pytest.raises(ValueError):
        fk.nich_score_sample(0, values, cls, coeffs, sampling='cdf')


@pytest.mark.parametrize('backend', ['pallas', 'xla'])
def test_v1_mixed_sweep_on_the_card(dev, backend):
    """The v1 mixed sweep on the card: under 'argmax' the kernel path
    equals the twin path on the CPU draw for draw, and the 'xla' backend
    equals sweep_blocked bitwise."""
    _, (spec, py, sh, st, tv) = _v1_inputs(dev, 'nich_gp_bb', 2048, 128)
    a0 = torch.from_numpy(testing.mixed_problem(
        2048, 128, seed=2, kind='nich_gp_bb', n_clusters=40)['labels']).to(dev)
    if backend == 'xla':
        _, an = gibbs.sweep_blocked_pallas_mixed(
            spec, py, sh, st, tv, a0, 512, torch.Generator().manual_seed(0),
            backend='xla')
        _, want = gibbs.sweep_blocked(spec, py, sh, st, tv, a0, 512,
                                      generator=torch.Generator().manual_seed(0))
        assert torch.equal(an, want)
        return
    before = fk.mixed_score_sample.launches
    st1, an = gibbs.sweep_blocked_pallas_mixed(
        spec, py, sh, st, tv, a0, 512, torch.Generator().manual_seed(0),
        sampling='argmax')
    assert fk.mixed_score_sample.launches == before + 4
    assert torch.equal(torch.bincount(an.long(), minlength=128).int(),
                       st1.counts)
    p = testing.mixed_problem(2048, 128, seed=2, kind='nich_gp_bb',
                              n_clusters=40)
    cspec, cpy, csh = testing.build_problem(p, MODULES, mx.make_spec,
                                            cl.PitmanYor.from_dict,
                                            device='cpu')
    ctv = tuple(torch.from_numpy(v) for v in p['values'])
    ca0 = torch.from_numpy(p['labels'])
    cst = mx.state_from_assignments(cspec, cpy, csh, ctv, ca0)
    _, can = gibbs.sweep_blocked_pallas_mixed(
        cspec, cpy, csh, cst, ctv, ca0, 512, torch.Generator().manual_seed(0),
        sampling='argmax')
    n_bad = int((an.cpu() != can).sum())
    assert n_bad <= 2, n_bad         # near-ties across devices' log1p


@pytest.mark.parametrize('use_pallas', [False, True])
def test_resume_is_bitwise_on_the_card(dev, use_pallas, tmp_path):
    """Interrupted plus resumed equals uninterrupted on the card, on the
    fused path and on the plain path (no float atomics anywhere), with a
    CUDA generator's state in the checkpoint."""
    from distributions_tpu_torch.inference import runner
    values, _ = testing.nich_problem(4096, seed=3)
    spec = mx.make_spec([(nich, 2)], capacity=128)
    py = cl.PitmanYor.from_dict(testing.PY, device=dev)
    sh = (nich.shared_from_dict(testing.NICH_SHARED, device=dev),)
    tv = (torch.from_numpy(values).to(dev),)
    common = dict(block=1024, use_pallas=use_pallas, sampling='gumbel',
                  checkpoint_every=2, init='random:16')

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)
    st_a, an_a, log_a = runner.run_gibbs(
        spec, py, sh, tv, gen(3), 5, resume=False,
        checkpoint_path=str(tmp_path / 'full.ckpt'), **common)
    ckpt = str(tmp_path / 'crash.ckpt')
    runner.run_gibbs(spec, py, sh, tv, gen(3), 2, resume=False,
                     checkpoint_path=ckpt, **common)
    st_b, an_b, log_b = runner.run_gibbs(spec, py, sh, tv, gen(999), 5,
                                         checkpoint_path=ckpt, **common)
    assert an_b.device.type == 'cuda'
    assert torch.equal(an_a, an_b) and torch.equal(st_a.counts, st_b.counts)
    assert torch.equal(st_a.groups[0].mean, st_b.groups[0].mean)
    assert [r['sweep'] for r in log_b.rows] == [0, 1, 2, 3, 4]
    with pytest.raises(ValueError, match='cuda generator'):
        runner.run_gibbs(spec, py, sh, tv, torch.Generator().manual_seed(0),
                         5, checkpoint_path=ckpt, **common)


# -- B1-B5: the measurement kernels (`-k bench`) ------------------------------

# B4 moves whole chunks through a ring: lengths at and around one chunk
# and one ring, and ragged tails
@pytest.mark.parametrize('n', [1 << 20, (1 << 16) + 3, 5,
                               *bk.COPY_EDGE_LENGTHS, (1 << 20) - 1,
                               (1 << 20) + 1])
def test_bench_copy_is_exact(dev, n):
    x = torch.randn(n, device=dev)
    before = bk.roofline_copy.launches
    got = bk.roofline_copy(x)
    assert bk.roofline_copy.launches == before + 1
    assert torch.equal(got, bk.roofline_copy_plain(x))


@pytest.mark.parametrize('K', [1, 3, 9])
@pytest.mark.parametrize('op', sorted(bk.CHAIN_OPS))
def test_bench_chain_matches_twin(dev, op, K):
    x = torch.rand((64, 1024), device=dev) + 0.5
    before = bk.roofline_chain.launches
    got = bk.roofline_chain(x, op, 3, K)
    assert bk.roofline_chain.launches == before + 1
    want = bk.roofline_chain_plain(x, op, 3, K)
    if op in bk.CHAIN_EXACT_OPS:
        # the kernel repeats the twin's rounded operations in its order
        assert torch.equal(got, want)
    else:
        # CUDA's logf / expf / log1pf / rsqrtf against PyTorch's: ulps,
        # which a chain carries along
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _int_operands(dev, N, hi, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randint(-hi, hi + 1, (N, N), generator=g,
                               device=dev).to(torch.bfloat16)
                 for _ in range(2))


# 2048: more tiles (512) than SMs; 384: fewer (18)
@pytest.mark.parametrize('hi', [1, 4])
@pytest.mark.parametrize('steps', [1, 3])
@pytest.mark.parametrize('N', [128, 384, 1024, 2048])
def test_bench_mma_exact_on_small_integers(dev, N, steps, hi):
    """Operands from {-hi, ..., hi}: every product and sum is an integer
    below 2^24, which f32 holds exactly whatever the order of the sums, so
    bf16(acc) rounds the same value in the kernel and the twin.  From {-1,
    0, 1} |acc| stays below 256, where bf16 is exact; from {-4, ..., 4}
    (sd of acc 6.7 sqrt(N)) it often passes 256, and the rounding itself is
    held bitwise."""
    a, b = _int_operands(dev, N, hi, N + steps + hi)
    before = bk.roofline_mma.launches
    got = bk.roofline_mma(a, b, steps)
    assert bk.roofline_mma.launches == before + 1
    assert torch.equal(got, bk.roofline_mma_plain(a, b, steps))


@pytest.mark.parametrize('steps', [1, 2, 3])
@pytest.mark.parametrize('N', [384, 2048])
def test_bench_mma_writes_before_it_reads(dev, monkeypatch, N, steps):
    """Every buffer of B3 starts as NaN, its strip counters as -1: a tile
    that reads accf, either accb or out before this call wrote it, or a
    counter the launcher did not zero, shows in the result.  Each accb
    buffer is first read at step 1 or 2; later steps compute the same acc
    again, so a stale read there could not be seen through this function."""
    scratch = bk._mma_scratch

    def poisoned(n, d):
        bufs = scratch(n, d)
        for t in bufs[:3]:
            t.fill_(float('nan'))
        bufs[3].fill_(-1)
        return bufs
    monkeypatch.setattr(bk, '_mma_scratch', poisoned)
    a, b = _int_operands(dev, N, 4, N + steps)
    assert torch.equal(bk.roofline_mma(a, b, steps),
                       bk.roofline_mma_plain(a, b, steps))


def test_bench_mma_normal_operands(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    a, b = (torch.randn((256, 256), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(2))
    got = bk.roofline_mma(a, b, 3)
    want = bk.roofline_mma_plain(a, b, 3)
    # f32 sums in another order, and a bf16 rounding of acc that may flip
    torch.testing.assert_close(got, want, rtol=1e-2,
                               atol=1e-3 * float(want.pow(2).mean().sqrt()))


@pytest.mark.parametrize('steps', [1, 3])
@pytest.mark.parametrize('N', [128, 384, 1024, 2048])
def test_bench_mma_normal_operands_at_sizes(dev, N, steps):
    """The tensor cores' f32 sums are not the twin's: where acc lies near a
    bf16 rounding boundary the two round it apart, and each such term moves
    an output by |a| x one bf16 ulp of acc.  On the H100 the kernel's sums
    and the twin's own both stay a few 1e-3 of the result's rms from the
    exact (float64) function, and the twin's pass the per-element atol of
    1e-3 rms above only up to N of a few hundred (chip_smoke.py's kernel_b3
    prints all three distances; PERF.md section 6).  Held to 5e-3 of the
    rms; the rounding itself is held bitwise on integer operands."""
    g = torch.Generator(device=dev).manual_seed(N + steps + 1)
    a, b = (torch.randn((N, N), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(2))
    got = bk.roofline_mma(a, b, steps)
    want = bk.roofline_mma_plain(a, b, steps)
    torch.testing.assert_close(got, want, rtol=1e-2,
                               atol=5e-3 * float(want.pow(2).mean().sqrt()))


@pytest.mark.parametrize('BR,C,T', [(64, 256, 40), (33, 1000, 16),
                                    (8, 13000, 5), (5, 64, 300)])
@pytest.mark.parametrize('sampling', ['argmax', 'gumbel_host'])
def test_bench_sampler_matches_twin(dev, BR, C, T, sampling):
    g = torch.Generator(device=dev).manual_seed(2)
    scores = torch.randn((BR, C), generator=g, device=dev)
    noise = _noise(dev, sampling, BR, C)
    before = bk.sampler_gumbel.launches
    got = bk.sampler_gumbel(4, scores, T, sampling, noise, all_draws=True)
    assert bk.sampler_gumbel.launches == before + 1
    want = bk.sampler_gumbel_plain(4, scores, T, sampling, noise,
                                   all_draws=True)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_bench_sampler_gumbel_distribution(dev):
    BR, C, T = 256, 64, 512
    g = torch.Generator(device=dev).manual_seed(3)
    scores = torch.randn((BR, C), generator=g, device=dev)
    last, checksum, draws = bk.sampler_gumbel(9, scores, T, all_draws=True)
    again = bk.sampler_gumbel(9, scores, T, all_draws=True)
    assert all(torch.equal(x, y) for x, y in zip((last, checksum, draws),
                                                 again))
    assert torch.equal(last, draws[-1])
    assert torch.equal(checksum, draws.sum(0).to(torch.int32))
    # the iterations are independent draws of one categorical per row
    assert not torch.equal(draws[0], draws[1])
    assert testing.softmax_ztest(draws.reshape(-1),
                                 scores.repeat(T, 1)) < 5.0
    two = bk.sampler_gumbel(9, scores, T)
    assert torch.equal(two[0], last) and torch.equal(two[1], checksum)


def test_bench_wrappers_reject_bad_inputs(dev):
    x = torch.rand((8, 128), device=dev)
    with pytest.raises(ValueError):
        bk.roofline_chain(x, 'sin', 3, 1)
    with pytest.raises(ValueError):
        bk.roofline_chain(x, 'log', 3, 4)
    with pytest.raises(TypeError):
        bk.roofline_copy(x.double())
    with pytest.raises(ValueError):
        bk.roofline_copy(x.t())
    a = torch.zeros((128, 128), dtype=torch.bfloat16, device=dev)
    with pytest.raises(TypeError):
        bk.roofline_mma(a.float(), a, 1)
    with pytest.raises(ValueError):
        bk.roofline_mma(a[:64, :64].contiguous(), a[:64, :64].contiguous(), 1)
    with pytest.raises(ValueError):
        bk.sampler_gumbel(0, x, 0)
    with pytest.raises(TypeError):
        bk.sampler_gumbel(0, x, 2, 'gumbel_host')
    with pytest.raises(ValueError):
        bk.sampler_gumbel(0, x, 2, 'cdf')


@pytest.mark.parametrize('B,C', [(4096, 128), (3000, 1000), (257, 2500)])
def test_bench_phases_match_twin(dev, B, C):
    v, cls, co = _inputs(dev, B, C)
    args = (v, cls, co, (2,))
    before = bk.fused_phase.launches
    k1_before = fk.fused_score_sample_stats.launches
    assert torch.equal(bk.fused_phase('noop', 0, *args),
                       bk.fused_phase_plain('noop', 0, *args))
    # the row maximum is the twin's, bitwise: the same rounded operations
    assert torch.equal(bk.fused_phase('score_max', 0, *args),
                       bk.fused_phase_plain('score_max', 0, *args))
    # 'score_bits' perturbs by at most BITS_NOISE_MAX: its pick scores
    # within that of the row maximum
    scores = fk._score_nich_product(v, co, cls, (2,), torch.log)
    pick = bk.fused_phase('score_bits', 5, *args)
    assert int(pick.min()) >= 0 and int(pick.max()) < C
    gap = scores.amax(1) - scores.gather(1, pick.long()[:, None])[:, 0]
    assert float(gap.max()) <= bk.BITS_NOISE_MAX + 1e-6
    noise = _noise(dev, 'gumbel_host', B, C)
    for sampling, nz in (('argmax', None), ('gumbel_host', noise),
                         ('gumbel', None), ('cdf', None),
                         ('gumbel_fast', None)):
        a, s = fk.fused_score_sample_stats(5, *args, sampling=sampling,
                                           noise=nz)
        # the score + sample kernel alone draws what K1 draws
        assert torch.equal(
            bk.fused_phase('score_' + sampling, 5, *args, noise=nz), a)
        a2, s2 = bk.fused_phase('full_' + sampling, 5, *args, noise=nz)
        assert torch.equal(a2, a) and torch.equal(s2, s)
    # a 'full' phase is K1's own launch, counted by K1's wrapper
    assert bk.fused_phase.launches == before + 8
    assert fk.fused_score_sample_stats.launches == k1_before + 10
    with pytest.raises(ValueError):
        bk.fused_phase('score', 0, *args)
    with pytest.raises(ValueError):
        bk.fused_phase('noop', 0, v, cls, co[:-1], (2,))


# -- the split walk of K1, B5, K2 and K3: edge geometry -----------------------

SPLIT_BLOCK_ROWS = fk.SPLIT_THREADS // fk.SPLIT_SLICES * fk.SPLIT_ROWS
# one row, one short of two warps' rows, several blocks, and one row past a
# whole number of blocks
SPLIT_B = (1, 127, 3000, 47 * SPLIT_BLOCK_ROWS + 1)
SPLIT_C = (1, 3, 5, 1000, 1025)
SPLIT_OFFSETS = (0, 2, 6, 256)
# layouts of K2 and K3: niw2mix's (an exact shape of the kernel), one table
# column of 2 values (bb: the folded shape), and some that take the wide
# shape (one table column of 9 values; several blocks of each kind; niw d =
# 3, 4; more than four columns in a block)
SPLIT_LAYOUTS = {'niw2mix': ((1,), ((1, 2),), (3,)),
                 'bb': ((), (), (2,)),
                 'table9': ((), (), (9,)),
                 'wide': ((2, 3), ((1, 3), (2, 1)), (2, 5)),
                 'niw3_nich_bb': ((1,), ((1, 3),), (2,)),
                 'niw4': ((), ((1, 4),), ()),
                 'niw1x5_nich6': ((6,), ((5, 1),), ()),
                 # one niw column of d = 16 (the niw16 shape); two of d = 8
                 # beside nich and table columns (the wide shape of d <= 16)
                 'niw16': ((), ((1, 16),), ()),
                 'niw8x2_nich_bb': ((1,), ((2, 8),), (2,))}


def _rand_layout(dev, B, C, groups, quads, tvs, seed=0):
    """Random inputs of K2 (K1 with quads = tvs = ()) on the card: nich
    values and coefficients, niw values and coefficients with positive
    diagonals, table columns, and cluster scores with every tenth slot
    dead.  Returns (args, kwargs) of fused_mixed_score_sample_stats."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g)
    values = coeffs = qvalues = qcoeffs = table_idx = tables = None
    if groups:
        values = r(B, sum(groups))
        rows = []
        for c in groups:
            rows += [r(1, C), -r(1, C).abs() - 0.1]
            for _ in range(c):
                rows += [r(1, C).abs() + 0.1, r(1, C)]
        coeffs = torch.cat(rows)
    if quads:
        qvalues = r(B, sum(nc * d for nc, d in quads))
        rows = []
        for nc, d in quads:
            rows += [r(1, C), -r(1, C).abs() - 0.1]
            for _ in range(nc):
                rows += [r(1, C) for _ in range(d)]
                rows += [r(1, C).abs() + 0.5 if a == b else 0.1 * r(1, C)
                         for a in range(d) for b in range(a, d)]
        qcoeffs = torch.cat(rows)
    if tvs:
        table_idx = torch.stack([torch.randint(0, v, (B,), generator=g)
                                 for v in tvs], 1).to(torch.int32)
        tables = r(sum(tvs), C)
    cls = r(C)
    cls[::10] = float('-inf')

    def put(x):
        return None if x is None else x.contiguous().to(dev)
    args = (put(values), put(table_idx), put(cls), put(coeffs), put(tables),
            tuple(groups))
    kwargs = dict(qvalues=put(qvalues), qcoeffs=put(qcoeffs),
                  quad_groups=tuple(quads), table_vs=tuple(tvs))
    return args, kwargs


def _scores(args, kwargs):
    B = next(x for x in (args[0], args[1], kwargs['qvalues'])
             if x is not None).shape[0]
    return fk._score_mixed(B, *args, kwargs['qvalues'], kwargs['qcoeffs'],
                           kwargs['quad_groups'], kwargs['table_vs'],
                           torch.log)


def _gumbel_is_philox(launch, scores, seed, B, C, slot_offset=0):
    """'gumbel' draws the kernel's own Philox noise: equal to 'gumbel_host'
    on philox_gumbel_noise but at near-ties (torch.log against the
    kernel's logf)."""
    noise = fk.philox_gumbel_noise(seed, B, C, slot_offset=slot_offset,
                                   device=scores.device)
    a = launch('gumbel', None)
    b = launch('gumbel_host', noise)
    n_bad, gap = testing.mismatches(scores + noise, a, b)
    assert gap <= 1e-4, (n_bad, gap)


def _check_k1_and_b5(dev, B, C, groups):
    """K1 and B5 against their twins, and K1's 'gumbel' against its own
    Philox noise, on random inputs of nich column groups `groups`."""
    args, kwargs = _rand_layout(dev, B, C, groups, (), (), seed=B + C)
    v, _, cls, co, _, groups = args
    noise = _noise(dev, 'gumbel_host', B, C)
    for sampling, nz in (('argmax', None), ('argmax_fast', None),
                         ('gumbel_host', noise)):
        a, s = fk.fused_score_sample_stats(3, v, cls, co, groups,
                                           sampling=sampling, noise=nz)
        a2, s2 = fk.fused_score_sample_stats_plain(3, v, cls, co, groups,
                                                   sampling=sampling,
                                                   noise=nz)
        assert torch.equal(a, a2)
        torch.testing.assert_close(s, s2, rtol=SUM_RTOL, atol=SUM_ATOL)
        assert torch.equal(
            bk.fused_phase('score_' + sampling, 3, v, cls, co, groups,
                           noise=nz), a)
    scores = _scores(args, kwargs)
    _gumbel_is_philox(
        lambda m, nz: fk.fused_score_sample_stats(9, v, cls, co, groups,
                                                  sampling=m, noise=nz)[0],
        scores, 9, B, C)
    assert torch.equal(bk.fused_phase('noop', 0, v, cls, co, groups),
                       bk.fused_phase_plain('noop', 0, v, cls, co, groups))
    assert torch.equal(bk.fused_phase('score_max', 0, v, cls, co, groups),
                       bk.fused_phase_plain('score_max', 0, v, cls, co,
                                            groups))


@pytest.mark.parametrize('C', SPLIT_C)
@pytest.mark.parametrize('B', SPLIT_B)
def test_fused_split_k1_and_b5_edges(dev, B, C):
    _check_k1_and_b5(dev, B, C, (2,))


# K1's other shapes: one block of 1, 3 or 4 columns (exact shapes), and
# several blocks or more columns (the wide shape)
SPLIT_K1_GROUPS = ((1,), (3,), (4,), (2, 3), (1, 1), (8,), (4, 4, 1))


@pytest.mark.parametrize('C', (5, 1025))
@pytest.mark.parametrize('B', (127, 47 * SPLIT_BLOCK_ROWS + 1))
@pytest.mark.parametrize('groups', SPLIT_K1_GROUPS, ids=str)
def test_fused_split_k1_and_b5_layouts(dev, groups, B, C):
    _check_k1_and_b5(dev, B, C, groups)


@pytest.mark.parametrize('C', SPLIT_C)
@pytest.mark.parametrize('B', SPLIT_B)
@pytest.mark.parametrize('layout', sorted(SPLIT_LAYOUTS))
def test_fused_split_k2_edges(dev, layout, B, C):
    args, kwargs = _rand_layout(dev, B, C, *SPLIT_LAYOUTS[layout],
                                seed=B * C)
    noise = _noise(dev, 'gumbel_host', B, C)
    for sampling, nz in (('argmax', None), ('argmax_fast', None),
                         ('gumbel_host', noise)):
        got = fk.fused_mixed_score_sample_stats(3, *args, sampling=sampling,
                                                noise=nz, **kwargs)
        want = fk.fused_mixed_score_sample_stats_plain(
            3, *args, sampling=sampling, noise=nz, **kwargs)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[2], want[2])
        for i in (1, 3):
            torch.testing.assert_close(got[i], want[i], rtol=SUM_RTOL,
                                       atol=SUM_ATOL)
    _gumbel_is_philox(
        lambda m, nz: fk.fused_mixed_score_sample_stats(
            9, *args, sampling=m, noise=nz, **kwargs)[0],
        _scores(args, kwargs), 9, B, C)


@pytest.mark.parametrize('C', SPLIT_C)
@pytest.mark.parametrize('slot_offset', SPLIT_OFFSETS)
def test_fused_split_k3_edges(dev, slot_offset, C):
    B = 3000
    args, kwargs = _rand_layout(dev, B, C, *SPLIT_LAYOUTS['niw2mix'],
                                seed=C + slot_offset)
    noise = _noise(dev, 'gumbel_host', B, C)
    for sampling, nz in (('argmax', None), ('argmax_fast', None),
                         ('gumbel_host', noise)):
        got = fk.fused_score_sample_pair(3, *args, sampling=sampling,
                                         noise=nz, slot_offset=slot_offset,
                                         **kwargs)
        want = fk.fused_score_sample_pair_plain(
            3, *args, sampling=sampling, noise=nz, slot_offset=slot_offset,
            **kwargs)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])
    _gumbel_is_philox(
        lambda m, nz: fk.fused_score_sample_pair(
            9, *args, sampling=m, noise=nz, slot_offset=slot_offset,
            **kwargs)[0],
        _scores(args, kwargs), 9, B, C, slot_offset)


@pytest.mark.parametrize('C', (5, 1025))
@pytest.mark.parametrize('slot_offset', SPLIT_OFFSETS + (3,))
@pytest.mark.parametrize('layout', ['wide', 'niw3_nich_bb', 'bb', 'table9',
                                    'niw16', 'niw8x2_nich_bb'])
def test_fused_split_k3_wide_layouts(dev, layout, slot_offset, C):
    B = 3000
    args, kwargs = _rand_layout(dev, B, C, *SPLIT_LAYOUTS[layout],
                                seed=C + slot_offset)
    noise = _noise(dev, 'gumbel_host', B, C)
    for sampling, nz in (('argmax', None), ('argmax_fast', None),
                         ('gumbel_host', noise)):
        got = fk.fused_score_sample_pair(3, *args, sampling=sampling,
                                         noise=nz, slot_offset=slot_offset,
                                         **kwargs)
        want = fk.fused_score_sample_pair_plain(
            3, *args, sampling=sampling, noise=nz, slot_offset=slot_offset,
            **kwargs)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])
    _gumbel_is_philox(
        lambda m, nz: fk.fused_score_sample_pair(
            9, *args, sampling=m, noise=nz, slot_offset=slot_offset,
            **kwargs)[0],
        _scores(args, kwargs), 9, B, C, slot_offset)


def _check_special_rows(dev, kernel, rows, lay):
    """Rows whose scores all tie or are all -inf draw slot 0; NaN counts as
    maximal, so a NaN row draws slot 0 and a NaN slot wins every row."""
    B, C = 3000, 1025
    args, kwargs = _rand_layout(dev, B, C, *lay, seed=5)
    values, table_idx, cls, coeffs, tables, groups = args
    want = torch.zeros(B, dtype=torch.int32, device=dev)
    if rows == 'tied':
        cls = torch.zeros_like(cls)
        coeffs = coeffs[:, :1].expand(-1, C).contiguous()
        if tables is not None:
            tables = tables[:, :1].expand(-1, C).contiguous()
        if kwargs['qcoeffs'] is not None:
            kwargs['qcoeffs'] = kwargs['qcoeffs'][:, :1].expand(
                -1, C).contiguous()
    elif rows == 'dead':
        cls = torch.full_like(cls, float('-inf'))
    elif rows == 'nan':
        values = values.clone()
        values[:, 0] = float('nan')
    else:
        cls = cls.clone()
        cls[C - 2] = float('nan')
        want.fill_(C - 2)
    args = (values, table_idx, cls, coeffs, tables, groups)
    for sampling in ('argmax', 'gumbel_host'):
        nz = (torch.zeros(B, C, device=dev) if sampling == 'gumbel_host'
              else None)
        if kernel == 'K1':
            got = fk.fused_score_sample_stats(3, values, cls, coeffs, groups,
                                              sampling=sampling, noise=nz)[0]
        elif kernel == 'K2':
            got = fk.fused_mixed_score_sample_stats(
                3, *args, sampling=sampling, noise=nz, **kwargs)[0]
        else:
            got = fk.fused_score_sample_pair(3, *args, sampling=sampling,
                                             noise=nz, slot_offset=2,
                                             **kwargs)[0]
        assert torch.equal(got, want), (sampling, got[:8])


@pytest.mark.parametrize('rows', ['tied', 'dead', 'nan', 'nan_slot'])
@pytest.mark.parametrize('kernel', ['K1', 'K2', 'K3'])
def test_fused_split_special_rows(dev, kernel, rows):
    _check_special_rows(dev, kernel, rows,
                        ((2,), (), ()) if kernel == 'K1'
                        else SPLIT_LAYOUTS['niw2mix'])


@pytest.mark.parametrize('rows', ['tied', 'dead', 'nan', 'nan_slot'])
@pytest.mark.parametrize('kernel', ['K1', 'K2', 'K3'])
def test_fused_split_special_rows_wide(dev, kernel, rows):
    _check_special_rows(dev, kernel, rows,
                        ((2, 3), (), ()) if kernel == 'K1'
                        else SPLIT_LAYOUTS['wide'])


def _staged_record_bytes(C, report):
    """split_geometry's shared memory of one turn's slot records (no
    padding between slices in the default build) for a kernel's report at
    C slots from slot 0."""
    per_slice = -(-((C + 3) // 4) // fk.SPLIT_SLICES)
    L = 4 * -(-per_slice // report['turns'])
    return fk.SPLIT_SLICES * L * report['record_floats'] * 4


def test_fused_split_occupancy_report(dev):
    """The occupancy entry points name the kernels of the main path, and
    the wide shape of other layouts; K2 names its shape."""
    r1 = fk.split_occupancy('fused_v2', 1024, (2,))
    r2 = fk.split_occupancy('fused_v3', 1024, (1,), ((1, 2),), (2,))
    r3 = fk.split_occupancy('fused_v2', 1024, (2, 3))
    r4 = fk.split_occupancy('fused_v3', 1024, *SPLIT_LAYOUTS['wide'])
    bb = fk.split_occupancy('fused_v3', 1024, *SPLIT_LAYOUTS['bb'])
    t9 = fk.split_occupancy('fused_v3', 8192, *SPLIT_LAYOUTS['table9'])
    t3 = fk.split_occupancy('fused_v3', 1024, (), (), (2, 4, 9))
    for r in (r1, r2, r3, r4, bb, t9, t3):
        assert r['threads_per_block'] == fk.SPLIT_THREADS
        assert r['blocks_per_sm'] >= 1 and r['registers'] > 0
        assert r['record_floats'] % fk.SPLIT_PACK == 0
    assert [r['shape'] for r in (r2, r4, bb, t9, t3)] == [
        'niw2mix', 'wide', 'table1_folded', 'wide', 'tables3']
    assert 'shape' not in r1
    # the wide shape stages the block's rows beside the records (5 nich
    # columns, 5 niw values and 2 table columns a row); the folded shape
    # stages its records alone, where the wide shape would add a row's
    # table index, and spills nothing
    assert r4['smem_bytes'] == (_staged_record_bytes(1024, r4)
                                + SPLIT_BLOCK_ROWS * (5 + 5 + 2) * 4)
    assert bb['smem_bytes'] == _staged_record_bytes(1024, bb)
    assert bb['record_floats'] == fk.SPLIT_PACK
    assert bb['local_bytes'] == 0
    # K1 on nich2 compiles as before
    assert (r1['registers'], r1['local_bytes'], r1['blocks_per_sm']) == (
        48, 0, 5)
    with pytest.raises(RuntimeError):
        fk.split_occupancy('fused_v2', 1024, (2,), sampling='cdf')


@pytest.mark.parametrize('layout,shape', [
    (SPLIT_LAYOUTS['bb'], 'table1_folded'), (((), (), (4,)), 'table1_folded'),
    (SPLIT_LAYOUTS['table9'], 'wide'), (SPLIT_LAYOUTS['niw2mix'], 'niw2mix'),
    (((), (), (2, 4, 9)), 'tables3'), (SPLIT_LAYOUTS['wide'], 'wide'),
    (SPLIT_LAYOUTS['niw16'], 'niw16'), (((), ((1, 5),), ()), 'wide_d16'),
    (SPLIT_LAYOUTS['niw8x2_nich_bb'], 'wide_d16')],
    ids=['bb', 'dd', 'table9', 'niw2mix', 'tables3', 'wide', 'niw16',
         'niw5', 'niw8x2_nich_bb'])
def test_k2_counts_launches_by_shape(dev, layout, shape):
    """K2 counts its eager launches by the split shape it takes ('cdf':
    the sequential walk), beside its count of all launches."""
    assert fk.split_shape(*layout) == shape
    args, kwargs = _rand_layout(dev, 300, 64, *layout)
    counts = fk.fused_mixed_score_sample_stats.shape_launches
    want = dict(counts)
    before = fk.fused_mixed_score_sample_stats.launches
    for sampling in ('gumbel', 'argmax', 'cdf'):
        fk.fused_mixed_score_sample_stats(1, *args, sampling=sampling,
                                          **kwargs)
    want[shape] = want.get(shape, 0) + 2
    want['sequential'] = want.get('sequential', 0) + 1
    assert counts == want
    assert fk.fused_mixed_score_sample_stats.launches == before + 3


@pytest.mark.parametrize('layout', ['niw16', 'niw8x2_nich_bb'])
def test_k2_niw_wide_gumbel_draws_the_law(dev, layout):
    """'gumbel' on niw columns past d = 4 (the niw16 shape, the wide shape
    of d <= 16) draws from the softmax of the twin's scores."""
    B, C = 16384, 96
    args, kwargs = _rand_layout(dev, B, C, *SPLIT_LAYOUTS[layout], seed=4)
    a = fk.fused_mixed_score_sample_stats(5, *args, sampling='gumbel',
                                          **kwargs)
    assert torch.equal(a[0], fk.fused_mixed_score_sample_stats(
        5, *args, sampling='gumbel', **kwargs)[0])
    assert testing.softmax_ztest(a[0], _scores(args, kwargs)) < 5.0


@pytest.mark.parametrize('quads', [((1, 17),), ((2, 9),), ((1, 4), (1, 13))],
                         ids=str)
def test_k2_and_k3_refuse_layouts_past_the_caps(dev, quads):
    """A niw column of d > 16 or more than 16 niw values in all: K2 in
    every walk and K3 raise ValueError before any launch."""
    args, kwargs = _rand_layout(dev, 64, 32, (), quads, ())
    before = fk.fused_mixed_score_sample_stats.launches
    for sampling in ('gumbel', 'argmax', 'cdf'):
        with pytest.raises(ValueError):
            fk.fused_mixed_score_sample_stats(1, *args, sampling=sampling,
                                              **kwargs)
    with pytest.raises(ValueError):
        fk.fused_score_sample_pair(1, *args, sampling='gumbel', **kwargs)
    assert fk.fused_mixed_score_sample_stats.launches == before


# -- the split walk of K4 and K5 (its v1 form): edge geometry -----------------

V1_SPLIT_B = (1, 63, 64, 65, 3000)
V1_SPLIT_C = (1, 3, 5, 1000, 1025)
# K4's nich columns: exact shapes for 1-4, the wide shape beyond; K5's
# (nich columns, table columns): exact shapes for 0-2 nich and 1-3 table
# columns, the wide shape for (3, 16)
V1_K4_COLS = (1, 3, 4, 5, 32)
V1_K5_LAYOUTS = ((0, 1), (0, 3), (1, 3), (2, 2), (3, 16))


def _v1_launch(kernel, args, sampling, noise, seed=3, plain=False):
    """K4 (nich columns only) or K5, or with plain=True its twin."""
    values, idx, cls, coeffs, tables = args
    if kernel == 'K4':
        f = fk.nich_score_sample_plain if plain else fk.nich_score_sample
        return f(seed, values, cls, coeffs, sampling=sampling, noise=noise)
    f = fk.mixed_score_sample_plain if plain else fk.mixed_score_sample
    return f(seed, values, idx, cls, coeffs, tables, sampling=sampling,
             noise=noise)


def _check_v1(dev, kernel, B, C, cols, n_tab):
    """K4 or K5 against its twin in 'argmax' and 'gumbel_host', and its
    'gumbel' against its own Philox noise, on random inputs."""
    args = testing.v1_random_inputs(B, C, cols, n_tab,
                                    seed=B * C + cols + n_tab, device=dev)
    noise = _noise(dev, 'gumbel_host', B, C)
    for sampling, nz in (('argmax', None), ('gumbel_host', noise)):
        got = _v1_launch(kernel, args, sampling, nz)
        assert torch.equal(got, _v1_launch(kernel, args, sampling, nz,
                                           plain=True)), sampling
    _gumbel_is_philox(
        lambda m, nz: _v1_launch(kernel, args, m, nz, seed=9),
        fk._score_v1(B, *args), 9, B, C)


@pytest.mark.parametrize('C', V1_SPLIT_C)
@pytest.mark.parametrize('B', V1_SPLIT_B)
@pytest.mark.parametrize('kernel', ['K4', 'K5'])
def test_v1_split_edges(dev, kernel, B, C):
    """The main path's layouts (K4: 2 nich columns; K5: nichbbddgp's 1 nich
    and 3 table columns) at edge rows and slots."""
    _check_v1(dev, kernel, B, C, *((2, 0) if kernel == 'K4' else (1, 3)))


@pytest.mark.parametrize('C', (5, 1025))
@pytest.mark.parametrize('B', (65, 3000))
@pytest.mark.parametrize('layout', [('K4', c, 0) for c in V1_K4_COLS]
                         + [('K5',) + lay for lay in V1_K5_LAYOUTS], ids=str)
def test_v1_split_layouts(dev, layout, B, C):
    _check_v1(dev, layout[0], B, C, *layout[1:])


@pytest.mark.parametrize('rows', ['tied', 'dead', 'nan', 'nan_slot'])
@pytest.mark.parametrize('layout', [('K4', 2, 0), ('K4', 5, 0),
                                    ('K5', 1, 3), ('K5', 3, 16)], ids=str)
def test_v1_split_special_rows(dev, layout, rows):
    """Rows whose scores all tie or are all -inf draw slot 0; NaN counts as
    maximal, so a NaN row draws slot 0 and a NaN slot wins every row (an
    exact and a wide shape of each kernel)."""
    kernel, cols, n_tab = layout
    B, C = 3000, 1025
    values, idx, cls, coeffs, tables = testing.v1_random_inputs(
        B, C, cols, n_tab, seed=5, device=dev)
    want = torch.zeros(B, dtype=torch.int32, device=dev)
    if rows == 'tied':
        cls = torch.zeros_like(cls)
        coeffs = coeffs[:, :1].expand(-1, C).contiguous()
        if tables is not None:
            tables = tables[:, :, :1].expand(-1, -1, C).contiguous()
    elif rows == 'dead':
        cls = torch.full_like(cls, float('-inf'))
    elif rows == 'nan':
        values = values.clone()
        values[:, 0] = float('nan')
    else:
        cls = cls.clone()
        cls[C - 2] = float('nan')
        want.fill_(C - 2)
    args = (values, idx, cls, coeffs, tables)
    for sampling in ('argmax', 'gumbel_host'):
        nz = (torch.zeros(B, C, device=dev) if sampling == 'gumbel_host'
              else None)
        got = _v1_launch(kernel, args, sampling, nz)
        assert torch.equal(got, want), (sampling, got[:8])


def test_v1_split_k5_nich_only_equals_k4(dev):
    """K5 without table columns takes K4's shapes: the same draws, on an
    exact and on the wide shape."""
    for cols in (2, 5):
        args = testing.v1_random_inputs(3000, 1025, cols, 0, seed=cols,
                                        device=dev)
        for sampling in ('argmax', 'gumbel'):
            assert torch.equal(_v1_launch('K4', args, sampling, None),
                               _v1_launch('K5', args, sampling, None))


def test_v1_split_occupancy_report(dev):
    """The occupancy entry point reports the split kernel of K4 and K5 on
    the main path's layouts and on the wide shape."""
    reports = [fk.split_occupancy('score_sample_v1', 1024, (2,)),
               fk.split_occupancy('score_sample_v1', 1024, (1,), (),
                                  (2, 4, 9)),
               fk.split_occupancy('score_sample_v1', 1024, (), (), (2, 4, 9)),
               fk.split_occupancy('score_sample_v1', 1024, (5,)),
               fk.split_occupancy('score_sample_v1', 1024, (3,), (),
                                  (6,) * 16)]
    for r in reports:
        assert r['threads_per_block'] == fk.SPLIT_THREADS
        assert r['blocks_per_sm'] >= 1 and r['registers'] > 0
        assert r['record_floats'] % fk.SPLIT_PACK == 0
    # [4 floats a nich column | cl, pad]
    assert [r['record_floats'] for r in reports] == [12, 8, 4, 24, 16]
    with pytest.raises(ValueError):
        fk.split_occupancy('score_sample_v1', 1024, (2,), sampling='cdf')


# -- samplers, the LowEntropy prior and the other moves ----------------------

def _z(x, mean, var):
    x = x.double()
    return abs(float(x.mean()) - mean) / (var / x.numel()) ** 0.5


@pytest.mark.parametrize('generator_on', ['cpu', 'cuda'])
def test_samplers_on_the_card(dev, generator_on):
    """Every sampler draws on the card from parameters on the card, with a
    generator on the CPU (one seed drawn from it) or on the card; moments
    z-tested against their closed forms, the same generator state giving
    the same draws."""
    from distributions_tpu_torch import random as rnd
    gen_dev = dev if generator_on == 'cuda' else 'cpu'

    def gen(seed=0):
        return torch.Generator(device=gen_dev).manual_seed(seed)
    n = 1 << 20
    t = lambda x: torch.tensor(x, device=dev)    # noqa: E731
    x = rnd.sample_gamma(gen(), t(2.5), 1.7, (n,))
    assert x.device.type == 'cuda' and _z(x, 4.25, 2.5 * 1.7 ** 2) < 5
    assert torch.equal(x, rnd.sample_gamma(gen(), t(2.5), 1.7, (n,)))
    assert _z(rnd.sample_beta(gen(1), t(0.5), 2.0, (n,)), 0.2,
              0.5 * 2 / (2.5 ** 2 * 3.5)) < 5
    assert _z(rnd.sample_chisq(gen(2), t(3.7), (n,)), 3.7, 7.4) < 5
    assert _z(rnd.sample_poisson(gen(3), t(3.3), (n,)), 3.3, 3.3) < 5
    nb = rnd.sample_negative_binomial(gen(4), t(0.4), 3, (n,))
    assert _z(nb, 4.5, 3 * 0.6 / 0.16) < 5
    dirich = rnd.sample_dirichlet(gen(5), t([0.5, 2.0, 3.5]), (n,))
    assert _z(dirich[:, 0], 0.5 / 6, (0.5 / 6) * (5.5 / 6) / 7) < 5
    w = rnd.sample_wishart(gen(6), 7.0, torch.eye(3, device=dev), (65536,))
    assert w.device.type == 'cuda' and _z(w[:, 0, 0], 7.0, 14.0) < 5
    iw = rnd.sample_inverse_wishart(gen(7), 10.0, 2 * torch.eye(2,
                                                               device=dev),
                                    (65536,))
    # E[X_00] = S_00 / (nu - d - 1), Var = 2 S_00^2 / ((nu - d - 1)^2
    # (nu - d - 3)) for the inverse Wishart's diagonal
    assert _z(iw[:, 0, 0], 2 / 7, 2 * 4 / (7 ** 2 * 5)) < 5
    k = rnd.sample_discrete(gen(8), t([0.1, 0.3, 0.05, 0.55]), (n,))
    assert _z(k == 3, 0.55, 0.55 * 0.45) < 5


def _card_problem(dev, R=512, C=32, kind='nich_gp_bb'):
    p = testing.mixed_problem(R, C, seed=2, kind=kind)
    spec, py, sh = testing.build_problem(p, MODULES, mx.make_spec,
                                         cl.PitmanYor.from_dict, device=dev)
    values = tuple(torch.from_numpy(v).to(dev) for v in p['values'])
    an = torch.from_numpy(p['labels']).to(dev)
    return spec, py, sh, values, an


def _consistent(spec, py, sh, values, st, an):
    fresh = mx.state_from_assignments(spec, py, sh, values, an)
    assert st.counts.device.type == 'cuda' and torch.equal(st.counts,
                                                           fresh.counts)
    s, f = float(mx.score_data(spec, py, sh, st)), float(
        mx.score_data(spec, py, sh, fresh))
    assert abs(s - f) <= 1e-4 * abs(f)


def test_moves_on_the_card(dev):
    """MH, split-merge (both), the sequential sweep and chains on the
    card: every move leaves the state equal to state_from_assignments of
    its assignments."""
    from distributions_tpu_torch.ops import mh, splitmerge
    spec, py, sh, values, an = _card_problem(dev)
    st = mx.state_from_assignments(spec, py, sh, values, an)
    g = torch.Generator().manual_seed(0)
    st, an = mh.sweep_mh(spec, py, sh, st, values, an, 128, 4, g)
    _consistent(spec, py, sh, values, st, an)
    for _ in range(5):
        st, an, _ = splitmerge.split_merge_move(spec, py, sh, st, values, an,
                                                g)
        st, an, _ = splitmerge.split_merge_restricted(spec, py, sh, st,
                                                      values, an, g)
    _consistent(spec, py, sh, values, st, an)
    st, an = gibbs.sweep_sequential(spec, py, sh, st, values, an, g)
    _consistent(spec, py, sh, values, st, an)
    A = torch.stack([an, torch.zeros_like(an)])
    states = gibbs.init_chains(spec, py, sh, values, A)
    states, A = gibbs.sweep_blocked_chains(
        spec, py, sh, states, values, A, 128,
        [torch.Generator().manual_seed(c) for c in range(2)])
    for c in range(2):
        _consistent(spec, py, sh, values, gibbs._chain_take(states, c), A[c])


def test_low_entropy_on_the_card(dev):
    """The LowEntropy prior through the fused sweep on the card (K2 on
    nich_gp_bb) equals the CPU twin path draw for draw in 'argmax';
    prior_init and the samplers of both priors run on the card."""
    spec, _, sh, values, an = _card_problem(dev)
    le = cl.LowEntropy.from_dict({'dataset_size': 512}, device=dev)
    outs = []
    for device in (dev, torch.device('cpu')):
        shd = tuple(type(s)(*(x.to(device) for x in s)) for s in sh)
        led = cl.LowEntropy(*(x.to(device) for x in le))
        v = tuple(x.to(device) for x in values)
        a = an.to(device)
        st = mx.state_from_assignments(spec, led, shd, v, a)
        cache = gibbs.build_stat_cache(spec, shd, v, 256, a)
        before = fk.fused_mixed_score_sample_stats.launches
        st, a, _ = gibbs.sweep_blocked_pallas_fused_mixed(
            spec, led, shd, st, v, a, 256, 256, torch.Generator(), cache,
            sampling='argmax')
        if device == dev:
            assert fk.fused_mixed_score_sample_stats.launches == before + 2
        outs.append(a.cpu())
    assert torch.equal(outs[0], outs[1])
    st, a = gibbs.prior_init(spec, le, sh, mx.init(spec, sh),
                             tuple(v[:64] for v in values),
                             torch.Generator().manual_seed(0))
    assert a.device.type == 'cuda' and int(st.counts.sum()) == 64
    py = cl.PitmanYor.from_dict(testing.PY, device=dev)
    g = torch.Generator().manual_seed(1)
    for sample in (cl.sample_assignments(g, le, 100, 16),
                   cl.sample_assignments(g, py, 4096, 64),
                   cl.py_sample_assignments_stick(g, py, 1 << 20, 1024)):
        assert sample.device.type == 'cuda' and sample.dtype == torch.int32


# -- the runner's sweeps replayed from CUDA graphs ----------------------------

def _bits_equal(a, b):
    """Every tensor of two nested results equal as bytes."""
    ta, tb = list(gibbs._tensors(tuple(a))), list(gibbs._tensors(tuple(b)))
    return len(ta) == len(tb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(
            x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
        for x, y in zip(ta, tb))


def _reset_graph_stats():
    gibbs.reset_graph_stats()
    gibbs.release_sweep_graphs()


@pytest.mark.parametrize('kernel', ['K1', 'K2'])
@pytest.mark.parametrize('sampling', ['gumbel', 'gumbel_fast', 'cdf',
                                      'argmax'])
def test_seed_pointer_is_the_seed(dev, kernel, sampling):
    """K1 and K2 with the seed in device memory equal the by-value launch
    bitwise, in the split walk ('gumbel', 'argmax') and the sequential one
    ('cdf'), for a seed whose top bit is set (the int64 tensor holds its
    bits)."""
    seed = 0xF123456789ABCDEF
    as_tensor = torch.tensor([seed - (1 << 64)], device=dev)
    if kernel == 'K1':
        v, cls, co = _inputs(dev, 3000, 1000)

        def launch(s):
            return fk.fused_score_sample_stats(s, v, cls, co, (2,),
                                               sampling=sampling)
    else:
        args, kwargs, _ = _mixed_inputs(dev, 'niw2mix', 3000, 1000)

        def launch(s):
            return fk.fused_mixed_score_sample_stats(s, *args,
                                                     sampling=sampling,
                                                     **kwargs)
    assert _bits_equal(launch(seed), launch(as_tensor))
    if sampling != 'argmax':
        assert not torch.equal(launch(seed)[0], launch(seed + 1)[0])
    with pytest.raises(ValueError, match='seed tensor'):
        launch(as_tensor.cpu())


def _graph_problem(dev, kind, R=4096, C=128):
    if kind == 'nich2':
        values, labels = testing.nich_problem(R, seed=3, n_clusters=40)
        spec = mx.make_spec([(nich, 2)], capacity=C)
        sh = (nich.shared_from_dict(testing.NICH_SHARED, device=dev),)
        py = cl.PitmanYor.from_dict(testing.PY, device=dev)
        tv = (torch.from_numpy(values).to(dev),)
        return spec, py, sh, tv, torch.from_numpy(labels).to(dev)
    p = testing.mixed_problem(R, C, seed=2, kind=kind, n_clusters=40)
    spec, py, sh = testing.build_problem(p, MODULES, mx.make_spec,
                                         cl.PitmanYor.from_dict, device=dev)
    return (spec, py, sh, tuple(torch.from_numpy(v).to(dev)
                                for v in p['values']),
            torch.from_numpy(p['labels']).to(dev))


@pytest.mark.parametrize('kind', ['nich2', 'niw2mix', 'niw4', 'bbddgp',
                                  'niw16'])
@pytest.mark.parametrize('sampling', ['gumbel', 'argmax', 'cdf'])
def test_graph_sweeps_equal_eager(dev, kind, sampling):
    """sweep_blocked_pallas_fused_mixed(n_sweeps=3, with_score=True)
    replayed from its CUDA graph equals the eager loop bitwise (state,
    assignments, cache, score).  The key's first call runs eagerly and
    captures nothing; the second runs its first sweep as the capture's
    warm-up and replays the other two; each counts tiles x sweeps kernel
    launches; niw4 (d = 4) captures torch.linalg's inverse and slogdet."""
    spec, py, sh, tv, an = _graph_problem(dev, kind)
    st = mx.state_from_assignments(spec, py, sh, tv, an)
    cache = gibbs.build_stat_cache(spec, sh, tv, 1024, an)
    wrapper = fk.fused_score_sample_stats if kind == 'nich2' \
        else fk.fused_mixed_score_sample_stats

    def run():
        return gibbs.sweep_blocked_pallas_fused_mixed(
            spec, py, sh, st, tv, an, 1024, 256,
            torch.Generator().manual_seed(5), cache, sampling=sampling,
            n_sweeps=3, with_score=True)
    _reset_graph_stats()
    before = wrapper.launches
    first = run()
    assert wrapper.launches == before + 4 * 3
    assert gibbs.GRAPH_STATS['first_uses'] == 1
    assert gibbs.GRAPH_STATS['captures'] == 0
    g = run()
    assert wrapper.launches == before + 2 * 4 * 3
    assert {k: gibbs.GRAPH_STATS[k] for k in ('captures', 'replays',
                                               'score_captures')} == {
        'captures': 1, 'replays': 2, 'score_captures': 1}
    g2 = run()
    assert gibbs.GRAPH_STATS['replays'] == 5
    assert gibbs.GRAPH_STATS['score_replays'] == 1
    with gibbs._eager_sweeps():
        e = run()
    assert _bits_equal(first, e)
    assert _bits_equal(g, e) and _bits_equal(g2, e)
    assert g[1].device.type == 'cuda'


def test_graph_fresh_seeds_and_no_aliasing(dev):
    """Two replays draw other seeds and other slots, each equal to the
    eager sweep from the same generator; what a call returned is not
    written by the next call.  (The key's first call runs eagerly, the
    second captures.)"""
    spec, py, sh, tv, an = _graph_problem(dev, 'nich2')
    st = mx.state_from_assignments(spec, py, sh, tv, an)
    cache = gibbs.build_stat_cache(spec, sh, tv, 1024, an)
    _reset_graph_stats()

    def call(st, an, cache, gen):
        return gibbs.sweep_blocked_pallas_fused(
            spec, py, sh, st, tv, an, 1024, 256, gen, cache,
            sampling='gumbel')
    gen, gen_e = torch.Generator().manual_seed(1), \
        torch.Generator().manual_seed(1)
    outs, seeds = [call(st, an, cache, gen)], []
    for _ in range(3):
        outs.append(call(st, an, cache, gen))
        seeds.append(gibbs._GRAPH['graph'].seeds.to('cpu', copy=True))
    assert gibbs.GRAPH_STATS['replays'] == 2
    assert not torch.equal(seeds[1], seeds[2])
    assert not torch.equal(outs[2][1], outs[3][1])
    with gibbs._eager_sweeps():
        for out in outs:
            assert _bits_equal(out, call(st, an, cache, gen_e))
    kept = [x.clone() for x in gibbs._tensors(outs[3])]
    call(*outs[3], gen)
    assert all(torch.equal(x, y)
               for x, y in zip(kept, gibbs._tensors(outs[3])))


def test_graph_host_modes_stay_eager(dev):
    """'gumbel_host' and 'cdf_host' never capture a graph, nor does a
    caller that passes its values on the host: each call copies them to
    new tensors, a key used once."""
    spec, py, sh, tv, an = _graph_problem(dev, 'nich2')
    st = mx.state_from_assignments(spec, py, sh, tv, an)
    cache = gibbs.build_stat_cache(spec, sh, tv, 1024, an)
    _reset_graph_stats()
    for sampling in ('gumbel_host', 'cdf_host') * 2:
        gibbs.sweep_blocked_pallas_fused_mixed(
            spec, py, sh, st, tv, an, 1024, 256,
            torch.Generator().manual_seed(5), cache, sampling=sampling,
            n_sweeps=2)
    assert gibbs.GRAPH_STATS['captures'] == 0
    assert gibbs.GRAPH_STATS['first_uses'] == 0
    host = tuple(v.cpu().numpy() for v in tv)
    for _ in range(3):
        gibbs.sweep_blocked_pallas_fused_mixed(
            spec, py, sh, st, host, an, 1024, 256,
            torch.Generator().manual_seed(5), cache, sampling='gumbel')
    assert gibbs.GRAPH_STATS['captures'] == 0
    assert gibbs.GRAPH_STATS['first_uses'] == 3
    assert gibbs._GRAPH['graph'] is None


def _runs(dev, **kw):
    """run_gibbs on nich2 on the graph path and under _eager_sweeps():
    both results, and the graph counters of the first."""
    from distributions_tpu_torch.inference import runner
    spec, py, sh, tv, an = _graph_problem(dev, 'nich2')
    kw = dict(dict(block=1024, use_pallas=True, sampling='gumbel',
                   initial_assignments=an, grow_headroom=0.0,
                   sweeps_per_step=2), **kw)
    spec = kw.pop('spec', spec)
    cl_model = kw.pop('cl_model', py)
    _reset_graph_stats()
    g = runner.run_gibbs(spec, cl_model, sh, tv,
                         torch.Generator().manual_seed(0), 6, **kw)
    stats = dict(gibbs.GRAPH_STATS)
    with gibbs._eager_sweeps():
        e = runner.run_gibbs(spec, cl_model, sh, tv,
                             torch.Generator().manual_seed(0), 6, **kw)
    rows = [[{k: v for k, v in r.items() if k not in diagnostics.CLOCK_KEYS}
             for r in x[2].rows] for x in (g, e)]
    assert _bits_equal(g[:2], e[:2]) and rows[0] == rows[1]
    return g, stats


def test_graph_runner_recaptures_on_growth(dev):
    """A run whose capacity doubles at a step edge captures a graph for
    each capacity and equals the eager run bitwise; the run frees its
    graph when it ends."""
    _, stats = _runs(dev, spec=mx.make_spec([(nich, 2)], capacity=32),
                     grow_headroom=0.5,
                     initial_assignments=torch.arange(
                         4096, device=dev).to(torch.int32) % 16)
    assert stats['captures'] == 2 and stats['replays'] == 4
    assert stats['first_uses'] == 0 and gibbs._GRAPH['graph'] is None


def test_graph_runner_hyper_moves_and_low_entropy(dev):
    """Hyper moves copy the new shareds and prior into the graph (one
    capture for the run), and the LowEntropy prior captures too; both
    equal their eager runs bitwise."""
    from distributions_tpu_torch.inference import hypers
    grid = nich.Shared(
        mu=torch.zeros(8, device=dev), kappa=torch.full((8,), 0.1,
                                                        device=dev),
        sigmasq=torch.logspace(-2, 0, 8, device=dev),
        nu=torch.ones(8, device=dev))
    cl_grid = hypers.make_py_grid([0.5, 1.0, 4.0], [0.0, 0.1, 0.3])
    g, stats = _runs(dev, hyper_grids={0: grid}, cl_grid=cl_grid,
                     hyper_every=2)
    assert stats['captures'] == 1 and stats['replays'] == 5
    assert stats['score_replays'] == 2
    _, stats = _runs(dev, cl_model=cl.LowEntropy.from_dict(
        {'dataset_size': 4096}, device=dev))
    assert stats['captures'] == 1 and stats['replays'] == 5


def test_graph_runner_rows_carry_device_and_tile_ms(dev):
    """On the graph path each step's row holds the card's timing marks:
    device_ms (CUDA events: load, sweeps a sweep, score, and from the
    second step on the edge from the step before) and tile 0's phases in
    the step's last sweep (the mark nodes in the graph, on for that
    replay); the capturing step is marked.  The run with those nodes in
    its graph equals the eager one bitwise (`_runs`)."""
    g, stats = _runs(dev)
    rows = g[2].rows
    assert len(rows) == 3
    assert rows[0].get('captured') is True
    assert not any('captured' in r for r in rows[1:])
    phases = gibbs._DeviceClock.PHASES
    for i, r in enumerate(rows):
        d = r['device_ms']
        assert all(d[k] > 0 for k in ('load', 'sweeps', 'score'))
        assert ('edge' in d) == (i > 0)
        assert d.get('edge', 0.0) >= 0
        t = r['tile_ms']
        assert set(t) == set(phases) | {'state_copy', 'sweep'}
        assert all(v > 0 for v in t.values()), t
        # a sweep of 4 tiles outlasts tile 0, and the step's last sweep
        # (the card's global timer) fits in its 2 sweeps (CUDA events)
        assert t['sweep'] > sum(t[p] for p in phases)
        assert t['sweep'] <= 2 * d['sweeps'] * 1.01
    assert stats['sweep_graph_nodes'] > 0


def test_graph_sweep_nodes_counted_at_each_capture(dev):
    """GRAPH_STATS['sweep_graph_nodes'] counts the captured sweep graph's
    nodes once a capture (never a replay), the same for two captures of
    one key; more tiles, more nodes.  The clock's 9 mark nodes stamp in a
    replay that switches them on, and in no other."""
    counts = []
    for R in (4096, 4096, 8192):
        spec, py, sh, tv, an = _graph_problem(dev, 'nich2', R=R)
        st = mx.state_from_assignments(spec, py, sh, tv, an)
        cache = gibbs.build_stat_cache(spec, sh, tv, 1024, an)
        _reset_graph_stats()
        with gibbs.sweep_graph_session():
            for _ in range(2):
                gibbs.sweep_blocked_pallas_fused_mixed(
                    spec, py, sh, st, tv, an, 1024, 256,
                    torch.Generator().manual_seed(5), cache,
                    sampling='gumbel', n_sweeps=2, with_score=True)
            assert gibbs.GRAPH_STATS['captures'] == 1
            assert gibbs.GRAPH_STATS['replays'] == 3
            graph = gibbs._GRAPH['graph']
            assert len(graph.marks) == gibbs._DeviceClock.MARKS
            stamps = graph.clock.stamps
            seeds = torch.arange(R // 1024, dtype=torch.int64)
            for marks in (False, True):
                stamps.zero_()
                graph.sweep(seeds, marks=marks)
                torch.cuda.synchronize(dev)
                t = stamps.tolist()
                if marks:
                    assert all(0 < a <= b for a, b in zip(t, t[1:])), t
                else:
                    assert not any(t)
        counts.append(gibbs.GRAPH_STATS['sweep_graph_nodes'])
    # tile 0's mark nodes and each tile's operations
    assert counts[0] > gibbs._DeviceClock.MARKS and counts[0] == counts[1]
    assert counts[2] > counts[0]


# -- the sharded fused sweeps replayed from CUDA graphs -----------------------

@pytest.mark.parametrize('sampling', ['gumbel', 'gumbel_fast', 'argmax'])
def test_k3_seed_pointer_is_the_seed(dev, sampling):
    """K3 with the seed in device memory equals the by-value launch
    bitwise, at an odd slot offset, for a seed whose top bit is set; the
    slots are K2's of test_seed_pointer_is_the_seed, where other seeds
    draw other slots."""
    seed = 0xF123456789ABCDEF
    as_tensor = torch.tensor([seed - (1 << 64)], device=dev)
    args, kwargs, _ = _mixed_inputs(dev, 'niw2mix', 3000, 1000)
    s_args, s_kwargs = _slot_slice(args, kwargs, 0, 1000)

    def launch(s):
        return fk.fused_score_sample_pair(s, *s_args, sampling=sampling,
                                          slot_offset=201, **s_kwargs)
    assert _bits_equal(launch(seed), launch(as_tensor))
    if sampling != 'argmax':
        assert not torch.equal(launch(seed)[0], launch(seed + 1)[0])
    with pytest.raises(ValueError, match='seed tensor'):
        launch(as_tensor.cpu())


def _check_replays(run, wrapper, per_call, sweeps, score):
    """run() three times on the graph path and once eagerly: the first
    call eager (the key's first use), the second captures at its first
    sweep and replays the rest, the third replays; every call counts
    `per_call` launches and all four results are bitwise equal."""
    _reset_graph_stats()
    before = wrapper.launches
    first = run()
    assert wrapper.launches == before + per_call
    assert gibbs.GRAPH_STATS['first_uses'] == 1
    assert gibbs.GRAPH_STATS['captures'] == 0
    g = run()
    g2 = run()
    assert wrapper.launches == before + 3 * per_call
    assert {k: gibbs.GRAPH_STATS[k] for k in (
        'captures', 'replays', 'score_captures', 'score_replays')} == {
        'captures': 1, 'replays': 2 * sweeps - 1,
        'score_captures': int(score), 'score_replays': int(score)}
    with gibbs._eager_sweeps():
        e = run()
    assert _bits_equal(first, e)
    assert _bits_equal(g, e) and _bits_equal(g2, e)
    return g


@pytest.mark.parametrize('kind', ['nich2', 'niw2mix'])
@pytest.mark.parametrize('sampling', ['gumbel', 'argmax', 'cdf'])
def test_graph_sharded_sweeps_equal_eager(dev, kind, sampling):
    """sharded_sweep_fused on 4 row shards, n_sweeps=3 with the score,
    replayed from its CUDA graph equals the eager loop bitwise (state,
    assignments, cache, score); each sweep launches shards x tiles
    kernels."""
    from distributions_tpu_torch.parallel import sharding
    spec, py, sh, tv, an = _graph_problem(dev, kind)
    st = mx.state_from_assignments(spec, py, sh, tv, an)
    cache = gibbs.build_stat_cache(spec, sh, tv, 256, an)
    mesh = sharding.make_mesh(4)
    wrapper = fk.fused_score_sample_stats if kind == 'nich2' \
        else fk.fused_mixed_score_sample_stats

    def run():
        return sharding.sharded_sweep_fused(
            spec, py, sh, st, tv, an, torch.Generator().manual_seed(5),
            mesh, 256, cache, block_rows=256, sampling=sampling, n_sweeps=3,
            with_score=True)
    g = _check_replays(run, wrapper, 16 * 3, 3, True)
    assert g[1].device.type == 'cuda' and g[1].dtype == torch.int32


@pytest.mark.parametrize('sampling', ['gumbel', 'argmax'])
def test_graph_2d_fused_equals_eager(dev, sampling):
    """sharded_sweep_2d_fused on 2 x 2 (niw2mix) replayed from its CUDA
    graph equals the eager sweep bitwise, K3 reading its seed from the
    table; a full state is cut and joined outside the graph, so it
    replays the same graph."""
    from distributions_tpu_torch.parallel import sharding
    spec, py, sh, tv, an = _graph_problem(dev, 'niw2mix')
    st = mx.state_from_assignments(spec, py, sh, tv, an)
    mesh = sharding.make_mesh_2d(2, 2)
    sts = sharding.shard_state_components(st, mesh)

    def run(state=sts):
        out = sharding.sharded_sweep_2d_fused(
            spec, py, sh, state, tv, an, torch.Generator().manual_seed(5),
            mesh, 512, block_rows=256, sampling=sampling)
        return (tuple(out[0]) if isinstance(out[0], list) else out[0],
                out[1])
    g = _check_replays(run, fk.fused_score_sample_pair, 4 * 4, 1, False)
    full = run(st)
    assert gibbs.GRAPH_STATS['replays'] == 2
    assert _bits_equal((full[0], full[1]), (
        sharding.unshard_state_components(list(g[0]), mesh), g[1]))


def test_graph_mesh_runner_replays(dev):
    """run_gibbs(mesh=2 row shards) replays every sweep after its first
    from the CUDA graph, equal to the eager run bitwise; a run whose
    capacity doubles captures a graph for each capacity; the run frees
    its graph when it ends."""
    from distributions_tpu_torch.parallel import sharding
    _, stats = _runs(dev, mesh=sharding.make_mesh(2))
    assert stats['captures'] == 1 and stats['replays'] == 5
    assert stats['score_captures'] == 1 and stats['score_replays'] == 2
    assert stats['first_uses'] == 0 and gibbs._GRAPH['graph'] is None
    _, stats = _runs(dev, mesh=sharding.make_mesh(2),
                     spec=mx.make_spec([(nich, 2)], capacity=32),
                     grow_headroom=0.5,
                     initial_assignments=torch.arange(
                         4096, device=dev).to(torch.int32) % 16)
    assert stats['captures'] == 2 and stats['replays'] == 4
    assert gibbs._GRAPH['graph'] is None


def test_graph_plain_mesh_and_v1_sweeps_stay_eager(dev):
    """The plain mesh sweeps capture nothing on the card, by the rule
    `_graph_refusal` names ('plain'); the v1 sweeps, which stayed eager
    before they were graphed, are held to their graphs by
    test_graph_v1_sweeps_equal_eager."""
    from distributions_tpu_torch.parallel import sharding
    spec, py, sh, tv, an = _graph_problem(dev, 'nich2')
    st = mx.state_from_assignments(spec, py, sh, tv, an)
    _reset_graph_stats()
    for _ in range(2):
        gen = torch.Generator().manual_seed(1)
        sharding.sharded_sweep_blocked(spec, py, sh, st, tv, an, gen,
                                       sharding.make_mesh(2), 512)
        sharding.sharded_sweep_2d(spec, py, sh, st, tv, an, gen,
                                  sharding.make_mesh_2d(2, 2), 512)
        sharding.sharded_sweep_components(spec, py, sh, st, tv, an, gen,
                                          sharding.make_component_mesh(2),
                                          512)
    assert all(v == 0 for k, v in gibbs.GRAPH_STATS.items()
               if k not in ('spans', 'stat_plan'))
    assert not gibbs.GRAPH_STATS['spans']
    assert not gibbs.GRAPH_STATS['stat_plan']
    assert gibbs._GRAPH['graph'] is None and gibbs._GRAPH['seen'] is None
    assert gibbs._graph_refusal(dev, 'gumbel', 'plain') \
        == gibbs._EAGER_SWEEPS['plain']
    assert 'v1' not in gibbs._EAGER_SWEEPS
    for kind in ('v1', 'blocked', 'chains'):
        assert gibbs._graph_refusal(dev, 'gumbel', kind) is None


def test_graph_process_group_mesh(dev):
    """A NCCL group of one rank: sharded_sweep_fused on the global mesh
    replays its CUDA graph (the eager first call makes the communicator
    before the capture) and equals its eager loop and the single-device
    fused sweep bitwise."""
    import socket
    from distributions_tpu_torch.parallel import distributed, sharding
    spec, py, sh, tv, an = _graph_problem(dev, 'nich2')
    st = mx.state_from_assignments(spec, py, sh, tv, an)
    cache = gibbs.build_stat_cache(spec, sh, tv, 1024, an)
    s = socket.socket()
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
    s.close()
    distributed.initialize('localhost:%d' % port, 1, 0, timeout=120)
    try:
        mesh = distributed.make_global_mesh()

        def run():
            return sharding.sharded_sweep_fused(
                spec, py, sh, st, tv, an, torch.Generator().manual_seed(5),
                mesh, 1024, cache, block_rows=256, sampling='gumbel',
                n_sweeps=3, with_score=True)
        g = _check_replays(run, fk.fused_score_sample_stats, 4 * 3, 3, True)
        torch.cuda.synchronize()
    finally:
        gibbs.release_sweep_graphs()
        distributed.shutdown()
    one = gibbs.sweep_blocked_pallas_fused_mixed(
        spec, py, sh, st, tv, an, 1024, 256,
        torch.Generator().manual_seed(5), cache, sampling='gumbel',
        n_sweeps=3, with_score=True)
    with gibbs._eager_sweeps():
        one_e = gibbs.sweep_blocked_pallas_fused_mixed(
            spec, py, sh, st, tv, an, 1024, 256,
            torch.Generator().manual_seed(5), cache, sampling='gumbel',
            n_sweeps=3, with_score=True)
    assert _bits_equal(one, one_e) and _bits_equal(g, one)


# -- the v1 and plain sweeps replayed from CUDA graphs ------------------------

@pytest.mark.parametrize('kernel', ['K4', 'K5'])
@pytest.mark.parametrize('sampling', ['gumbel', 'argmax', 'gumbel_host'])
def test_v1_seed_pointer_is_the_seed(dev, kernel, sampling):
    """K4 and K5 with the seed in device memory equal the by-value launch
    bitwise, for a seed whose top bit is set; another seed draws other
    slots in 'gumbel'; a seed tensor on the host is refused."""
    seed = 0xF123456789ABCDEF
    as_tensor = torch.tensor([seed - (1 << 64)], device=dev)
    nv, idx, cls, co, tab = testing.v1_random_inputs(3000, 1000, 2, 3,
                                                     seed=8, device=dev)
    noise = None
    if sampling == 'gumbel_host':
        noise = -torch.log(-torch.log(torch.rand(
            3000, 1000, device=dev).clamp(min=1e-30)))

    def launch(s):
        if kernel == 'K4':
            return fk.nich_score_sample(s, nv, cls, co, sampling=sampling,
                                        noise=noise)
        return fk.mixed_score_sample(s, nv, idx, cls, co, tab,
                                     sampling=sampling, noise=noise)
    assert torch.equal(launch(seed), launch(as_tensor))
    if sampling == 'gumbel':
        assert not torch.equal(launch(seed), launch(seed + 1))
    with pytest.raises(ValueError, match='seed tensor'):
        launch(as_tensor.cpu())


def _chained(one, start, n=3, seed=5):
    gen = torch.Generator().manual_seed(seed)
    out = start
    for _ in range(n):
        out = one(*out, gen)
    return out


def _check_chained_replays(one, start, wrapper, per_sweep):
    """Three chained one-sweep calls twice on the graph path (the key's
    first call eager, the second captures, every later one replays) and
    once eagerly: `per_sweep` launches of `wrapper` a sweep (None: no
    kernel), all three results bitwise equal."""
    _reset_graph_stats()
    before = 0 if wrapper is None else wrapper.launches
    g = _chained(one, start)
    assert {k: gibbs.GRAPH_STATS[k] for k in (
        'first_uses', 'captures', 'replays')} == {
        'first_uses': 1, 'captures': 1, 'replays': 1}
    g2 = _chained(one, start)
    assert gibbs.GRAPH_STATS['replays'] == 4
    if wrapper is not None:
        assert wrapper.launches == before + 6 * per_sweep
    with gibbs._eager_sweeps():
        e = _chained(one, start)
    assert _bits_equal(g, e) and _bits_equal(g2, e)
    assert g[1].device.type == 'cuda' and g[1].dtype == torch.int32
    return g


@pytest.mark.parametrize('case,sampling', [
    ('K4', 'gumbel'), ('K4', 'argmax'), ('K5', 'gumbel'), ('K5', 'argmax'),
    ('xla', 'gumbel')])
def test_graph_v1_sweeps_equal_eager(dev, case, sampling):
    """sweep_blocked_pallas (K4, nich2) and sweep_blocked_pallas_mixed (K5
    and 'xla', nichbbddgp) replayed from their CUDA graph equal the eager
    loop bitwise over three chained sweeps, with a K4 / K5 launch a tile
    counted at every replay; 'xla' draws from the graph's registered
    generator and stays sweep_blocked bitwise."""
    kind = 'nich2' if case == 'K4' else 'nichbbddgp'
    spec, py, sh, tv, an = _graph_problem(dev, kind)
    st = mx.state_from_assignments(spec, py, sh, tv, an)

    def one(st, an, gen):
        if case == 'K4':
            return gibbs.sweep_blocked_pallas(spec, py, sh, st, tv, an, 1024,
                                              generator=gen,
                                              sampling=sampling)
        return gibbs.sweep_blocked_pallas_mixed(
            spec, py, sh, st, tv, an, 1024, gen,
            backend='xla' if case == 'xla' else 'pallas', sampling=sampling)
    wrapper = {'K4': fk.nich_score_sample, 'K5': fk.mixed_score_sample,
               'xla': None}[case]
    g = _check_chained_replays(one, (st, an), wrapper, 4)
    if case == 'xla':
        with gibbs._eager_sweeps():
            want = _chained(lambda st, an, gen: gibbs.sweep_blocked(
                spec, py, sh, st, tv, an, 1024, generator=gen), (st, an))
        assert _bits_equal(g, want)


@pytest.mark.parametrize('kind', ['nich2', 'niw2mix'])
def test_graph_plain_sweeps_equal_eager(dev, kind):
    """sweep_blocked replayed from its CUDA graph (the tiles drawing from
    the graph's registered device generator, reseeded before each replay)
    equals the eager loop bitwise over three chained sweeps, at the
    runner's default 4096-row tiles on nich2 and 1024 on niw2mix."""
    spec, py, sh, tv, an = _graph_problem(dev, kind, R=8192)
    st = mx.state_from_assignments(spec, py, sh, tv, an)
    block = 4096 if kind == 'nich2' else 1024

    def one(st, an, gen):
        return gibbs.sweep_blocked(spec, py, sh, st, tv, an, block,
                                   generator=gen)
    _check_chained_replays(one, (st, an), None, 0)


def test_graph_chains_equal_each_chain(dev):
    """sweep_blocked_chains, all 4 chains in one replay a sweep, equals
    the eager chains bitwise, and chain c equals sweep_blocked with its
    own generator."""
    spec, py, sh, tv, an = _graph_problem(dev, 'nich2')
    A = torch.stack([an, (an + 1) % 64, an % 8, torch.zeros_like(an)])
    states = gibbs.init_chains(spec, py, sh, tv, A)

    def run():
        gens = [torch.Generator().manual_seed(10 + c) for c in range(4)]
        out = (states, A)
        for _ in range(3):
            out = gibbs.sweep_blocked_chains(spec, py, sh, out[0], tv,
                                             out[1], 1024, gens)
        return out
    _reset_graph_stats()
    g = run()
    assert gibbs.GRAPH_STATS['captures'] == 1
    assert gibbs.GRAPH_STATS['replays'] == 1
    with gibbs._eager_sweeps():
        e = run()
        for c in range(4):
            one = _chained(lambda st, a, gen: gibbs.sweep_blocked(
                spec, py, sh, st, tv, a, 1024, generator=gen),
                (gibbs._chain_take(states, c), A[c]), seed=10 + c)
            assert _bits_equal((gibbs._chain_take(g[0], c), g[1][c]), one)
    assert _bits_equal(g, e)


def test_graph_plain_runner_replays(dev):
    """run_gibbs(use_pallas=False) replays every sweep after its first
    from the CUDA graph, a step's two sweeps in one call and its score
    from the score graph, equal to the eager run bitwise (logger rows
    included); the run frees its graph when it ends."""
    _, stats = _runs(dev, use_pallas=False)
    assert stats['captures'] == 1 and stats['replays'] == 5
    assert stats['score_captures'] == 1 and stats['score_replays'] == 2
    assert stats['first_uses'] == 0 and gibbs._GRAPH['graph'] is None


def test_graph_v1_runner_replays(dev, monkeypatch):
    """The runner's v1 fallback (the fused gate closed by hand: K4 on
    nich2) replays every sweep after its first, bitwise its eager run."""
    monkeypatch.setattr(fk, 'supports_mixed_pallas', lambda spec: False)
    before = fk.nich_score_sample.launches
    _, stats = _runs(dev)
    assert stats['captures'] == 1 and stats['replays'] == 5
    assert stats['score_captures'] == 1 and stats['score_replays'] == 2
    assert fk.nich_score_sample.launches == before + 2 * 4 * 6


# -- the stat stage of K1 and K2 (csrc/fused_stats.cuh) -----------------------

def _stat_slots(dev, kind, B, C):
    """int32 [B] on the card: every row in one slot, uniform slots,
    Pitman-Yor {alpha 1, d 0.1} stick-breaking weights cut to C, or a
    quarter of the rows outside [0, C) (some far out)."""
    g = torch.Generator().manual_seed(B + C)
    if kind == 'one':
        a = torch.full((B,), C // 3, dtype=torch.int32)
    elif kind == 'uniform':
        a = torch.randint(0, C, (B,), generator=g, dtype=torch.int32)
    elif kind == 'pitman_yor':
        rng = np.random.RandomState(B + C)
        v = rng.beta(0.9, 1.0 + 0.1 * np.arange(1, C + 1))
        w = v * np.concatenate([[1.0], np.cumprod(1.0 - v)[:-1]])
        a = torch.from_numpy(rng.choice(C, B, p=w / w.sum()).astype(
            np.int32))
    else:
        a = torch.randint(-C // 8, C + C // 8, (B,), generator=g,
                          dtype=torch.int32)
        a[::7] = -1000000
        a[1::11] = C + 100000
    return a.to(dev)


def _stage_holds(launch, plain, exact=()):
    """The stage against its twin (float sums within SUM_RTOL / SUM_ATOL,
    the outputs in `exact` equal), twice bitwise, and a CUDA graph replay
    of it bitwise an eager launch."""
    got, want = launch(), plain()
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape
        if i in exact:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=SUM_RTOL, atol=SUM_ATOL)
    assert all(torch.equal(a, b) for a, b in zip(got, launch()))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = launch()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, replayed))


STAT_KINDS = ('one', 'uniform', 'pitman_yor', 'outside')


@pytest.mark.parametrize('B,C', [(4096, 1024), (3001, 1000), (131072 - 77,
                                                              1024),
                                 (65536, 8192), (257, 2500)])
@pytest.mark.parametrize('kind', STAT_KINDS)
def test_stat_stage_k1_matches_twin(dev, kind, B, C):
    v = torch.randn((B, 2), generator=torch.Generator().manual_seed(B)).to(
        dev)
    a = _stat_slots(dev, kind, B, C)
    before = bk.stat_sums.launches
    _stage_holds(lambda: (bk.stat_sums(v, a, C),),
                 lambda: (bk.stat_sums_plain(v, a, C),))
    assert bk.stat_sums.launches == before + 3


@pytest.mark.parametrize('B,C', [(4096, 1024), (3001, 1000), (65536, 8192),
                                 (257, 2500)])
@pytest.mark.parametrize('kind', STAT_KINDS)
@pytest.mark.parametrize('layout', sorted(SPLIT_LAYOUTS) + ['tables'])
def test_stat_stage_k2_matches_twin(dev, layout, kind, B, C):
    """K2's layouts of the split-walk tests, and table columns alone (no
    float sums); count tables exact."""
    groups, quads, tvs = SPLIT_LAYOUTS.get(layout, ((), (), (2, 7, 3)))
    args, kwargs = _rand_layout(dev, B, C, groups, quads, tvs, seed=B)
    values, table_idx = args[0], args[1]
    a = _stat_slots(dev, kind, B, C)
    call = (values, kwargs['qvalues'], table_idx, a, C, groups, quads, tvs)
    _stage_holds(lambda: bk.mixed_stat_sums(*call),
                 lambda: bk.mixed_stat_sums_plain(*call), exact=(1,))


def test_stat_stage_plans_and_shared_memory_opt_in(dev):
    """The C plan's blocks are stat_blocks' (which sizes the partials);
    the main path's tiles and 8192 slots take more than the 48 KB of
    shared memory a block gets without opting in, and 8192 slots walk the
    staged rows in chunks of 1024."""
    for B in (1, 33, 3001, 16384, 65536, 131072, 131073, 1048576):
        assert fk.stat_plan('fused_v2', B, 1024, (2,))['blocks'] == \
            fk.stat_blocks(B)
    p = fk.stat_plan('fused_v2', 131072, 1024, (2,))
    assert (p['warps'], p['chunk_slots'], p['rows_per_block']) == \
        (8, 1024, 1024)
    assert p['smem_bytes'] > 48 * 1024
    q = fk.stat_plan('fused_v3', 65536, 1024, (1,), ((1, 2),), (2,))
    assert (q['warps'], q['tables_in_shared']) == (4, 1)
    r = fk.stat_plan('fused_v2', 65536, 8192, (2,))
    assert r['chunk_slots'] == 1024 and r['smem_bytes'] > 48 * 1024
    v = torch.randn((65536, 2), device=dev)
    a = _stat_slots(dev, 'uniform', 65536, 8192)
    torch.testing.assert_close(bk.stat_sums(v, a, 8192),
                               bk.stat_sums_plain(v, a, 8192),
                               rtol=SUM_RTOL, atol=SUM_ATOL)


def test_stat_stage_niw16(dev):
    """niw16's 153 float features a row fit the stat stage's plan: at the
    cell's tile (131,072 rows, 1024 slots) one warp a block in chunks of
    256 slots, and 65,536 rows at 8192 slots; against the twin, and a
    graph replay bitwise."""
    p = fk.stat_plan('fused_v3', 131072, 1024, (), ((1, 16),), ())
    assert (p['warps'], p['chunk_slots']) == (1, 256)
    for B, C, kind in ((131072, 1024, 'pitman_yor'), (65536, 8192,
                                                      'uniform')):
        args, kwargs = _rand_layout(dev, B, C, (), ((1, 16),), (), seed=C)
        a = _stat_slots(dev, kind, B, C)
        call = (None, kwargs['qvalues'], None, a, C, (), ((1, 16),), ())
        _stage_holds(lambda: bk.mixed_stat_sums(*call),
                     lambda: bk.mixed_stat_sums_plain(*call), exact=(1,))


def test_niw16_run_marks_its_coefficients(dev):
    """run_gibbs on one niw column of d = 16: every launch takes the niw16
    shape, the sweep graph holds the clock's two niw marks beside its
    nine, the capture records the stat stage's plan, and the step
    rows time the niw coefficients inside the tiles' inputs."""
    from distributions_tpu_torch.inference import runner
    p = testing.mixed_problem(8192, 256, seed=3, kind='niw16',
                              n_clusters=40)
    spec, py, sh = testing.build_problem(p, MODULES, mx.make_spec,
                                         cl.PitmanYor.from_dict, device=dev)
    tv = tuple(torch.from_numpy(v).to(dev) for v in p['values'])
    counts = fk.fused_mixed_score_sample_stats.shape_launches
    before = dict(counts)
    _reset_graph_stats()
    _, _, log = runner.run_gibbs(
        spec, py, sh, tv, torch.Generator().manual_seed(2), 6, block=1024,
        use_pallas=True, grow_headroom=0.0, sampling='gumbel',
        sweeps_per_step=2, initial_assignments=torch.from_numpy(
            p['labels']).to(dev), device=dev)
    assert set(counts) - set(before) <= {'niw16'}
    assert counts['niw16'] > before.get('niw16', 0)
    assert all(counts[k] == before[k] for k in before if k != 'niw16')
    plan = gibbs.GRAPH_STATS['stat_plan']
    assert plan['warps'] >= 1 and plan['chunks'] * plan['chunk_slots'] >= 256
    rows = [r['tile_ms'] for r in log.rows if 'tile_ms' in r]
    assert rows and all(0 < t['niw_coeffs'] <= t['inputs'] for t in rows)


@pytest.mark.parametrize('sampling', ['gumbel', 'argmax', 'cdf'])
def test_stat_stage_inside_k1_and_k2_is_the_stage_alone(dev, sampling):
    """K1's and K2's sums are, bitwise, the stage alone on their draws."""
    v, cls, co = _inputs(dev, 65536, 1024)
    a, s = fk.fused_score_sample_stats(7, v, cls, co, (2,),
                                       sampling=sampling)
    assert torch.equal(s, bk.stat_sums(v, a, 1024))
    args, kwargs, _ = _mixed_inputs(dev, 'niw2mix', 65536, 1024)
    out = fk.fused_mixed_score_sample_stats(7, *args, sampling=sampling,
                                            **kwargs)
    alone = bk.mixed_stat_sums(args[0], kwargs['qvalues'], args[1], out[0],
                               1024, args[5], kwargs['quad_groups'],
                               kwargs['table_vs'])
    assert all(torch.equal(x, y) for x, y in zip(alone, out[1:]))


def test_stat_stage_wrappers_reject_bad_inputs(dev):
    v = torch.randn((512, 2), device=dev)
    a = torch.zeros(512, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        bk.stat_sums(v, a.long(), 64)
    with pytest.raises(ValueError):
        bk.stat_sums(v[:-1], a, 64)
    with pytest.raises(ValueError):
        bk.mixed_stat_sums(v, None, None, a, 64, (2,))


# -- niw's score for a scale that is not positive definite -------------------

def test_niw_non_pd_scale_gives_non_finite_scores_on_the_card(dev):
    """models/niw.py factors the predictive scale with cholesky_ex, which
    reads no status: a scale that is not positive definite gives
    non-finite score rows, as the JAX package's all-NaN factor does, and
    raises nothing (ROADMAP Queue 3 item 21)."""
    from distributions_tpu_torch.models import niw
    raw = {'mu': [0.0, 0.0], 'kappa': 1.0, 'psi': [[1.0, 2.0], [2.0, 1.0]],
           'nu': 3.0}
    shared = niw.shared_from_dict(raw, device=dev)
    group = niw.group_init(shared, (3,))
    values = torch.randn((5, 2), device=dev)
    scores = niw.score_value_batch(shared, group, values)
    torch.cuda.synchronize()
    assert scores.shape == (5, 3)
    assert not torch.isfinite(scores).any()
    one = niw.score_value(shared, group, values[0])
    assert not torch.isfinite(one).any()
    # a positive definite scale beside it stays finite
    good = niw.shared_from_dict(dict(raw, psi=[[2.0, 1.0], [1.0, 2.0]]),
                                device=dev)
    assert torch.isfinite(niw.score_value_batch(
        good, niw.group_init(good, (3,)), values)).all()


# -- the JAX package's documented configurations: 8192 slots, the bb layout --

# bench.py's BENCH_COMPONENTS=8192: the slot axis staged in turns (K1's
# nich2 record, 8 floats, holds 896 slots a turn: 10 turns), Philox words
# of slots g >= 4096 (counter words q = g / 4 >= 1024)
REF_SLOTS = 8192
REF_B = (3000, 16384 + 5)


@pytest.mark.parametrize('B', REF_B)
@pytest.mark.parametrize('groups', [(2,), (1,)], ids=str)
def test_reference_k1_at_8192_slots(dev, groups, B):
    """K1 (and B5 on its split walk) on nich2 and on the one-column exact
    shape at 8192 slots: the twin's draws in 'argmax' and 'gumbel_host',
    its sums, and 'gumbel' on its own Philox noise."""
    _check_k1_and_b5(dev, B, REF_SLOTS, groups)


@pytest.mark.parametrize('B', REF_B)
def test_reference_k4_at_8192_slots(dev, B):
    _check_v1(dev, 'K4', B, REF_SLOTS, 2, 0)


@pytest.mark.parametrize('C', [1024, REF_SLOTS])
@pytest.mark.parametrize('B', REF_B)
def test_reference_k2_bb_layout(dev, B, C):
    """K2 on the bb runner's layout: one table column of support 2, no
    float feature (the folded shape; the stat stage with no float sums,
    the count table alone), against its twin and its Philox noise."""
    args, kwargs = _rand_layout(dev, B, C, (), (), (2,), seed=B + C)
    noise = _noise(dev, 'gumbel_host', B, C)
    for sampling, nz in (('argmax', None), ('gumbel_host', noise)):
        got = fk.fused_mixed_score_sample_stats(3, *args, sampling=sampling,
                                                noise=nz, **kwargs)
        want = fk.fused_mixed_score_sample_stats_plain(
            3, *args, sampling=sampling, noise=nz, **kwargs)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w), sampling
    # the count table [C, V], float counts; no float sums
    assert got[2].shape == (C, 2) and int(got[2].sum()) == B
    assert got[1].numel() == got[3].numel() == 0
    _gumbel_is_philox(
        lambda m, nz: fk.fused_mixed_score_sample_stats(
            9, *args, sampling=m, noise=nz, **kwargs)[0],
        _scores(args, kwargs), 9, B, C)


@pytest.mark.parametrize('groups', [(2,), ()], ids=['nich2', 'bb'])
def test_reference_k3_last_shard_of_8192(dev, groups):
    """K3 on the 2 x 4 mesh's last slot shard at 8192 slots: 2048 slots at
    offset 6144, against its twin and its Philox noise at that offset."""
    B, C = 16384 + 5, REF_SLOTS
    a, b = 3 * C // 4, C
    args, kwargs = _rand_layout(dev, B, C, groups, (), () if groups else (2,),
                                seed=7)
    args, kwargs = _slot_slice(args, kwargs, a, b)
    kwargs.update(slot_offset=a, total_slots=C)
    noise = _noise(dev, 'gumbel_host', B, b - a)
    for sampling, nz in (('argmax', None), ('gumbel_host', noise)):
        got = fk.fused_score_sample_pair(3, *args, sampling=sampling,
                                         noise=nz, **kwargs)
        want = fk.fused_score_sample_pair_plain(3, *args, sampling=sampling,
                                                noise=nz, **kwargs)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _gumbel_is_philox(
        lambda m, nz: fk.fused_score_sample_pair(
            9, *args, sampling=m, noise=nz, **kwargs)[0],
        _scores(args, kwargs), 9, B, b - a, a)
