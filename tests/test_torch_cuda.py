"""The CUDA kernels K1 and K2 against their plain twins, on the card.
Every test here needs an NVIDIA GPU and skips without one.  On a machine
with a GPU and no JAX, run them with

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from distributions_tpu_torch import clustering as cl, mixture as mx, testing
from distributions_tpu_torch.models import MODULES, nich
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
    ('bnb', 1024, 128), ('niw2mix', 4096, 1024), ('bbddgp', 4096, 1024)])
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
