"""The plain twins of the measurement kernels B1-B5
(distributions_tpu_torch/ops/bench_kernels.py) against the JAX package's
bodies run on the CPU (benchmarks/roofline.py's `_chain_kernel` in
interpret mode and `_mxu_kernel`'s arithmetic, `pallas_kernels.
_score_nich_product`, K1 in interpret mode) and against closed forms.  On
CPU tensors every wrapper runs its twin; the CUDA kernels are held to the
same twins by tests/test_torch_cuda.py on the card."""

import functools
import importlib.util
import os
import re
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from distributions_tpu import clustering as jcl, mixture as jmx
from distributions_tpu.models import nich as jnich
from distributions_tpu.ops import pallas_kernels as pk
from distributions_tpu_torch import clustering as tcl, config, convert
from distributions_tpu_torch import testing
from distributions_tpu_torch.models import nich as tnich
from distributions_tpu_torch.ops import bench_kernels as bk
from distributions_tpu_torch.ops import fused_kernels as fk

torch.set_num_threads(1)
config.set_default_device('cpu')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def jroofline():
    """benchmarks/roofline.py of the JAX package, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        'jax_roofline', os.path.join(ROOT, 'benchmarks', 'roofline.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# -- B2 ------------------------------------------------------------------------

@pytest.mark.parametrize('op', ['add', 'mul', 'fma', 'log', 'exp', 'log1p',
                                'rsqrt'])
def test_chain_twin_matches_jax_kernel(jroofline, op):
    x = np.abs(np.random.RandomState(0).randn(8, 128)).astype(np.float32) \
        + 0.5
    T, K = 3, 2
    want = pl.pallas_call(
        functools.partial(jroofline._chain_kernel, T=T, K=K, op_name=op),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True)(jnp.asarray(x))
    got = bk.roofline_chain(torch.from_numpy(x), op, T, K)
    # the same chain in f32; XLA and PyTorch round log / exp / rsqrt apart
    # by ulps, and XLA may or may not fuse the multiply-add
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize('op,ref', [('fast_log', 'log'), ('fast_exp', 'exp')])
def test_chain_fast_ops_follow_the_accurate_ones(op, ref):
    x = torch.rand((8, 128), generator=torch.Generator().manual_seed(1)) + 0.5
    for K in bk.CHAIN_DEPTHS:
        # fast_log is 5.7e-7 absolute, fast_exp 2.3e-7 relative, per level
        torch.testing.assert_close(bk.roofline_chain(x, op, 2, K),
                                   bk.roofline_chain(x, ref, 2, K),
                                   rtol=1e-5, atol=1e-5)


def test_chain_closed_form_and_checks():
    x = torch.full((4, 16), 2.0)
    got = bk.roofline_chain(x, 'add', 4, 3)
    # sum over i < 4 of x + i + 3e-6
    torch.testing.assert_close(got, torch.full((4, 16), 14.0 + 12e-6))
    with pytest.raises(ValueError, match='unknown chain op'):
        bk.roofline_chain(x, 'sin', 1, 1)
    with pytest.raises(ValueError, match='K in'):
        bk.roofline_chain(x, 'log', 1, 4)
    assert bk.roofline_chain.launches == 0     # CPU tensors: the twin


# Random123's known-answer vectors for philox4x32 with 10 rounds:
# (counter, key, output)
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize('counter,key,want', PHILOX_KAT)
def test_philox_twin_known_answers(counter, key, want):
    got = bk.philox4x32_10_plain(
        tuple(torch.tensor([c], dtype=torch.int64) for c in counter), key)
    assert tuple(int(w) for w in got) == want


def test_chain_philox_op():
    x = torch.rand((8, 128), generator=torch.Generator().manual_seed(5)) + 0.5
    one = bk.roofline_chain(x, 'philox', 1, 1)
    # T = 1, K = 1: the block counted by the bits of x + 0, folded
    bits = x.view(torch.int32).to(torch.int64)
    zero = torch.zeros_like(bits)
    r = bk.philox4x32_10_plain((bits, zero, zero, zero),
                               (0xA4093822, 0x299F31D0))
    m = (r[0] ^ r[1] ^ r[2] ^ r[3]) & 0xFFFFFF
    assert torch.equal(one, m.float() * 2.0 ** -24 + 0.5)
    # uniform on [0.5, 1.5) whatever the depth, and a function of its input
    deep = bk.roofline_chain(x, 'philox', 1, 9)
    assert float(deep.min()) >= 0.5 and float(deep.max()) < 1.5
    assert abs(float(deep.mean()) - 1.0) < 0.03
    assert torch.equal(deep, bk.roofline_chain(x, 'philox', 1, 9))
    assert not torch.equal(deep, one)


def test_fma_rn_is_correctly_rounded():
    rng = np.random.RandomState(2)
    a = torch.from_numpy((rng.randn(3000) * 3).astype(np.float32))
    b = torch.from_numpy(rng.randn(3000).astype(np.float32))
    c = torch.from_numpy((rng.randn(3000) * 1e-3).astype(np.float32))
    c[:1500] *= 1e-9            # the addend only decides the rounding
    got = bk.fma_rn(a, b, c).numpy()
    two_roundings = 0
    for i in range(3000):
        exact = (Fraction(float(a[i])) * Fraction(float(b[i]))
                 + Fraction(float(c[i])))
        near = np.float32(float(exact))
        cands = [np.nextafter(near, np.float32(-np.inf)), near,
                 np.nextafter(near, np.float32(np.inf))]
        best = min(cands, key=lambda v: abs(Fraction(float(v)) - exact))
        assert got[i] == best, (i, got[i], best)
        two_roundings += np.float32(float(a[i]) * float(b[i])) + c[i].numpy() \
            != best
    assert two_roundings > 0    # the inputs do tell an fma from mul + add


# -- B3, B4 ----------------------------------------------------------------------

def _jax_mxu(a, b, steps):
    """`_mxu_kernel`'s arithmetic (unroll=2) over `steps` grid steps."""
    out = jnp.zeros(a.shape, jnp.float32)
    for _ in range(steps):
        acc = jnp.dot(a, b, preferred_element_type=jnp.float32)
        acc = acc + jnp.dot(a, acc.astype(jnp.bfloat16),
                            preferred_element_type=jnp.float32)
        out = out + acc
    return out


@pytest.mark.parametrize('kind', ['integers', 'normal'])
def test_mma_twin_matches_jax_arithmetic(kind):
    rng = np.random.RandomState(3)
    if kind == 'integers':
        a, b = (rng.randint(-1, 2, (128, 128)).astype(np.float32)
                for _ in range(2))
    else:
        a, b = (rng.randn(128, 128).astype(np.float32) for _ in range(2))
    ta, tb = (torch.from_numpy(x).to(torch.bfloat16) for x in (a, b))
    got = bk.roofline_mma(ta, tb, 2).numpy()
    want = np.asarray(_jax_mxu(jnp.asarray(a, jnp.bfloat16),
                               jnp.asarray(b, jnp.bfloat16), 2))
    if kind == 'integers':
        # every product and sum is a small integer: exact in any order
        np.testing.assert_array_equal(got, want)
    else:
        # f32 sums in another order, and a bf16 rounding that may flip
        np.testing.assert_allclose(got, want, rtol=1e-2,
                                   atol=1e-3 * np.sqrt((want ** 2).mean()))
    with pytest.raises(ValueError, match=r'\[N, N\]'):
        bk.roofline_mma(ta[:64], tb, 1)
    with pytest.raises(ValueError, match='steps'):
        bk.roofline_mma(ta, tb, 0)


def test_copy_twin():
    x = torch.arange(7, dtype=torch.float32)
    assert torch.equal(bk.roofline_copy(x), x + 1.0)
    with pytest.raises(ValueError, match='CPU or CUDA'):
        bk.roofline_copy(torch.empty(4, device='meta'))


def test_copy_geometry_is_the_kernels():
    """The chunk and ring whose edges the card's tests walk, and the tile
    that N must be a multiple of, are csrc/roofline.cu's own."""
    with open(os.path.join(ROOT, 'distributions_tpu_torch', 'csrc',
                           'roofline.cu')) as f:
        defines = dict(re.findall(r'^#define (\w+) (\d+)$', f.read(), re.M))
    assert int(defines['COPY_CHUNK']) == 4 * bk.COPY_CHUNK_FLOATS
    assert int(defines['COPY_STAGES']) == bk.COPY_RING
    assert int(defines['MMA_BM']) == bk.MMA_TILE
    assert bk.COPY_CHUNK_FLOATS in bk.COPY_EDGE_LENGTHS
    assert bk.COPY_RING * bk.COPY_CHUNK_FLOATS + 1 in bk.COPY_EDGE_LENGTHS


def _misaligned(shape, dtype):
    """A contiguous tensor of `shape` that starts one element past a
    16-byte boundary."""
    n = 1
    for d in shape:
        n *= d
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


# the wrappers check on the CPU what the kernels need on the card
@pytest.mark.parametrize('case,error,match', [
    ('dtype', TypeError, 'dtype'),
    ('strided', ValueError, 'contiguous'),
    ('empty', ValueError, 'at least one'),
    ('misaligned', ValueError, '16-byte'),
])
def test_copy_wrapper_checks(case, error, match):
    x = {'dtype': lambda: torch.zeros(64, dtype=torch.float64),
         'strided': lambda: torch.zeros((8, 8)).t(),
         'empty': lambda: torch.zeros(0),
         'misaligned': lambda: _misaligned((64,), torch.float32)}[case]()
    with pytest.raises(error, match=match):
        bk.roofline_copy(x)


@pytest.mark.parametrize('case,error,match', [
    ('not_square', ValueError, r'\[N, N\]'),
    ('not_multiple', ValueError, 'multiple of 128'),
    ('dtype', TypeError, 'dtype'),
    ('b_shape', ValueError, 'shape'),
    ('misaligned', ValueError, '16-byte'),
    ('steps', ValueError, 'steps'),
])
def test_mma_wrapper_checks(case, error, match):
    a = torch.zeros((128, 128), dtype=torch.bfloat16)
    args = {'not_square': lambda: (a[:, :64], a, 1),
            'not_multiple': lambda: (a[:64, :64].contiguous(),
                                     a[:64, :64].contiguous(), 1),
            'dtype': lambda: (a.float(), a, 1),
            'b_shape': lambda: (a, torch.zeros((256, 256),
                                               dtype=torch.bfloat16), 1),
            'misaligned': lambda: (_misaligned((128, 128), torch.bfloat16),
                                   a, 1),
            'steps': lambda: (a, a, 0)}[case]()
    with pytest.raises(error, match=match):
        bk.roofline_mma(*args)


# -- B1 ------------------------------------------------------------------------

def test_sampler_twin_host_modes():
    rng = np.random.RandomState(4)
    scores = torch.from_numpy(rng.randn(32, 50).astype(np.float32))
    g = torch.from_numpy(rng.gumbel(size=(32, 50)).astype(np.float32))
    want = torch.argmax(scores + g, 1).to(torch.int32)
    last, checksum, draws = bk.sampler_gumbel(7, scores, 5, 'gumbel_host', g,
                                              all_draws=True)
    assert torch.equal(last, want) and torch.equal(checksum, 5 * want)
    assert draws.shape == (5, 32) and torch.equal(draws[3], want)
    last, checksum = bk.sampler_gumbel(7, scores, 3, 'argmax')
    assert torch.equal(last, torch.argmax(scores, 1).to(torch.int32))
    assert torch.equal(checksum, 3 * last)
    with pytest.raises(ValueError, match='iters'):
        bk.sampler_gumbel(0, scores, 0)
    with pytest.raises(ValueError, match='draw'):
        bk.sampler_gumbel(0, scores, 2, 'cdf')


def test_sampler_twin_gumbel_distribution():
    """Iteration `it` draws with the seed seed + it: independent draws of
    one categorical per row, following the softmax of the scores."""
    scores = torch.from_numpy(
        np.random.RandomState(5).randn(64, 8).astype(np.float32))
    T = 300
    last, checksum, draws = bk.sampler_gumbel(11, scores, T, all_draws=True)
    assert torch.equal(last, draws[-1])
    assert torch.equal(checksum, draws.sum(0).to(torch.int32))
    assert testing.softmax_ztest(draws.reshape(-1),
                                 scores.repeat(T, 1)) < 5.0
    again = bk.sampler_gumbel(11 + 3, scores, 2, all_draws=True)[2]
    assert torch.equal(again[0], draws[3]) and torch.equal(again[1], draws[4])


# -- B5 ------------------------------------------------------------------------

R, C = 512, 128


@pytest.fixture(scope='module')
def k1_inputs():
    values, labels = testing.nich_problem(R, seed=3)
    jspec = jmx.make_spec([(jnich, 2)], capacity=C)
    jpy = jcl.PitmanYor.from_dict(testing.PY)
    jsh = (jnich.shared_from_dict(testing.NICH_SHARED),)
    jst = jmx.state_from_assignments(jspec, jpy, jsh, (jnp.asarray(values),),
                                     jnp.asarray(labels))
    st = convert.state(jspec, jax.tree_util.tree_map(np.asarray, jst))
    sh = (tnich.shared_from_dict(testing.NICH_SHARED),)
    py = tcl.PitmanYor.from_dict(testing.PY)
    jargs = (jnp.asarray(values),
             jcl.score_value(jpy, jst.counts, jst.alive, jst.sample_size),
             pk.nich_coeffs_v2(jsh[0], jst.groups[0]))
    args = (torch.from_numpy(values),
            tcl.score_value(py, st.counts, st.alive, st.sample_size),
            fk.nich_coeffs_v2(sh[0], st.groups[0]), (2,))
    return jargs, args


def test_phase_twins_without_a_draw(k1_inputs):
    (jv, jcls, jco), args = k1_inputs
    noop = bk.fused_phase('noop', 0, *args)
    assert noop.dtype == torch.int32
    np.testing.assert_array_equal(
        noop.numpy(), np.asarray(jnp.sum(jv, axis=1).astype(jnp.int32)))
    jscores = pk._score_nich_product(jv, jco, jcls[None, :], (2,), jnp.log)
    best = bk.fused_phase('score_max', 0, *args)
    np.testing.assert_allclose(best.numpy(), np.asarray(jscores.max(1)),
                               rtol=1e-5, atol=1e-4)
    # 'score_bits' perturbs by less than BITS_NOISE_MAX: its pick scores
    # within that of the row maximum, and a seed gives one pick
    pick = bk.fused_phase('score_bits', 3, *args)
    scores = fk._score_nich_product(*args[:1], args[2], args[1], (2,),
                                    torch.log)
    gap = scores.amax(1) - scores.gather(1, pick.long()[:, None])[:, 0]
    assert float(gap.max()) <= bk.BITS_NOISE_MAX
    assert torch.equal(pick, bk.fused_phase('score_bits', 3, *args))


@pytest.mark.parametrize('sampling', ['argmax', 'gumbel_host', 'cdf_host',
                                      'gumbel', 'cdf', 'argmax_fast'])
def test_phase_twins_with_a_draw_are_k1(k1_inputs, sampling):
    """'full_<sampling>' is K1's twin and 'score_<sampling>' its draws."""
    _, args = k1_inputs
    rng = np.random.RandomState(6)
    noise = None
    if sampling == 'gumbel_host':
        noise = torch.from_numpy(rng.gumbel(size=(R, C)).astype(np.float32))
    elif sampling == 'cdf_host':
        noise = torch.from_numpy(rng.rand(R, 1).astype(np.float32))
    a, sums = fk.fused_score_sample_stats_plain(5, *args, sampling=sampling,
                                                noise=noise)
    a2, sums2 = bk.fused_phase('full_' + sampling, 5, *args, noise=noise)
    assert torch.equal(a, a2) and torch.equal(sums, sums2)
    assert torch.equal(bk.fused_phase('score_' + sampling, 5, *args,
                                      noise=noise), a)


def test_full_argmax_phase_matches_the_jax_kernel(k1_inputs):
    (jv, jcls, jco), args = k1_inputs
    ja, jsums = pk.fused_score_sample_stats(
        0, jv, jcls, jco, (2,), block_rows=256, interpret=True,
        sampling='argmax')
    a, sums = bk.fused_phase('full_argmax', 0, *args)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), rtol=1e-5,
                               atol=1e-3)


def test_phase_names_are_checked(k1_inputs):
    _, args = k1_inputs
    for bad in ('score', 'full', 'score_sideways', 'tnoop', 'score_bits16'):
        with pytest.raises(ValueError):
            bk.fused_phase(bad, 0, *args)
