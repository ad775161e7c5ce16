"""The measurement kernels and their plain PyTorch twins.  Counterpart of
the Pallas kernels on the JAX package's measurement entry points:

- B1, `sampler_gumbel` (the inline kernel of benchmarks/suite.py::
  bench_kernel_sampler): T gumbel-argmax draws per row of a resident
  [BR, C] score block, in one launch (`csrc/sampler_bench.cu`);
- B2, `roofline_chain` (benchmarks/roofline.py::_chain_kernel): a K-deep
  dependent chain of one op per element, T times;
- B3, `roofline_mma` (roofline.py::_mxu_kernel): repeated bf16 matrix
  products with f32 accumulation on the tensor cores (wgmma fed by TMA,
  one persistent launch a call);
- B4, `roofline_copy` (roofline.py::_copy_kernel): `o = x + 1` streamed
  by TMA bulk copies (B2-B4 in `csrc/roofline.cu`);
- B5, `fused_phase` (profile_kernel_phases.py::_variant_kernel): K1's
  score + sample kernel cut into cumulative phases (`csrc/fused_v2.cu`
  instantiated over a compile-time phase).

Beside B5, the stat stage of K1 and K2 alone on given slots (the stage
of `csrc/fused_stats.cuh` that K1 and K2 run after their draw; no TPU
kernel of its own): `stat_sums` (K1's nich sums) and `mixed_stat_sums`
(K2's nich and niw sums and count tables).

Each wrapper takes its twin (`*_plain`) for CPU tensors.  For CUDA tensors
it launches the hand-written kernel (built by `fused_kernels.build`) or
raises; there is no fallback.  Its `launches` attribute counts the kernel
launches.
"""

import torch

from distributions_tpu_torch.models import base
from distributions_tpu_torch.ops import fused_kernels as fk
from distributions_tpu_torch.random import device_generator

_MASK64 = (1 << 64) - 1


def _device_kind(name, t):
    kind = t.device.type
    if kind not in ('cpu', 'cuda'):
        raise ValueError('%s runs on CPU or CUDA tensors, got %s'
                         % (name, t.device))
    return kind


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


# -- B2: the dependent chain -------------------------------------------------

# op -> the kernel's OP_* enum (csrc/roofline.cu)
CHAIN_OPS = {'add': 0, 'mul': 1, 'fma': 2, 'log': 3, 'exp': 4, 'log1p': 5,
             'rsqrt': 6, 'fast_log': 7, 'fast_exp': 8, 'philox': 9}
# chain depths the kernel is instantiated for
CHAIN_DEPTHS = (1, 2, 3, 5, 9)
# ops whose kernel repeats the twin's rounded operations exactly; the
# others call CUDA's accurate logf / expf / log1pf / rsqrtf, which differ
# from PyTorch's by ulps
CHAIN_EXACT_OPS = ('add', 'mul', 'fma', 'fast_log', 'fast_exp', 'philox')
_MASK32 = 0xFFFFFFFF
# the key of the 'philox' chain op
_CHAIN_PHILOX_KEY = (0xA4093822, 0x299F31D0)


def fma_rn(a, b, c):
    """a * b + c of f32 tensors with one rounding, as the FMA instruction
    gives it: the product is exact in f64, the sum is rounded to odd in
    f64 (the sum's exact error decides the sticky bit), and an odd-rounded
    f64 rounds to f32 as the exact value would."""
    p = a.double() * b.double()
    cd = c.double() if isinstance(c, torch.Tensor) else torch.full_like(
        p, float(torch.tensor(c, dtype=torch.float32)))
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    bits = s.view(torch.int64)
    # the f64 toward zero of the exact sum, then its last bit set
    toward_zero = torch.where((err != 0) & ((err > 0) != (s > 0)), bits - 1,
                              bits)
    odd = torch.where(err != 0, toward_zero | 1, bits)
    return odd.view(torch.float64).to(torch.float32)


def _mulhilo32(m, a):
    """(high, low) 32-bit words of m * a for a Python int m < 2**32 and an
    int64 tensor a of values < 2**32, through 16-bit halves of a so that
    no product leaves int64."""
    p0 = m * (a & 0xFFFF)
    p1 = m * (a >> 16)
    return (p1 + (p0 >> 16)) >> 16, (((p1 & 0xFFFF) << 16) + p0) & _MASK32


def philox4x32_10_plain(counter, key):
    """Philox4x32-10 (Salmon et al., SC'11) as `csrc/fused_common.cuh`
    computes it: counter, a tuple of four int64 tensors of 32-bit words,
    and key, two Python ints -> four int64 tensors of 32-bit words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo32(0xD2511F53, c0)
        hi1, lo1 = _mulhilo32(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & _MASK32
        k1 = (k1 + 0xBB67AE85) & _MASK32
    return c0, c1, c2, c3


def _chain_step(op, y):
    # renorms keep the chained value in the op's domain (positive, near 1)
    if op == 'add':
        return y + 1e-6
    if op == 'mul':
        return y * 1.000001
    if op == 'fma':
        return fma_rn(y, torch.full_like(y, 1.000001), 0.000001)
    if op == 'log':
        return torch.log(torch.abs(y) + 0.5)
    if op == 'exp':
        return torch.exp(y * 1e-3)
    if op == 'log1p':
        return torch.log1p(torch.abs(y) + 0.5)
    if op == 'rsqrt':
        return torch.rsqrt(torch.abs(y) + 0.5)
    if op == 'fast_log':
        return fk.fast_log(torch.abs(y) + 0.5)
    if op == 'philox':
        bits = y.contiguous().view(torch.int32).to(torch.int64) & _MASK32
        zero = torch.zeros_like(bits)
        r = philox4x32_10_plain((bits, zero, zero, zero), _CHAIN_PHILOX_KEY)
        m = (r[0] ^ r[1] ^ r[2] ^ r[3]) & 0x00FFFFFF
        return m.to(torch.float32) * 5.960464477539063e-08 + 0.5
    return fk.fast_exp(y * 1e-3)


def _check_chain(op, T, K):
    if op not in CHAIN_OPS:
        raise ValueError('unknown chain op %r (one of %s)'
                         % (op, ', '.join(CHAIN_OPS)))
    if int(T) < 1 or int(K) not in CHAIN_DEPTHS:
        raise ValueError('chain needs T >= 1 and K in %s, got T=%r K=%r'
                         % (CHAIN_DEPTHS, T, K))


def roofline_chain_plain(x, op, T, K):
    """The plain PyTorch version of B2, on any device: per element the sum
    over i < T of the K-fold op(renorm(.)) of x + i."""
    _check_chain(op, T, K)
    acc = torch.zeros_like(x)
    for i in range(int(T)):
        y = x + float(i)
        for _ in range(int(K)):
            y = _chain_step(op, y)
        acc = acc + y
    return acc


def roofline_chain(x, op, T, K):
    """B2: a dependent chain per element.  x: f32, any shape, contiguous.
    Returns sum_{i<T} f^K(x + i), f = op(renorm(.)), op one of CHAIN_OPS
    and K one of CHAIN_DEPTHS ('philox': one Philox4x32-10 block counted
    by the bits of y, its four words folded into a value in [0.5, 1.5)).
    The time's slope between two depths K is the cost of one evaluation: x
    is read once and the sum written once.

    CPU tensors run the plain twin; CUDA tensors launch the kernel or
    raise."""
    if _device_kind('roofline_chain', x) == 'cpu':
        return roofline_chain_plain(x, op, T, K)
    _check_chain(op, T, K)
    if x.numel() < 1:
        raise ValueError('x must hold at least one element')
    fk._check('x', x, x.device, x.shape)
    lib = fk.build('roofline')['lib']
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.roofline_chain_launch(
            x.data_ptr(), out.data_ptr(), x.numel(), int(T), int(K),
            CHAIN_OPS[op], _stream(x.device))
    fk._raise_on('roofline', lib, err)
    roofline_chain.launches += 1
    return out


roofline_chain.launches = 0


# -- B4: the streamed copy ----------------------------------------------------

# the kernel's chunk and ring (COPY_CHUNK bytes, COPY_STAGES in
# csrc/roofline.cu): the lengths at and around one chunk and one ring are
# where its bulk copies end and its plain tail begins
COPY_CHUNK_FLOATS = 4096
COPY_RING = 6
COPY_EDGE_LENGTHS = tuple(
    m * COPY_CHUNK_FLOATS + d for m in (1, COPY_RING) for d in (-1, 0, 1))


def roofline_copy_plain(x):
    """The plain PyTorch version of B4, on any device."""
    return x + 1.0


def _check_copy(x):
    fk._check('x', x, x.device, x.shape)
    if x.numel() < 1:
        raise ValueError('x must hold at least one element')
    # the kernel's bulk copies move 16-byte-aligned spans
    if x.data_ptr() % 16:
        raise ValueError('x must be 16-byte aligned')


def roofline_copy(x):
    """B4: `x + 1` of a contiguous, 16-byte-aligned f32 tensor, read and
    written once by TMA bulk copies through shared memory: (bytes in +
    bytes out) / time is the device-memory rate a kernel can reach.

    CPU tensors run the plain twin (after the same checks); CUDA tensors
    launch the kernel or raise."""
    kind = _device_kind('roofline_copy', x)
    _check_copy(x)
    if kind == 'cpu':
        return roofline_copy_plain(x)
    lib = fk.build('roofline')['lib']
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.roofline_copy_launch(x.data_ptr(), out.data_ptr(),
                                       x.numel(), _stream(x.device))
    fk._raise_on('roofline', lib, err)
    roofline_copy.launches += 1
    return out


roofline_copy.launches = 0


# -- B3: bf16 matrix products -------------------------------------------------

# the kernel's block tile is 128 x 64: N must be a multiple of 128
MMA_TILE = 128


def roofline_mma_plain(a, b, steps):
    """The plain PyTorch version of B3, on any device: f32 products of the
    bf16 operands' values, acc rounded to bf16 where the kernel rounds
    it."""
    af, bf = a.float(), b.float()
    out = torch.zeros_like(af)
    for _ in range(int(steps)):
        acc = af @ bf
        acc = acc + af @ acc.to(torch.bfloat16).float()
        out = out + acc
    return out


def _check_mma(a, b, steps):
    if steps < 1:
        raise ValueError('steps must be >= 1')
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ValueError('a must be [N, N], got %s' % (tuple(a.shape),))
    N = a.shape[0]
    if N % MMA_TILE or N < MMA_TILE:
        raise ValueError('N must be a positive multiple of %d, got %d'
                         % (MMA_TILE, N))
    fk._check('a', a, a.device, (N, N), torch.bfloat16)
    fk._check('b', b, a.device, (N, N), torch.bfloat16)
    # the TMA unit reads from 16-byte-aligned rows
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError('a and b must be 16-byte aligned')
    return N


def _mma_scratch(N, dev):
    """The kernel's buffers, uninitialised: accf, accb (bf16(acc) of even
    and of odd steps), out (zeroed in the kernel) and, per column strip of
    accb, its tiles done (zeroed by the launcher)."""
    return (torch.empty((N, N), dtype=torch.float32, device=dev),
            torch.empty((2, N, N), dtype=torch.bfloat16, device=dev),
            torch.empty((N, N), dtype=torch.float32, device=dev),
            torch.empty(N // 64, dtype=torch.int32, device=dev))


def roofline_mma(a, b, steps):
    """B3: `steps` times on [N, N] bf16 operands, with f32 sums,

        acc = a @ b;  acc += a @ bf16(acc);  out += acc

    Returns out [N, N] f32.  4 * N**3 * steps floating-point operations.
    N must be a multiple of 128.  All 2 * steps products run in one
    persistent cooperative launch (wgmma on TMA-loaded tiles; a tile of
    product 2 waits for the product-1 tiles of its column strip) on the
    current stream.

    CPU tensors run the plain twin (after the same checks); CUDA tensors
    launch the kernel or raise."""
    steps = int(steps)
    kind = _device_kind('roofline_mma', a)
    N = _check_mma(a, b, steps)
    if kind == 'cpu':
        return roofline_mma_plain(a, b, steps)
    dev = a.device
    lib = fk.build('roofline')['lib']
    accf, accb, out, done = _mma_scratch(N, dev)
    with torch.cuda.device(dev):
        err = lib.roofline_mma_launch(
            a.data_ptr(), b.data_ptr(), accf.data_ptr(), accb.data_ptr(),
            out.data_ptr(), done.data_ptr(), N, steps, _stream(dev))
    fk._raise_on('roofline', lib, err)
    roofline_mma.launches += 1
    return out


roofline_mma.launches = 0


# -- B1: the sampler alone ----------------------------------------------------

def _check_sampler(scores, iters, sampling):
    mode = fk._parse_v1_sampling(sampling)
    if scores.dim() != 2 or scores.shape[0] < 1 or scores.shape[1] < 1:
        raise ValueError('scores must be [BR >= 1, C >= 1], got %s'
                         % (tuple(scores.shape),))
    if int(iters) < 1:
        raise ValueError('iters must be >= 1')
    return mode


def sampler_gumbel_plain(seed, scores, iters, sampling='gumbel', noise=None,
                         all_draws=False):
    """The plain PyTorch version of B1, on any device: iteration `it` is
    one draw of the fused kernels' twins (`fused_kernels._draw`) with the
    seed `seed + it`.  Same arguments and results as `sampler_gumbel`."""
    mode = _check_sampler(scores, iters, sampling)
    checksum = torch.zeros(scores.shape[0], dtype=torch.int32,
                           device=scores.device)
    draws = []
    for it in range(int(iters)):
        last = fk._draw(scores, mode, False, (int(seed) + it) & _MASK64,
                        noise)
        checksum = checksum + last
        if all_draws:
            draws.append(last)
    if all_draws:
        return last, checksum, torch.stack(draws)
    return last, checksum


def sampler_gumbel(seed, scores, iters, sampling='gumbel', noise=None,
                   all_draws=False):
    """B1: `iters` categorical draws per row of scores [BR, C] f32 by
    gumbel-argmax, in one launch; iteration `it` draws with the seed
    `seed + it`.  Returns (the last iteration's draws [BR] int32, the sum
    of every iteration's draw per row [BR] int32) and, with all_draws,
    every iteration's draws [iters, BR] int32 as a third result.

    sampling: 'gumbel' (Philox in the kernel) | 'argmax' | 'gumbel_host'
    taking `noise` [BR, C], the same for every iteration; in the last two
    the kernel equals its twin draw for draw.

    CPU tensors run the plain twin; CUDA tensors launch the kernel or
    raise."""
    if _device_kind('sampler_gumbel', scores) == 'cpu':
        return sampler_gumbel_plain(seed, scores, iters, sampling, noise,
                                    all_draws)
    mode = _check_sampler(scores, iters, sampling)
    dev = scores.device
    BR, C = scores.shape
    fk._check('scores', scores, dev, (BR, C))
    fk._check_noise(mode, sampling, noise, dev, BR, C)
    seed = fk._check_seed(seed)
    iters = int(iters)
    lib = fk.build('sampler_bench')['lib']
    last = torch.empty(BR, dtype=torch.int32, device=dev)
    checksum = torch.zeros(BR, dtype=torch.int32, device=dev)
    draws = (torch.empty((iters, BR), dtype=torch.int32, device=dev)
             if all_draws else None)
    with torch.cuda.device(dev):
        err = lib.sampler_bench_launch(
            scores.data_ptr(), fk._ptr(noise), last.data_ptr(),
            checksum.data_ptr(), fk._ptr(draws), BR, C, iters,
            fk.SAMPLING_MODES[mode], seed, _stream(dev))
    fk._raise_on('sampler_bench', lib, err)
    sampler_gumbel.launches += 1
    if all_draws:
        return last, checksum, draws
    return last, checksum


sampler_gumbel.launches = 0


# -- B5: K1 cut into phases ---------------------------------------------------

# the phases without a draw; 'score_<sampling>' and 'full_<sampling>' take
# any sampling mode of K1 ('gumbel', 'cdf', 'argmax', '_fast', '_host')
PHASES = ('noop', 'score_max', 'score_bits')
_PHASE_FULL, _PHASE_NOOP, _PHASE_SCORE_MAX = 0, 1, 2
_MODE_BITS = 5
# the largest perturbation of 'score_bits': (2**24 - 1) * 1e-9
BITS_NOISE_MAX = 0.016777215


def _parse_phase(phase):
    """(stage, sampling): stage 'noop' | 'score_max' | 'score_bits' |
    'score' | 'full'; sampling only for the last two."""
    if phase in PHASES:
        return phase, None
    for stage in ('score', 'full'):
        if phase.startswith(stage + '_'):
            sampling = phase[len(stage) + 1:]
            fk._parse_sampling(sampling)
            return stage, sampling
    raise ValueError('unknown phase %r: %s, score_<sampling> or '
                     'full_<sampling>' % (phase, ', '.join(PHASES)))


def fused_phase_plain(phase, seed, values, cl_scores, coeffs, col_groups,
                      noise=None):
    """The plain PyTorch version of B5, on any device.  Same arguments and
    results as `fused_phase`.  'score_bits' draws its 24-bit words from a
    generator seeded with `seed`, so it equals the kernel in distribution
    only."""
    stage, sampling = _parse_phase(phase)
    if stage == 'noop':
        s = torch.zeros_like(values[:, 0])
        for c in range(values.shape[1]):
            s = s + values[:, c]
        return s.to(torch.int32)
    if stage == 'full':
        return fk.fused_score_sample_stats_plain(
            seed, values, cl_scores, coeffs, col_groups, sampling=sampling,
            noise=noise)
    fast = sampling is not None and sampling.endswith('_fast')
    scores = fk._score_nich_product(values, coeffs, cl_scores, col_groups,
                                    fk.fast_log if fast else torch.log)
    if stage == 'score_max':
        return torch.amax(scores, dim=1)
    if stage == 'score_bits':
        m = torch.randint(0, 1 << 24, scores.shape, dtype=torch.int32,
                          device=scores.device,
                          generator=device_generator(seed, scores.device))
        return torch.argmax(scores + m.to(torch.float32) * 1e-9,
                            dim=1).to(torch.int32)
    mode, fast = fk._parse_sampling(sampling)
    return fk._draw(scores, mode, fast, seed, noise)


def fused_phase(phase, seed, values, cl_scores, coeffs, col_groups,
                noise=None):
    """B5: one cumulative phase of K1 (`fused_score_sample_stats`, same
    inputs) on one tile:

    - 'noop': load the values; returns int32 [B], each row's values summed
      and truncated;
    - 'score_max': + the scoring; returns the row maxima f32 [B];
    - 'score_bits': + Philox: argmax of score + m * 1e-9, m the 24-bit
      word of a 'gumbel' draw; returns int32 [B];
    - 'score_<sampling>': + the draw, K1's score + sample kernel alone;
      returns the draws int32 [B];
    - 'full_<sampling>': + the stat sums: K1 itself, through its wrapper
      (which counts the launch); returns (draws, sums [C, 3 * cols]).

    CPU tensors run the plain twin; CUDA tensors launch the kernel or
    raise."""
    if _device_kind('fused_phase', values) == 'cpu':
        return fused_phase_plain(phase, seed, values, cl_scores, coeffs,
                                 col_groups, noise)
    stage, sampling = _parse_phase(phase)
    if stage == 'full':
        # K1 itself, counted by its own wrapper
        return fk.fused_score_sample_stats(
            seed, values, cl_scores, coeffs, col_groups, sampling=sampling,
            noise=noise)
    mode, fast = (fk._parse_sampling(sampling) if stage == 'score'
                  else ('argmax', False))
    col_groups = fk._check_col_groups(col_groups, 1)
    dev = values.device
    if values.dim() != 2 or values.shape[0] < 1:
        raise ValueError('values must be [B >= 1, cols], got %s'
                         % (tuple(values.shape),))
    if cl_scores.dim() != 1 or cl_scores.shape[0] < 1:
        raise ValueError('cl_scores must be [C >= 1]')
    B, C = values.shape[0], cl_scores.shape[0]
    fk._check('values', values, dev, (B, sum(col_groups)))
    fk._check('cl_scores', cl_scores, dev, (C,))
    fk._check('coeffs', coeffs, dev, (sum(2 + 2 * c for c in col_groups), C))
    fk._check_noise(mode, sampling or stage, noise, dev, B, C)
    seed = fk._check_seed(seed)
    code = {'noop': _PHASE_NOOP, 'score_max': _PHASE_SCORE_MAX}.get(
        stage, _PHASE_FULL)
    mode_code = (_MODE_BITS if stage == 'score_bits'
                 else fk.SAMPLING_MODES[mode])
    lib = fk.build('fused_v2')['lib']
    if stage == 'score_max':
        out, best = None, torch.empty(B, dtype=torch.float32, device=dev)
    else:
        out, best = torch.empty(B, dtype=torch.int32, device=dev), None
    with torch.cuda.device(dev):
        err = lib.fused_v2_phase_launch(
            values.data_ptr(), cl_scores.data_ptr(), coeffs.data_ptr(),
            fk._ptr(noise), fk._ptr(out), fk._ptr(best), B, C,
            len(col_groups), fk._int_array(col_groups), code, mode_code,
            int(fast), seed, _stream(dev))
    fk._raise_on('fused_v2', lib, err)
    fused_phase.launches += 1
    return best if out is None else out


fused_phase.launches = 0


# -- the stat stage of K1 and K2 alone ----------------------------------------

def stat_sums_plain(values, assign, C):
    """The plain PyTorch version of `stat_sums`, on any device: an exact
    f32 one-hot contraction (K1's twin's sums)."""
    stats = torch.cat([torch.ones_like(values), values, values * values],
                      dim=1)
    return base.segment_sum(stats, assign, C)


def stat_sums(values, assign, C):
    """K1's stat stage alone: per slot k < C the sums [C, 3 * cols] of
    [1 | v | v^2] over the rows of `values` [B, cols] f32 whose slot
    `assign` [B] int32 is k; rows with a slot outside [0, C) add nothing.
    The same launch as the stage inside K1 (`fused_v2_stats_launch`);
    for measurement, off the main path.

    CPU tensors run the plain twin; CUDA tensors launch the kernels or
    raise."""
    if _device_kind('stat_sums', values) == 'cpu':
        return stat_sums_plain(values, assign, C)
    dev = values.device
    if values.dim() != 2 or not 1 <= values.shape[1] <= fk.MAX_COLS \
            or values.shape[0] < 1 or C < 1:
        raise ValueError('values must be [B >= 1, 1..%d], C >= 1'
                         % fk.MAX_COLS)
    B, cols = values.shape
    fk._check('values', values, dev, (B, cols))
    fk._check('assign', assign, dev, (B,), torch.int32)
    lib = fk.build('fused_v2')['lib']
    partials, bmask = fk.stat_scratch(B, C, 3 * cols, dev)
    sums = torch.empty((C, 3 * cols), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.fused_v2_stats_launch(
            values.data_ptr(), assign.data_ptr(), partials.data_ptr(),
            bmask.data_ptr(), sums.data_ptr(), B, C, cols, _stream(dev))
    fk._raise_on('fused_v2', lib, err)
    stat_sums.launches += 1
    return sums


stat_sums.launches = 0


def mixed_stat_sums_plain(values, qvalues, table_idx, assign, C, col_groups,
                          quad_groups=(), table_vs=()):
    """The plain PyTorch version of `mixed_stat_sums`, on any device: the
    exact f32 one-hot contractions of K2's twin."""
    sums, tcounts, qsums = fk._mixed_stat_sums(
        assign, C, values, table_idx, tuple(col_groups), qvalues,
        tuple(quad_groups), tuple(table_vs))
    return sums, tcounts, qsums


def mixed_stat_sums(values, qvalues, table_idx, assign, C, col_groups,
                    quad_groups=(), table_vs=()):
    """K2's stat stage alone on the slots `assign` [B] int32: (nich sums
    [C, 3 * ncols], packed count tables [C, Vtot] f32, niw sums [C,
    quad_stat_dim]) of the rows `values` / `qvalues` / `table_idx` in the
    layout of `fk.fused_mixed_score_sample_stats` (None for a family that
    is absent, which gives [C, 0]); rows with a slot outside [0, C) add
    nothing.  The same launch as the stage inside K2
    (`fused_v3_stats_launch`); for measurement, off the main path.

    CPU tensors run the plain twin; CUDA tensors launch the kernels or
    raise."""
    col_groups = fk._check_col_groups(col_groups, 0)
    quad_groups = tuple((int(nc), int(d)) for nc, d in quad_groups)
    table_vs = tuple(int(v) for v in table_vs)
    if _device_kind('mixed_stat_sums', assign) == 'cpu':
        return mixed_stat_sums_plain(values, qvalues, table_idx, assign, C,
                                     col_groups, quad_groups, table_vs)
    if not quad_groups and not table_vs:
        raise ValueError('mixed_stat_sums needs niw or table columns: '
                         'nich columns alone are stat_sums')
    dev = assign.device
    B = assign.shape[0]
    if assign.dim() != 1 or B < 1 or C < 1:
        raise ValueError('assign must be [B >= 1], C >= 1')
    # the layout's checks of K2, against a stand-in for its score inputs
    cl = torch.empty(C, dtype=torch.float32, device=dev)
    fk._check_mixed(
        values, table_idx, cl,
        torch.empty((sum(2 + 2 * c for c in col_groups), C), device=dev),
        torch.empty((sum(table_vs), C), device=dev), col_groups, qvalues,
        torch.empty((sum(2 + nc * (d + d * (d + 1) // 2)
                         for nc, d in quad_groups), C), device=dev),
        quad_groups, table_vs)
    fk._check('assign', assign, dev, (B,), torch.int32)
    lib = fk.build('fused_v3')['lib']
    outputs = fk._mixed_stat_outputs(B, C, sum(col_groups), quad_groups,
                                     sum(table_vs), dev)
    with torch.cuda.device(dev):
        err = lib.fused_v3_stats_launch(
            fk._ptr(values if col_groups else None),
            fk._ptr(qvalues if quad_groups else None),
            fk._ptr(table_idx if table_vs else None), assign.data_ptr(),
            *(t.data_ptr() for t in outputs), B, C,
            *fk._layout_args(col_groups, quad_groups, table_vs),
            _stream(dev))
    fk._raise_on('fused_v3', lib, err)
    mixed_stat_sums.launches += 1
    _, _, sums, qsums, _, tcounts = outputs
    return sums, tcounts, qsums


mixed_stat_sums.launches = 0
