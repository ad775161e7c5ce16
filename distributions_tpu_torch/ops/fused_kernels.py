"""The fused score + sample + stat-sum kernels and their plain PyTorch
twins.  Counterpart of distributions_tpu/ops/pallas_kernels.py:

- K1, `fused_score_sample_stats` (`_fused_v2_kernel`): nich columns only,
  with `nich_coeffs_v2`, `split_stat_sums`, `fast_log`/`fast_exp`;
- K2, `fused_mixed_score_sample_stats` (`_fused_v3_kernel`): nich columns,
  niw columns (`niw_coeffs_v4`, `quad_sums_to_raw`) and table columns of
  the discrete models.  A nich-only call falls through to K1;
- K3, `fused_score_sample_pair` (`_fused_pair_kernel`): K2's score over
  the slots of one shard of a wider slot axis, giving per row the (local
  argmax, best perturbed score) pair that the component-sharded sweeps
  reduce across shards; no stat outputs;
- K4, `nich_score_sample` (`_score_sample_kernel`) and K5,
  `mixed_score_sample` (`_mixed_kernel`): the v1 score + sample kernels
  without stat outputs, with `nich_coeffs` (four rows per column, `log1p`
  form) and, for K5, one [V, C] score table per discrete column.

Each wrapper takes its twin (`*_plain`) for CPU tensors.  For CUDA tensors
it launches the hand-written Hopper kernel in `csrc/fused_v2.cu`,
`csrc/fused_v3.cu` or `csrc/score_sample_v1.cu` (built with nvcc into
build/torch_kernels/ at first use, bound with ctypes) or raises; there is
no fallback.  Its `launches` attribute counts the kernel launches; K2's
`shape_launches` counts them by the split walk's shape (`split_shape`).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

from distributions_tpu_torch import config
from distributions_tpu_torch.models import base, nich as nich_mod
from distributions_tpu_torch.models import niw as niw_mod
from distributions_tpu_torch.random import device_generator
from distributions_tpu_torch.special import lgamma_nu

DEFAULT_BLOCK_ROWS = 256

# sampling mode -> the kernels' MODE_* enum (csrc/fused_common.cuh)
SAMPLING_MODES = {'argmax': 0, 'gumbel': 1, 'gumbel_host': 2, 'cdf': 3,
                  'cdf_host': 4}
# caps of the kernels' run-time layouts (csrc/fused_v3.cu's MAX_* defines,
# which a test holds these to)
MAX_GROUPS = 8          # nich blocks, and niw blocks
MAX_COLS = 32           # nich columns in all
MAX_QVALS = 16          # niw value columns in all (sum of cols * d)
MAX_D = 16              # niw dimension
MAX_TABLE_COLS = 16
MAX_VTOT = 4096         # packed table rows
# the stat stage of K1 and K2 (csrc/fused_stats.cuh): the blocks a launch
# aims at and the most rows a block takes
STAT_GRID = 132
STAT_MAX_ROWS = 1024
# the slot-split walk of the argmax-family draws (csrc/fused_split.cuh):
# threads per row (one slice of the slot axis each), rows per thread,
# threads per block, and the unit of a staged slot record (floats: one
# 16-byte load)
SPLIT_SLICES = 8
SPLIT_ROWS = 2
SPLIT_THREADS = 256
SPLIT_PACK = 4
# K2's and K3's split shapes by their csrc/fused_v3.cu SHAPE_* codes: the
# wide shape (niw columns of d <= 4), the exact shapes of niw2mix and
# bbddgp, of one table column of at most SPLIT_PACK values, its scores
# folded into the slot records, and of one niw column of d = 16, its
# record read from shared memory; and the wide shape of layouts with a
# niw column of 4 < d <= MAX_D
SPLIT_SHAPES = ('wide', 'niw2mix', 'tables3', 'table1_folded', 'niw16',
                'wide_d16')

# -- fast transcendentals (pallas_kernels.py _FAST_LOG_C / _FAST_EXP_C) -----

_FAST_LOG_C = (5.621959006663069e-07, 0.9999574870750698,
               -0.4992065685478762, 0.3269731000139177,
               -0.22283625832784004, 0.1307650325036001,
               -0.05262485136716543, 0.010119082927575069)
_FAST_EXP_C = (0.9999997696337066, 0.6931567766988703,
               0.24013169187191022, 0.05587655686900896,
               0.008940582529378103, 0.001894379423367964)
# ln 2 split Cody-Waite style: e * _LN2_HI is exact in f32 for every
# exponent e, so fast_log rounds once fewer than e * ln2 + poly would
_LN2_HI = 0.693145751953125
_LN2_LO = 1.428606765330187e-06
_LOG2E = 1.4426950408889634


def _horner(coeffs, t):
    p = torch.full_like(t, coeffs[-1])
    for c in coeffs[-2::-1]:
        p = p * t + c
    return p


def fast_log(x):
    """~5.7e-7-abs-accurate log for positive normal f32 (x >= 2^-126):
    exponent/mantissa bit split plus a degree-7 polynomial."""
    bits = x.contiguous().view(torch.int32)
    e = (bits >> 23) - 127
    m = ((bits & 0x007FFFFF) | 0x3F800000).view(torch.float32)
    ef = e.to(torch.float32)
    return ef * _LN2_HI + (ef * _LN2_LO + _horner(_FAST_LOG_C, m - 1.0))


def fast_exp(x):
    """~2.3e-7-rel-accurate exp; clamps below -86."""
    y = torch.clamp(x, min=-86.0) * _LOG2E
    f = torch.floor(y)
    p = _horner(_FAST_EXP_C, y - f)
    scale = ((f.to(torch.int32) + 127) << 23).view(torch.float32)
    return scale * p


def _parse_sampling(sampling):
    fast = sampling.endswith('_fast')
    mode = sampling[:-len('_fast')] if fast else sampling
    if mode not in SAMPLING_MODES:
        raise ValueError('unknown sampling mode %r' % (sampling,))
    return mode, fast


# -- [C]-sized inputs and outputs -------------------------------------------

def supports_pallas(spec):
    """True when every block is nich: the specs K1 serves."""
    return all(b.module is nich_mod for b in spec.blocks)


def supports_mixed_pallas(spec):
    """nich blocks (product form) + niw blocks (quadratic form) + any
    discrete model with score_value_batch (score tables): the specs K2
    serves."""
    return all(b.module is nich_mod or b.module is niw_mod
               or hasattr(b.module, 'score_value_batch')
               for b in spec.blocks)


def nich_coeffs(shared, group):
    """[4*cols, C] scorer rows from [C, cols] nich groups, per column
    {score, log_coeff, precision, mean}: the inputs of K4 and K5, where
    score(v, k) = score_k + log_coeff_k * log1p(prec_k (v - mean_k)^2)."""
    post = nich_mod.plus_group(shared, group)            # leaves [C, cols]
    lambda_ = ((1.0 + post.kappa) * post.sigmasq) / post.kappa
    score = (lgamma_nu(post.nu)
             - 0.5 * torch.log(post.nu * torch.pi * lambda_))
    log_coeff = -0.5 * (post.nu + 1.0)
    precision = 1.0 / (post.nu * lambda_)
    stack = torch.stack([score, log_coeff, precision, post.mu],
                        dim=-1)                           # [C, cols, 4]
    return stack.permute(1, 2, 0).reshape(-1, stack.shape[0])


def nich_coeffs_v2(shared, group):
    """Product-form coefficient rows for one nich block: [2 + 2*cols, C] =
    [sum of per-column score constants; log_coeff; then per column prec;
    mean].  log_coeff is column-independent because nu_post = nu0 + count,
    so `nu` must be column-constant within a block."""
    nu0 = shared.nu
    if nu0.dim() > 0 and nu0.numel() > 1 and not bool(
            (nu0 == nu0.reshape(-1)[0]).all()):
        raise ValueError(
            'fused nich block requires column-constant nu (got %r); put '
            'columns with distinct nu in separate cols=1 blocks'
            % (nu0.tolist(),))
    return nich_coeffs_v2_rows(shared, group)


def nich_coeffs_v2_rows(shared, group):
    """`nich_coeffs_v2` without its check of `nu`, which reads the device:
    the sweeps check once per call (`gibbs._check_constant_nu`) and build
    the rows of every tile with this, so that a tile never waits on the
    card and can be captured into a CUDA graph."""
    post = nich_mod.plus_group(shared, group)            # leaves [C, cols]
    lambda_ = ((1.0 + post.kappa) * post.sigmasq) / post.kappa
    score = (lgamma_nu(post.nu)
             - 0.5 * torch.log(post.nu * torch.pi * lambda_))  # [C, cols]
    base_row = score.sum(1)                                    # [C]
    lc = -0.5 * (post.nu[:, 0] + 1.0)                          # [C]
    precision = 1.0 / (post.nu * lambda_)                      # [C, cols]
    rows = [base_row, lc]
    for j in range(precision.shape[1]):
        rows.append(precision[:, j])
        rows.append(post.mu[:, j])
    return torch.stack(rows, dim=0)                            # [2+2c, C]


def split_stat_sums(spec, sums):
    """[C, 3*total_cols] kernel sums -> (counts_delta [C] int32, per-block
    raw sums [C, cols, 3]) matching mixture.tile_sums_fast."""
    total_cols = sum(b.cols for b in spec.blocks)
    ones = sums[:, :total_cols]
    v = sums[:, total_cols:2 * total_cols]
    vv = sums[:, 2 * total_cols:]
    counts = torch.round(ones[:, 0]).to(torch.int32)
    out = []
    c0 = 0
    for b in spec.blocks:
        sl = slice(c0, c0 + b.cols)
        out.append(torch.stack([ones[:, sl], v[:, sl], vv[:, sl]], dim=-1))
        c0 += b.cols
    return counts, tuple(out)


def quad_stat_dim(quad_groups):
    return sum(ncols * (1 + d + d * (d + 1) // 2)
               for ncols, d in quad_groups)


def _inv_logdet_spd_small(m):
    """(inverse, logdet) of batched SPD [..., d, d] matrices: closed-form
    adjugate for d <= 3, `torch.linalg` beyond.  The closed forms can
    round a near-singular determinant to <= 0; it is clamped to the
    dtype's tiny so that log and divide stay finite."""
    d = m.shape[-1]
    tiny = torch.finfo(m.dtype).tiny
    if d == 1:
        det = torch.clamp(m[..., 0, 0], min=tiny)
        inv = (1.0 / det)[..., None, None]
    elif d == 2:
        a, b = m[..., 0, 0], m[..., 0, 1]
        c, e = m[..., 1, 0], m[..., 1, 1]
        det = torch.clamp(a * e - b * c, min=tiny)
        inv = torch.stack(
            [torch.stack([e, -b], -1), torch.stack([-c, a], -1)], -2) \
            / det[..., None, None]
    elif d == 3:
        a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
        e, f, g = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
        h, i, j = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
        A = f * j - g * i
        B = -(e * j - g * h)
        Cc = e * i - f * h
        det = torch.clamp(a * A + b * B + c * Cc, min=tiny)
        adj = torch.stack([
            torch.stack([A, -(b * j - c * i), b * g - c * f], -1),
            torch.stack([B, a * j - c * h, -(a * g - c * e)], -1),
            torch.stack([Cc, -(a * i - b * h), a * f - b * e], -1)], -2)
        inv = adj / det[..., None, None]
    else:
        # inv_ex: a singular matrix gives non-finite entries, it does not
        # raise, as in the JAX package
        return torch.linalg.inv_ex(m).inverse, torch.linalg.slogdet(m)[1]
    return inv, torch.log(det)


def niw_coeffs_v4(shared, group):
    """Quadratic-form coefficient rows for one niw block:
    [2 + cols*(d + d(d+1)/2), C] = [base; lc; then per column d mean rows
    and d(d+1)/2 upper-triangle precision rows with the off-diagonals
    pre-doubled].

    The predictive (niw.score_value) is a multivariate student-t with
    dof = nu_n - d + 1 and scale Sigma = psi_n (kappa_n+1)/(kappa_n dof),
    so with Lam = Sigma^-1/dof = psi_n^-1 kappa_n/(kappa_n+1):

        score = const + lc * log(1 + (v-mu_n)^T Lam (v-mu_n))
        lc    = -(dof+d)/2
        const = sum_i lgamma_nu(dof+i) - (d/2) log(dof*pi)
                - (1/2) logdet Sigma

    lc is column-independent within a block (nu_n = nu0 + count), which
    lets the kernel chain a block's columns into one log."""
    post = niw_mod.plus_group(shared, group)     # mu [C, cols, d], ...
    d = post.mu.shape[-1]
    dof = post.nu - d + 1.0                      # [C, cols]
    kap = post.kappa                             # [C, cols]
    psi_inv, logdet_psi = _inv_logdet_spd_small(post.psi)
    lam = psi_inv * (kap / (kap + 1.0))[..., None, None]
    logdet_sigma = logdet_psi + d * torch.log((kap + 1.0) / (kap * dof))
    # lgamma_nu(dof + i) of every i < d at once, summed in i's order
    lgs = lgamma_nu(dof[..., None] + torch.arange(d, dtype=dof.dtype,
                                                  device=dof.device))
    lg = lgs[..., 0]
    for i in range(1, d):
        lg = lg + lgs[..., i]
    const = lg - 0.5 * (d * torch.log(dof * torch.pi) + logdet_sigma)
    # the upper triangle in row-major order, off-diagonals doubled: one
    # gather a column, not d (d + 1) / 2 launches
    a, b = torch.triu_indices(d, d, device=lam.device)
    twice = (a != b).to(lam.dtype) + 1.0
    rows = [const.sum(1)[None],                  # base [C]
            -0.5 * (dof[:, 0] + d)[None]]        # lc   [C]
    for j in range(post.mu.shape[1]):
        rows.append(post.mu[:, j, :].t())
        rows.append((lam[:, j, a, b] * twice).t())
    return torch.cat(rows, dim=0)


def quad_sums_to_raw(qsums, quad_groups):
    """Kernel quad sums [C, quad_stat_dim] -> per-block raw sums
    [C, cols, 1+d+d*d] in niw.row_stat_columns order ([1 | v | full
    outer]), mirroring the upper-triangle cross products."""
    out = []
    o = 0
    for ncols, d in quad_groups:
        S = 1 + d + d * (d + 1) // 2
        cols_raw = []
        for _ in range(ncols):
            blk = qsums[:, o:o + S]
            o += S
            tri = blk[:, 1 + d:]
            full = [None] * (d * d)
            t = 0
            for a in range(d):
                for b in range(a, d):
                    full[a * d + b] = tri[:, t]
                    full[b * d + a] = tri[:, t]
                    t += 1
            cols_raw.append(torch.cat(
                [blk[:, :1 + d], torch.stack(full, dim=1)], dim=1))
        out.append(torch.stack(cols_raw, dim=1))           # [C, cols, S']
    return tuple(out)


# -- the plain twins --------------------------------------------------------

def _const_row(cl_scores, coeffs, col_groups, qcoeffs=None, quad_groups=()):
    """cl + each nich block's base + each niw block's base, in that
    order: the per-slot constants, summed once per slot."""
    const_row = cl_scores
    r = 0
    for ncols in col_groups:
        const_row = const_row + coeffs[r]
        r += 2 + 2 * ncols
    r = 0
    for ncols, d in quad_groups:
        const_row = const_row + qcoeffs[r]
        r += 2 + ncols * (d + d * (d + 1) // 2)
    return const_row


def _add_nich_terms(scores, values, coeffs, col_groups, log_):
    """scores + per block and per chunk of <= 4 columns
    lc * log(prod of (1 + prec (v - mean)^2))."""
    r = 0
    c0 = 0
    for ncols in col_groups:
        lc = coeffs[r + 1][None, :]
        r += 2
        for j0 in range(0, ncols, 4):
            prod = None
            for j in range(j0, min(j0 + 4, ncols)):
                prec = coeffs[r][None, :]
                mean = coeffs[r + 1][None, :]
                r += 2
                t = values[:, c0 + j][:, None] - mean
                f = 1.0 + prec * (t * t)
                prod = f if prod is None else prod * f
            scores = scores + lc * log_(prod)
        c0 += ncols
    return scores


def _add_quad_terms(scores, qvalues, qcoeffs, quad_groups, log_):
    """scores + per niw block and per chunk of <= 4 columns
    lc * log(prod of (1 + q)), q = sum_{a<=b} lam'_ab (v_a - mu_a)(v_b -
    mu_b) from centred differences (the expanded form cancels when
    |mu| >> |v - mu|)."""
    r = 0
    c0 = 0
    for ncols, d in quad_groups:
        lc = qcoeffs[r + 1][None, :]
        r += 2
        for j0 in range(0, ncols, 4):
            prod = None
            for j in range(j0, min(j0 + 4, ncols)):
                t = [qvalues[:, c0 + a][:, None] - qcoeffs[r + a][None, :]
                     for a in range(d)]
                r += d
                q = None
                for a in range(d):
                    for b in range(a, d):
                        term = qcoeffs[r][None, :] * (t[a] * t[b])
                        r += 1
                        q = term if q is None else q + term
                c0 += d
                f = 1.0 + q
                prod = f if prod is None else prod * f
            scores = scores + lc * log_(prod)
    return scores


def _score_nich_product(values, coeffs, cl_scores, col_groups, log_):
    """[B, C] product-form nich scores in K1's operation order: the
    per-slot constants first, then the blocks' log terms."""
    const_row = _const_row(cl_scores, coeffs, col_groups)
    scores = const_row[None, :].expand(values.shape[0], -1)
    return _add_nich_terms(scores, values, coeffs, col_groups, log_)


def _table_offsets(table_vs):
    offs = []
    o = 0
    for v in table_vs:
        offs.append(o)
        o += int(v)
    return offs


def _score_mixed(B, values, table_idx, cl_scores, coeffs, tables, col_groups,
                 qvalues, qcoeffs, quad_groups, table_vs, log_):
    """[B, C] scores in K2's operation order: constants, nich blocks, niw
    blocks, then one gathered table row per table column."""
    const_row = _const_row(cl_scores, coeffs, col_groups, qcoeffs,
                           quad_groups)
    scores = const_row[None, :].expand(B, -1)
    scores = _add_nich_terms(scores, values, coeffs, col_groups, log_)
    scores = _add_quad_terms(scores, qvalues, qcoeffs, quad_groups, log_)
    for j, off in enumerate(_table_offsets(table_vs)):
        scores = scores + tables[table_idx[:, j].long() + off]
    return scores


def _cdf_draw(scores, u, exp_):
    """Count of slots whose inclusive prefix of exp(score - rowmax) is
    strictly below t = max(u, 1e-7) * total.  The prefix is a sequential
    f32 sum in slot order, as in the kernel, and total is its last value."""
    m = torch.amax(scores, dim=1, keepdim=True)
    p = exp_(scores - m).t().contiguous()                     # [C, B]
    acc = torch.zeros_like(p[0])
    for k in range(p.shape[0]):
        acc = acc + p[k]
    t = torch.clamp(u[:, 0], min=1e-7) * acc
    acc = torch.zeros_like(p[0])
    idx = torch.zeros(p.shape[1], dtype=torch.int32, device=p.device)
    for k in range(p.shape[0]):
        acc = acc + p[k]
        idx += (acc < t).to(torch.int32)
    return idx


def _perturb(scores, mode, fast, seed, noise, slot_offset=0,
             total_slots=None):
    """[B, C] scores plus the noise of an argmax-family draw ('argmax':
    none; 'gumbel_host': `noise`; 'gumbel': from a generator seeded with
    `seed`).  The 'gumbel' words are drawn as [B, total_slots] and columns
    [slot_offset, slot_offset + C) kept, so that the shards of a slot axis
    of `total_slots` slots see the noise of the whole matrix
    (total_slots=None: slot_offset + C)."""
    if mode == 'argmax':
        return scores
    if mode == 'gumbel_host':
        return scores + noise
    log_ = fast_log if fast else torch.log
    B, C = scores.shape
    width = slot_offset + C if total_slots is None else int(total_slots)
    m = torch.randint(0, 1 << 24, (B, width), dtype=torch.int32,
                      device=scores.device,
                      generator=device_generator(seed, scores.device))
    m = m[:, slot_offset:slot_offset + C]
    inner = -log_(m.to(torch.float32) * 5.960464477539063e-08)
    del m
    return scores - log_(torch.clamp(inner, min=6e-8))


def philox_gumbel_noise(seed, B, C, slot_offset=0, fast=False, device=None):
    """The [B, C] noise that the kernels add to a score in 'gumbel' mode
    (`gumbel_perturb` of csrc/fused_common.cuh): the Philox4x32-10 block
    keyed by the 64-bit `seed` at counter (row, g // 4, 0, 0), its word
    g % 4, g = slot_offset + slot; m = the word's low 24 bits; noise =
    -log(max(-log(m * 2^-24), 6e-8)) (fast_log with `fast`).  Given to
    'gumbel_host' it reproduces the 'gumbel' draws up to the last bit of a
    log.  A plain function for checks: the twins draw their 'gumbel' noise
    from a torch generator."""
    from distributions_tpu_torch.ops.bench_kernels import (
        philox4x32_10_plain)
    seed = _check_seed(seed)
    dev = config.resolve_device(device)
    lead, q0 = slot_offset % 4, slot_offset // 4
    quads = (lead + C + 3) // 4
    rows = torch.arange(B, dtype=torch.int64, device=dev)[:, None]
    q = q0 + torch.arange(quads, dtype=torch.int64, device=dev)[None, :]
    rows, q = torch.broadcast_tensors(rows, q)
    zero = torch.zeros_like(rows)
    words = philox4x32_10_plain((rows, q, zero, zero),
                                (seed & 0xFFFFFFFF, seed >> 32))
    del rows, q, zero
    m = torch.stack(words, 2).reshape(B, 4 * quads)[:, lead:lead + C]
    del words
    log_ = fast_log if fast else torch.log
    inner = -log_((m & 0x00FFFFFF).to(torch.float32) * 5.960464477539063e-08)
    return -log_(torch.clamp(inner, min=6e-8))


def _draw(scores, mode, fast, seed, noise):
    """One slot per row of [B, C] scores -> [B] int32.  'gumbel' and 'cdf'
    draw their noise from a generator seeded with `seed` and then apply
    the '_host' formulas."""
    if mode in ('argmax', 'gumbel', 'gumbel_host'):
        idx = torch.argmax(_perturb(scores, mode, fast, seed, noise), dim=1)
    else:
        if mode == 'cdf':
            u = torch.randint(0, 1 << 24, (scores.shape[0], 1),
                              dtype=torch.int32, device=scores.device,
                              generator=device_generator(seed,
                                                         scores.device))
            u = u.to(torch.float32) * 5.960464477539063e-08
        else:
            u = noise
        idx = _cdf_draw(scores, u, fast_exp if fast else torch.exp)
    return idx.to(torch.int32)


def fused_score_sample_stats_plain(seed, values, cl_scores, coeffs,
                                   col_groups, block_rows=DEFAULT_BLOCK_ROWS,
                                   sampling='cdf', noise=None):
    """The plain PyTorch version of K1, on any device; the stat sums are
    an exact f32 one-hot contraction.  Returns (assignments [B] int32,
    sums [C, 3*cols])."""
    mode, fast = _parse_sampling(sampling)
    scores = _score_nich_product(values, coeffs, cl_scores, col_groups,
                                 fast_log if fast else torch.log)
    idx = _draw(scores, mode, fast, seed, noise)
    del scores
    stats = torch.cat([torch.ones_like(values), values, values * values],
                      dim=1)
    return idx, base.segment_sum(stats, idx, cl_scores.shape[0])


def _quad_stat_features(qvalues, quad_groups):
    """[B, quad_stat_dim] per-column stat features [1 | v | v_a v_b
    (a <= b)]."""
    feats = []
    c0 = 0
    for ncols, d in quad_groups:
        for _ in range(ncols):
            v = qvalues[:, c0:c0 + d]
            feats.append(torch.ones_like(v[:, :1]))
            feats.append(v)
            for a in range(d):
                for b in range(a, d):
                    feats.append((v[:, a] * v[:, b])[:, None])
            c0 += d
    return torch.cat(feats, dim=1)


def fused_mixed_score_sample_stats_plain(
        seed, values, table_idx, cl_scores, coeffs, tables, col_groups,
        block_rows=DEFAULT_BLOCK_ROWS, sampling='cdf', qvalues=None,
        qcoeffs=None, quad_groups=(), noise=None, table_vs=()):
    """The plain PyTorch version of K2, on any device: scores by
    broadcasting and `tables[off_j + idx_j]` indexing, K1's draws, and
    the sums as exact f32 one-hot contractions of the stat features.
    Same arguments and results as `fused_mixed_score_sample_stats`."""
    mode, fast = _parse_sampling(sampling)
    C = cl_scores.shape[0]
    B = _mixed_rows(values, qvalues, table_idx)
    scores = _score_mixed(B, values, table_idx, cl_scores, coeffs, tables,
                          col_groups, qvalues, qcoeffs, quad_groups, table_vs,
                          fast_log if fast else torch.log)
    idx = _draw(scores, mode, fast, seed, noise)
    del scores
    return (idx,) + _mixed_stat_sums(idx, C, values, table_idx, col_groups,
                                     qvalues, quad_groups, table_vs)


def _mixed_stat_sums(idx, C, values, table_idx, col_groups, qvalues,
                     quad_groups, table_vs):
    """(nich sums [C, 3*ncols], count tables [C, Vtot], quad sums
    [C, quad_stat_dim]) of the draws `idx`: exact f32 one-hot contractions
    of the stat features; a family that is absent gives [C, 0]."""
    dev = idx.device
    B = idx.shape[0]
    empty = torch.zeros((C, 0), dtype=torch.float32, device=dev)
    sums = qsums = tcounts = empty
    if col_groups:
        stats = torch.cat([torch.ones_like(values), values, values * values],
                          dim=1)
        sums = base.segment_sum(stats, idx, C)
    if quad_groups:
        qsums = base.segment_sum(_quad_stat_features(qvalues, quad_groups),
                                 idx, C)
    if table_vs:
        onehot = torch.zeros((B, sum(table_vs)), dtype=torch.float32,
                             device=dev)
        rows = torch.arange(B, device=dev)
        for j, off in enumerate(_table_offsets(table_vs)):
            onehot[rows, table_idx[:, j].long() + off] = 1.0
        tcounts = base.segment_sum(onehot, idx, C)
    return sums, tcounts, qsums


def _mixed_rows(values, qvalues, table_idx):
    for t in (values, qvalues, table_idx):
        if t is not None:
            return t.shape[0]
    raise ValueError('no nich, niw or table columns given')


# the draws of K3: a cdf draw has no pair reduce
PAIR_SAMPLING = ('argmax', 'gumbel', 'gumbel_host')


def _parse_pair_sampling(sampling):
    mode, fast = _parse_sampling(sampling)
    if mode not in PAIR_SAMPLING:
        raise ValueError('sampling %r: the pair kernel draws with '
                         "'gumbel', 'argmax' or 'gumbel_host' (optionally "
                         "'_fast')" % (sampling,))
    return mode, fast


def fused_score_sample_pair_plain(
        seed, values, table_idx, cl_scores, coeffs, tables, col_groups,
        block_rows=DEFAULT_BLOCK_ROWS, sampling='gumbel', qvalues=None,
        qcoeffs=None, quad_groups=(), table_vs=(), noise=None,
        slot_offset=0, total_slots=None):
    """The plain PyTorch version of K3, on any device: K2's scores over
    the shard's slots, the argmax-family noise, then the first maximal
    slot and its perturbed score.  Same arguments and results as
    `fused_score_sample_pair`.  In 'gumbel' its generator fills the noise
    of the whole [B, total_slots] matrix and the shard keeps its columns:
    with total_slots given, the shards of one slot axis, pair-reduced,
    draw what `fused_mixed_score_sample_stats_plain` draws on the whole
    axis with that seed."""
    mode, fast = _parse_pair_sampling(sampling)
    B = _mixed_rows(values, qvalues, table_idx)
    scores = _score_mixed(B, values, table_idx, cl_scores, coeffs, tables,
                          tuple(col_groups), qvalues, qcoeffs, quad_groups,
                          table_vs, fast_log if fast else torch.log)
    total = _perturb(scores, mode, fast, _seed_value(seed), noise,
                     int(slot_offset), total_slots)
    del scores
    idx = torch.argmax(total, dim=1)
    best = total.gather(1, idx[:, None])[:, 0]
    return idx.to(torch.int32), best


# the draws of K4 and K5
V1_SAMPLING = ('gumbel', 'argmax', 'gumbel_host')


def _parse_v1_sampling(sampling):
    if sampling not in V1_SAMPLING:
        raise ValueError('sampling %r: the v1 score + sample kernels draw '
                         "with 'gumbel', 'argmax' or 'gumbel_host'"
                         % (sampling,))
    return sampling


def _score_v1(B, nich_values, table_indices, cl_scores, coeffs, tables):
    """[B, C] scores in the operation order of K4 and K5: cl, then per
    nich column (scores + score) + log_coeff * log1p((prec * t) * t), then
    one gathered table row per table column."""
    scores = cl_scores[None, :].expand(B, -1)
    ncols = 0 if nich_values is None else nich_values.shape[1]
    for j in range(ncols):
        score, log_coeff, prec, mean = (coeffs[4 * j + i][None, :]
                                        for i in range(4))
        t = nich_values[:, j][:, None] - mean
        scores = scores + score + log_coeff * torch.log1p(prec * t * t)
    tcols = 0 if table_indices is None else table_indices.shape[1]
    for j in range(tcols):
        scores = scores + tables[j][table_indices[:, j].long()]
    return scores


def nich_score_sample_plain(seed, values, cl_scores, coeffs,
                            block_rows=DEFAULT_BLOCK_ROWS, sampling='gumbel',
                            noise=None):
    """The plain PyTorch version of K4, on any device; the seed an int or
    a 1-element int64 tensor, as the kernel takes it.  Returns assignments
    [B] int32."""
    mode = _parse_v1_sampling(sampling)
    scores = _score_v1(values.shape[0], values, None, cl_scores, coeffs,
                       None)
    return _draw(scores, mode, False, _seed_value(seed), noise)


def mixed_score_sample_plain(seed, nich_values, table_indices, cl_scores,
                             coeffs, tables, block_rows=DEFAULT_BLOCK_ROWS,
                             sampling='gumbel', noise=None):
    """The plain PyTorch version of K5, on any device: nich terms by
    broadcasting, table terms by `tables[j][idx_j]` indexing.  Same
    arguments and result as `mixed_score_sample`."""
    mode = _parse_v1_sampling(sampling)
    B = _mixed_rows(nich_values, None, table_indices)
    scores = _score_v1(B, nich_values, table_indices, cl_scores, coeffs,
                       tables)
    return _draw(scores, mode, False, _seed_value(seed), noise)


# -- the Hopper kernels -----------------------------------------------------

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'csrc')
# device code that the kernel sources include
_HEADERS = ('fused_common.cuh', 'fused_split.cuh', 'fused_stats.cuh',
            'hopper.cuh')
KERNELS = ('fused_v2', 'fused_v3', 'score_sample_v1', 'roofline',
           'sampler_bench', 'step_clock')
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), 'build', 'torch_kernels')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P, _I, _U64, _I64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64,
                      ctypes.c_longlong)
_IP = ctypes.POINTER(_I)
_LAYOUT = [_I, _IP, _I, _IP, _IP, _I, _IP]
# library -> its C entry points that launch a kernel -> their argument
# types (the wrappers of roofline and sampler_bench are in
# ops/bench_kernels.py)
_LAUNCHERS = {
    'fused_v2': {
        'fused_v2_launch': [_P] * 8 + [_I, _I, _I, _IP, _I, _I, _U64, _P,
                                       _P],
        'fused_v2_stats_launch': [_P] * 5 + [_I, _I, _I, _P],
        'fused_v2_phase_launch': [_P] * 6 + [_I, _I, _I, _IP, _I, _I, _I,
                                             _U64, _P]},
    'fused_v3': {
        'fused_v3_launch': [_P] * 15 + [_I, _I] + _LAYOUT + [_I, _I, _U64,
                                                             _P, _P],
        'fused_v3_stats_launch': [_P] * 10 + [_I, _I] + _LAYOUT + [_P],
        'fused_v3_pair_launch': [_P] * 10 + [_I, _I] + _LAYOUT + [
            _I, _I, _U64, _P, _I, _P]},
    'score_sample_v1': {
        'score_sample_v1_nich_launch': [_P] * 5 + [_I, _I, _I, _I, _U64, _P,
                                                   _P],
        'score_sample_v1_mixed_launch': [_P] * 7 + [_I] * 6 + [_U64, _P,
                                                                 _P]},
    'roofline': {
        'roofline_chain_launch': [_P, _P, _I64, _I, _I, _I, _P],
        'roofline_copy_launch': [_P, _P, _I64, _P],
        'roofline_mma_launch': [_P] * 6 + [_I, _I, _P]},
    'sampler_bench': {
        'sampler_bench_launch': [_P] * 5 + [_I, _I, _I, _I, _U64, _P]},
    'step_clock': {
        'step_clock_mark_launch': [_P, _I, _P, ctypes.POINTER(_P)],
        'step_clock_set_enabled': [_P, _P, _I]},
}

# library -> its C entry points that report on a kernel without launching
# it (the split kernel's occupancy, the stat stage's plan) -> their
# argument types
_QUERIES = {
    'fused_v2': {'fused_v2_occupancy': [_I, _I, _IP, _I, _I, _I, _IP],
                 'fused_v2_stat_plan': [_I, _I, _I, _IP]},
    'fused_v3': {'fused_v3_occupancy': [_I] + _LAYOUT + [_I, _I, _IP],
                 'fused_v3_split_shape': _LAYOUT + [_IP],
                 'fused_v3_stat_plan': [_I, _I] + _LAYOUT + [_IP]},
    'score_sample_v1': {'score_sample_v1_occupancy': [_I, _I, _I, _I, _IP]},
}

# (name, -D definitions) -> the loaded library
_LIBRARIES = {}


def _nvcc():
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: building the fused kernels '
                           'needs the CUDA toolkit')
    return path


def _bind(name, lib):
    for launch, argtypes in dict(_LAUNCHERS[name],
                                 **_QUERIES.get(name, {})).items():
        getattr(lib, launch).argtypes = argtypes
        getattr(lib, launch).restype = _I
    getattr(lib, name + '_error_string').argtypes = [_I]
    getattr(lib, name + '_error_string').restype = ctypes.c_char_p


def _start_build(name, defines=()):
    """Start nvcc on csrc/<name>.cu unless its library exists already (one
    library per content of the source, the shared headers and the flags).
    Returns what `_finish_build` needs."""
    src = os.path.join(_CSRC, name + '.cu')
    flags = NVCC_FLAGS + tuple('-D' + d for d in defines)
    h = hashlib.sha1(' '.join(flags).encode())
    for path in (src,) + tuple(os.path.join(_CSRC, n) for n in _HEADERS):
        with open(path, 'rb') as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, '%s_%s.so' % (name, h.hexdigest()[:12]))
    if os.path.exists(so):
        return name, so, None, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen([_nvcc(), *flags, '-o', tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return name, so, tmp, proc, time.time()


def _finish_build(name, so, tmp, proc, t0):
    log_path = so + '.log'
    seconds = 0.0
    if proc is not None:
        output, _ = proc.communicate()
        seconds = time.time() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError('nvcc failed on csrc/%s.cu:\n%s'
                               % (name, output))
        with open(log_path, 'w') as f:
            f.write(output)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    _bind(name, lib)
    report = ''
    if os.path.exists(log_path):
        with open(log_path) as f:
            report = f.read()
    return dict(lib=lib, seconds=seconds, report=report, path=so)


def build(name, defines=()):
    """Compile csrc/<name>.cu (a name in KERNELS) with nvcc into
    BUILD_DIR, once per content of the source, the shared headers and the
    flags, and load it.  `defines` ('NAME=VALUE' each, given to nvcc as
    -D) builds a compile-time design variant as a library of its own; the
    wrappers use the default one.  Returns a dict with the ctypes library,
    the build seconds (0 when it was already built) and the compiler's
    register and shared-memory report."""
    key = (name, tuple(defines))
    if key not in _LIBRARIES:
        _LIBRARIES[key] = _finish_build(*_start_build(name, key[1]))
    return _LIBRARIES[key]


def build_all():
    """Build every kernel, with all the compilers started together.
    Returns {name: build(name)}."""
    started = [_start_build(name) for name in KERNELS
               if (name, ()) not in _LIBRARIES]
    for job in started:
        _LIBRARIES[(job[0], ())] = _finish_build(*job)
    return {name: _LIBRARIES[(name, ())] for name in KERNELS}


def _check(name, t, device, shape, dtype=torch.float32):
    if not isinstance(t, torch.Tensor):
        raise TypeError('%s must be a tensor' % name)
    if t.device != device:
        raise ValueError('%s is on %s, expected %s' % (name, t.device,
                                                       device))
    if t.dtype != dtype:
        raise TypeError('%s has dtype %s, expected %s' % (name, t.dtype,
                                                          dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError('%s has shape %s, expected %s'
                         % (name, tuple(t.shape), tuple(shape)))
    if not t.is_contiguous():
        raise ValueError('%s must be contiguous' % name)


def _check_noise(mode, sampling, noise, dev, B, C):
    if mode == 'gumbel_host':
        _check('noise', noise, dev, (B, C))
    elif mode == 'cdf_host':
        _check('noise', noise, dev, (B, 1))
    elif noise is not None:
        raise ValueError('sampling %r takes no noise' % (sampling,))


def _check_seed(seed):
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError('seed must be in [0, 2**64)')
    return seed


def _is_seed_tensor(seed):
    """K1-K5 take their seed as an int or as a 1-element int64 tensor
    (the form a CUDA graph replays: the kernel reads it from device
    memory when it runs).  True for the tensor form, after checking it."""
    if not isinstance(seed, torch.Tensor):
        return False
    if seed.dtype != torch.int64 or seed.numel() != 1:
        raise ValueError('a seed tensor must hold one int64, got %s %s'
                         % (seed.dtype, tuple(seed.shape)))
    return True


def _seed_value(seed):
    """The seed as a checked int, from either form; the twins' form (on
    the card this reads the device)."""
    if _is_seed_tensor(seed):
        seed = int(seed.reshape(()))
        # the tensor holds the seed's 64 bits as a signed int64
        seed &= (1 << 64) - 1
    return _check_seed(seed)


def _seed_args(seed, dev):
    """(seed, seed_ptr) of a K1-K5 launch on `dev`: (the int,
    None), or (0, the tensor's address) for a seed tensor on `dev`."""
    if not _is_seed_tensor(seed):
        return _check_seed(seed), None
    if seed.device != dev:
        raise ValueError('the seed tensor is on %s, the launch on %s'
                         % (seed.device, dev))
    return 0, seed.data_ptr()


def _check_col_groups(col_groups, lowest):
    col_groups = tuple(int(c) for c in col_groups)
    if not lowest <= len(col_groups) <= MAX_GROUPS or (
            col_groups and min(col_groups) < 1):
        raise ValueError('col_groups %r: %d..%d groups of >= 1 column'
                         % (col_groups, lowest, MAX_GROUPS))
    if sum(col_groups) > MAX_COLS:
        raise ValueError('at most %d nich columns, got %d'
                         % (MAX_COLS, sum(col_groups)))
    return col_groups


def _int_array(xs):
    return (ctypes.c_int * max(len(xs), 1))(*xs)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(name, lib, err):
    if err != 0:
        msg = getattr(lib, name + '_error_string')(err).decode()
        raise RuntimeError('%s kernel launch failed: %s (%d)'
                           % (name, msg, err))


def split_occupancy(name, C, col_groups, quad_groups=(), table_vs=(),
                    sampling='gumbel', phase=0):
    """What the split kernel that a launch of library `name` ('fused_v2':
    K1 and B5, `phase` as B5's codes; 'fused_v3': K2 and K3;
    'score_sample_v1': K4 and K5, with sum(col_groups) nich columns and
    len(table_vs) table columns) takes for this layout and draw at C
    slots: its registers, local (spill) bytes, dynamic shared memory,
    record floats, turns of the slot axis, threads and resident blocks per
    SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor); for 'fused_v3'
    also its `shape` (`split_shape`).  Needs the card; 'cdf' draws take
    the sequential walk and raise."""
    lib = build(name)['lib']
    info = (ctypes.c_int * 7)()
    if name == 'score_sample_v1':
        err = lib.score_sample_v1_occupancy(
            C, sum(col_groups), len(table_vs),
            SAMPLING_MODES[_parse_v1_sampling(sampling)], info)
    else:
        mode, fast = _parse_sampling(sampling)
        if name == 'fused_v2':
            err = lib.fused_v2_occupancy(C, len(col_groups),
                                         _int_array(col_groups), phase,
                                         SAMPLING_MODES[mode], int(fast),
                                         info)
        else:
            err = lib.fused_v3_occupancy(
                C, *_layout_args(col_groups, quad_groups, table_vs),
                SAMPLING_MODES[mode], int(fast), info)
    _raise_on(name, lib, err)
    report = dict(zip(('blocks_per_sm', 'threads_per_block', 'smem_bytes',
                       'record_floats', 'turns', 'registers',
                       'local_bytes'), info))
    if name == 'fused_v3':
        report['shape'] = split_shape(col_groups, quad_groups, table_vs)
    return report


# (col_groups, quad_groups, table_vs) -> its SPLIT_SHAPES name
_SPLIT_SHAPE = {}


def split_shape(col_groups, quad_groups=(), table_vs=()):
    """The split walk's shape (a SPLIT_SHAPES name) that K2 and K3 take
    for this layout in 'argmax', 'gumbel' and 'gumbel_host'.  Needs the
    card."""
    key = (tuple(col_groups), tuple(quad_groups), tuple(table_vs))
    if key not in _SPLIT_SHAPE:
        lib = build('fused_v3')['lib']
        code = _I()
        _raise_on('fused_v3', lib, lib.fused_v3_split_shape(
            *_layout_args(*key), ctypes.byref(code)))
        _SPLIT_SHAPE[key] = SPLIT_SHAPES[code.value]
    return _SPLIT_SHAPE[key]


def stat_blocks(B):
    """Blocks of the stat stage's launch over B rows
    (csrc/fused_stats.cuh stat_rows_per_block): one per SM of the H100
    (STAT_GRID), each of a multiple of 32 rows, at most STAT_MAX_ROWS."""
    rows = -(-B // STAT_GRID)
    rows = min(STAT_MAX_ROWS, -(-rows // 32) * 32)
    return -(-B // rows)


def stat_scratch(B, C, S, dev):
    """The stat stage's scratch for B rows of S float features against C
    slots: per-block partials [blocks, S, C] f32 and their slot bits
    [blocks, ceil(C / 32)] (int32 words)."""
    nblocks = stat_blocks(B)
    return (torch.empty((nblocks, S, C), dtype=torch.float32, device=dev),
            torch.empty((nblocks, -(-C // 32)), dtype=torch.int32,
                        device=dev))


def _mixed_stat_outputs(B, C, ncols, quad_groups, vtot, dev):
    """(partials, bmask, sums, qsums, tcounts_i, tcounts): the scratch and
    outputs of K2's stat stage, in the order fused_v3_launch takes them."""
    qdim = quad_stat_dim(quad_groups)

    def empty(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)
    return stat_scratch(B, C, 3 * ncols + qdim, dev) + (
        empty((C, 3 * ncols)), empty((C, qdim)),
        empty((C, vtot), torch.int32), empty((C, vtot)))


def stat_plan(name, B, C, col_groups, quad_groups=(), table_vs=()):
    """How the stat stage of library `name` ('fused_v2': K1, nich column
    groups `col_groups`; 'fused_v3': K2's layout) cuts a launch of B rows
    against C slots: rows a block, rows staged at once, warps, slots a
    chunk, whether the count tables sit in shared memory, blocks and
    dynamic shared memory bytes.  Needs the card."""
    lib = build(name)['lib']
    info = (ctypes.c_int * 7)()
    if name == 'fused_v2':
        err = lib.fused_v2_stat_plan(B, C, sum(col_groups), info)
    else:
        err = lib.fused_v3_stat_plan(
            B, C, *_layout_args(col_groups, quad_groups, table_vs), info)
    _raise_on(name, lib, err)
    return dict(zip(('rows_per_block', 'staged_rows', 'warps', 'chunk_slots',
                     'tables_in_shared', 'blocks', 'smem_bytes'), info))


def _launch(seed, values, cl_scores, coeffs, col_groups, sampling, noise):
    mode, fast = _parse_sampling(sampling)
    col_groups = _check_col_groups(col_groups, 1)
    total_cols = sum(col_groups)
    dev = values.device
    if values.dim() != 2 or values.shape[0] < 1:
        raise ValueError('values must be [B >= 1, cols], got %s'
                         % (tuple(values.shape),))
    B = values.shape[0]
    if cl_scores.dim() != 1 or cl_scores.shape[0] < 1:
        raise ValueError('cl_scores must be [C >= 1]')
    C = cl_scores.shape[0]
    _check('values', values, dev, (B, total_cols))
    _check('cl_scores', cl_scores, dev, (C,))
    _check('coeffs', coeffs, dev, (sum(2 + 2 * c for c in col_groups), C))
    _check_noise(mode, sampling, noise, dev, B, C)
    seed, seed_ptr = _seed_args(seed, dev)

    lib = build('fused_v2')['lib']
    out = torch.empty(B, dtype=torch.int32, device=dev)
    partials, bmask = stat_scratch(B, C, 3 * total_cols, dev)
    sums = torch.empty((C, 3 * total_cols), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_v2_launch(
            values.data_ptr(), cl_scores.data_ptr(), coeffs.data_ptr(),
            _ptr(noise), out.data_ptr(), partials.data_ptr(),
            bmask.data_ptr(), sums.data_ptr(), B, C, len(col_groups),
            _int_array(col_groups), SAMPLING_MODES[mode], int(fast), seed,
            seed_ptr, stream)
    _raise_on('fused_v2', lib, err)
    fused_score_sample_stats.launches += 1
    return out, sums


def fused_score_sample_stats(seed, values, cl_scores, coeffs, col_groups,
                             block_rows=DEFAULT_BLOCK_ROWS, interpret=False,
                             sampling='cdf', noise=None):
    """K1: fused score + sample + stat sums for nich feature blocks.

    values: [B, total_cols] f32; cl_scores: [C]; coeffs: [rows, C] in the
    nich_coeffs_v2 layout; col_groups: per-block ncols.  seed: the per-tile
    seed of 'gumbel' and 'cdf', an int in [0, 2**64) or a 1-element int64
    tensor on the launch's device holding its bits, which the kernel reads
    when it runs (the form that a CUDA graph replays).  Returns
    (assignments [B] int32, stat_sums [C, 3*total_cols] f32) with columns
    [ones-block | v-block | v^2-block].

    sampling: 'cdf' | 'gumbel' | 'argmax', optionally with a '_fast'
    suffix (polynomial fast_log/fast_exp), or 'cdf_host' | 'gumbel_host'
    taking `noise` ([B, 1] uniform / [B, C] gumbel).

    CPU tensors run the plain twin; CUDA tensors launch the kernel or
    raise.  `block_rows` and `interpret` are kept for parity with the JAX
    signature: the CUDA kernel picks its own rows per block and has no
    interpret mode."""
    if values.device.type == 'cpu':
        return fused_score_sample_stats_plain(
            _seed_value(seed), values, cl_scores, coeffs, col_groups,
            block_rows=block_rows, sampling=sampling, noise=noise)
    if values.device.type != 'cuda':
        raise ValueError('fused_score_sample_stats runs on CPU or CUDA '
                         'tensors, got %s' % values.device)
    return _launch(seed, values, cl_scores, coeffs, col_groups, sampling,
                   noise)


fused_score_sample_stats.launches = 0


def _check_mixed(values, table_idx, cl_scores, coeffs, tables, col_groups,
                 qvalues, qcoeffs, quad_groups, table_vs):
    """Raise on inputs that K2 and K3 do not take.  Returns (device, B, C,
    col_groups)."""
    col_groups = _check_col_groups(col_groups, 0)
    if len(quad_groups) > MAX_GROUPS or any(
            nc < 1 or not 1 <= d <= MAX_D for nc, d in quad_groups):
        raise ValueError('quad_groups %r: at most %d groups of (>= 1 '
                         'columns, 1 <= d <= %d)'
                         % (quad_groups, MAX_GROUPS, MAX_D))
    qvals = sum(nc * d for nc, d in quad_groups)
    if qvals > MAX_QVALS:
        raise ValueError('at most %d niw value columns (sum of cols * d), '
                         'got %d' % (MAX_QVALS, qvals))
    if len(table_vs) > MAX_TABLE_COLS or any(v < 1 for v in table_vs):
        raise ValueError('table_vs %r: at most %d table columns of >= 1 '
                         'value' % (table_vs, MAX_TABLE_COLS))
    vtot = sum(table_vs)
    if vtot > MAX_VTOT:
        raise ValueError('at most %d packed table rows, got %d'
                         % (MAX_VTOT, vtot))
    if not isinstance(cl_scores, torch.Tensor) or cl_scores.dim() != 1 \
            or cl_scores.shape[0] < 1:
        raise ValueError('cl_scores must be [C >= 1]')
    dev = cl_scores.device
    C = cl_scores.shape[0]
    B = _mixed_rows(values if col_groups else None,
                    qvalues if quad_groups else None,
                    table_idx if table_vs else None)
    if B < 1:
        raise ValueError('need at least one row')
    _check('cl_scores', cl_scores, dev, (C,))
    if col_groups:
        _check('values', values, dev, (B, sum(col_groups)))
        _check('coeffs', coeffs, dev,
               (sum(2 + 2 * c for c in col_groups), C))
    if quad_groups:
        _check('qvalues', qvalues, dev, (B, qvals))
        _check('qcoeffs', qcoeffs, dev,
               (sum(2 + nc * (d + d * (d + 1) // 2)
                    for nc, d in quad_groups), C))
    if table_vs:
        _check('table_idx', table_idx, dev, (B, len(table_vs)), torch.int32)
        _check('tables', tables, dev, (vtot, C))
    return dev, B, C, col_groups


def _mixed_pointers(values, table_idx, cl_scores, coeffs, tables, col_groups,
                    qvalues, qcoeffs, quad_groups, table_vs, noise):
    """The eight input pointers that fused_v3_launch and
    fused_v3_pair_launch take first."""
    return (_ptr(values if col_groups else None),
            _ptr(qvalues if quad_groups else None),
            _ptr(table_idx if table_vs else None), cl_scores.data_ptr(),
            _ptr(coeffs if col_groups else None),
            _ptr(qcoeffs if quad_groups else None),
            _ptr(tables if table_vs else None), _ptr(noise))


def _layout_args(col_groups, quad_groups, table_vs):
    """The layout arguments of fused_v3_launch and fused_v3_pair_launch."""
    return (len(col_groups), _int_array(col_groups), len(quad_groups),
            _int_array([nc for nc, _ in quad_groups]),
            _int_array([d for _, d in quad_groups]), len(table_vs),
            _int_array(table_vs))


def _launch_mixed(seed, values, table_idx, cl_scores, coeffs, tables,
                  col_groups, sampling, qvalues, qcoeffs, quad_groups, noise,
                  table_vs):
    mode, fast = _parse_sampling(sampling)
    dev, B, C, col_groups = _check_mixed(
        values, table_idx, cl_scores, coeffs, tables, col_groups, qvalues,
        qcoeffs, quad_groups, table_vs)
    ncols = sum(col_groups)
    vtot = sum(table_vs)
    _check_noise(mode, sampling, noise, dev, B, C)
    seed, seed_ptr = _seed_args(seed, dev)

    lib = build('fused_v3')['lib']
    out = torch.empty(B, dtype=torch.int32, device=dev)
    outputs = _mixed_stat_outputs(B, C, ncols, quad_groups, vtot, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_v3_launch(
            *_mixed_pointers(values, table_idx, cl_scores, coeffs, tables,
                             col_groups, qvalues, qcoeffs, quad_groups,
                             table_vs, noise),
            out.data_ptr(), *(t.data_ptr() for t in outputs), B, C,
            *_layout_args(col_groups, quad_groups, table_vs),
            SAMPLING_MODES[mode], int(fast), seed, seed_ptr, stream)
    _raise_on('fused_v3', lib, err)
    fused_mixed_score_sample_stats.launches += 1
    shape = ('sequential' if mode in ('cdf', 'cdf_host')
             else split_shape(col_groups, quad_groups, table_vs))
    counts = fused_mixed_score_sample_stats.shape_launches
    counts[shape] = counts.get(shape, 0) + 1
    _, _, sums, qsums, _, tcounts = outputs
    return out, sums, tcounts, qsums


def fused_mixed_score_sample_stats(seed, values, table_idx, cl_scores,
                                   coeffs, tables, col_groups,
                                   block_rows=DEFAULT_BLOCK_ROWS,
                                   interpret=None, sampling='cdf',
                                   qvalues=None, qcoeffs=None,
                                   quad_groups=(), noise=None,
                                   table_vs=()):
    """K2: fused score + sample + stats for mixed nich + discrete + niw
    specs.

    values: [B, ncols] f32 nich columns with coeffs / col_groups as in
    `fused_score_sample_stats` (None and () for a spec without nich
    blocks); table_idx: [B, table_cols] int32 support indices; tables:
    PACKED [Vtot, C] f32 score tables, column j's [table_vs[j], C] table
    at rows [off_j, off_j + table_vs[j]) with off = exclusive prefix sums
    of table_vs and Vtot = sum(table_vs); qvalues: [B, sum(cols*d)] f32
    niw columns; qcoeffs: rows in the niw_coeffs_v4 layout; quad_groups:
    tuple of (ncols, d).  Table entries are floored at -1e30, so a -inf
    entry stays unselectable and never makes a NaN.  seed: as in
    `fused_score_sample_stats`, an int or a 1-element int64 tensor.

    Returns (assignments [B] int32, nich stat sums [C, 3*ncols] f32,
    PACKED count tables [C, Vtot] f32 (slice per column at the same
    offsets), quad sums [C, quad_stat_dim] f32 with per-column blocks
    [1 | v | upper-triangle v v^T]); a family that is absent gives [C, 0].

    A nich-only call falls through to K1.  Otherwise CPU tensors run the
    plain twin, CUDA tensors launch the kernel or raise.  `block_rows` and
    `interpret` are kept for parity with the JAX signature."""
    col_groups = tuple(col_groups)
    quad_groups = tuple((int(nc), int(d)) for nc, d in quad_groups)
    table_vs = tuple(int(v) for v in table_vs)
    if not table_vs and not quad_groups:
        out, sums = fused_score_sample_stats(
            seed, values, cl_scores, coeffs, col_groups,
            block_rows=block_rows, interpret=interpret, sampling=sampling,
            noise=noise)
        C = cl_scores.shape[0]
        empty = torch.zeros((C, 0), dtype=torch.float32, device=sums.device)
        return out, sums, empty, empty
    if table_vs:
        tables = torch.clamp(tables, min=-1e30)
    if cl_scores.device.type == 'cpu':
        return fused_mixed_score_sample_stats_plain(
            _seed_value(seed), values, table_idx, cl_scores, coeffs, tables,
            col_groups, block_rows=block_rows, sampling=sampling,
            qvalues=qvalues, qcoeffs=qcoeffs, quad_groups=quad_groups,
            noise=noise, table_vs=table_vs)
    if cl_scores.device.type != 'cuda':
        raise ValueError('fused_mixed_score_sample_stats runs on CPU or '
                         'CUDA tensors, got %s' % cl_scores.device)
    return _launch_mixed(seed, values, table_idx, cl_scores, coeffs, tables,
                         col_groups, sampling, qvalues, qcoeffs, quad_groups,
                         noise, table_vs)


fused_mixed_score_sample_stats.launches = 0
# launches by the split walk's shape (SPLIT_SHAPES; 'sequential': the
# 'cdf' walk), eager and at a CUDA graph's capture (a replay calls no
# Python)
fused_mixed_score_sample_stats.shape_launches = {}


def _launch_pair(seed, values, table_idx, cl_scores, coeffs, tables,
                 col_groups, sampling, qvalues, qcoeffs, quad_groups,
                 table_vs, noise, slot_offset):
    mode, fast = _parse_pair_sampling(sampling)
    dev, B, C, col_groups = _check_mixed(
        values, table_idx, cl_scores, coeffs, tables, col_groups, qvalues,
        qcoeffs, quad_groups, table_vs)
    _check_noise(mode, sampling, noise, dev, B, C)
    seed, seed_ptr = _seed_args(seed, dev)

    lib = build('fused_v3')['lib']
    out = torch.empty(B, dtype=torch.int32, device=dev)
    best = torch.empty(B, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_v3_pair_launch(
            *_mixed_pointers(values, table_idx, cl_scores, coeffs, tables,
                             col_groups, qvalues, qcoeffs, quad_groups,
                             table_vs, noise),
            out.data_ptr(), best.data_ptr(), B, C,
            *_layout_args(col_groups, quad_groups, table_vs),
            SAMPLING_MODES[mode], int(fast), seed, seed_ptr, slot_offset,
            stream)
    _raise_on('fused_v3', lib, err)
    fused_score_sample_pair.launches += 1
    return out, best


def fused_score_sample_pair(seed, values, table_idx, cl_scores, coeffs,
                            tables, col_groups,
                            block_rows=DEFAULT_BLOCK_ROWS, interpret=None,
                            sampling='gumbel', qvalues=None, qcoeffs=None,
                            quad_groups=(), table_vs=(), noise=None,
                            slot_offset=0, total_slots=None):
    """K3: fused score + LOCAL argmax pair over one component shard's slot
    range, for the component-sharded sweeps.

    The operands are those of `fused_mixed_score_sample_stats` (tables
    PACKED [Vtot, C_local] with table_vs; a nich-only call is served too),
    with cl_scores, coeffs, qcoeffs and tables holding the shard's C_local
    slots.  Returns (idx [B] int32 local slot ids, best [B] f32 their
    perturbed scores): idx is the first maximal local slot.  Across shards
    the caller keeps the largest best and, at equal best, the lowest
    global slot.

    sampling: 'gumbel' (Philox in the kernel, optionally '_fast') |
    'argmax' | 'gumbel_host' taking `noise` [B, C_local].  seed: as in
    `fused_score_sample_stats`, an int in [0, 2**64) or a 1-element int64
    tensor that the kernel reads when it runs.  slot_offset (>= 0, any
    value): the global id of the shard's slot 0.  The 'gumbel' noise of
    a cell is counted by (row, slot_offset + local slot), so with one
    seed for all shards of a row block the shards' pairs, reduced, give
    exactly the slot that
    `fused_mixed_score_sample_stats` draws on the whole slot axis with
    that seed.  total_slots: the width of the whole slot axis; only the
    twin needs it (its generator is not counter-based), to give the same
    property on CPU tensors.

    CPU tensors run the plain twin; CUDA tensors launch the kernel or
    raise.  `block_rows` and `interpret` are kept for parity with the JAX
    signature."""
    col_groups = tuple(col_groups)
    quad_groups = tuple((int(nc), int(d)) for nc, d in quad_groups)
    table_vs = tuple(int(v) for v in table_vs)
    slot_offset = int(slot_offset)
    if slot_offset < 0:
        raise ValueError('slot_offset must be >= 0')
    if table_vs:
        tables = torch.clamp(tables, min=-1e30)
    if cl_scores.device.type == 'cpu':
        return fused_score_sample_pair_plain(
            seed, values, table_idx, cl_scores, coeffs, tables, col_groups,
            block_rows=block_rows, sampling=sampling, qvalues=qvalues,
            qcoeffs=qcoeffs, quad_groups=quad_groups, table_vs=table_vs,
            noise=noise, slot_offset=slot_offset, total_slots=total_slots)
    if cl_scores.device.type != 'cuda':
        raise ValueError('fused_score_sample_pair runs on CPU or CUDA '
                         'tensors, got %s' % cl_scores.device)
    return _launch_pair(seed, values, table_idx, cl_scores, coeffs, tables,
                        col_groups, sampling, qvalues, qcoeffs, quad_groups,
                        table_vs, noise, slot_offset)


fused_score_sample_pair.launches = 0


def _launch_v1(seed, nich_values, table_indices, cl_scores, coeffs, tables,
               sampling, noise, wrapper):
    """Launch K4 (`wrapper` is nich_score_sample: nich columns only) or K5
    (mixed_score_sample) and count the launch on `wrapper`."""
    mode = _parse_v1_sampling(sampling)
    if cl_scores.dim() != 1 or cl_scores.shape[0] < 1:
        raise ValueError('cl_scores must be [C >= 1]')
    dev = cl_scores.device
    C = cl_scores.shape[0]
    B = _mixed_rows(nich_values, None, table_indices)
    if B < 1:
        raise ValueError('need at least one row')
    ncols = tcols = V = 0
    _check('cl_scores', cl_scores, dev, (C,))
    if nich_values is not None:
        if nich_values.dim() != 2 or not 1 <= nich_values.shape[1] <= MAX_COLS:
            raise ValueError('nich values must be [B, 1..%d columns], got %s'
                             % (MAX_COLS, tuple(nich_values.shape)))
        ncols = nich_values.shape[1]
        _check('values', nich_values, dev, (B, ncols))
        _check('coeffs', coeffs, dev, (4 * ncols, C))
    if table_indices is not None:
        if table_indices.dim() != 2 or not (
                1 <= table_indices.shape[1] <= MAX_TABLE_COLS):
            raise ValueError('table_indices must be [B, 1..%d columns], got '
                             '%s' % (MAX_TABLE_COLS,
                                     tuple(table_indices.shape)))
        tcols = table_indices.shape[1]
        if not isinstance(tables, torch.Tensor) or tables.dim() != 3 \
                or tables.shape[1] < 1:
            raise ValueError('tables must be [table_cols, V >= 1, C]')
        V = tables.shape[1]
        _check('table_indices', table_indices, dev, (B, tcols), torch.int32)
        _check('tables', tables, dev, (tcols, V, C))
    _check_noise(mode, sampling, noise, dev, B, C)
    seed, seed_ptr = _seed_args(seed, dev)

    lib = build('score_sample_v1')['lib']
    out = torch.empty(B, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if wrapper is nich_score_sample:
            err = lib.score_sample_v1_nich_launch(
                nich_values.data_ptr(), cl_scores.data_ptr(),
                coeffs.data_ptr(), _ptr(noise), out.data_ptr(), B, C, ncols,
                SAMPLING_MODES[mode], seed, seed_ptr, stream)
        else:
            err = lib.score_sample_v1_mixed_launch(
                _ptr(nich_values), _ptr(table_indices), cl_scores.data_ptr(),
                _ptr(coeffs if ncols else None),
                _ptr(tables if tcols else None), _ptr(noise), out.data_ptr(),
                B, C, ncols, tcols, V, SAMPLING_MODES[mode], seed, seed_ptr,
                stream)
    _raise_on('score_sample_v1', lib, err)
    wrapper.launches += 1
    return out


def nich_score_sample(seed, values, cl_scores, coeffs,
                      block_rows=DEFAULT_BLOCK_ROWS, interpret=False,
                      sampling='gumbel', noise=None):
    """K4: fused score + categorical draw for nich columns, no stat
    outputs.

    values: [B, cols] f32; cl_scores: [C] f32; coeffs: [4*cols, C] f32 in
    the `nich_coeffs` layout.  seed: the tile's seed of 'gumbel', an int in
    [0, 2**64) or a 1-element int64 tensor holding its bits (read from
    device memory when the kernel runs: the form a CUDA graph of the v1
    sweep replays).  Returns assignments [B] int32.

    sampling: 'gumbel' (Philox in the kernel) | 'argmax' | 'gumbel_host'
    taking `noise` [B, C].  The JAX kernel only draws with its core's
    generator; the other two modes exist so that the kernel can be held to
    its twin draw for draw.

    CPU tensors run the plain twin; CUDA tensors launch the kernel or
    raise.  `block_rows` and `interpret` are kept for parity with the JAX
    signature."""
    if values.device.type == 'cpu':
        return nich_score_sample_plain(seed, values, cl_scores, coeffs,
                                       block_rows=block_rows,
                                       sampling=sampling, noise=noise)
    if values.device.type != 'cuda':
        raise ValueError('nich_score_sample runs on CPU or CUDA tensors, '
                         'got %s' % values.device)
    return _launch_v1(seed, values, None, cl_scores, coeffs, None, sampling,
                      noise, nich_score_sample)


nich_score_sample.launches = 0


def mixed_score_sample(seed, nich_values, table_indices, cl_scores, coeffs,
                       tables, block_rows=DEFAULT_BLOCK_ROWS, interpret=False,
                       sampling='gumbel', noise=None):
    """K5: fused score + categorical draw over nich columns and discrete
    table columns, no stat outputs.

    nich_values: [B, nich_cols] f32 with coeffs [4*nich_cols, C] in the
    `nich_coeffs` layout, or None and None for a spec without nich
    columns; table_indices: [B, table_cols] int32 indices into each
    column's support with tables [table_cols, V, C] f32 (V the largest
    support; rows beyond a column's own support are never read), or None
    and None for a spec without table columns.  The kernel gathers the f32
    entry `tables[j, idx, k]`.  Table entries are floored at -1e30, so a
    -inf entry stays unselectable and never makes a NaN.  Returns
    assignments [B] int32.

    sampling and the CPU / CUDA split are as in `nich_score_sample`."""
    if nich_values is None and table_indices is None:
        raise ValueError('no nich or table columns given')
    if table_indices is not None:
        tables = torch.clamp(tables, min=-1e30)
    if cl_scores.device.type == 'cpu':
        return mixed_score_sample_plain(
            seed, nich_values, table_indices, cl_scores, coeffs, tables,
            block_rows=block_rows, sampling=sampling, noise=noise)
    if cl_scores.device.type != 'cuda':
        raise ValueError('mixed_score_sample runs on CPU or CUDA tensors, '
                         'got %s' % cl_scores.device)
    return _launch_v1(seed, nich_values, table_indices, cl_scores, coeffs,
                      tables, sampling, noise, mixed_score_sample)


mixed_score_sample.launches = 0


# -- the phase marks of a sweep (csrc/step_clock.cu) -------------------------

def clock_mark(stamps, slot):
    """Write the card's global nanosecond timer into `stamps[slot]` ([N]
    int64 on the card) once the work before it on the current stream is
    done.  Returns the graph node of the mark while the stream captures a
    CUDA graph (for `clock_set_enabled`), else None."""
    if stamps.device.type != 'cuda' or stamps.dtype != torch.int64 \
            or stamps.dim() != 1 or not 0 <= slot < stamps.shape[0]:
        raise ValueError('clock_mark takes a slot of a 1-D int64 tensor on '
                         'the card')
    lib = build('step_clock')['lib']
    node = _P()
    _raise_on('step_clock', lib, lib.step_clock_mark_launch(
        stamps.data_ptr(), slot,
        torch.cuda.current_stream(stamps.device).cuda_stream,
        ctypes.byref(node)))
    return node.value


def clock_set_enabled(graph_exec, nodes, on):
    """Switch the captured marks `nodes` on or off in the instantiated
    graph `graph_exec` (a cudaGraphExec_t as an int: a torch.cuda.CUDAGraph
    made with keep_graph=True gives it, `raw_cuda_graph_exec()`, once
    instantiated).  Later replays follow; a replay with them off runs
    none."""
    lib = build('step_clock')['lib']
    for node in nodes:
        _raise_on('step_clock', lib, lib.step_clock_set_enabled(
            graph_exec, node, int(bool(on))))
