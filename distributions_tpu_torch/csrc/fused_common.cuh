// Device code shared by the fused score + sample kernels (fused_v2.cu,
// fused_v3.cu, score_sample_v1.cu): the polynomial fast_log / fast_exp of the JAX
// package, Philox4x32-10, and the per-row draw state that turns a stream
// of slot scores into one drawn slot.
//
// Every float operation is an explicitly rounded __f*_rn op in the order
// of the plain-PyTorch twins (distributions_tpu_torch/ops/fused_kernels.py),
// so nvcc cannot contract it into an FMA and the kernels equal their twins
// bitwise in the deterministic modes.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// a double literal rounded once to float, as the twin rounds its Python
// scalars
#define F(x) ((float)(x))

enum { MODE_ARGMAX = 0, MODE_GUMBEL = 1, MODE_GUMBEL_HOST = 2,
       MODE_CDF = 3, MODE_CDF_HOST = 4, MODE_BITS = 5 };

// -- fast_log / fast_exp: pallas_kernels.py _FAST_LOG_C / _FAST_EXP_C ------

__device__ __forceinline__ float horner_log(float t) {
  float p = F(0.010119082927575069);
  p = __fadd_rn(__fmul_rn(p, t), F(-0.05262485136716543));
  p = __fadd_rn(__fmul_rn(p, t), F(0.1307650325036001));
  p = __fadd_rn(__fmul_rn(p, t), F(-0.22283625832784004));
  p = __fadd_rn(__fmul_rn(p, t), F(0.3269731000139177));
  p = __fadd_rn(__fmul_rn(p, t), F(-0.4992065685478762));
  p = __fadd_rn(__fmul_rn(p, t), F(0.9999574870750698));
  p = __fadd_rn(__fmul_rn(p, t), F(5.621959006663069e-07));
  return p;
}

__device__ __forceinline__ float horner_exp(float t) {
  float p = F(0.001894379423367964);
  p = __fadd_rn(__fmul_rn(p, t), F(0.008940582529378103));
  p = __fadd_rn(__fmul_rn(p, t), F(0.05587655686900896));
  p = __fadd_rn(__fmul_rn(p, t), F(0.24013169187191022));
  p = __fadd_rn(__fmul_rn(p, t), F(0.6931567766988703));
  p = __fadd_rn(__fmul_rn(p, t), F(0.9999997696337066));
  return p;
}

__device__ __forceinline__ float fast_log(float x) {
  int bits = __float_as_int(x);
  int e = (bits >> 23) - 127;
  float m = __int_as_float((bits & 0x007FFFFF) | 0x3F800000);
  // ln 2 = LN2_HI + LN2_LO with e * LN2_HI exact for every exponent
  const float ef = (float)e;
  return __fadd_rn(__fmul_rn(ef, F(0.693145751953125)),
                   __fadd_rn(__fmul_rn(ef, F(1.428606765330187e-06)),
                             horner_log(__fsub_rn(m, F(1.0)))));
}

__device__ __forceinline__ float fast_exp(float x) {
  float y = __fmul_rn(fmaxf(x, F(-86.0)), F(1.4426950408889634));
  float f = floorf(y);
  float p = horner_exp(__fsub_rn(y, f));
  float scale = __int_as_float(((int)f + 127) << 23);
  return __fmul_rn(scale, p);
}

template <bool FAST>
__device__ __forceinline__ float log_(float x) {
  return FAST ? fast_log(x) : logf(x);
}

template <bool FAST>
__device__ __forceinline__ float exp_(float x) {
  return FAST ? fast_exp(x) : expf(x);
}

// -- Philox4x32-10 (Salmon et al., SC'11) ----------------------------------

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    unsigned lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    unsigned lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ unsigned uint4_get(uint4 v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// -- the perturbations of the argmax-family draws --------------------------
//
// m is the low 24 bits of the cell's Philox word.  'gumbel': score -
// log(max(-log(m * 2^-24), 6e-8)); 'bits' (the phase profiler's
// generator-only draw): score + m * 1e-9.

template <bool FAST>
__device__ __forceinline__ float gumbel_perturb(float s, unsigned m) {
  const float inner =
      -log_<FAST>(__fmul_rn((float)m, F(5.960464477539063e-08)));
  return __fsub_rn(s, log_<FAST>(fmaxf(inner, F(6e-8))));
}

__device__ __forceinline__ float bits_perturb(float s, unsigned m) {
  return __fadd_rn(s, __fmul_rn((float)m, F(1e-9)));
}

// the first maximal value of a scan wins: `tot` replaces `best` only when
// it is strictly greater, or NaN where best is not (NaN counts as maximal,
// as torch/jnp argmax)
__device__ __forceinline__ bool beats(float tot, float best) {
  return tot > best || (isnan(tot) && !isnan(best));
}

// -- one row's draw ---------------------------------------------------------
//
// The owner of a row feeds its slot scores in slot order, once per pass:
//
//   Draw<MODE, FAST> dr;  dr.init(row, active, seed, noise);
//   for (pass = 0; pass < Draw<MODE, FAST>::kPasses; ++pass) {
//     dr.begin_pass(pass);
//     for (k = 0; k < C; ++k) dr.visit(pass, row, k, C, score(k), noise);
//   }
//   slot = dr.result();
//
//   - 'argmax' keeps the first maximal slot (strictly greater wins, as a
//     sequential scan), so dead slots (score -inf) are never drawn unless
//     every slot is dead;
//   - 'gumbel' uses Philox4x32-10 keyed by the 64-bit tile seed, counted
//     by (row, g / 4) with word g % 4, where g is the slot's id (the split
//     walk of fused_split.cuh adds the slot offset of a shard of a wider
//     slot axis, so that the noise of a (row, global slot) does not depend
//     on how the slots are cut); m = low 24 bits of the word, and the
//     perturbed score is gumbel_perturb(score, m);
//   - 'cdf' takes one uniform per row (Philox counter (row, 0, 1, 0)),
//     t = max(u, 1e-7) * total, and draws the number of slots whose
//     inclusive prefix of exp(score - rowmax) is strictly below t; the
//     prefix is a sequential f32 sum in slot order, and total is the last
//     prefix of that same scan, so the draw never reaches C.  It needs the
//     scores three times (max, total, count);
//   - '_host' modes read the caller's noise instead of Philox;
//   - 'bits' (the phase profiler's generator-only draw, never a sampler)
//     takes 'gumbel's Philox words and adds m * 1e-9 to the score: the
//     generator's cost without the two logs.

template <int MODE, bool FAST>
struct Draw {
  static constexpr bool kCdf = (MODE == MODE_CDF || MODE == MODE_CDF_HOST);
  static constexpr int kPasses = kCdf ? 3 : 1;

  float best, rmax, total, acc, t, u;
  int best_idx, count, bits_q;
  uint4 bits4;
  uint2 key;

  __device__ __forceinline__ void init(int row, bool active,
                                       unsigned long long seed,
                                       const float* __restrict__ noise) {
    key = make_uint2((unsigned)seed, (unsigned)(seed >> 32));
    best = -INFINITY;
    best_idx = 0;
    rmax = -INFINITY;
    total = F(0.0);
    acc = F(0.0);
    t = F(0.0);
    count = 0;
    u = F(0.0);
    if (active && MODE == MODE_CDF) {
      uint4 r = philox4x32_10(make_uint4((unsigned)row, 0u, 1u, 0u), key);
      u = __fmul_rn((float)(r.x & 0x00FFFFFFu), F(5.960464477539063e-08));
    } else if (active && MODE == MODE_CDF_HOST) {
      u = noise[row];
    }
    bits4 = make_uint4(0u, 0u, 0u, 0u);
    bits_q = -1;
  }

  __device__ __forceinline__ void begin_pass(int pass) {
    if (pass == 1) {
      acc = F(0.0);
    } else if (pass == 2) {
      total = acc;
      t = __fmul_rn(fmaxf(u, F(1e-7)), total);
      acc = F(0.0);
    }
  }

  __device__ __forceinline__ void visit(int pass, int row, int k, int C,
                                        float s,
                                        const float* __restrict__ noise) {
    if (MODE == MODE_ARGMAX || MODE == MODE_GUMBEL ||
        MODE == MODE_GUMBEL_HOST || MODE == MODE_BITS) {
      float tot = s;
      if (MODE == MODE_GUMBEL || MODE == MODE_BITS) {
        const int q = k >> 2;
        if (q != bits_q) {
          bits4 = philox4x32_10(
              make_uint4((unsigned)row, (unsigned)q, 0u, 0u), key);
          bits_q = q;
        }
        const unsigned m = uint4_get(bits4, k & 3) & 0x00FFFFFFu;
        tot = MODE == MODE_BITS ? bits_perturb(s, m)
                                : gumbel_perturb<FAST>(s, m);
      } else if (MODE == MODE_GUMBEL_HOST) {
        tot = __fadd_rn(s, noise[(size_t)row * C + k]);
      }
      if (beats(tot, best)) {
        best = tot;
        best_idx = k;
      }
    } else if (pass == 0) {
      rmax = fmaxf(rmax, s);
    } else {
      acc = __fadd_rn(acc, exp_<FAST>(__fsub_rn(s, rmax)));
      if (pass == 2) count += (acc < t) ? 1 : 0;
    }
  }

  __device__ __forceinline__ int result() const {
    return kCdf ? count : best_idx;
  }
};
