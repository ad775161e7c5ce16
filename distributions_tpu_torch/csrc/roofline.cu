// Roofline calibration kernels for NVIDIA Hopper (sm_90a): what the card
// really does per second, measured by kernels small enough to reason about.
//
// Replaces benchmarks/roofline.py of the JAX package:
//   - roofline_chain  (B2)  _chain_kernel  (vpu_rate):   a K-deep dependent
//     chain of op(renorm(y)) per element, T times, one read and one write
//     (beside the reference's ops also the port's own fast_log, fast_exp and
//     Philox4x32-10 block, which the production kernels spend their time in);
//   - roofline_mma    (B3)  _mxu_kernel    (mxu_rate):   repeated bf16
//     matrix products with f32 accumulation on the tensor cores;
//   - roofline_copy   (B4)  _copy_kernel   (hbm_rate_pallas): o = x + 1
//     streamed through device memory.
//
// What bounds each: B2 the rate at which the card executes the op's
// instruction sequence (x stays in a register for all T x K evaluations, so
// neither memory nor the launch enters the slope between two depths K); B3
// the tensor-core rate and, in this simple form, the shared-memory reads
// that feed it; B4 the device-memory rate.
//
// Semantics held against the plain-PyTorch twins
// (distributions_tpu_torch/ops/bench_kernels.py): every float operation of
// B2 and B4 is an explicitly rounded __f*_rn op (or one fused __fmaf_rn for
// the 'fma' op), in the twin's order, so add, mul, fma, fast_log, fast_exp
// and philox chains equal their twins bitwise; logf, expf, log1pf and rsqrtf
// are CUDA's accurate functions and may differ from PyTorch's by ulps.  No
// --use_fast_math: the kernels these rates calibrate are built without it.
//
// Bound through ctypes: plain C entry points that launch on the caller's
// stream, allocate nothing, and return cudaGetLastError().

#include "fused_common.cuh"

#include <cuda_bf16.h>
#include <mma.h>

// -- B2: the dependent chain -------------------------------------------------

enum { OP_ADD = 0, OP_MUL = 1, OP_FMA = 2, OP_LOG = 3, OP_EXP = 4,
       OP_LOG1P = 5, OP_RSQRT = 6, OP_FAST_LOG = 7, OP_FAST_EXP = 8,
       OP_PHILOX = 9, OP_COUNT = 10 };

template <int OP>
__device__ __forceinline__ float chain_step(float y) {
  // renorms keep the chained value in the op's domain (positive, near 1)
  if (OP == OP_ADD) return __fadd_rn(y, F(1e-6));
  if (OP == OP_MUL) return __fmul_rn(y, F(1.000001));
  if (OP == OP_FMA) return __fmaf_rn(y, F(1.000001), F(0.000001));
  if (OP == OP_LOG) return logf(__fadd_rn(fabsf(y), F(0.5)));
  if (OP == OP_EXP) return expf(__fmul_rn(y, F(1e-3)));
  if (OP == OP_LOG1P) return log1pf(__fadd_rn(fabsf(y), F(0.5)));
  if (OP == OP_RSQRT) return rsqrtf(__fadd_rn(fabsf(y), F(0.5)));
  if (OP == OP_FAST_LOG) return fast_log(__fadd_rn(fabsf(y), F(0.5)));
  if (OP == OP_PHILOX) {
    // one block, counted by the chained value's bits; all four words reach
    // the result, as the draws use all four
    const uint4 r = philox4x32_10(make_uint4(__float_as_uint(y), 0u, 0u, 0u),
                                  make_uint2(0xA4093822u, 0x299F31D0u));
    const unsigned m = (r.x ^ r.y ^ r.z ^ r.w) & 0x00FFFFFFu;
    return __fadd_rn(__fmul_rn((float)m, F(5.960464477539063e-08)), F(0.5));
  }
  return fast_exp(__fmul_rn(y, F(1e-3)));
}

// One thread per element (grid-stride beyond the grid): x is read once,
// the T-loop and the K-deep chain run in registers, the sum is written
// once.  y depends on the loop index and every y reaches the output, so
// the compiler can neither hoist nor drop an evaluation.
template <int OP, int K>
__global__ void __launch_bounds__(256)
roofline_chain(const float* __restrict__ x, float* __restrict__ o,
               long long n, int T) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const float xv = x[e];
    float acc = F(0.0);
    for (int i = 0; i < T; ++i) {
      float y = __fadd_rn(xv, (float)i);
#pragma unroll
      for (int k = 0; k < K; ++k) y = chain_step<OP>(y);
      acc = __fadd_rn(acc, y);
    }
    o[e] = acc;
  }
}

template <int OP>
static int launch_chain_k(int K, int grid, cudaStream_t st, const float* x,
                          float* o, long long n, int T) {
  switch (K) {
    case 1: roofline_chain<OP, 1><<<grid, 256, 0, st>>>(x, o, n, T); break;
    case 2: roofline_chain<OP, 2><<<grid, 256, 0, st>>>(x, o, n, T); break;
    case 3: roofline_chain<OP, 3><<<grid, 256, 0, st>>>(x, o, n, T); break;
    case 5: roofline_chain<OP, 5><<<grid, 256, 0, st>>>(x, o, n, T); break;
    case 9: roofline_chain<OP, 9><<<grid, 256, 0, st>>>(x, o, n, T); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int roofline_chain_launch(const float* x, float* o, long long n,
                                     int T, int K, int op, void* stream) {
  if (n < 1 || T < 1 || op < 0 || op >= OP_COUNT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  long long blocks = (n + 255) / 256;
  const int grid = (int)(blocks < (1LL << 30) ? blocks : (1LL << 30));
  switch (op) {
    case OP_ADD: return launch_chain_k<OP_ADD>(K, grid, st, x, o, n, T);
    case OP_MUL: return launch_chain_k<OP_MUL>(K, grid, st, x, o, n, T);
    case OP_FMA: return launch_chain_k<OP_FMA>(K, grid, st, x, o, n, T);
    case OP_LOG: return launch_chain_k<OP_LOG>(K, grid, st, x, o, n, T);
    case OP_EXP: return launch_chain_k<OP_EXP>(K, grid, st, x, o, n, T);
    case OP_LOG1P: return launch_chain_k<OP_LOG1P>(K, grid, st, x, o, n, T);
    case OP_RSQRT: return launch_chain_k<OP_RSQRT>(K, grid, st, x, o, n, T);
    case OP_FAST_LOG:
      return launch_chain_k<OP_FAST_LOG>(K, grid, st, x, o, n, T);
    case OP_FAST_EXP:
      return launch_chain_k<OP_FAST_EXP>(K, grid, st, x, o, n, T);
    default: return launch_chain_k<OP_PHILOX>(K, grid, st, x, o, n, T);
  }
}

// -- B4: the streamed copy ----------------------------------------------------

// o = x + 1 with 16-byte loads and stores, grid-stride, four independent
// loads in flight per thread before the first store; the tail of n % 4
// elements goes one float at a time.
#define COPY_UNROLL 4

__global__ void __launch_bounds__(256)
roofline_copy(const float* __restrict__ x, float* __restrict__ o,
              long long n) {
  const long long n4 = n >> 2;
  const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x);
  float4* __restrict__ o4 = reinterpret_cast<float4*>(o);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = t0; i < n4; i += COPY_UNROLL * stride) {
    float4 v[COPY_UNROLL];
#pragma unroll
    for (int u = 0; u < COPY_UNROLL; ++u)
      if (i + u * stride < n4) v[u] = x4[i + u * stride];
#pragma unroll
    for (int u = 0; u < COPY_UNROLL; ++u)
      if (i + u * stride < n4) {
        v[u].x = __fadd_rn(v[u].x, F(1.0));
        v[u].y = __fadd_rn(v[u].y, F(1.0));
        v[u].z = __fadd_rn(v[u].z, F(1.0));
        v[u].w = __fadd_rn(v[u].w, F(1.0));
        o4[i + u * stride] = v[u];
      }
  }
  for (long long i = (n4 << 2) + t0; i < n; i += stride)
    o[i] = __fadd_rn(x[i], F(1.0));
}

extern "C" int roofline_copy_launch(const float* x, float* o, long long n,
                                    void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  // 8 blocks of 256 threads per SM (a full SM), grid-stride over the rest
  long long blocks = ((n >> 2) + 255) / 256;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 8) blocks = 132 * 8;
  roofline_copy<<<(int)blocks, 256, 0, (cudaStream_t)stream>>>(x, o, n);
  return (int)cudaGetLastError();
}

// -- B3: bf16 matrix products on the tensor cores ----------------------------
//
// The reference's function, per step on [N, N] operands:
//
//   acc = a . b;  acc += a . bf16(acc);  out += acc        (f32 sums)
//
// The second product needs the whole first product, a grid-wide step edge:
// each product is one launch, 2 * steps launches on one stream.  The first
// launch writes acc as f32 and, from its epilogue, as bf16; the second
// starts its accumulators from acc, adds a . bf16(acc), and adds the result
// into out.
//
// A block computes a 128 x 64 tile of the product with 8 warps as 4 x 2,
// each warp 32 x 32 = 2 x 2 wmma tiles of 16 x 16 x 16 (mma.sync on the
// tensor cores; wgmma is later work).  Operand tiles of depth 32 are staged
// in shared memory, the next tile prefetched into registers while the
// current one is multiplied.

#define MMA_BM 128
#define MMA_BN 64
#define MMA_BK 32
#define MMA_THREADS 256
#define MMA_LDA (MMA_BK + 8)     // bf16 elements; rows stay 16-byte aligned
#define MMA_LDB (MMA_BN + 8)

using namespace nvcuda;

// SECOND = false: accf = a . b, accb = bf16(accf).
// SECOND = true:  out += accf + a . b   (b is then bf16(accf)).
template <bool SECOND>
__global__ void __launch_bounds__(MMA_THREADS)
roofline_mma(const __nv_bfloat16* __restrict__ a,
             const __nv_bfloat16* __restrict__ b, float* __restrict__ accf,
             __nv_bfloat16* __restrict__ accb, float* __restrict__ out,
             int N) {
  __shared__ __align__(32) __nv_bfloat16 sa[MMA_BM * MMA_LDA];
  __shared__ __align__(32) __nv_bfloat16 sb[MMA_BK * MMA_LDB];
  __shared__ __align__(32) float stage[MMA_THREADS / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 1;            // 0..3: rows 32 * wm of the tile
  const int wn = warp & 1;             // 0..1: cols 32 * wn of the tile
  const int row0 = blockIdx.y * MMA_BM;
  const int col0 = blockIdx.x * MMA_BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (SECOND) {
        wmma::load_matrix_sync(
            c[i][j],
            accf + (size_t)(row0 + 32 * wm + 16 * i) * N + col0 + 32 * wn +
                16 * j,
            N, wmma::mem_row_major);
      } else {
        wmma::fill_fragment(c[i][j], 0.0f);
      }
    }

  // global -> registers: the a tile is 128 x 32 bf16 = 512 chunks of 16
  // bytes (2 per thread), the b tile 32 x 64 = 256 chunks (1 per thread)
  uint4 ra[2], rb;
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int chunk = tid + h * MMA_THREADS;
      const int r = chunk >> 2, cc = (chunk & 3) * 8;
      ra[h] = *reinterpret_cast<const uint4*>(
          a + (size_t)(row0 + r) * N + k0 + cc);
    }
    const int r = tid >> 3, cc = (tid & 7) * 8;
    rb = *reinterpret_cast<const uint4*>(b + (size_t)(k0 + r) * N + col0 + cc);
  };
  auto store_tiles = [&]() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int chunk = tid + h * MMA_THREADS;
      const int r = chunk >> 2, cc = (chunk & 3) * 8;
      *reinterpret_cast<uint4*>(sa + r * MMA_LDA + cc) = ra[h];
    }
    const int r = tid >> 3, cc = (tid & 7) * 8;
    *reinterpret_cast<uint4*>(sb + r * MMA_LDB + cc) = rb;
  };

  load_tiles(0);
  store_tiles();
  __syncthreads();
  for (int k0 = 0; k0 < N; k0 += MMA_BK) {
    const bool more = k0 + MMA_BK < N;
    if (more) load_tiles(k0 + MMA_BK);
#pragma unroll
    for (int kk = 0; kk < MMA_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], sa + (32 * wm + 16 * i) * MMA_LDA + kk,
                               MMA_LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], sb + kk * MMA_LDB + 32 * wn + 16 * j,
                               MMA_LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(c[i][j], fa[i], fb[j], c[i][j]);
    }
    __syncthreads();
    if (more) {
      store_tiles();
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const size_t base =
          (size_t)(row0 + 32 * wm + 16 * i) * N + col0 + 32 * wn + 16 * j;
      if (SECOND) {
        // same fragment type, same element mapping: add element by element
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
        wmma::load_matrix_sync(o, out + base, N, wmma::mem_row_major);
#pragma unroll
        for (int t = 0; t < o.num_elements; ++t)
          o.x[t] = __fadd_rn(o.x[t], c[i][j].x[t]);
        wmma::store_matrix_sync(out + base, o, N, wmma::mem_row_major);
      } else {
        wmma::store_matrix_sync(accf + base, c[i][j], N, wmma::mem_row_major);
        // the bf16 copy goes through a staging tile: the accumulator's
        // element mapping is opaque
        wmma::store_matrix_sync(stage[warp], c[i][j], 16,
                                wmma::mem_row_major);
        __syncwarp();
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int e = lane + 32 * t;           // 0..255
          accb[base + (size_t)(e >> 4) * N + (e & 15)] =
              __float2bfloat16(stage[warp][e]);
        }
        __syncwarp();
      }
    }
}

extern "C" int roofline_mma_launch(const void* a, const void* b, void* accf,
                                   void* accb, void* out, int N, int steps,
                                   void* stream) {
  if (N < MMA_BM || N % MMA_BM != 0 || steps < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)N * N * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / MMA_BN, N / MMA_BM);
  const __nv_bfloat16* pa = (const __nv_bfloat16*)a;
  const __nv_bfloat16* pb = (const __nv_bfloat16*)b;
  for (int s = 0; s < steps; ++s) {
    roofline_mma<false><<<grid, MMA_THREADS, 0, st>>>(
        pa, pb, (float*)accf, (__nv_bfloat16*)accb, (float*)out, N);
    roofline_mma<true><<<grid, MMA_THREADS, 0, st>>>(
        pa, (const __nv_bfloat16*)accb, (float*)accf, (__nv_bfloat16*)accb,
        (float*)out, N);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* roofline_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
