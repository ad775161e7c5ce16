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
// the tensor-core rate (wgmma fed by TMA, all products in one persistent
// launch); B4 the device-memory rate (TMA bulk copies through a ring in
// shared memory).
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
#include "hopper.cuh"

#include <cuda_bf16.h>

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
//
// o = x + 1 through shared memory by the TMA unit: a persistent grid, each
// block walking whole chunks b, b + G, b + 2G, ... of CHUNK contiguous bytes
// (G blocks side by side cover one contiguous window).  A ring of STAGES
// chunks per block is filled by 1-D bulk copies that complete on one
// mbarrier per stage; the block's threads add 1 in shared memory; one
// thread stores the chunk back with a bulk copy and, once the previous
// chunk's store has read its stage, refills that stage.  Both streams carry
// an L2 evict-first policy: 512 MB passes through a 50 MB L2 once.  The
// bytes after the last whole chunk (fewer than CHUNK, and the n % 4 tail)
// go by plain 16-byte and 4-byte accesses.  x must be 16-byte aligned.

#define COPY_THREADS 256
#define COPY_CHUNK 16384
#define COPY_STAGES 6
#define COPY_BLOCKS_PER_SM 2

__global__ void __launch_bounds__(COPY_THREADS)
roofline_copy(const float* __restrict__ x, float* __restrict__ o,
              long long n) {
  constexpr int CHUNK = COPY_CHUNK, STAGES = COPY_STAGES;
  uint8_t* ring = dynamic_smem();
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * CHUNK);
  const int tid = threadIdx.x;
  const long long G = gridDim.x, b = blockIdx.x;
  const long long chunks = n * 4 / CHUNK;
  const long long mine = b < chunks ? (chunks - 1 - b) / G + 1 : 0;
  const char* xb = reinterpret_cast<const char*>(x);
  char* ob = reinterpret_cast<char*>(o);
  const uint64_t policy = l2_evict_first();
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
    for (int s = 0; s < STAGES && s < mine; ++s) {
      mbar_arrive_expect_tx(&full[s], CHUNK);
      bulk_load(ring + s * CHUNK, xb + (b + s * G) * CHUNK, CHUNK, &full[s],
                policy);
    }
  }
  __syncthreads();
  for (long long i = 0; i < mine; ++i) {
    const int s = (int)(i % STAGES);
    mbar_wait(&full[s], (unsigned)((i / STAGES) & 1));
    float4* v = reinterpret_cast<float4*>(ring + s * CHUNK);
#pragma unroll
    for (int u = 0; u < CHUNK / 16 / COPY_THREADS; ++u) {
      float4 t = v[tid + u * COPY_THREADS];
      t.x = __fadd_rn(t.x, F(1.0));
      t.y = __fadd_rn(t.y, F(1.0));
      t.z = __fadd_rn(t.z, F(1.0));
      t.w = __fadd_rn(t.w, F(1.0));
      v[tid + u * COPY_THREADS] = t;
    }
    fence_proxy_async_shared();
    __syncthreads();
    if (tid == 0) {
      bulk_store(ob + (b + i * G) * CHUNK, ring + s * CHUNK, CHUNK, policy);
      bulk_commit();
      // the stage of chunk i - 1 takes chunk i - 1 + STAGES once its store
      // has read it: STAGES - 1 loads and two stores in flight
      const long long next = i - 1 + STAGES;
      if (i >= 1 && next < mine) {
        const int sp = (int)((i - 1) % STAGES);
        bulk_wait_read<1>();
        mbar_arrive_expect_tx(&full[sp], CHUNK);
        bulk_load(ring + sp * CHUNK, xb + (b + next * G) * CHUNK, CHUNK,
                  &full[sp], policy);
      }
    }
  }
  // after the whole chunks, by the block whose turn the next chunk would be
  if (b == chunks % G) {
    const long long e0 = chunks * (CHUNK / 4);
    const long long n4 = (n - e0) >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(x + e0);
    float4* o4 = reinterpret_cast<float4*>(o + e0);
    for (long long j = tid; j < n4; j += COPY_THREADS) {
      float4 t = x4[j];
      t.x = __fadd_rn(t.x, F(1.0));
      t.y = __fadd_rn(t.y, F(1.0));
      t.z = __fadd_rn(t.z, F(1.0));
      t.w = __fadd_rn(t.w, F(1.0));
      o4[j] = t;
    }
    for (long long e = e0 + (n4 << 2) + tid; e < n; e += COPY_THREADS)
      o[e] = __fadd_rn(x[e], F(1.0));
  }
  if (tid == 0) bulk_wait<0>();
}

// 16 KB chunks, a ring of 6, two blocks an SM: 2 x 96 KB of shared memory
// and ~160 KB of loads in flight per SM
extern "C" int roofline_copy_launch(const float* x, float* o, long long n,
                                    void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int smem = COPY_STAGES * COPY_CHUNK + COPY_STAGES * 8;
  // blocks resident on the card at once, found once per device
  static int resident[64] = {0};
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidValue;
  if (resident[dev] == 0) {
    err = cudaFuncSetAttribute(
        roofline_copy, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    int sms, per_sm;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, roofline_copy, COPY_THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm > COPY_BLOCKS_PER_SM) per_sm = COPY_BLOCKS_PER_SM;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident[dev] = sms * per_sm;
  }
  long long grid = n * 4 / COPY_CHUNK;
  if (grid < 1) grid = 1;
  if (grid > resident[dev]) grid = resident[dev];
  roofline_copy<<<(int)grid, COPY_THREADS, smem, (cudaStream_t)stream>>>(
      x, o, n);
  return (int)cudaGetLastError();
}

// -- B3: bf16 matrix products on the tensor cores ----------------------------
//
// The reference's function, per step on [N, N] operands:
//
//   acc = a . b;  acc += a . bf16(acc);  out += acc        (f32 sums)
//
// All 2 * steps products run in ONE cooperative launch (every block
// resident), phase p = 0, 1, ..., 2 steps - 1 being product p % 2 + 1 of
// step p / 2.  The operands stay in L2 (a, b, the two accb 2 MB each, accf
// and out 4 MB each at N = 1024), as the TPU kernel's single program keeps
// them resident.
//
// Tiles of 128 x 64 (128 tiles at N = 1024 for 132 SMs); a block loops
// over tiles blockIdx.x, + gridDim.x, ... in every phase, so it owns the
// same tiles of accf and out throughout.  Per block a producer warp and two
// consumer warpgroups:
//   - the producer's one thread issues TMA tiled loads of a (128 x 64, K
//     inner) and of b or accb (64 x 64, N inner), 128-byte swizzled, into
//     a ring of MMA_STAGES stages, paced by a full and an empty mbarrier
//     per stage;
//   - each consumer warpgroup runs wgmma m64n64k16 (A K-major, B MN-major:
//     the transposed-B mode, no transposed copy) on its 64 rows, one group
//     of four k16 products per stage, one group in flight while the
//     previous stage is released;
//   - the epilogue works in the accumulator's documented register layout:
//     product 1 stores accf (f32) and accb (bf16); product 2 adds accf and
//     adds the sum into out (out = 0 + sum at step 0: no memset), both
//     loaded into registers before its products.
//
// Only accb crosses blocks: a product-2 tile reads the column strip of accb
// that the product-1 tiles of the same strip wrote.  So
//   - steps alternate between two accb buffers: product 1 of step s + 1
//     writes the other one, and never waits;
//   - after each product-1 tile its consumers arrive on the strip's
//     counter; before loading a tile's accb in product 2 the producer
//     waits for all N / 128 tiles of the strip, then fences the async
//     proxy (accb was written by thread stores and is read by TMA), having
//     issued the a tiles of its first stages already;
//   - product 1 of step s + 2 overwrites a buffer only after its own
//     product 2 of step s + 1 waited for its strip, whose tiles finished
//     reading that buffer before their product 1 of step s + 1.

#define MMA_BM 128
#define MMA_BN 64
#define MMA_BK 64
#define MMA_STAGES 8
#define MMA_CONSUMERS 256
#define MMA_THREADS (MMA_CONSUMERS + 32)
#define MMA_A_BYTES (MMA_BM * MMA_BK * 2)
#define MMA_B_BYTES (MMA_BK * MMA_BN * 2)
#define MMA_STAGE_BYTES (MMA_A_BYTES + MMA_B_BYTES)
// the ring, 1024-byte aligned for the swizzle, and its 2 x STAGES barriers
#define MMA_SMEM (1024 + MMA_STAGES * MMA_STAGE_BYTES + 16 * MMA_STAGES)

__global__ void __launch_bounds__(MMA_THREADS, 1)
roofline_mma(const __grid_constant__ CUtensorMap map_a,
             const __grid_constant__ CUtensorMap map_b,
             const __grid_constant__ CUtensorMap map_acc0,
             const __grid_constant__ CUtensorMap map_acc1,
             float* __restrict__ accf, __nv_bfloat16* __restrict__ accb,
             float* __restrict__ out, unsigned* __restrict__ done, int N,
             int steps) {
  uint8_t* raw = dynamic_smem();
  uint8_t* ring = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring +
                                               MMA_STAGES * MMA_STAGE_BYTES);
  uint64_t* empty = full + MMA_STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < MMA_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);    // one arrival per consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int tiles_n = N / MMA_BN;
  const int tiles_m = N / MMA_BM;
  const int tiles = tiles_m * tiles_n;
  const int kchunks = N / MMA_BK;
  const int phases = 2 * steps;
  const int G = gridDim.x;

  if (tid >= MMA_CONSUMERS) {
    // the producer warp: one thread issues every load
    if (tid == MMA_CONSUMERS) {
      int stage = 0;
      unsigned parity = 0;
      for (int p = 0; p < phases; ++p) {
        const bool second = p & 1;
        const int step = p >> 1;
        const CUtensorMap* map_k =
            !second ? &map_b : (step & 1) ? &map_acc1 : &map_acc0;
        // product 2 waits for accb; the a tiles of its first stages need
        // not, and go first
        int ahead = 0;
        if (second) {
          const int row0 = (blockIdx.x / tiles_n) * MMA_BM;
          int s = stage;
          unsigned par = parity;
          for (; ahead < MMA_STAGES && ahead < kchunks; ++ahead) {
            mbar_wait(&empty[s], par ^ 1);
            mbar_arrive_expect_tx(&full[s], MMA_STAGE_BYTES);
            tma_load_2d(ring + s * MMA_STAGE_BYTES, &map_a, &full[s],
                        ahead * MMA_BK, row0);
            if (++s == MMA_STAGES) {
              s = 0;
              par ^= 1;
            }
          }
        }
        int n = 0;
        for (int t = blockIdx.x; t < tiles; t += G) {
          const int row0 = (t / tiles_n) * MMA_BM;
          const int col0 = (t % tiles_n) * MMA_BN;
          if (second) {
            // the tile reads accb's column strip: every tile of the strip
            // has finished this step's product 1.  accb was written by
            // thread stores and is read by TMA: fence the async proxy.
            counter_wait(&done[t % tiles_n], (unsigned)(tiles_m * (step + 1)));
            fence_proxy_async_global();
          }
          for (int kc = 0; kc < kchunks; ++kc, ++n) {
            uint8_t* sa = ring + stage * MMA_STAGE_BYTES;
            if (n >= ahead) {
              mbar_wait(&empty[stage], parity ^ 1);
              mbar_arrive_expect_tx(&full[stage], MMA_STAGE_BYTES);
              tma_load_2d(sa, &map_a, &full[stage], kc * MMA_BK, row0);
            }
            tma_load_2d(sa + MMA_A_BYTES, map_k, &full[stage], col0,
                        kc * MMA_BK);
            if (++stage == MMA_STAGES) {
              stage = 0;
              parity ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  // the consumer warpgroups: wg 0 rows 0-63 of a tile, wg 1 rows 64-127
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  int stage = 0;
  unsigned parity = 0;
  for (int p = 0; p < phases; ++p) {
    const bool second = p & 1;
    const int step = p >> 1;
    __nv_bfloat16* acc_bf = accb + (size_t)(step & 1) * N * N;
    for (int t = blockIdx.x; t < tiles; t += G) {
      const int row0 = (t / tiles_n) * MMA_BM;
      const int col0 = (t % tiles_n) * MMA_BN;
      // this thread's elements: i -> row + 8 (i & 1), columns 8 (i >> 1)
      // and + 1 (the accumulator layout of wgmma_m64n64k16_bf16_tb)
      const size_t base = (size_t)(row0 + 64 * wg + 16 * warp + (lane >> 2)) *
                              N + col0 + 2 * (lane & 3);
      // product 2 adds accf and the running out: this thread wrote both
      // (its block has the same tiles in every phase), so it loads them
      // before its products, to be in registers by the epilogue
      float2 pf[16], po[16];
      if (second) {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const size_t idx = base + (size_t)(8 * (i & 1)) * N + 8 * (i >> 1);
          pf[i] = *reinterpret_cast<const float2*>(accf + idx);
          po[i] = p == 1 ? make_float2(F(0.0), F(0.0))
                         : *reinterpret_cast<const float2*>(out + idx);
        }
      }
      float d[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) d[r] = 0.0f;
      int prev = 0;
      for (int kc = 0; kc < kchunks; ++kc) {
        mbar_wait(&full[stage], parity);
        const uint32_t sa = smem_u32(ring + stage * MMA_STAGE_BYTES) +
                            wg * (64 * 128);
        const uint32_t sb = smem_u32(ring + stage * MMA_STAGE_BYTES +
                                     MMA_A_BYTES);
        wgmma_fence_regs(d);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < MMA_BK / 16; ++k)
          // A: 32 bytes further along K per k16 inside the swizzled rows;
          // B: 16 rows of 128 bytes further per k16; 8-row atoms 1024
          // bytes apart
          wgmma_m64n64k16_bf16_tb(d, wgmma_desc(sa + 32 * k, 16, 1024),
                                  wgmma_desc(sb + 2048 * k, 8192, 1024));
        wgmma_commit();
        wgmma_fence_regs(d);
        if (kc > 0) {
          wgmma_wait<1>();
          if ((tid & 127) == 0) mbar_arrive(&empty[prev]);
        }
        prev = stage;
        if (++stage == MMA_STAGES) {
          stage = 0;
          parity ^= 1;
        }
      }
      wgmma_wait<0>();
      if ((tid & 127) == 0) mbar_arrive(&empty[prev]);
      wgmma_fence_regs(d);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const size_t idx = base + (size_t)(8 * (i & 1)) * N + 8 * (i >> 1);
        if (!second) {
          *reinterpret_cast<float2*>(accf + idx) =
              make_float2(d[2 * i], d[2 * i + 1]);
          *reinterpret_cast<__nv_bfloat162*>(acc_bf + idx) =
              __floats2bfloat162_rn(d[2 * i], d[2 * i + 1]);
        } else {
          float2 o = po[i];
          o.x = __fadd_rn(o.x, __fadd_rn(pf[i].x, d[2 * i]));
          o.y = __fadd_rn(o.y, __fadd_rn(pf[i].y, d[2 * i + 1]));
          *reinterpret_cast<float2*>(out + idx) = o;
        }
      }
      if (!second) {
        // the tile's accb is written: one arrival on its column strip
        fence_proxy_async_global();
        named_barrier(1, MMA_CONSUMERS);
        if (tid == 0) counter_arrive(&done[t % tiles_n]);
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against the driver
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = (EncodeTiledFn)p;
  }
  return fn;
}

// an [N, N] row-major bf16 matrix in boxes of 64 columns x `rows`, swizzled
// by 128 bytes
static bool bf16_map(EncodeTiledFn encode, CUtensorMap* map, const void* base,
                     int N, int rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)N};
  const cuuint64_t strides[1] = {(cuuint64_t)N * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// accb: 2 x N x N bf16 (steps alternate between the two), done: N / 64
// unsigned of scratch, zeroed here before the launch
extern "C" int roofline_mma_launch(const void* a, const void* b, void* accf,
                                   void* accb, void* out, void* done, int N,
                                   int steps, void* stream) {
  if (N < MMA_BM || N % MMA_BM != 0 || steps < 1)
    return (int)cudaErrorInvalidValue;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  __nv_bfloat16* acc_bf = (__nv_bfloat16*)accb;
  CUtensorMap map_a, map_b, map_acc0, map_acc1;
  if (!bf16_map(encode, &map_a, a, N, MMA_BM) ||
      !bf16_map(encode, &map_b, b, N, MMA_BK) ||
      !bf16_map(encode, &map_acc0, acc_bf, N, MMA_BK) ||
      !bf16_map(encode, &map_acc1, acc_bf + (size_t)N * N, N, MMA_BK))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // blocks resident on the card at once, found once per device
  static int resident[64] = {0};
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidValue;
  if (resident[dev] == 0) {
    err = cudaFuncSetAttribute(
        roofline_mma, cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_SMEM);
    if (err != cudaSuccess) return (int)err;
    int sms, per_sm;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, roofline_mma, MMA_THREADS, MMA_SMEM);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident[dev] = sms * per_sm;
  }
  const int tiles = (N / MMA_BM) * (N / MMA_BN);
  const int grid = tiles < resident[dev] ? tiles : resident[dev];
  err = cudaMemsetAsync(done, 0, sizeof(unsigned) * (N / MMA_BN), st);
  if (err != cudaSuccess) return (int)err;
  float* pf = (float*)accf;
  float* po = (float*)out;
  unsigned* pd = (unsigned*)done;
  void* args[] = {&map_a, &map_b, &map_acc0, &map_acc1, &pf, &acc_bf, &po,
                  &pd, &N, &steps};
  // every block resident at once (a tile waits on others' arrivals), or
  // the launch is refused
  err = cudaLaunchCooperativeKernel(roofline_mma, dim3(grid),
                                    dim3(MMA_THREADS), args, MMA_SMEM, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* roofline_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
