// The sampler alone, for NVIDIA Hopper (sm_90a): T gumbel-argmax draws per
// row of a resident [BR, C] score block, in one launch.
//
// Replaces the inline kernel of benchmarks/suite.py::bench_kernel_sampler
// (body pallas_kernels._sample_from_kernel_scores) of the JAX package: seed
// the in-kernel generator, perturb the scores with gumbel noise, take the
// argmax, T times.  It is the draw of the fused kernels (Draw<MODE, false>
// of fused_common.cuh: Philox4x32-10, two logs a cell, first maximal slot)
// without their scoring, so its time against theirs says what the draw
// costs.
//
// What bounds it on the H100: two logf and a quarter of a Philox block per
// cell; the scores are read once per block from device memory (a row is
// staged in shared memory and read as a warp-wide broadcast), so bytes do
// not matter.  The design: one block per row and slice of the iterations,
// one thread per iteration; each thread walks the row's slots in order.
// Iteration `it` draws with the seed `seed + it`.
//
// Outputs: the last iteration's winners [BR], a checksum [BR] (the sum of
// every iteration's winner, added atomically: integer sums do not depend
// on the order), and, when asked for, every iteration's winners [T, BR].
// Every iteration reaches an output, so none is dead code.
//
// Modes as in the v1 score + sample kernels: 'gumbel' (Philox in the
// kernel), 'argmax' and 'gumbel_host' (noise [BR, C] from the caller, the
// same for every iteration), so that the kernel equals its plain-PyTorch
// twin (distributions_tpu_torch/ops/bench_kernels.py) draw for draw in the
// last two.
//
// Bound through ctypes: sampler_bench_launch() launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include "fused_common.cuh"

#define SAMPLER_MAX_THREADS 128
#define SAMPLER_SMEM_FLOATS (48 * 1024 / 4)

template <int MODE>
__global__ void __launch_bounds__(SAMPLER_MAX_THREADS)
sampler_gumbel(const float* __restrict__ scores,
               const float* __restrict__ noise, int* __restrict__ last,
               int* __restrict__ checksum, int* __restrict__ draws, int BR,
               int C, int T, int CK, unsigned long long seed) {
  extern __shared__ float srow[];
  const int row = blockIdx.x;
  const int it = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = it < T;
  Draw<MODE, false> dr;
  dr.init(row, active, seed + (unsigned long long)it, noise);
  for (int c0 = 0; c0 < C; c0 += CK) {
    const int n = min(CK, C - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      srow[i] = scores[(size_t)row * C + c0 + i];
    __syncthreads();
    if (!active) continue;
    for (int kk = 0; kk < n; ++kk)
      dr.visit(0, row, c0 + kk, C, srow[kk], noise);
  }
  if (!active) return;
  const int k = dr.result();
  atomicAdd(&checksum[row], k);
  if (draws != nullptr) draws[(size_t)it * BR + row] = k;
  if (it == T - 1) last[row] = k;
}

extern "C" const char* sampler_bench_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// checksum must hold zeros on entry.
extern "C" int sampler_bench_launch(const float* scores, const float* noise,
                                    int* last, int* checksum, int* draws,
                                    int BR, int C, int T, int mode,
                                    unsigned long long seed, void* stream) {
  if (BR < 1 || C < 1 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int threads = ((T < SAMPLER_MAX_THREADS ? T : SAMPLER_MAX_THREADS) + 31) /
                32 * 32;
  const dim3 grid(BR, (T + threads - 1) / threads);
  const int CK = C < SAMPLER_SMEM_FLOATS ? C : SAMPLER_SMEM_FLOATS;
  const size_t smem = (size_t)CK * sizeof(float);
  switch (mode) {
    case MODE_ARGMAX:
      sampler_gumbel<MODE_ARGMAX><<<grid, threads, smem, st>>>(
          scores, noise, last, checksum, draws, BR, C, T, CK, seed);
      break;
    case MODE_GUMBEL:
      sampler_gumbel<MODE_GUMBEL><<<grid, threads, smem, st>>>(
          scores, noise, last, checksum, draws, BR, C, T, CK, seed);
      break;
    case MODE_GUMBEL_HOST:
      sampler_gumbel<MODE_GUMBEL_HOST><<<grid, threads, smem, st>>>(
          scores, noise, last, checksum, draws, BR, C, T, CK, seed);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
