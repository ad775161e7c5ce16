// Fused nich score + sample + stat-sum kernel for NVIDIA Hopper (sm_90a).
//
// Replaces distributions_tpu/ops/pallas_kernels.py::_fused_v2_kernel
// (wrapper fused_score_sample_stats).  For one tile of B rows against C
// mixture slots it computes
//
//   scores[r, k] = cl[k] + sum_g base_g[k]
//                + sum_g lc_g[k] * log(prod over chunks of <= 4 columns of
//                                      (1 + prec_j[k] * (v_rj - mean_j[k])^2))
//
// (the centered (v - mean)^2 form: the expanded a v^2 + b v + c form
// cancels on unstandardized data), draws one slot per row, and sums the
// rows' [1 | v | v^2] statistics per drawn slot into [C, 3 * cols].
//
// What bounds it on the H100: operations, not bytes.  Per (row, slot)
// cell the kernel does one log per 4 columns of scoring, plus two logs and
// a quarter Philox block in 'gumbel' mode -- about 1.07e9 cells per sweep
// at the flagship size (1,048,576 rows x 1024 slots), on the FMA, SFU and
// integer pipes.  Device-memory traffic is small: the values, the
// assignments, the [C]-sized coefficient rows and the [C, 3 * cols] sums,
// about 12 MB per sweep.  Nothing of size [B, C] reaches device memory.
//
// The argmax family of draws ('argmax', 'gumbel', 'gumbel_host') runs the
// slot-split walk of fused_split.cuh: eight threads share a row, each on
// a slice of the slot axis made of whole Philox blocks, each thread holds
// two rows in registers and reads each slot's staged coefficients once
// (16-byte loads) for both, Philox runs as two independent chains, and a
// merge in slice order gives the sequential scan's slot.  That is for one
// block of 1-4 nich columns (an exact shape); other layouts take the wide
// shape, which stages the rows in shared memory.  At
// the flagship tile (131,072 x 1024) that is 524,288 threads where one
// thread a row gave 131,072, a quarter of what the card holds resident.
// 'cdf' and 'cdf_host' keep the sequential walk below (one thread owns one
// row and walks all slots in order, three passes): the draw counts slots
// whose inclusive prefix of exp(score - rowmax) is below t, and that f32
// prefix is summed in slot order -- part of the function, summed so by
// the twin (_cdf_draw in ops/fused_kernels.py) -- so it cannot be cut into
// slices without changing the bits of the draw.
//
// Semantics held against the plain-PyTorch twin
// (distributions_tpu_torch/ops/fused_kernels.py):
//   - every float operation is an explicitly rounded __f*_rn op, in the
//     twin's order, so nvcc cannot contract it into an FMA;
//   - the draws ('argmax', 'gumbel', 'cdf' and their '_host' forms) are
//     those of Draw<MODE, FAST> in fused_common.cuh, which the split walk
//     reproduces slot for slot;
//   - '_fast' replaces log/exp with the polynomial fast_log/fast_exp of the
//     JAX package (same coefficients);
//   - stat sums are deterministic: the stat stage of fused_stats.cuh sums
//     per-block partials in an order fixed by the launch's shape, then
//     reduces them over blocks in a fixed order.  No float atomics.
//
// Bound through ctypes: fused_v2_launch() is a plain C entry point that
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().  fused_v2_stats_launch() runs the stat stage alone
// on given slots (a measurement entry point; fused_v2_launch runs the same
// stage after its draw), fused_v2_stat_plan() reports how it cuts a
// launch.  fused_v2_occupancy() reports the split kernel's
// registers, shared memory and resident blocks for a layout.
//
// The seed.  fused_v2_launch takes the tile's 64-bit seed by value or, with
// seed_ptr non-null, from device memory, read by every thread of the score
// + sample kernel when it runs (both walks).  The runner's sweeps are
// replayed from a CUDA graph (ops/gibbs.py), whose launch arguments are
// frozen at capture: the seed then lives in a buffer the host refills
// before each replay.  Both forms give the same draws for the same seed.
//
// The same score + sample kernel is also instantiated over a compile-time
// PHASE, for the phase profiler (replaces profile_kernel_phases.py::
// _variant_kernel of the JAX package; entry point fused_v2_phase_launch):
// 'noop' loads the values and writes one int per row, 'score_max' adds the
// scoring and writes the row maximum, the draw MODE_BITS adds Philox
// without the logs, and PHASE_FULL with any draw is the production kernel
// without the two stat kernels behind it.  Each phase writes something
// that depends on all its work.  The differences of their times split the
// production kernel's time into load, scoring, generator, draw and sums.
// All but the 'cdf' phases are the split walk.

#include "fused_split.cuh"
#include "fused_stats.cuh"

#define MAX_GROUPS 8
#define MAX_COLS 32
#define SCORE_THREADS 128
#define SMEM_FLOATS (48 * 1024 / 4)

static inline int imin(int a, int b) { return a < b ? a : b; }

struct ColGroups {
  int n;
  int cols[MAX_GROUPS];
};

// -- kernel 1a: the sequential score + sample walk, for 'cdf' --------------
//
// One thread per row.  Shared memory: the coefficient chunk [W][CK] with
// W = 1 + n_groups + 2 * total_cols rows (row 0 = cl + sum of bases, then
// one lc row per group, then prec, mean per column), followed by the
// block's values [total_cols][SCORE_THREADS].  (Kernel 1b, the split walk
// of every other draw, is split_score_sample of fused_split.cuh.)

template <int MODE, bool FAST>
__global__ void __launch_bounds__(SCORE_THREADS)
fused_v2_score_sample(const float* __restrict__ values,
                      const float* __restrict__ cl,
                      const float* __restrict__ coeffs,
                      const float* __restrict__ noise,
                      int* __restrict__ out, int B, int C, ColGroups cg,
                      int total_cols, int CK, unsigned long long seed,
                      const unsigned long long* __restrict__ seed_ptr) {
  extern __shared__ float smem[];
  const int G = cg.n;
  const int W = 1 + G + 2 * total_cols;
  float* sco = smem;
  float* sval = smem + (size_t)W * CK;
  const int tid = threadIdx.x;
  const int row = blockIdx.x * SCORE_THREADS + tid;
  const bool active = row < B;
  if (active) {
    for (int c = 0; c < total_cols; ++c)
      sval[c * SCORE_THREADS + tid] = values[(size_t)row * total_cols + c];
  }
  Draw<MODE, FAST> dr;
  dr.init(row, active, seed_ptr ? *seed_ptr : seed, noise);

  for (int pass = 0; pass < Draw<MODE, FAST>::kPasses; ++pass) {
    dr.begin_pass(pass);
    for (int c0 = 0; c0 < C; c0 += CK) {
      const int n = min(CK, C - c0);
      __syncthreads();
      for (int i = tid; i < n; i += SCORE_THREADS) {
        const int k = c0 + i;
        float cst = cl[k];
        int r = 0, cidx = 0;
        for (int g = 0; g < G; ++g) {
          const int nc = cg.cols[g];
          cst = __fadd_rn(cst, coeffs[(size_t)r * C + k]);
          sco[(size_t)(1 + g) * CK + i] = coeffs[(size_t)(r + 1) * C + k];
          for (int j = 0; j < nc; ++j) {
            const int w = 1 + G + 2 * (cidx + j);
            sco[(size_t)w * CK + i] = coeffs[(size_t)(r + 2 + 2 * j) * C + k];
            sco[(size_t)(w + 1) * CK + i] =
                coeffs[(size_t)(r + 3 + 2 * j) * C + k];
          }
          r += 2 + 2 * nc;
          cidx += nc;
        }
        sco[i] = cst;
      }
      __syncthreads();
      if (!active) continue;
      for (int kk = 0; kk < n; ++kk) {
        const int k = c0 + kk;
        float s = sco[kk];
        int cidx = 0;
        for (int g = 0; g < G; ++g) {
          const float lc = sco[(size_t)(1 + g) * CK + kk];
          const int nc = cg.cols[g];
          for (int j0 = 0; j0 < nc; j0 += 4) {
            const int j1 = min(j0 + 4, nc);
            float prod = F(1.0);
            for (int j = j0; j < j1; ++j) {
              const int w = 1 + G + 2 * (cidx + j);
              const float prec = sco[(size_t)w * CK + kk];
              const float mean = sco[(size_t)(w + 1) * CK + kk];
              const float d = __fsub_rn(sval[(cidx + j) * SCORE_THREADS + tid],
                                        mean);
              const float f =
                  __fadd_rn(F(1.0), __fmul_rn(prec, __fmul_rn(d, d)));
              prod = (j == j0) ? f : __fmul_rn(prod, f);
            }
            s = __fadd_rn(s, __fmul_rn(lc, log_<FAST>(prod)));
          }
          cidx += nc;
        }
        dr.visit(pass, row, k, C, s, noise);
      }
    }
  }
  if (active) out[row] = dr.result();
}

// -- kernels 2 and 3: the stat stage of fused_stats.cuh ----------------------
//
// stat_partials<NichRows<NC>> and stat_reduce: per-block partials of the
// rows' [1 | v | v^2] features, then a fixed-order reduce over blocks; an
// exact shape for 1-4 nich columns (NC), the run-time one (NC = 0) for
// more.

template <int NC>
static int nich_stage(const float* values, const int* assign,
                      float* partials, unsigned* bmask, float* sums, int B,
                      int C, int cols, cudaStream_t st) {
  NichRows<NC> rows;
  rows.values = values;
  rows.cols = cols;
  return stat_stage_launch(rows, assign, partials, bmask, sums, nullptr,
                           3 * cols, nullptr, nullptr, B, C, st);
}

static int launch_nich_stage(const float* values, const int* assign,
                             float* partials, unsigned* bmask, float* sums,
                             int B, int C, int cols, cudaStream_t st) {
  switch (cols) {
    case 1:
      return nich_stage<1>(values, assign, partials, bmask, sums, B, C, cols,
                           st);
    case 2:
      return nich_stage<2>(values, assign, partials, bmask, sums, B, C, cols,
                           st);
    case 3:
      return nich_stage<3>(values, assign, partials, bmask, sums, B, C, cols,
                           st);
    case 4:
      return nich_stage<4>(values, assign, partials, bmask, sums, B, C, cols,
                           st);
    default:
      return nich_stage<0>(values, assign, partials, bmask, sums, B, C, cols,
                           st);
  }
}

// The split kernel of one phase and draw for the shape `SH`, handed to fn
// with the record floats and staged row floats of layout L on it.
template <class SH, class Fn>
static void with_split_shape(const SplitLayout& L, int phase, int mode,
                             bool fast, Fn&& fn) {
  const int P = split_record_floats<SH>(L), R = split_row_floats<SH>(L);
#define SPLIT(MODE, PHASE)                                             \
  (fast ? fn(split_score_sample<MODE, true, PHASE, SH>, P, R)          \
        : fn(split_score_sample<MODE, false, PHASE, SH>, P, R))
  if (phase == PHASE_NOOP) {
    fn(split_score_sample<MODE_ARGMAX, false, PHASE_NOOP, SH>, P, R);
  } else if (phase == PHASE_SCORE_MAX) {
    SPLIT(MODE_ARGMAX, PHASE_SCORE_MAX);
  } else {
    switch (mode) {
      case MODE_ARGMAX: SPLIT(MODE_ARGMAX, PHASE_FULL); break;
      case MODE_GUMBEL: SPLIT(MODE_GUMBEL, PHASE_FULL); break;
      case MODE_GUMBEL_HOST: SPLIT(MODE_GUMBEL_HOST, PHASE_FULL); break;
      default: SPLIT(MODE_BITS, PHASE_FULL); break;
    }
  }
#undef SPLIT
}

// An exact shape for one block of 1-4 nich columns (one product, one log
// a cell), the wide one for every other layout (several blocks, or more
// columns).
template <int NC>
using ShapeNich = Shape<NC, 0, 1, 0>;

template <class Fn>
static void with_split_kernel(const SplitLayout& L, int phase, int mode,
                              bool fast, Fn&& fn) {
  if (split_fits<ShapeNich<1>>(L))
    with_split_shape<ShapeNich<1>>(L, phase, mode, fast, fn);
  else if (split_fits<ShapeNich<2>>(L))
    with_split_shape<ShapeNich<2>>(L, phase, mode, fast, fn);
  else if (split_fits<ShapeNich<3>>(L))
    with_split_shape<ShapeNich<3>>(L, phase, mode, fast, fn);
  else if (split_fits<ShapeNich<4>>(L))
    with_split_shape<ShapeNich<4>>(L, phase, mode, fast, fn);
  else
    with_split_shape<WideShape>(L, phase, mode, fast, fn);
}

// Check the layout: *total_cols gets the nich columns, cg and L the two
// walks' descriptions.
static bool v2_layout(int B, int C, int n_groups, const int* col_groups,
                      int phase, int mode, ColGroups* cg, SplitLayout* L,
                      int* total_cols) {
  if (B < 1 || C < 1 || n_groups < 1 || n_groups > MAX_GROUPS ||
      mode < MODE_ARGMAX || mode > MODE_BITS || phase < PHASE_FULL ||
      phase > PHASE_SCORE_MAX)
    return false;
  const bool cdf = mode == MODE_CDF || mode == MODE_CDF_HOST;
  if (cdf && phase != PHASE_FULL) return false;
  cg->n = n_groups;
  *total_cols = 0;
  for (int g = 0; g < n_groups; ++g) {
    if (col_groups[g] < 1) return false;
    cg->cols[g] = col_groups[g];
    *total_cols += col_groups[g];
  }
  for (int g = n_groups; g < MAX_GROUPS; ++g) cg->cols[g] = 0;
  if (*total_cols > MAX_COLS) return false;
  return split_layout(n_groups, col_groups, 0, nullptr, nullptr, 0, nullptr,
                      L);
}

// Check the layout and launch the score + sample kernel in one phase and
// draw mode: the split walk, or for 'cdf' the sequential one.
// `total_cols_out` receives the number of nich columns.
static int launch_score_phase(const float* values, const float* cl,
                              const float* coeffs, const float* noise,
                              int* out, float* best, int B, int C,
                              int n_groups, const int* col_groups, int phase,
                              int mode, int fast, unsigned long long seed,
                              const unsigned long long* seed_ptr,
                              cudaStream_t st, int* total_cols_out) {
  ColGroups cg;
  SplitLayout L;
  int total_cols = 0;
  if (!v2_layout(B, C, n_groups, col_groups, phase, mode, &cg, &L,
                 &total_cols))
    return (int)cudaErrorInvalidValue;
  *total_cols_out = total_cols;

  if (mode == MODE_CDF || mode == MODE_CDF_HOST) {
    const int W = 1 + n_groups + 2 * total_cols;
    const int CK = imin(C, (SMEM_FLOATS - SCORE_THREADS * total_cols) / W);
    if (CK < 1) return (int)cudaErrorInvalidValue;
    const size_t smem =
        ((size_t)W * CK + (size_t)SCORE_THREADS * total_cols) * sizeof(float);
    const dim3 grid((B + SCORE_THREADS - 1) / SCORE_THREADS);
#define SEQ(MODE, FAST)                                                   \
  fused_v2_score_sample<MODE, FAST><<<grid, SCORE_THREADS, smem, st>>>(   \
      values, cl, coeffs, noise, out, B, C, cg, total_cols, CK, seed,       \
      seed_ptr)
    if (mode == MODE_CDF) {
      if (fast) SEQ(MODE_CDF, true); else SEQ(MODE_CDF, false);
    } else {
      if (fast) SEQ(MODE_CDF_HOST, true); else SEQ(MODE_CDF_HOST, false);
    }
#undef SEQ
    return (int)cudaGetLastError();
  }

  SplitArgs a = SplitArgs();
  a.values = values;
  a.cl = cl;
  a.coeffs = coeffs;
  a.noise = noise;
  a.out = phase == PHASE_SCORE_MAX ? nullptr : out;
  a.best = phase == PHASE_SCORE_MAX ? best : nullptr;
  a.B = B;
  a.C = C;
  a.slot_offset = 0;
  a.seed = seed;
  a.seed_ptr = seed_ptr;
  const dim3 grid((B + SPLIT_BLOCK_ROWS - 1) / SPLIT_BLOCK_ROWS);
  size_t smem = 0;
  bool fits = true;
  with_split_kernel(L, phase, mode, fast != 0,
                    [&](auto kern, int P, int rows) {
                      fits = split_geometry(P, rows, &a, &smem);
                      if (fits) kern<<<grid, SPLIT_THREADS, smem, st>>>(a, L);
                      return 0;
                    });
  if (!fits) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// One phase of the score + sample kernel alone (no stat kernels): `out`
// [B] int for every phase but PHASE_SCORE_MAX, which writes `best` [B].
extern "C" int fused_v2_phase_launch(const float* values, const float* cl,
                                     const float* coeffs, const float* noise,
                                     int* out, float* best, int B, int C,
                                     int n_groups, const int* col_groups,
                                     int phase, int mode, int fast,
                                     unsigned long long seed, void* stream) {
  int total_cols = 0;
  return launch_score_phase(values, cl, coeffs, noise, out, best, B, C,
                            n_groups, col_groups, phase, mode, fast, seed,
                            nullptr, (cudaStream_t)stream, &total_cols);
}

// The split kernel that a launch with these arguments takes, at C slots:
// info[0] resident blocks per SM, [1] threads per block, [2] dynamic
// shared memory bytes, [3] record floats, [4] turns of the slot axis,
// [5] registers per thread, [6] local memory bytes per thread (spills).
// 'cdf' modes take the sequential walk and are refused here.
extern "C" int fused_v2_occupancy(int C, int n_groups, const int* col_groups,
                                  int phase, int mode, int fast, int* info) {
  ColGroups cg;
  SplitLayout L;
  int total_cols = 0;
  if (!v2_layout(1, C, n_groups, col_groups, phase, mode, &cg, &L,
                 &total_cols) ||
      mode == MODE_CDF || mode == MODE_CDF_HOST)
    return (int)cudaErrorInvalidValue;
  int rc = 0;
  with_split_kernel(L, phase, mode, fast != 0,
                    [&](auto kern, int P, int rows) {
                      SplitArgs a = SplitArgs();
                      a.C = C;
                      size_t smem = 0;
                      if (!split_geometry(P, rows, &a, &smem))
                        return rc = (int)cudaErrorInvalidValue;
                      return rc = split_occupancy(kern, P, a, smem, info);
                    });
  return rc;
}

extern "C" const char* fused_v2_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// partials: scratch of [nblocks, 3 * cols, C] floats and bmask of
// [nblocks, ceil(C / 32)] words, nblocks = ceil(B / stat_rows_per_block(B))
// (fused_stats.cuh).  seed_ptr: null, or the seed in device memory in place
// of `seed`.
extern "C" int fused_v2_launch(const float* values, const float* cl,
                               const float* coeffs, const float* noise,
                               int* out, float* partials, unsigned* bmask,
                               float* sums, int B, int C, int n_groups,
                               const int* col_groups, int mode, int fast,
                               unsigned long long seed,
                               const unsigned long long* seed_ptr,
                               void* stream) {
  if (mode > MODE_CDF_HOST) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int total_cols = 0;
  int rc = launch_score_phase(values, cl, coeffs, noise, out, nullptr, B, C,
                              n_groups, col_groups, PHASE_FULL, mode, fast,
                              seed, seed_ptr, st, &total_cols);
  if (rc != 0) return rc;
  return launch_nich_stage(values, out, partials, bmask, sums, B, C,
                           total_cols, st);
}

// The stat stage alone: sums [C, 3 * cols] of the rows `values` [B, cols]
// at the slots `assign` [B] (a slot outside [0, C) adds nothing), with the
// scratch of fused_v2_launch.
extern "C" int fused_v2_stats_launch(const float* values, const int* assign,
                                     float* partials, unsigned* bmask,
                                     float* sums, int B, int C, int cols,
                                     void* stream) {
  if (cols < 1 || cols > MAX_COLS) return (int)cudaErrorInvalidValue;
  return launch_nich_stage(values, assign, partials, bmask, sums, B, C, cols,
                           (cudaStream_t)stream);
}

// How the stat stage cuts a launch of B rows of `cols` nich columns
// against C slots: info[0..6] as stat_plan_info's (fused_stats.cuh).
extern "C" int fused_v2_stat_plan(int B, int C, int cols, int* info) {
  if (cols < 1 || cols > MAX_COLS) return (int)cudaErrorInvalidValue;
  return stat_plan_info(B, C, 3 * cols, cols, 0, 0, 0, info);
}
