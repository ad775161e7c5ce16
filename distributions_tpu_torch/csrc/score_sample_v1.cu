// The v1 score + sample kernels for NVIDIA Hopper (sm_90a): no stat outputs.
//
// Replace distributions_tpu/ops/pallas_kernels.py::_score_sample_kernel
// (wrapper nich_score_sample) and ::_mixed_kernel (wrapper
// mixed_score_sample).  For one tile of B rows against C mixture slots
//
//   scores[r, k] = cl[k]
//     then per nich column j, in column order,
//       (scores + score_j[k]) + log_coeff_j[k] * log1p((prec_j[k] * t) * t),
//       t = v_rj - mean_j[k]
//     then per table column j      + tables[j, idx_rj, k]     (mixed only)
//
// and one slot per row is drawn by gumbel-argmax.  The TPU kernel reaches
// the table term through a one-hot matmul of bf16 halves; here it is a
// gather of the f32 entry.
//
// This is not the product-form kernel with its sums dropped: that one
// takes one log per block of columns, this one a log1p per column, and the
// per-column constants enter the sum column by column.
//
// Design, as in the fused kernels: one thread owns one row and walks all
// slots in order with the running score in registers; the per-slot
// coefficient rows ([1 + 4 * cols][CK]: cl, then per column score,
// log_coeff, prec, mean) are staged through shared memory in chunks of CK
// slots and read as warp-wide broadcasts; score tables are read through
// the read-only cache (__ldg), since rows of a warp hold different values
// and a thread walks its own table row in slot order; nothing of size
// [B, C] reaches device memory.  What bounds it on the H100 is operations,
// not bytes: a log1p per nich column and the draw's two logs per cell.
//
// Semantics held against the plain-PyTorch twins (nich_score_sample_plain,
// mixed_score_sample_plain in ops/fused_kernels.py): every float operation
// is an explicitly rounded __f*_rn op in the twin's order with log1pf, and
// the draws are Draw<MODE, false> of fused_common.cuh ('argmax', 'gumbel'
// with Philox, 'gumbel_host' with the caller's noise).
//
// Bound through ctypes: two plain C entry points that launch on the
// caller's stream, allocate nothing, and return cudaGetLastError().

#include "fused_common.cuh"

#define MAX_COLS 32         // nich columns
#define MAX_TABLE_COLS 16
#define SCORE_THREADS 128
#define SMEM_FLOATS (48 * 1024 / 4)

// The nich terms of one (row, slot) cell added onto s, column by column.
// sco: the slot's staged coefficient column, rows CK apart, row 0 = cl;
// sval: the row's values, SCORE_THREADS apart.
__device__ __forceinline__ float add_nich_terms(float s,
                                                const float* __restrict__ sco,
                                                const float* __restrict__ sval,
                                                int cols, int CK) {
  for (int j = 0; j < cols; ++j) {
    const float* co = sco + (size_t)(1 + 4 * j) * CK;
    const float score = co[0];
    const float log_coeff = co[CK];
    const float prec = co[2 * CK];
    const float mean = co[3 * CK];
    const float t = __fsub_rn(sval[j * SCORE_THREADS], mean);
    const float x = __fmul_rn(__fmul_rn(prec, t), t);
    s = __fadd_rn(__fadd_rn(s, score), __fmul_rn(log_coeff, log1pf(x)));
  }
  return s;
}

// Stage slots [c0, c0 + n) of cl and the 4 * cols coefficient rows.
__device__ __forceinline__ void stage_coeffs(float* __restrict__ sco,
                                             const float* __restrict__ cl,
                                             const float* __restrict__ coeffs,
                                             int c0, int n, int C, int cols,
                                             int CK) {
  for (int i = threadIdx.x; i < n; i += SCORE_THREADS) {
    const int k = c0 + i;
    sco[i] = cl[k];
    for (int x = 0; x < 4 * cols; ++x)
      sco[(size_t)(1 + x) * CK + i] = coeffs[(size_t)x * C + k];
  }
}

// -- nich columns only ------------------------------------------------------

template <int MODE>
__global__ void __launch_bounds__(SCORE_THREADS)
score_sample_v1_nich(const float* __restrict__ values,
                     const float* __restrict__ cl,
                     const float* __restrict__ coeffs,
                     const float* __restrict__ noise, int* __restrict__ out,
                     int B, int C, int cols, int CK,
                     unsigned long long seed) {
  extern __shared__ float smem[];
  float* sco = smem;
  float* sval = smem + (size_t)(1 + 4 * cols) * CK;
  const int tid = threadIdx.x;
  const int row = blockIdx.x * SCORE_THREADS + tid;
  const bool active = row < B;
  if (active)
    for (int c = 0; c < cols; ++c)
      sval[c * SCORE_THREADS + tid] = values[(size_t)row * cols + c];
  Draw<MODE, false> dr;
  dr.init(row, active, seed, noise);
  dr.begin_pass(0);
  for (int c0 = 0; c0 < C; c0 += CK) {
    const int n = min(CK, C - c0);
    __syncthreads();
    stage_coeffs(sco, cl, coeffs, c0, n, C, cols, CK);
    __syncthreads();
    if (!active) continue;
    for (int kk = 0; kk < n; ++kk) {
      const float s = add_nich_terms(sco[kk], sco + kk, sval + tid, cols, CK);
      dr.visit(0, row, c0 + kk, C, s, noise);
    }
  }
  if (active) out[row] = dr.result();
}

// -- nich columns and table columns -----------------------------------------
//
// srow[j] holds the row of the flattened [n_tab * V, C] table that the
// row's value in table column j selects: j * V + idx.

template <int MODE>
__global__ void __launch_bounds__(SCORE_THREADS)
score_sample_v1_mixed(const float* __restrict__ values,
                      const int* __restrict__ table_idx,
                      const float* __restrict__ cl,
                      const float* __restrict__ coeffs,
                      const float* __restrict__ tables,
                      const float* __restrict__ noise, int* __restrict__ out,
                      int B, int C, int cols, int n_tab, int V, int CK,
                      unsigned long long seed) {
  extern __shared__ float smem[];
  float* sco = smem;
  float* sval = smem + (size_t)(1 + 4 * cols) * CK;
  int* srow = (int*)(sval + cols * SCORE_THREADS);
  const int tid = threadIdx.x;
  const int row = blockIdx.x * SCORE_THREADS + tid;
  const bool active = row < B;
  if (active) {
    for (int c = 0; c < cols; ++c)
      sval[c * SCORE_THREADS + tid] = values[(size_t)row * cols + c];
    for (int j = 0; j < n_tab; ++j) {
      const int v = table_idx[(size_t)row * n_tab + j];
#ifdef SCORE_SAMPLE_V1_DEBUG
      if (v < 0 || v >= V) __trap();
#endif
      srow[j * SCORE_THREADS + tid] = j * V + v;
    }
  }
  Draw<MODE, false> dr;
  dr.init(row, active, seed, noise);
  dr.begin_pass(0);
  for (int c0 = 0; c0 < C; c0 += CK) {
    const int n = min(CK, C - c0);
    __syncthreads();
    stage_coeffs(sco, cl, coeffs, c0, n, C, cols, CK);
    __syncthreads();
    if (!active) continue;
    for (int kk = 0; kk < n; ++kk) {
      const int k = c0 + kk;
      float s = add_nich_terms(sco[kk], sco + kk, sval + tid, cols, CK);
      for (int j = 0; j < n_tab; ++j)
        s = __fadd_rn(
            s, __ldg(tables + (size_t)srow[j * SCORE_THREADS + tid] * C + k));
      dr.visit(0, row, k, C, s, noise);
    }
  }
  if (active) out[row] = dr.result();
}

static inline int imin(int a, int b) { return a < b ? a : b; }

// slots per staged chunk, given the floats each thread keeps in shared
// memory; 0 when nothing fits
static int chunk_slots(int C, int cols, int per_thread) {
  const int W = 1 + 4 * cols;
  return imin(C, (SMEM_FLOATS - SCORE_THREADS * per_thread) / W);
}

extern "C" const char* score_sample_v1_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// values [B, cols], cl [C], coeffs [4 * cols, C], noise [B, C] or null,
// out [B].
extern "C" int score_sample_v1_nich_launch(
    const float* values, const float* cl, const float* coeffs,
    const float* noise, int* out, int B, int C, int cols, int mode,
    unsigned long long seed, void* stream) {
  if (B < 1 || C < 1 || cols < 1 || cols > MAX_COLS || mode < MODE_ARGMAX ||
      mode > MODE_GUMBEL_HOST)
    return (int)cudaErrorInvalidValue;
  const int CK = chunk_slots(C, cols, cols);
  if (CK < 1) return (int)cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)(1 + 4 * cols) * CK + (size_t)SCORE_THREADS * cols) *
      sizeof(float);
  const dim3 grid((B + SCORE_THREADS - 1) / SCORE_THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case MODE_ARGMAX:
      score_sample_v1_nich<MODE_ARGMAX><<<grid, SCORE_THREADS, smem, st>>>(
          values, cl, coeffs, noise, out, B, C, cols, CK, seed);
      break;
    case MODE_GUMBEL:
      score_sample_v1_nich<MODE_GUMBEL><<<grid, SCORE_THREADS, smem, st>>>(
          values, cl, coeffs, noise, out, B, C, cols, CK, seed);
      break;
    default:
      score_sample_v1_nich<MODE_GUMBEL_HOST>
          <<<grid, SCORE_THREADS, smem, st>>>(values, cl, coeffs, noise, out,
                                              B, C, cols, CK, seed);
      break;
  }
  return (int)cudaGetLastError();
}

// values [B, cols] and coeffs [4 * cols, C] (null when cols == 0),
// table_idx [B, n_tab] and tables [n_tab, V, C] (null when n_tab == 0).
extern "C" int score_sample_v1_mixed_launch(
    const float* values, const int* table_idx, const float* cl,
    const float* coeffs, const float* tables, const float* noise, int* out,
    int B, int C, int cols, int n_tab, int V, int mode,
    unsigned long long seed, void* stream) {
  if (B < 1 || C < 1 || cols < 0 || cols > MAX_COLS || n_tab < 0 ||
      n_tab > MAX_TABLE_COLS || cols + n_tab < 1 || (n_tab > 0 && V < 1) ||
      mode < MODE_ARGMAX || mode > MODE_GUMBEL_HOST)
    return (int)cudaErrorInvalidValue;
  const int per_thread = cols + n_tab;
  const int CK = chunk_slots(C, cols, per_thread);
  if (CK < 1) return (int)cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)(1 + 4 * cols) * CK + (size_t)SCORE_THREADS * per_thread) *
      sizeof(float);
  const dim3 grid((B + SCORE_THREADS - 1) / SCORE_THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case MODE_ARGMAX:
      score_sample_v1_mixed<MODE_ARGMAX><<<grid, SCORE_THREADS, smem, st>>>(
          values, table_idx, cl, coeffs, tables, noise, out, B, C, cols, n_tab,
          V, CK, seed);
      break;
    case MODE_GUMBEL:
      score_sample_v1_mixed<MODE_GUMBEL><<<grid, SCORE_THREADS, smem, st>>>(
          values, table_idx, cl, coeffs, tables, noise, out, B, C, cols, n_tab,
          V, CK, seed);
      break;
    default:
      score_sample_v1_mixed<MODE_GUMBEL_HOST>
          <<<grid, SCORE_THREADS, smem, st>>>(values, table_idx, cl, coeffs,
                                              tables, noise, out, B, C, cols,
                                              n_tab, V, CK, seed);
      break;
  }
  return (int)cudaGetLastError();
}
