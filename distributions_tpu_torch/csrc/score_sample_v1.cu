// The v1 score + sample kernels for NVIDIA Hopper (sm_90a): no stat outputs.
//
// Replace distributions_tpu/ops/pallas_kernels.py::_score_sample_kernel
// (wrapper nich_score_sample, K4) and ::_mixed_kernel (wrapper
// mixed_score_sample, K5).  For one tile of B rows against C mixture
// slots
//
//   scores[r, k] = cl[k]
//     then per nich column j, in column order,
//       (scores + score_j[k]) + log_coeff_j[k] * log1p((prec_j[k] * t) * t),
//       t = v_rj - mean_j[k]
//     then per table column j      + tables[j, idx_rj, k]     (K5 only)
//
// and one slot per row is drawn by gumbel-argmax.  The TPU kernel reaches
// the table term through a one-hot matmul of bf16 halves; here it is a
// gather of the f32 entry.
//
// This is not the product-form score of K1 with its sums dropped: that one
// takes one log per block of columns, this one a log1p per column, and the
// per-column constants enter the sum column by column.
//
// What bounds it on the H100: operations, not bytes -- a log1pf per nich
// column and the draw's two logs and a quarter Philox block per (row,
// slot) cell; nothing of size [B, C] reaches device memory.  Design: the
// slot-split walk of fused_split.cuh in its v1 form (eight threads a row,
// each on a slice of whole Philox blocks; two rows a thread with their
// values and table row pointers in registers; each slot's record [per
// nich column score, log_coeff, prec, mean | cl] staged in shared memory
// and read 16 bytes a load; K5's table rows read four slots a 16-byte
// load; two independent Philox chains; the slices merged in slice order).
// At K4's tile of 131,072 rows that is 524,288 threads where one thread a
// row gave 131,072, at K5's tile of 65,536 rows 262,144 where it gave
// 65,536: a quarter and an eighth of what the card holds resident.
//
// Shapes, by layout (cols nich columns, n_tab table columns):
//   - n_tab == 0, cols 1-4: an exact shape (K4's nich layouts; the main
//     path runs 2 columns);
//   - n_tab 1-3, cols 0-2: an exact shape (K5's mixes of a few blocks:
//     nichbbddgp (1, 3) on the main path, bbddgp (0, 3), nich_gp_bb
//     (1, 2), dd_bb (0, 2), dpd_nich (1, 1), bnb (0, 1));
//   - every other layout (up to MAX_COLS and MAX_TABLE_COLS): the wide
//     shape, its rows staged in shared memory.
// An exact shape keeps the record and the rows' values in registers and
// unrolls every loop; a layout with more columns would hold more
// registers than two rows a thread leave room for, and the wide shape
// takes it at one staged load per value.
//
// Semantics held against the plain-PyTorch twins (nich_score_sample_plain,
// mixed_score_sample_plain in ops/fused_kernels.py): every float operation
// is an explicitly rounded __f*_rn op in the twin's order with log1pf, and
// the draws are those of Draw<MODE, false> of fused_common.cuh ('argmax',
// 'gumbel' with Philox counted by (row, slot / 4), word slot % 4,
// 'gumbel_host' with the caller's noise), which the split walk reproduces
// slot for slot.
//
// Bound through ctypes: two plain C entry points that launch on the
// caller's stream, allocate nothing, and return cudaGetLastError() (the
// seed by value, or from device memory for a CUDA graph's replays), and
// score_sample_v1_occupancy(), which reports the split kernel a launch
// takes.

#include "fused_split.cuh"

#define MAX_COLS 32         // nich columns
#define MAX_TABLE_COLS 16

static_assert(MAX_COLS <= SPLIT_MAX_NICH && MAX_TABLE_COLS <= SPLIT_MAX_TAB,
              "the split layout holds every layout the wrappers accept");

// The split kernel of one draw for the shape `SH`, handed to fn with the
// record floats and staged row floats of layout L on it.
template <class SH, class Fn>
static void with_v1_shape(const SplitLayout& L, int mode, Fn&& fn) {
  const int P = split_record_floats<SH>(L), R = split_row_floats<SH>(L);
  switch (mode) {
    case MODE_ARGMAX:
      fn(split_score_sample<MODE_ARGMAX, false, PHASE_FULL, SH>, P, R);
      break;
    case MODE_GUMBEL:
      fn(split_score_sample<MODE_GUMBEL, false, PHASE_FULL, SH>, P, R);
      break;
    default:
      fn(split_score_sample<MODE_GUMBEL_HOST, false, PHASE_FULL, SH>, P, R);
      break;
  }
}

// The first of the exact shapes SH... that fits L, else the wide shape.
template <class... SH, class Fn>
static void with_v1_shapes(const SplitLayout& L, int mode, Fn&& fn) {
  const bool exact =
      ((split_fits<SH>(L) && (with_v1_shape<SH>(L, mode, fn), true)) || ...);
  if (!exact) with_v1_shape<WideShapeV1>(L, mode, fn);
}

template <class Fn>
static void with_v1_kernel(const SplitLayout& L, int mode, Fn&& fn) {
  with_v1_shapes<ShapeV1<1, 0>, ShapeV1<2, 0>, ShapeV1<3, 0>, ShapeV1<4, 0>,
                 ShapeV1<0, 1>, ShapeV1<0, 2>, ShapeV1<0, 3>,
                 ShapeV1<1, 1>, ShapeV1<1, 2>, ShapeV1<1, 3>,
                 ShapeV1<2, 1>, ShapeV1<2, 2>, ShapeV1<2, 3>>(L, mode, fn);
}

// The layout of a launch; false when the wrappers' caps refuse it.
static bool v1_layout(int C, int cols, int n_tab, int V, int mode,
                      SplitLayout* L) {
  if (C < 1 || cols < 0 || cols > MAX_COLS || n_tab < 0 ||
      n_tab > MAX_TABLE_COLS || cols + n_tab < 1 || (n_tab > 0 && V < 1) ||
      mode < MODE_ARGMAX || mode > MODE_GUMBEL_HOST)
    return false;
  return split_layout_v1(cols, n_tab, V, L);
}

static int launch_v1(const float* values, const int* table_idx,
                     const float* cl, const float* coeffs,
                     const float* tables, const float* noise, int* out,
                     int B, int C, int cols, int n_tab, int V, int mode,
                     unsigned long long seed,
                     const unsigned long long* seed_ptr, cudaStream_t st) {
  SplitLayout L;
  if (B < 1 || !v1_layout(C, cols, n_tab, V, mode, &L))
    return (int)cudaErrorInvalidValue;
  SplitArgs a = SplitArgs();
  a.values = values;
  a.table_idx = table_idx;
  a.cl = cl;
  a.coeffs = coeffs;
  a.tables = tables;
  a.noise = noise;
  a.out = out;
  a.B = B;
  a.C = C;
  a.slot_offset = 0;
  a.seed = seed;
  a.seed_ptr = seed_ptr;
  const dim3 grid((B + SPLIT_BLOCK_ROWS - 1) / SPLIT_BLOCK_ROWS);
  bool fits = true;
  with_v1_kernel(L, mode, [&](auto kern, int P, int rows) {
    size_t smem = 0;
    fits = split_geometry(P, rows, &a, &smem);
    if (fits) kern<<<grid, SPLIT_THREADS, smem, st>>>(a, L);
  });
  return fits ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

extern "C" const char* score_sample_v1_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// values [B, cols], cl [C], coeffs [4 * cols, C], noise [B, C] or null,
// out [B].  seed_ptr: null, or the seed in device memory in place of
// `seed`, read when the kernel runs (the v1 sweeps' CUDA graph); Philox is
// counted by (row, slot / 4) either way, so both draw alike.
extern "C" int score_sample_v1_nich_launch(
    const float* values, const float* cl, const float* coeffs,
    const float* noise, int* out, int B, int C, int cols, int mode,
    unsigned long long seed, const unsigned long long* seed_ptr,
    void* stream) {
  if (cols < 1) return (int)cudaErrorInvalidValue;
  return launch_v1(values, nullptr, cl, coeffs, nullptr, noise, out, B, C,
                   cols, 0, 0, mode, seed, seed_ptr, (cudaStream_t)stream);
}

// values [B, cols] and coeffs [4 * cols, C] (null when cols == 0),
// table_idx [B, n_tab] and tables [n_tab, V, C] (null when n_tab == 0);
// seed_ptr as above.
extern "C" int score_sample_v1_mixed_launch(
    const float* values, const int* table_idx, const float* cl,
    const float* coeffs, const float* tables, const float* noise, int* out,
    int B, int C, int cols, int n_tab, int V, int mode,
    unsigned long long seed, const unsigned long long* seed_ptr,
    void* stream) {
  return launch_v1(values, table_idx, cl, coeffs, tables, noise, out, B, C,
                   cols, n_tab, V, mode, seed, seed_ptr,
                   (cudaStream_t)stream);
}

// The split kernel that a launch with this layout and draw takes at C
// slots: info[0..6] as fused_v2_occupancy's (resident blocks per SM,
// threads per block, dynamic shared memory bytes, record floats, turns,
// registers, local bytes).
extern "C" int score_sample_v1_occupancy(int C, int cols, int n_tab,
                                         int mode, int* info) {
  SplitLayout L;
  if (!v1_layout(C, cols, n_tab, 1, mode, &L))
    return (int)cudaErrorInvalidValue;
  int rc = 0;
  with_v1_kernel(L, mode, [&](auto kern, int P, int rows) {
    SplitArgs a = SplitArgs();
    a.C = C;
    size_t smem = 0;
    rc = split_geometry(P, rows, &a, &smem)
             ? split_occupancy(kern, P, a, smem, info)
             : (int)cudaErrorInvalidValue;
  });
  return rc;
}
