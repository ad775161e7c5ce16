// The slot-split walk of the score + sample kernels for NVIDIA Hopper
// (sm_90a), for the argmax family of draws ('argmax', 'gumbel',
// 'gumbel_host', and the phase profiler's 'bits', 'score_max' and 'noop'):
// K1 and its phases B5 (fused_v2.cu), K2 and K3 (fused_v3.cu), K4 and K5
// (score_sample_v1.cu).  'cdf' keeps the sequential one-row-per-thread
// walk of fused_v2.cu and fused_v3.cu (see there).
//
// Geometry.  SPLIT_SLICES threads share each row: thread s scores its rows
// against slice s of the slot axis, a contiguous run of whole Philox blocks
// -- slices start on global slots g = slot_offset + slot that are multiples
// of 4, so no block of four Philox words is split between threads (with
// slot_offset % 4 != 0 the first slice is short).  Each thread holds
// SPLIT_ROWS rows, their values (and niw values, and table row pointers)
// in registers for the whole walk.  A block of SPLIT_THREADS threads holds
// SPLIT_BLOCK_ROWS rows.  Each warp walks one slice for 32 row groups, so
// that all its lanes read the same slot at once: one broadcast address
// per record load, and the table columns' reads land on as few cache
// lines as the rows' values allow.  (With SPLIT_LANE_SLICES=1 at compile
// time a row's slices sit instead on lanes of one warp, SPLIT_LANES lanes
// apart: the first version of this walk, kept as a variant to time.)
//
// Two score forms.  The product form (K1, K2, K3): cst, then per block of
// <= 4 nich (or niw) columns lc * log(prod of (1 + ...)), then the table
// columns.  The v1 form (K4, K5: Shape V1 below): s = cl, then per nich
// column, in column order, s = (s + score) + log_coeff * log1pf((prec * t)
// * t) with t = v - mean, then the table columns.  Its per-column
// constants enter the sum one by one, so they cannot be folded into one
// constant as the product form folds its bases: each cell repeats the
// sequential v1 kernel's operations exactly.
//
// Coefficients.  The per-slot coefficients are staged in shared memory
// slot-major, one record of P floats per slot, P a multiple of SPLIT_PACK
// (4: a record is P / 4 16-byte loads).  A product-form record is [cst |
// per nich column prec, mean, lc | per niw column mu[D], lam[D (D + 1) /
// 2], lc], with cst = cl + every block's base, and the block's lc repeated
// per column so that every field sits at a compile-time offset.  A v1
// record is [per nich column score, log_coeff, prec, mean | cl, pad]: each
// column one aligned 16-byte load.  A thread reads a slot's record once
// for all SPLIT_ROWS rows.  In the lane variant each slice's records lie
// SPLIT_PAD floats past the previous slice's, so that its eight
// slices in a warp read eight distinct banks (no pad otherwise: a warp's
// lanes all read one slot).  Where the slices' records do not fit in
// SPLIT_SMEM_FLOATS, the slot axis is staged in turns, each turn a run of
// every slice's next slots.
//
// Shapes.  An exact shape (Shape<NC, NQC, D, NT>: one block of NC nich
// columns, one block of NQC niw columns of dimension D, NT table columns;
// ShapeV1<NC, NT>: NC nich columns and NT table columns in the v1 form)
// fixes the layout's sizes and its products at compile time, so that the
// record and the row values are register arrays and every loop unrolls.
// A folded shape (ShapeTable1Folded: one table column of V <= 4 values and
// nothing else) stages in each slot's record the slot's score for each of
// the column's values, cst + tables[v, k] (the one rounded add of the
// sequential walk, done once a slot and block instead of once a cell):
// a row keeps its value index in a register, and a cell's score is the
// record's entry at that index, with no table gather in the walk.
// A shared-record shape (ShapeNiw16: one niw column of D = 16 and nothing
// else) has a record too large for registers (cst, mu[16], lam[136], lc:
// 156 floats with its pad): its rows' values stay in registers, and the
// walk reads the record from shared memory a 16-byte load at a time, in
// field order, once for all SPLIT_ROWS rows (a warp's lanes read one
// slot: one broadcast address a load); the block's threads stage the
// records a field a thread, so that a turn's staging is not left to one
// thread a slot.
// The wide shape (WideShape, WideShapeV1) takes every other layout the
// wrappers accept: its loops run to the run-time layout's counts, so the
// rows' values (and table rows) are staged in shared memory beside the
// records, column by column, SPLIT_BLOCK_ROWS apart, and indexed there;
// the record is packed to the layout (each niw column at its own
// dimension) and read field by field, once for all SPLIT_ROWS rows; the
// niw form unrolls to D <= kQMax (WideShape: 4; WideShapeD16, for layouts
// with a niw column of d > 4: 16) with the column's d as a guard, so the
// centred differences stay in registers.  The wrappers pick the shape by
// layout (fused_v2.cu, fused_v3.cu, score_sample_v1.cu); SPLIT_WIDE_ONLY=1
// at compile time sends every layout to a wide shape, a variant that
// times one shape against the other.
//
// Table columns.  A table entry is a gather: the lanes of a warp read one
// slot of as many table rows as their rows hold distinct values, each on
// its own cache line.  An exact shape of the v1 form with table columns
// (K5) therefore takes a row at a time through each block of four slots:
// one 16-byte load per table column gives the row's entries of all four
// (where C % 4 == 0, the slot offset % 4 == 0 and the tables are 16-byte
// aligned; else one load a slot), a quarter of the load instructions for
// the same cache lines, and the slot's record is read again from shared
// memory for each row.  The product form's shapes (K2, K3) read one slot
// a load, their rows side by side.  SPLIT_TABLE_VEC=0 at compile time
// makes K5 read one slot a load too, a variant to time.
//
// Philox.  In 'gumbel' and 'bits' a thread draws, per block of four slots,
// one Philox4x32-10 block per row: SPLIT_ROWS independent chains (the rows
// share the counter's slot word q = g / 4), which the compiler interleaves.
// Counter (row, q, 0, 0), word g % 4, as in Draw of fused_common.cuh.
//
// Merge.  Each slice keeps the first maximal perturbed score of its slots
// and its slot (NaN counts as maximal: beats() of fused_common.cuh).  The
// slices' pairs meet in shared memory, and the first warp folds them in
// slice order, the earlier slice kept on a tie (the lane variant: a
// butterfly of warp shuffles with the earlier slice always on the left).
// "First maximal element" is associative, so the merged slot and score
// equal the sequential scan's bit for bit; each cell's score is the same
// sequence of __f*_rn operations as in the sequential walk.

#pragma once

#include <type_traits>

#include "fused_common.cuh"

#define SPLIT_SLICES 8              // threads per row, one slot slice each
#ifndef SPLIT_ROWS
#define SPLIT_ROWS 2                // rows per thread
#endif
#ifndef SPLIT_LANE_SLICES
#define SPLIT_LANE_SLICES 0         // 1: a row's slices on lanes of a warp
#endif
#ifndef SPLIT_WIDE_ONLY
#define SPLIT_WIDE_ONLY 0           // 1: every layout on the wide shape
#endif
#ifndef SPLIT_TABLE_VEC
#define SPLIT_TABLE_VEC 1           // 0: K5's table rows one slot a load
#endif
#ifndef SPLIT_MIN_BLOCKS
#define SPLIT_MIN_BLOCKS 0          // > 0: __launch_bounds__' minimum of
#endif                              // resident blocks (0: none given)
#define SPLIT_THREADS 256           // threads per block
#define SPLIT_PACK 4                // a record's floats are a multiple of this
#define SPLIT_PAD (SPLIT_LANE_SLICES ? 4 : 0)  // floats between two slices'
                                               // records
#define SPLIT_SMEM_FLOATS (28 * 1024 / 4)   // staged records per block
#define SPLIT_SMEM_MAX (48 * 1024)          // bytes one turn may stage
#define SPLIT_LANES (32 / SPLIT_SLICES)     // the lane variant's row groups
                                            // per warp
#define SPLIT_GROUPS (SPLIT_THREADS / SPLIT_SLICES)  // row groups per block
#define SPLIT_BLOCK_ROWS (SPLIT_GROUPS * SPLIT_ROWS)
#define SPLIT_MAX_NICH 32           // caps of a layout
#define SPLIT_MAX_QUAD 16
#define SPLIT_MAX_TAB 16
#define SPLIT_MAX_GROUPS 8
#define SPLIT_MAX_D 16              // niw dimension

static_assert(SPLIT_THREADS == 32 * SPLIT_SLICES && 32 % SPLIT_SLICES == 0,
              "a warp a slice, or a row's slices in one warp");

enum { PHASE_FULL = 0, PHASE_NOOP = 1, PHASE_SCORE_MAX = 2 };

// Columns that start (first) and end (last) a product of <= 4 factors when
// all n columns form one block: bit c set.
constexpr unsigned chunk_first(int n, int c = 0) {
  return c >= n ? 0u : (c % 4 == 0 ? 1u << c : 0u) | chunk_first(n, c + 1);
}
constexpr unsigned chunk_last(int n, int c = 0) {
  return c >= n ? 0u
                : ((c % 4 == 3 || c == n - 1) ? 1u << c : 0u) |
                      chunk_last(n, c + 1);
}

// An exact shape also fixes the products: one nich block and one niw
// block (their chunk masks at compile time).
template <int NC, int NQC, int D, int NT>
struct Shape {
  static constexpr int kNC = NC, kNQC = NQC, kD = D, kNT = NT;
  static constexpr bool kExact = true, kV1 = false, kFolded = false;
  static constexpr bool kSharedRecord = false;
  static constexpr unsigned kNFirst = chunk_first(NC), kNLast = chunk_last(NC);
  static constexpr unsigned kQFirst = chunk_first(NQC),
                            kQLast = chunk_last(NQC);
  static constexpr int kTri = D * (D + 1) / 2;
  static constexpr int kQRec = D + kTri + 1;
  static constexpr int kQBase = 1 + 3 * NC;
  static constexpr int kRec = kQBase + NQC * kQRec;
  static constexpr int kP =
      (kRec + SPLIT_PACK - 1) / SPLIT_PACK * SPLIT_PACK;
};

// One table column of V <= kP values and nothing else, each slot's V
// scores folded into its record: record entry v is cst + tables[v, k].
struct ShapeTable1Folded : Shape<0, 0, 1, 1> {
  static constexpr bool kFolded = true;
};

// One niw column of D = 16 and nothing else, its record read from shared
// memory (kSharedRecord).
struct ShapeNiw16 : Shape<0, 1, 16, 0> {
  static constexpr bool kSharedRecord = true;
};

// the shape that takes every layout whose niw columns have d <= kQMax
struct WideShape {
  static constexpr bool kExact = false, kV1 = false, kFolded = false;
  static constexpr bool kSharedRecord = false;
  static constexpr int kQMax = 4;
};

// the shape that takes every layout
struct WideShapeD16 : WideShape {
  static constexpr int kQMax = SPLIT_MAX_D;
};

// The v1 form's exact shapes: NC nich columns, NT table columns.
template <int NC, int NT>
struct ShapeV1 {
  static constexpr int kNC = NC, kNQC = 0, kD = 1, kNT = NT;
  static constexpr bool kExact = true, kV1 = true, kFolded = false;
  static constexpr bool kSharedRecord = false;
  static constexpr int kP = 4 * NC + SPLIT_PACK;   // [4 a column | cl, pad]
};

// the v1 form's shape that takes every layout
struct WideShapeV1 {
  static constexpr bool kExact = false, kV1 = true, kFolded = false;
  static constexpr bool kSharedRecord = false;
  static constexpr int kQMax = 4;
};

// What varies at run time: the groups, and per column where a product of
// <= 4 factors starts (bit set in *first) and ends (bit set in *last).
struct SplitLayout {
  bool v1;                   // the v1 score form (split_layout_v1)
  int n_nich, nich_cols[SPLIT_MAX_GROUPS];
  int n_quad, quad_cols[SPLIT_MAX_GROUPS], quad_d[SPLIT_MAX_GROUPS];
  int n_tab, tab_off[SPLIT_MAX_TAB], vtot;
  int ncols, nqc, qvals;     // nich columns, niw columns, niw values
  unsigned nfirst, nlast, qfirst, qlast;
  // per niw column: dimension, first value, record offset
  int qd[SPLIT_MAX_QUAD], qoff[SPLIT_MAX_QUAD], qrec[SPLIT_MAX_QUAD];
  int P;                     // the packed record's floats
};

struct SplitArgs {
  const float* values;      // [B, ncols]
  const float* qvalues;     // [B, qvals]
  const int* table_idx;     // [B, n_tab]
  const float* cl;          // [C]
  const float* coeffs;      // nich_coeffs_v2 rows [., C] (v1: nich_coeffs)
  const float* qcoeffs;     // niw_coeffs_v4 rows [., C]
  const float* tables;      // packed [Vtot, C]
  const float* noise;       // 'gumbel_host': [B, C]
  int* out;                 // [B] drawn slot, or null
  float* best;              // [B] its perturbed score (PHASE_SCORE_MAX:
                            // the row maximum), or null
  int B, C, slot_offset;
  unsigned long long seed;
  // Under a CUDA graph (K1-K5): the seed in device memory, read when the
  // kernel runs (null: `seed` above).  A replayed graph keeps its launch
  // arguments, so a seed passed by value would repeat every replay.
  const unsigned long long* seed_ptr;
  int lead;                 // slot_offset % 4: virtual slot v = slot + lead
  int SL;                   // virtual slots per slice, a multiple of 4
  int L;                    // virtual slots per slice per turn, ditto
  int turns;
  int P;                    // record floats
  int row_floats;           // the wide shape's staged rows, before the
                            // records in shared memory
  int vec_tables;           // table rows read four slots a load: lead 0,
                            // C % 4 == 0 and the tables 16-byte aligned
};

// Fill the geometry of `a` for records of P floats after row_floats of
// staged rows; *smem gets the dynamic shared memory.  Returns false when
// one turn of the slices' records does not fit.
static inline bool split_geometry(int P, int row_floats, SplitArgs* a,
                                  size_t* smem) {
  a->P = P;
  a->row_floats = row_floats;
  a->lead = a->slot_offset & 3;
  const int quads = (a->lead + a->C + 3) / 4;
  const int per_slice = (quads + SPLIT_SLICES - 1) / SPLIT_SLICES;
  a->SL = 4 * per_slice;
  int fit = (SPLIT_SMEM_FLOATS / SPLIT_SLICES - SPLIT_PAD) / P / 4;
  if (fit < 1) fit = 1;
  a->turns = (per_slice + fit - 1) / fit;
  a->L = 4 * ((per_slice + a->turns - 1) / a->turns);
  a->vec_tables = SPLIT_TABLE_VEC && a->lead == 0 && a->C % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(a->tables) % 16 == 0;
  *smem = ((size_t)SPLIT_SLICES * ((size_t)a->L * P + SPLIT_PAD) +
           row_floats) *
          sizeof(float);
  return *smem <= SPLIT_SMEM_MAX;
}

// Shape SH's record floats and staged row floats for layout L.
template <class SH>
static inline int split_record_floats(const SplitLayout& L) {
  if constexpr (SH::kExact) return SH::kP;
  return L.P;
}
template <class SH>
static inline int split_row_floats(const SplitLayout& L) {
  if constexpr (SH::kExact) return 0;
  return SPLIT_BLOCK_ROWS * (L.ncols + L.qvals + L.n_tab);
}

// The occupancy entry points' report of one split kernel (see
// fused_v2_occupancy): info[0..6].
template <class K>
static int split_occupancy(K kern, int P, const SplitArgs& a, size_t smem,
                           int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                      SPLIT_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = blocks;
  info[1] = SPLIT_THREADS;
  info[2] = (int)smem;
  info[3] = P;
  info[4] = a.turns;
  info[5] = attr.numRegs;
  info[6] = (int)attr.localSizeBytes;
  return 0;
}

// Per-column flags of a layout; false when it exceeds the wide caps.
static inline bool split_layout(int n_nich, const int* nich_cols, int n_quad,
                                const int* quad_cols, const int* quad_d,
                                int n_tab, const int* tab_off,
                                SplitLayout* L) {
  if (n_nich < 0 || n_nich > SPLIT_MAX_GROUPS || n_quad < 0 ||
      n_quad > SPLIT_MAX_GROUPS || n_tab < 0 || n_tab > SPLIT_MAX_TAB)
    return false;
  *L = SplitLayout();
  L->n_nich = n_nich;
  L->n_quad = n_quad;
  L->n_tab = n_tab;
  for (int j = 0; j < n_tab; ++j) L->tab_off[j] = tab_off[j];
  for (int g = 0; g < n_nich; ++g) {
    const int nc = nich_cols[g];
    if (nc < 1 || L->ncols + nc > SPLIT_MAX_NICH) return false;
    L->nich_cols[g] = nc;
    for (int j = 0; j < nc; ++j) {
      const int c = L->ncols + j;
      if (j % 4 == 0) L->nfirst |= 1u << c;
      if (j % 4 == 3 || j == nc - 1) L->nlast |= 1u << c;
    }
    L->ncols += nc;
  }
  int rec = 1 + 3 * L->ncols;
  for (int g = 0; g < n_quad; ++g) {
    const int nc = quad_cols[g], d = quad_d[g];
    if (nc < 1 || d < 1 || d > SPLIT_MAX_D || L->nqc + nc > SPLIT_MAX_QUAD)
      return false;
    L->quad_cols[g] = nc;
    L->quad_d[g] = d;
    for (int j = 0; j < nc; ++j) {
      const int c = L->nqc + j;
      if (j % 4 == 0) L->qfirst |= 1u << c;
      if (j % 4 == 3 || j == nc - 1) L->qlast |= 1u << c;
      L->qd[c] = d;
      L->qoff[c] = L->qvals;
      L->qrec[c] = rec;
      L->qvals += d;
      rec += d + d * (d + 1) / 2 + 1;
    }
    L->nqc += nc;
  }
  L->P = (rec + SPLIT_PACK - 1) / SPLIT_PACK * SPLIT_PACK;
  return true;
}

// The layout of the v1 form: ncols nich columns, n_tab table columns of
// a [n_tab, V, C] table, which is the packed [n_tab * V, C] table with
// column j's rows from j * V.  False when it exceeds the caps.
static inline bool split_layout_v1(int ncols, int n_tab, int V,
                                   SplitLayout* L) {
  if (ncols < 0 || ncols > SPLIT_MAX_NICH || n_tab < 0 ||
      n_tab > SPLIT_MAX_TAB)
    return false;
  *L = SplitLayout();
  L->v1 = true;
  L->ncols = ncols;
  L->n_tab = n_tab;
  for (int j = 0; j < n_tab; ++j) L->tab_off[j] = j * V;
  L->vtot = n_tab * V;
  L->P = 4 * ncols + SPLIT_PACK;
  return true;
}

// True when layout L runs on shape SH: a shape of its form, the wide one
// for any layout, an exact one for its counts (and dimension and chunk
// masks), a folded one also for its table values (at most a record).
template <class SH>
static bool split_fits(const SplitLayout& L) {
  if (L.v1 != SH::kV1) return false;
  if constexpr (!SH::kExact) {
    for (int j = 0; j < L.nqc; ++j)
      if (L.qd[j] > SH::kQMax) return false;
    return true;
  } else {
    if (SPLIT_WIDE_ONLY) return false;
    if constexpr (SH::kV1) {
      return L.ncols == SH::kNC && L.n_tab == SH::kNT;
    } else {
      if (L.ncols != SH::kNC || L.nqc != SH::kNQC || L.n_tab != SH::kNT ||
          L.nfirst != SH::kNFirst || L.nlast != SH::kNLast ||
          L.qfirst != SH::kQFirst || L.qlast != SH::kQLast)
        return false;
      for (int j = 0; j < L.nqc; ++j)
        if (L.qd[j] != SH::kD) return false;
      return !SH::kFolded || L.vtot <= SH::kP;
    }
  }
}

// -- one slot's record -------------------------------------------------------

// Stage slot k's record at rec (shared memory), in the twin's order of the
// constant: cl, then the nich blocks' bases, then the niw blocks' bases.
// A niw column's record is mu[d], lam[d (d + 1) / 2] in row-major
// upper-triangle order, lc (an exact shape's d is its D).  A folded
// shape's record is the slot's score of each table value.
template <class SH>
__device__ __forceinline__ void split_stage(const SplitArgs& a,
                                            const SplitLayout& L, int k,
                                            float* rec) {
  const size_t C = a.C;
  float cst = a.cl[k];
  if constexpr (SH::kFolded) {
    for (int v = 0; v < L.vtot; ++v)
      rec[v] = __fadd_rn(cst, a.tables[v * C + k]);
    return;
  }
  int r = 0, c = 0;
  for (int g = 0; g < L.n_nich; ++g) {
    const int nc = L.nich_cols[g];
    cst = __fadd_rn(cst, a.coeffs[r * C + k]);
    const float lc = a.coeffs[(r + 1) * C + k];
    for (int j = 0; j < nc; ++j, ++c) {
      rec[1 + 3 * c] = a.coeffs[(r + 2 + 2 * j) * C + k];
      rec[2 + 3 * c] = a.coeffs[(r + 3 + 2 * j) * C + k];
      rec[3 + 3 * c] = lc;
    }
    r += 2 + 2 * nc;
  }
  r = 0;
  int jq = 0;
  for (int g = 0; g < L.n_quad; ++g) {
    const int nc = L.quad_cols[g], d = L.quad_d[g];
    cst = __fadd_rn(cst, a.qcoeffs[r * C + k]);
    const float lc = a.qcoeffs[(r + 1) * C + k];
    int x = r + 2;
    for (int j = 0; j < nc; ++j, ++jq) {
      int off;
      if constexpr (SH::kExact)
        off = SH::kQBase + jq * SH::kQRec;
      else
        off = L.qrec[jq];
      float* q = rec + off;
      for (int u = 0; u < d; ++u) q[u] = a.qcoeffs[x++ * C + k];
      for (int u = 0; u < d * (d + 1) / 2; ++u)
        q[d + u] = a.qcoeffs[x++ * C + k];
      q[d + d * (d + 1) / 2] = lc;
    }
    r += 2 + nc * (d + d * (d + 1) / 2);
  }
  rec[0] = cst;
}

// Record field f of slot k of a shared-record shape, as split_stage
// stages it: cst = cl + the block's base; mu, lam in niw_coeffs_v4's row
// order; lc last.
template <class SH>
__device__ __forceinline__ float split_field(const SplitArgs& a, int f,
                                             int k) {
  const size_t C = a.C;
  if (f == 0) return __fadd_rn(a.cl[k], a.qcoeffs[k]);
  if (f == SH::kRec - 1) return a.qcoeffs[C + k];
  return a.qcoeffs[(f + 1) * C + k];
}

// Stage the records of a turn of a shared-record shape (one niw column,
// nothing else).  Where the turn's nrec records divide the block's threads
// (ShapeNiw16's turn is a block of four slots a slice: nrec = 32), thread
// t stages fields t / nrec, t / nrec + SPLIT_THREADS / nrec, ... of record
// t % nrec: a warp's lanes load one field of consecutive slots, and no
// thread divides a field index; otherwise a thread a record.
template <class SH>
__device__ __forceinline__ void split_stage_fields(const SplitArgs& a,
                                                   float* recs, int stride,
                                                   int v0, int tid) {
  static_assert(SH::kNC == 0 && SH::kNQC == 1 && SH::kNT == 0 &&
                    SH::kQBase == 1,
                "one niw column alone");
  const int nrec = SPLIT_SLICES * a.L;
  const bool even = SPLIT_THREADS % nrec == 0;
  const int per = even ? SPLIT_THREADS / nrec : 1;
  for (int j = even ? tid % nrec : tid; j < nrec;
       j += even ? nrec : SPLIT_THREADS) {
    const int s = j / a.L, o = j - s * a.L;
    const int k = s * a.SL + v0 + o - a.lead;
    if (v0 + o >= a.SL || k < 0 || k >= a.C) continue;
    float* rec = recs + (size_t)s * stride + (size_t)o * SH::kP;
    for (int f = even ? tid / nrec : 0; f < SH::kRec; f += per)
      rec[f] = split_field<SH>(a, f, k);
  }
}

// Stage slot k's v1 record at rec: nich_coeffs' four rows of each column
// (score, log_coeff, prec, mean), then cl.
__device__ __forceinline__ void split_stage_v1(const SplitArgs& a,
                                               const SplitLayout& L, int k,
                                               float* rec) {
  const size_t C = a.C;
  for (int x = 0; x < 4 * L.ncols; ++x) rec[x] = a.coeffs[x * C + k];
  rec[4 * L.ncols] = a.cl[k];
}

// An exact shape's record, loaded from shared memory into registers with
// 16-byte loads.
template <class SH>
struct RegRecord {
  float x[SH::kP];
  __device__ __forceinline__ void load(const float* __restrict__ p) {
#pragma unroll
    for (int i = 0; i < SH::kP / 4; ++i) {
      const float4 f = reinterpret_cast<const float4*>(p)[i];
      x[4 * i] = f.x;
      x[4 * i + 1] = f.y;
      x[4 * i + 2] = f.z;
      x[4 * i + 3] = f.w;
    }
  }
  __device__ __forceinline__ float operator[](int i) const { return x[i]; }
};

__device__ __forceinline__ float float4_get(float4 v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// A record in shared memory read in field order, a 16-byte load each four
// fields: with the fields' indices known at compile time (unrolled loops)
// every load and select folds to a constant place.
struct SharedRecord {
  const float4* p;
  float4 cur;
  int at;
  __device__ __forceinline__ explicit SharedRecord(const float* q)
      : p(reinterpret_cast<const float4*>(q)), at(-1) {}
  __device__ __forceinline__ float operator[](int i) {
    if (i / 4 != at) {
      at = i / 4;
      cur = p[at];
    }
    return float4_get(cur, i % 4);
  }
};

// -- the rows of a thread ----------------------------------------------------

// One row of an exact shape, its values (and table row pointers) in
// registers.
template <class SH>
struct SplitRow {
  float nv[SH::kNC > 0 ? SH::kNC : 1];
  float qv[SH::kNQC > 0 ? SH::kNQC * SH::kD : 1];
  const float* trow[SH::kNT > 0 ? SH::kNT : 1];

  // an inactive row reads nothing and scores zeros against table row 0
  __device__ __forceinline__ void load(const SplitArgs& a,
                                       const SplitLayout& L, int row,
                                       bool active) {
#pragma unroll
    for (int c = 0; c < SH::kNC; ++c)
      nv[c] = active ? a.values[(size_t)row * SH::kNC + c] : F(0.0);
#pragma unroll
    for (int x = 0; x < SH::kNQC * SH::kD; ++x)
      qv[x] = active ? a.qvalues[(size_t)row * SH::kNQC * SH::kD + x]
                     : F(0.0);
#pragma unroll
    for (int t = 0; t < SH::kNT; ++t) {
      const int v =
          active ? L.tab_off[t] + a.table_idx[(size_t)row * SH::kNT + t] : 0;
#if defined(FUSED_V3_DEBUG) || defined(SCORE_SAMPLE_V1_DEBUG)
      if (v < 0 || v >= L.vtot) __trap();
#endif
      trow[t] = a.tables + (size_t)v * a.C;
    }
  }

  // the values summed in column order (PHASE_NOOP)
  __device__ __forceinline__ float sum() const {
    float s = F(0.0);
#pragma unroll
    for (int c = 0; c < SH::kNC; ++c) s = __fadd_rn(s, nv[c]);
    return s;
  }

  // The score of slot k with record f, in the sequential walk's order:
  // its base, then the table columns.
  template <bool FAST>
  __device__ __forceinline__ float score(const RegRecord<SH>& f,
                                         int k) const {
    float s = base<FAST>(f);
#pragma unroll
    for (int t = 0; t < SH::kNT; ++t) s = __fadd_rn(s, __ldg(trow[t] + k));
    return s;
  }

  // The table columns' entries of slots k0 .. k0 + 3: one 16-byte load a
  // column where SplitArgs::vec_tables (then k0 % 4 == 0 and every slot
  // lies in [0, C)), else one load a slot in [0, C).
  __device__ __forceinline__ void tables4(
      const SplitArgs& a, int k0,
      float4 (&tv)[SH::kNT > 0 ? SH::kNT : 1]) const {
#pragma unroll
    for (int t = 0; t < SH::kNT; ++t) {
      if (a.vec_tables) {
        tv[t] = __ldg(reinterpret_cast<const float4*>(trow[t] + k0));
      } else {
        float e[4];
#pragma unroll
        for (int w = 0; w < 4; ++w)
          e[w] = k0 + w >= 0 && k0 + w < a.C ? __ldg(trow[t] + k0 + w)
                                               : F(0.0);
        tv[t] = make_float4(e[0], e[1], e[2], e[3]);
      }
    }
  }

  // The score of a slot without its table columns, in the sequential
  // walk's order: the v1 form's cl and nich columns, or the product form's
  // cst, nich products and niw products.
  template <bool FAST>
  __device__ __forceinline__ float base(const RegRecord<SH>& f) const {
    if constexpr (SH::kV1) {
      float s = f[4 * SH::kNC];
#pragma unroll
      for (int c = 0; c < SH::kNC; ++c) {
        const float t = __fsub_rn(nv[c], f[4 * c + 3]);
        const float x = __fmul_rn(__fmul_rn(f[4 * c + 2], t), t);
        s = __fadd_rn(__fadd_rn(s, f[4 * c]),
                      __fmul_rn(f[4 * c + 1], log1pf(x)));
      }
      return s;
    } else {
      return product_base<FAST>(f);
    }
  }

  template <bool FAST>
  __device__ __forceinline__ float product_base(
      const RegRecord<SH>& f) const {
    float s = f[0];
    float prod = F(1.0);
#pragma unroll
    for (int c = 0; c < SH::kNC; ++c) {
      const float t = __fsub_rn(nv[c], f[2 + 3 * c]);
      const float fc =
          __fadd_rn(F(1.0), __fmul_rn(f[1 + 3 * c], __fmul_rn(t, t)));
      prod = ((SH::kNFirst >> c) & 1u) ? fc : __fmul_rn(prod, fc);
      if ((SH::kNLast >> c) & 1u)
        s = __fadd_rn(s, __fmul_rn(f[3 + 3 * c], log_<FAST>(prod)));
    }
#pragma unroll
    for (int j = 0; j < SH::kNQC; ++j) {
      const int base = SH::kQBase + j * SH::kQRec;
      float t[SH::kD];
#pragma unroll
      for (int u = 0; u < SH::kD; ++u)
        t[u] = __fsub_rn(qv[j * SH::kD + u], f[base + u]);
      // lam in row-major upper-triangle order
      float q = F(0.0);
      int r = 0;
#pragma unroll
      for (int u = 0; u < SH::kD; ++u) {
#pragma unroll
        for (int w = u; w < SH::kD; ++w, ++r) {
          const float term =
              __fmul_rn(f[base + SH::kD + r], __fmul_rn(t[u], t[w]));
          q = (r == 0) ? term : __fadd_rn(q, term);
        }
      }
      const float fq = __fadd_rn(F(1.0), q);
      prod = ((SH::kQFirst >> j) & 1u) ? fq : __fmul_rn(prod, fq);
      if ((SH::kQLast >> j) & 1u)
        s = __fadd_rn(
            s, __fmul_rn(f[base + SH::kD + SH::kTri], log_<FAST>(prod)));
    }
    return s;
  }
};

// A thread's rows on an exact shape: registers.
template <class SH>
struct ExactRows {
  static constexpr bool kExact = true;
  SplitRow<SH> r[SPLIT_ROWS];

  // A shared-record shape's scores of the slot whose record is at p
  // (shared memory): the niw column's fields read once for all rows, and
  // per row product_base's operations in its order.
  template <bool FAST>
  __device__ __forceinline__ void scores_shared(const float* __restrict__ p,
                                                float (&s)[SPLIT_ROWS]) const {
    constexpr int D = SH::kD, Q = SH::kQBase;
    SharedRecord f(p);
    const float cst = f[0];
    float t[SPLIT_ROWS][D];
#pragma unroll
    for (int u = 0; u < D; ++u) {
      const float mu = f[Q + u];
#pragma unroll
      for (int i = 0; i < SPLIT_ROWS; ++i)
        t[i][u] = __fsub_rn(r[i].qv[u], mu);
    }
    // lam in row-major upper-triangle order
    float q[SPLIT_ROWS];
    int x = 0;
#pragma unroll
    for (int u = 0; u < D; ++u) {
#pragma unroll
      for (int w = u; w < D; ++w, ++x) {
        const float l = f[Q + D + x];
#pragma unroll
        for (int i = 0; i < SPLIT_ROWS; ++i) {
          const float term = __fmul_rn(l, __fmul_rn(t[i][u], t[i][w]));
          q[i] = (x == 0) ? term : __fadd_rn(q[i], term);
        }
      }
    }
    const float lc = f[Q + D + SH::kTri];
#pragma unroll
    for (int i = 0; i < SPLIT_ROWS; ++i)
      s[i] = __fadd_rn(
          cst, __fmul_rn(lc, log_<FAST>(__fadd_rn(F(1.0), q[i]))));
  }

  __device__ __forceinline__ void load(const SplitArgs& a,
                                       const SplitLayout& L,
                                       const int (&row)[SPLIT_ROWS],
                                       const bool (&active)[SPLIT_ROWS], int,
                                       float*) {
#pragma unroll
    for (int i = 0; i < SPLIT_ROWS; ++i) r[i].load(a, L, row[i], active[i]);
  }

  __device__ __forceinline__ float sum(int i, const SplitLayout&) const {
    return r[i].sum();
  }

  // a slot's record, staged at p, in registers
  __device__ __forceinline__ RegRecord<SH> record(
      const float* __restrict__ p) const {
    RegRecord<SH> f;
    f.load(p);
    return f;
  }
};

// A thread's rows on a wide shape: the block's rows staged in shared
// memory, value column c of block row b at sv[c * SPLIT_BLOCK_ROWS + b]
// (nich columns, then niw values, then the table rows' indices into the
// packed tables, as ints), so that run-time column counts index no local
// array; a warp's lanes read consecutive rows.  QMAX: the largest niw
// dimension that the walk unrolls to.
template <int QMAX>
struct WideRows {
  static constexpr bool kExact = false;
  const float* sv;
  int rb[SPLIT_ROWS];   // the thread's rows within the block

  // Every thread of the block stages a share of its rows (an inactive row
  // as zeros and table row 0), then the block synchronises.
  __device__ __forceinline__ void load(const SplitArgs& a,
                                       const SplitLayout& L,
                                       const int (&)[SPLIT_ROWS],
                                       const bool (&)[SPLIT_ROWS],
                                       int group, float* smem) {
    const int nv = L.ncols, nq = nv + L.qvals, nt = nq + L.n_tab;
    const int row0 = blockIdx.x * SPLIT_BLOCK_ROWS;
    for (int i = threadIdx.x; i < nt * SPLIT_BLOCK_ROWS; i += SPLIT_THREADS) {
      const int c = i / SPLIT_BLOCK_ROWS;
      const size_t row = row0 + (i - c * SPLIT_BLOCK_ROWS);
      const bool active = row < (size_t)a.B;
      if (c < nv) {
        smem[i] = active ? a.values[row * nv + c] : F(0.0);
      } else if (c < nq) {
        smem[i] = active ? a.qvalues[row * L.qvals + (c - nv)] : F(0.0);
      } else {
        const int t = c - nq;
        const int v =
            active ? L.tab_off[t] + a.table_idx[row * L.n_tab + t] : 0;
#if defined(FUSED_V3_DEBUG) || defined(SCORE_SAMPLE_V1_DEBUG)
        if (v < 0 || v >= L.vtot) __trap();
#endif
        reinterpret_cast<int*>(smem)[i] = v;
      }
    }
    __syncthreads();
    sv = smem;
#pragma unroll
    for (int i = 0; i < SPLIT_ROWS; ++i) rb[i] = i * SPLIT_GROUPS + group;
  }

  __device__ __forceinline__ float sum(int i, const SplitLayout& L) const {
    float s = F(0.0);
    for (int c = 0; c < L.ncols; ++c)
      s = __fadd_rn(s, sv[c * SPLIT_BLOCK_ROWS + rb[i]]);
    return s;
  }

  // The scores of slot k, its packed record at p (shared memory): each
  // field read once for all rows; per row the exact shape's operations in
  // its order.
  template <bool FAST>
  __device__ __forceinline__ void scores(const float* __restrict__ f,
                                         const SplitLayout& L,
                                         const SplitArgs& a, int k,
                                         float (&s)[SPLIT_ROWS]) const {
    float prod[SPLIT_ROWS];
#pragma unroll
    for (int i = 0; i < SPLIT_ROWS; ++i) {
      s[i] = f[0];
      prod[i] = F(1.0);
    }
    for (int c = 0; c < L.ncols; ++c) {
      const float prec = f[1 + 3 * c], mean = f[2 + 3 * c];
      const bool first = (L.nfirst >> c) & 1u;
      const float* v = sv + c * SPLIT_BLOCK_ROWS;
#pragma unroll
      for (int i = 0; i < SPLIT_ROWS; ++i) {
        const float t = __fsub_rn(v[rb[i]], mean);
        const float fc = __fadd_rn(F(1.0), __fmul_rn(prec, __fmul_rn(t, t)));
        prod[i] = first ? fc : __fmul_rn(prod[i], fc);
      }
      if ((L.nlast >> c) & 1u) {
        const float lc = f[3 + 3 * c];
#pragma unroll
        for (int i = 0; i < SPLIT_ROWS; ++i)
          s[i] = __fadd_rn(s[i], __fmul_rn(lc, log_<FAST>(prod[i])));
      }
    }
    const float* qv = sv + L.ncols * SPLIT_BLOCK_ROWS;
    for (int j = 0; j < L.nqc; ++j) {
      const int d = L.qd[j];
      const float* q = f + L.qrec[j];
      const float* v = qv + L.qoff[j] * SPLIT_BLOCK_ROWS;
      float t[SPLIT_ROWS][QMAX];
#pragma unroll
      for (int u = 0; u < QMAX; ++u) {
        if (u < d) {
          const float mu = q[u];
#pragma unroll
          for (int i = 0; i < SPLIT_ROWS; ++i)
            t[i][u] = __fsub_rn(v[u * SPLIT_BLOCK_ROWS + rb[i]], mu);
        }
      }
      // lam in row-major upper-triangle order, the d x d triangle of a
      // D = QMAX walk with the column's d as a guard
      float qq[SPLIT_ROWS];
      const float* lam = q + d;
#pragma unroll
      for (int u = 0; u < QMAX; ++u) {
#pragma unroll
        for (int w = u; w < QMAX; ++w) {
          if (w < d) {
            const float l = *lam++;
#pragma unroll
            for (int i = 0; i < SPLIT_ROWS; ++i) {
              const float term = __fmul_rn(l, __fmul_rn(t[i][u], t[i][w]));
              qq[i] = (u == 0 && w == 0) ? term : __fadd_rn(qq[i], term);
            }
          }
        }
      }
      const bool first = (L.qfirst >> j) & 1u;
#pragma unroll
      for (int i = 0; i < SPLIT_ROWS; ++i) {
        const float fq = __fadd_rn(F(1.0), qq[i]);
        prod[i] = first ? fq : __fmul_rn(prod[i], fq);
      }
      if ((L.qlast >> j) & 1u) {
        const float lc = *lam;
#pragma unroll
        for (int i = 0; i < SPLIT_ROWS; ++i)
          s[i] = __fadd_rn(s[i], __fmul_rn(lc, log_<FAST>(prod[i])));
      }
    }
    add_tables(L, a, k, s);
  }

  // The v1 form's scores of slot k, its record at p (shared memory): a
  // column's four fields in one 16-byte load for all rows; per row the
  // exact shape's operations in its order.
  __device__ __forceinline__ void scores_v1(const float* __restrict__ f,
                                            const SplitLayout& L,
                                            const SplitArgs& a, int k,
                                            float (&s)[SPLIT_ROWS]) const {
#pragma unroll
    for (int i = 0; i < SPLIT_ROWS; ++i) s[i] = f[4 * L.ncols];
    for (int c = 0; c < L.ncols; ++c) {
      const float4 co = reinterpret_cast<const float4*>(f)[c];
      const float* v = sv + c * SPLIT_BLOCK_ROWS;
#pragma unroll
      for (int i = 0; i < SPLIT_ROWS; ++i) {
        const float t = __fsub_rn(v[rb[i]], co.w);
        const float x = __fmul_rn(__fmul_rn(co.z, t), t);
        s[i] = __fadd_rn(__fadd_rn(s[i], co.x), __fmul_rn(co.y, log1pf(x)));
      }
    }
    add_tables(L, a, k, s);
  }

  // the table columns of slot k added in column order
  __device__ __forceinline__ void add_tables(const SplitLayout& L,
                                             const SplitArgs& a, int k,
                                             float (&s)[SPLIT_ROWS]) const {
    const int* tv = reinterpret_cast<const int*>(sv) +
                    (L.ncols + L.qvals) * SPLIT_BLOCK_ROWS;
    for (int c = 0; c < L.n_tab; ++c) {
#pragma unroll
      for (int i = 0; i < SPLIT_ROWS; ++i)
        s[i] = __fadd_rn(
            s[i], __ldg(a.tables +
                        (size_t)tv[c * SPLIT_BLOCK_ROWS + rb[i]] * a.C + k));
    }
  }
};

// A thread's rows on a folded shape: each row's table value, its index
// into a slot's record, in a register.
struct FoldedRows {
  static constexpr bool kExact = true;
  int v[SPLIT_ROWS];

  // an inactive row reads nothing and takes value 0
  __device__ __forceinline__ void load(const SplitArgs& a,
                                       const SplitLayout& L,
                                       const int (&row)[SPLIT_ROWS],
                                       const bool (&active)[SPLIT_ROWS], int,
                                       float*) {
#pragma unroll
    for (int i = 0; i < SPLIT_ROWS; ++i) {
      v[i] = active[i] ? L.tab_off[0] + a.table_idx[row[i]] : 0;
#if defined(FUSED_V3_DEBUG)
      if (v[i] < 0 || v[i] >= L.vtot) __trap();
#endif
    }
  }

  // no nich columns (PHASE_NOOP)
  __device__ __forceinline__ float sum(int, const SplitLayout&) const {
    return F(0.0);
  }

  // Row i's score of the slot whose record is at p (shared memory): one
  // 4-byte load at its value (a 16-byte load of the record for all rows
  // and a select per row measured 6-38% slower on the H100).
  __device__ __forceinline__ float score(const float* __restrict__ p,
                                         int i) const {
    return p[v[i]];
  }
};

template <class SH, bool EXACT = SH::kExact>
struct SplitRowsOf {
  using type = ExactRows<SH>;
};
template <class SH>
struct SplitRowsOf<SH, false> {
  using type = WideRows<SH::kQMax>;
};
template <class SH>
using SplitRows = std::conditional_t<SH::kFolded, FoldedRows,
                                     typename SplitRowsOf<SH>::type>;

// -- the kernel -------------------------------------------------------------

// One cell: the perturbed score of slot k (word m of its Philox block)
// offered to the row's running first maximum (PHASE_SCORE_MAX: maximum).
template <int MODE, bool FAST, int PHASE>
__device__ __forceinline__ void split_visit(float s, unsigned m, int k,
                                            const SplitArgs& a, int row,
                                            bool active, float& best,
                                            int& idx) {
  if (PHASE == PHASE_SCORE_MAX) {
    best = fmaxf(best, s);
    return;
  }
  float tot = s;
  if (MODE == MODE_GUMBEL)
    tot = gumbel_perturb<FAST>(s, m);
  else if (MODE == MODE_BITS)
    tot = bits_perturb(s, m);
  else if (MODE == MODE_GUMBEL_HOST && active)
    tot = __fadd_rn(s, a.noise[(size_t)row * a.C + k]);
  if (beats(tot, best)) {
    best = tot;
    idx = k;
  }
}

// One turn of a thread's slice: slots [v0, v0 + L) of the slice (virtual
// ids), read from the thread's slice of the staged records, `mine`, P
// floats a record.
template <int MODE, bool FAST, int PHASE, class SH>
__device__ __forceinline__ void split_turn(
    const SplitArgs& a, const SplitLayout& L, const float* __restrict__ mine,
    int P, int slice, int v0, const SplitRows<SH>& rows,
    const int (&row)[SPLIT_ROWS],
    const bool (&active)[SPLIT_ROWS], uint2 key, float (&best)[SPLIT_ROWS],
    int (&idx)[SPLIT_ROWS]) {
  constexpr bool kBits = MODE == MODE_GUMBEL || MODE == MODE_BITS;
  const int n = min(a.L, a.SL - v0);
  const unsigned q0 = (unsigned)(a.slot_offset >> 2);
  for (int o = 0; o < n; o += 4) {
    const int vq = slice * a.SL + v0 + o;   // virtual id of the block's slot 0
    if (vq - a.lead >= a.C) break;
    uint4 bits[SPLIT_ROWS];
    if (kBits && PHASE == PHASE_FULL) {
#pragma unroll
      for (int r = 0; r < SPLIT_ROWS; ++r)
        bits[r] = philox4x32_10(
            make_uint4((unsigned)row[r], q0 + (unsigned)(vq >> 2), 0u, 0u),
            key);
    }
    if constexpr (SH::kExact) {
      if constexpr (SH::kV1 && SH::kNT > 0) {
        // per row: its table entries of the block's four slots, then its
        // scores of the four in slot order (the record read per row)
#pragma unroll
        for (int r = 0; r < SPLIT_ROWS; ++r) {
          float4 tv[SH::kNT];
          rows.r[r].tables4(a, vq - a.lead, tv);
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const int k = vq + w - a.lead;
            if (k < 0 || k >= a.C) continue;
            float s = rows.r[r].template base<FAST>(
                rows.record(mine + (size_t)(o + w) * P));
#pragma unroll
            for (int t = 0; t < SH::kNT; ++t)
              s = __fadd_rn(s, float4_get(tv[t], w));
            split_visit<MODE, FAST, PHASE>(
                s, kBits ? uint4_get(bits[r], w) & 0x00FFFFFFu : 0u, k, a,
                row[r], active[r], best[r], idx[r]);
          }
        }
        continue;
      }
    }
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int k = vq + w - a.lead;
      if (k < 0 || k >= a.C) continue;
      const float* p = mine + (size_t)(o + w) * P;
      if constexpr (SH::kFolded) {
        // each row's score read from the record at its value
#pragma unroll
        for (int r = 0; r < SPLIT_ROWS; ++r)
          split_visit<MODE, FAST, PHASE>(
              rows.score(p, r),
              kBits ? uint4_get(bits[r], w) & 0x00FFFFFFu : 0u, k, a, row[r],
              active[r], best[r], idx[r]);
      } else if constexpr (SH::kSharedRecord) {
        // every row scored against the record in shared memory, then
        // offered in turn
        float s[SPLIT_ROWS];
        rows.template scores_shared<FAST>(p, s);
#pragma unroll
        for (int r = 0; r < SPLIT_ROWS; ++r)
          split_visit<MODE, FAST, PHASE>(
              s[r], kBits ? uint4_get(bits[r], w) & 0x00FFFFFFu : 0u, k, a,
              row[r], active[r], best[r], idx[r]);
      } else if constexpr (SH::kExact) {
        // each row scored and offered in turn, the record in registers
        const auto f = rows.record(p);
#pragma unroll
        for (int r = 0; r < SPLIT_ROWS; ++r)
          split_visit<MODE, FAST, PHASE>(
              rows.r[r].template score<FAST>(f, k),
              kBits ? uint4_get(bits[r], w) & 0x00FFFFFFu : 0u, k, a, row[r],
              active[r], best[r], idx[r]);
      } else {
        float s[SPLIT_ROWS];
        if constexpr (SH::kV1)
          rows.scores_v1(p, L, a, k, s);
        else
          rows.template scores<FAST>(p, L, a, k, s);
#pragma unroll
        for (int r = 0; r < SPLIT_ROWS; ++r)
          split_visit<MODE, FAST, PHASE>(
              s[r], kBits ? uint4_get(bits[r], w) & 0x00FFFFFFu : 0u, k, a,
              row[r], active[r], best[r], idx[r]);
      }
    }
  }
}

#if SPLIT_MIN_BLOCKS > 0
#define SPLIT_BOUNDS __launch_bounds__(SPLIT_THREADS, SPLIT_MIN_BLOCKS)
#else
#define SPLIT_BOUNDS __launch_bounds__(SPLIT_THREADS)
#endif

template <int MODE, bool FAST, int PHASE, class SH>
__global__ void SPLIT_BOUNDS split_score_sample(SplitArgs a, SplitLayout L) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
#if SPLIT_LANE_SLICES
  const int slice = lane / SPLIT_LANES;
  const int group = (tid >> 5) * SPLIT_LANES + lane % SPLIT_LANES;
#else
  const int slice = tid >> 5;
  const int group = lane;
#endif
  int row[SPLIT_ROWS];
  bool active[SPLIT_ROWS];
#pragma unroll
  for (int r = 0; r < SPLIT_ROWS; ++r) {
    row[r] = blockIdx.x * SPLIT_BLOCK_ROWS + r * SPLIT_GROUPS + group;
    active[r] = row[r] < a.B;
  }
  SplitRows<SH> rows;
  rows.load(a, L, row, active, group, smem);
  if (PHASE == PHASE_NOOP) {
#pragma unroll
    for (int r = 0; r < SPLIT_ROWS; ++r)
      if (slice == 0 && active[r]) a.out[row[r]] = (int)rows.sum(r, L);
    return;
  }
  float best[SPLIT_ROWS];
  int idx[SPLIT_ROWS];
#pragma unroll
  for (int r = 0; r < SPLIT_ROWS; ++r) {
    best[r] = -INFINITY;
    idx[r] = 0;
  }
  const unsigned long long seed = a.seed_ptr ? *a.seed_ptr : a.seed;
  const uint2 key = make_uint2((unsigned)seed, (unsigned)(seed >> 32));
  int P;
  if constexpr (SH::kExact)
    P = SH::kP;
  else
    P = a.P;
  float* recs = smem;
  if constexpr (!SH::kExact) recs += a.row_floats;
  const int stride = a.L * P + SPLIT_PAD;
  const float* mine = recs + (size_t)slice * stride;
  for (int turn = 0; turn < a.turns; ++turn) {
    const int v0 = turn * a.L;
    __syncthreads();
    if constexpr (SH::kSharedRecord) {
      split_stage_fields<SH>(a, recs, stride, v0, tid);
    } else {
      for (int i = tid; i < SPLIT_SLICES * a.L; i += SPLIT_THREADS) {
        const int s = i / a.L, o = i - s * a.L;
        const int k = s * a.SL + v0 + o - a.lead;
        if (v0 + o < a.SL && k >= 0 && k < a.C) {
          float* rec = recs + (size_t)s * stride + o * P;
          if constexpr (SH::kV1)
            split_stage_v1(a, L, k, rec);
          else
            split_stage<SH>(a, L, k, rec);
        }
      }
    }
    __syncthreads();
    split_turn<MODE, FAST, PHASE, SH>(a, L, mine, P, slice, v0, rows, row,
                                      active, key, best, idx);
  }
  // merge the slices of each row, earlier slice on the left
#if SPLIT_LANE_SLICES
#pragma unroll
  for (int r = 0; r < SPLIT_ROWS; ++r) {
#pragma unroll
    for (int o = SPLIT_LANES; o < 32; o <<= 1) {
      const float ob = __shfl_xor_sync(0xFFFFFFFFu, best[r], o);
      const int oi = __shfl_xor_sync(0xFFFFFFFFu, idx[r], o);
      if (PHASE == PHASE_SCORE_MAX) {
        best[r] = fmaxf(best[r], ob);
      } else if ((lane & o) == 0 ? beats(ob, best[r]) : !beats(best[r], ob)) {
        best[r] = ob;
        idx[r] = oi;
      }
    }
  }
#else
  __shared__ float mbest[SPLIT_SLICES][SPLIT_BLOCK_ROWS];
  __shared__ int midx[SPLIT_SLICES][SPLIT_BLOCK_ROWS];
#pragma unroll
  for (int r = 0; r < SPLIT_ROWS; ++r) {
    mbest[slice][r * SPLIT_GROUPS + group] = best[r];
    midx[slice][r * SPLIT_GROUPS + group] = idx[r];
  }
  __syncthreads();
  if (slice != 0) return;
#pragma unroll
  for (int r = 0; r < SPLIT_ROWS; ++r) {
    for (int s = 1; s < SPLIT_SLICES; ++s) {
      const float ob = mbest[s][r * SPLIT_GROUPS + group];
      if (PHASE == PHASE_SCORE_MAX) {
        best[r] = fmaxf(best[r], ob);
      } else if (beats(ob, best[r])) {
        best[r] = ob;
        idx[r] = midx[s][r * SPLIT_GROUPS + group];
      }
    }
  }
#endif
#pragma unroll
  for (int r = 0; r < SPLIT_ROWS; ++r) {
    if (slice == 0 && active[r]) {
      if (a.out) a.out[row[r]] = idx[r];
      if (a.best) a.best[row[r]] = best[r];
    }
  }
}
