// Fused mixed score + sample + stat-sum kernel for NVIDIA Hopper (sm_90a).
//
// Replaces distributions_tpu/ops/pallas_kernels.py::_fused_v3_kernel
// (wrapper fused_mixed_score_sample_stats, with _score_quad_blocks and
// _quad_stat_features).  For one tile of B rows against C mixture slots it
// computes
//
//   scores[r, k] = cl[k] + sum of the nich and niw blocks' bases[k]
//     + per nich block  lc[k] * log(prod over <= 4 columns of
//                                   (1 + prec_j[k] (v_rj - mean_j[k])^2))
//     + per niw block   lc[k] * log(prod over <= 4 columns of (1 + q)),
//           q = sum_{a<=b} lam'_ab[k] (v_a - mu_a[k]) (v_b - mu_b[k])
//           (centred differences; off-diagonal lam' pre-doubled; a
//           column's dimension d <= MAX_D = 16)
//     + per table column  tables[off_j + idx_rj, k]
//
// draws one slot per row, and emits per drawn slot the nich [1 | v | v^2]
// sums, the niw [1 | v | v_a v_b (a <= b)] sums and the packed table of
// value counts [C, Vtot].
//
// What bounds it on the H100: operations, not bytes.  Per (row, slot) cell
// it does one log per nich or niw block and the draw's transcendentals
// (two logs and a quarter Philox block in 'gumbel', one exp per pass in
// 'cdf'), while device memory sees each row's values and draw once and
// the [C]-sized coefficient rows once per block of rows.  Nothing of size
// [B, C] reaches device memory.
//
// The argmax family of draws ('argmax', 'gumbel', 'gumbel_host') runs the
// slot-split walk of fused_split.cuh (eight threads a row, each on a slice
// of whole Philox blocks; two rows a thread with their values, niw values
// and table row pointers in registers; each slot's staged record read once
// for both rows; a merge in slice order).  At the main path's
// tile of 65,536 rows that is 262,144 threads where one thread a row gave
// 65,536, an eighth of what the card holds resident.  'cdf' and 'cdf_host'
// keep the sequential walk of score_and_draw below: their f32 prefix of
// exp(score - rowmax) is summed in slot order, as the twin sums it, and a
// slice cannot start that sum in the middle without changing its bits.
//
// Design points of its own:
//   - The layout (how many nich blocks and columns, niw blocks as
//     (columns, d), table offsets) is a small struct passed by value.  The
//     split walk is instantiated over the layout's sizes for the layouts
//     of the main path (Shape<> in fused_split.cuh: niw2mix, bbddgp, one
//     table column of at most four values, its scores folded into the
//     slots' records, and one niw column of d = 16, its record read from
//     shared memory) and a wide shape for the rest (its rows staged in
//     shared memory, its loops to the layout's counts; its niw form
//     unrolled to d = 4, or to d = 16 for a layout with a wider niw
//     column); the sequential 'cdf' walk only over MODE x FAST, its
//     quadratic form a function template over d (1..MAX_D) picked by a
//     warp-uniform switch, so the centred differences stay in
//     registers.
//   - Score tables are read from device memory through the read-only cache
//     (__ldg), not staged in shared memory: a thread walks its own table
//     row in slot order, so consecutive slots hit the same cache line, and
//     rows of a warp that hold different values cannot collide on a shared
//     memory bank.  The table of a tile is [Vtot, C] f32, small enough to
//     stay in L1/L2.
//   - The stat stage is fused_stats.cuh's: count tables are integers,
//     added with int32 atomics (exact in any order, so still bitwise
//     repeatable) and converted to f32 by the reduce; the float sums are
//     per-block partials in an order fixed by the launch's shape and a
//     fixed-order reduce, no float atomics.
//   - An index outside its column's support would read the next column's
//     rows: the caller checks supports on the host (ops/gibbs.py
//     _mixed_static_layout); building with -DFUSED_V3_DEBUG also traps in
//     the kernels.
//
// Semantics held against the plain-PyTorch twin
// (fused_mixed_score_sample_stats_plain in ops/fused_kernels.py): every
// float operation is an explicitly rounded __f*_rn op in the twin's order
// (constants, nich blocks, niw blocks, table columns), and the draws are
// Draw<MODE, FAST> of fused_common.cuh.
//
// The split walk also serves the pair kernel (one shard of a wider slot
// axis; see its note below).
//
// Bound through ctypes: fused_v3_launch() and fused_v3_pair_launch() are
// plain C entry points that launch on the caller's stream, allocate
// nothing, and return cudaGetLastError(); fused_v3_occupancy() reports the
// split kernel's registers, shared memory and resident blocks, and
// fused_v3_split_shape() the split shape a layout takes.
// fused_v3_stats_launch() runs the stat stage alone on given slots (a
// measurement entry point), fused_v3_stat_plan() reports how it cuts a
// launch.
//
// fused_v3_launch and fused_v3_pair_launch take the tile's seed by value
// or, with seed_ptr non-null, from device memory, read when the kernel
// runs (both walks), as fused_v2_launch does: a CUDA graph of a fused
// sweep (the runner's, the row-sharded one, the 2-D one) refills that
// buffer before each replay.

#include <string.h>

#include "fused_split.cuh"
#include "fused_stats.cuh"

#define MAX_GROUPS 8        // nich blocks, and niw blocks
#define MAX_COLS 32         // nich columns in all
#define MAX_QVALS 16        // niw value columns in all (sum of cols * d)
#define MAX_D 16            // niw dimension
#define MAX_TABLE_COLS 16
#define SCORE_THREADS 128
#define SMEM_FLOATS (48 * 1024 / 4)

struct Layout {
  int n_nich;
  int nich_cols[MAX_GROUPS];
  int n_quad;
  int quad_cols[MAX_GROUPS];
  int quad_d[MAX_GROUPS];
  int n_tab;
  int tab_off[MAX_TABLE_COLS];
  int ncols;   // nich columns in all
  int qvals;   // niw value columns in all
  int W;       // staged coefficient rows per slot
  int vtot;    // packed table rows
};

// (v - mu)^T Lam (v - mu) of one niw column for one (row, slot) cell:
// q = sum_{a<=b} lam'_ab (v_a - mu_a)(v_b - mu_b), terms added in row-major
// upper-triangle order.  v: the row's D values, SCORE_THREADS apart; co:
// the slot's D mean rows then D(D+1)/2 precision rows, CK apart.  D is a
// template parameter so that the differences stay in registers.
template <int D>
__device__ __forceinline__ float quad_form(const float* __restrict__ v,
                                           const float* __restrict__ co,
                                           int CK) {
  float t[D];
#pragma unroll
  for (int a = 0; a < D; ++a)
    t[a] = __fsub_rn(v[a * SCORE_THREADS], co[(size_t)a * CK]);
  const float* lam = co + (size_t)D * CK;
  float q = F(0.0);
  int r = 0;
#pragma unroll
  for (int a = 0; a < D; ++a) {
#pragma unroll
    for (int b = a; b < D; ++b) {
      const float term = __fmul_rn(lam[(size_t)r * CK], __fmul_rn(t[a], t[b]));
      q = (r == 0) ? term : __fadd_rn(q, term);
      ++r;
    }
  }
  return q;
}

// -- kernel 1: the sequential score + sample walk, for 'cdf' ----------------
//
// One thread per row.  Shared memory: the coefficient chunk [W][CK] (row 0
// = cl + sum of bases; per nich block lc, then prec, mean per column; per
// niw block lc, then per column d mean rows and d(d+1)/2 precision rows),
// followed by the block's nich values [ncols][SCORE_THREADS], niw values
// [qvals][SCORE_THREADS] and packed table rows [n_tab][SCORE_THREADS].
//
// score_and_draw is the kernel's body: it scores the thread's row against
// slots 0..C-1 and feeds each score to `dr`.  Every thread of the block
// must call it (it synchronises the block around each staged chunk).

template <int MODE, bool FAST>
__device__ __forceinline__ void score_and_draw(
    const float* __restrict__ values, const float* __restrict__ qvalues,
    const int* __restrict__ table_idx, const float* __restrict__ cl,
    const float* __restrict__ coeffs, const float* __restrict__ qcoeffs,
    const float* __restrict__ tables, const float* __restrict__ noise, int B,
    int C, const Layout& L, int CK, unsigned long long seed,
    Draw<MODE, FAST>& dr) {
  extern __shared__ float smem[];
  float* sco = smem;
  float* sval = smem + (size_t)L.W * CK;
  float* sq = sval + L.ncols * SCORE_THREADS;
  int* srow = (int*)(sq + L.qvals * SCORE_THREADS);
  const int tid = threadIdx.x;
  const int row = blockIdx.x * SCORE_THREADS + tid;
  const bool active = row < B;
  if (active) {
    for (int c = 0; c < L.ncols; ++c)
      sval[c * SCORE_THREADS + tid] = values[(size_t)row * L.ncols + c];
    for (int c = 0; c < L.qvals; ++c)
      sq[c * SCORE_THREADS + tid] = qvalues[(size_t)row * L.qvals + c];
    for (int j = 0; j < L.n_tab; ++j) {
      const int v = L.tab_off[j] + table_idx[(size_t)row * L.n_tab + j];
#ifdef FUSED_V3_DEBUG
      if (v < 0 || v >= L.vtot) __trap();
#endif
      srow[j * SCORE_THREADS + tid] = v;
    }
  }
  dr.init(row, active, seed, noise);

  for (int pass = 0; pass < Draw<MODE, FAST>::kPasses; ++pass) {
    dr.begin_pass(pass);
    for (int c0 = 0; c0 < C; c0 += CK) {
      const int n = min(CK, C - c0);
      __syncthreads();
      for (int i = tid; i < n; i += SCORE_THREADS) {
        const int k = c0 + i;
        float cst = cl[k];
        int w = 1, r = 0;
        for (int g = 0; g < L.n_nich; ++g) {
          const int rows = 2 * L.nich_cols[g];
          cst = __fadd_rn(cst, coeffs[(size_t)r * C + k]);
          for (int x = 0; x <= rows; ++x)
            sco[(size_t)(w + x) * CK + i] = coeffs[(size_t)(r + 1 + x) * C + k];
          w += 1 + rows;
          r += 2 + rows;
        }
        r = 0;
        for (int g = 0; g < L.n_quad; ++g) {
          const int d = L.quad_d[g];
          const int rows = L.quad_cols[g] * (d + d * (d + 1) / 2);
          cst = __fadd_rn(cst, qcoeffs[(size_t)r * C + k]);
          for (int x = 0; x <= rows; ++x)
            sco[(size_t)(w + x) * CK + i] =
                qcoeffs[(size_t)(r + 1 + x) * C + k];
          w += 1 + rows;
          r += 2 + rows;
        }
        sco[i] = cst;
      }
      __syncthreads();
      if (!active) continue;
      for (int kk = 0; kk < n; ++kk) {
        const int k = c0 + kk;
        float s = sco[kk];
        int w = 1, cidx = 0;
        for (int g = 0; g < L.n_nich; ++g) {
          const float lc = sco[(size_t)w * CK + kk];
          ++w;
          const int nc = L.nich_cols[g];
          for (int j0 = 0; j0 < nc; j0 += 4) {
            const int j1 = min(j0 + 4, nc);
            float prod = F(1.0);
            for (int j = j0; j < j1; ++j) {
              const float prec = sco[(size_t)w * CK + kk];
              const float mean = sco[(size_t)(w + 1) * CK + kk];
              w += 2;
              const float t = __fsub_rn(
                  sval[(cidx + j) * SCORE_THREADS + tid], mean);
              const float f =
                  __fadd_rn(F(1.0), __fmul_rn(prec, __fmul_rn(t, t)));
              prod = (j == j0) ? f : __fmul_rn(prod, f);
            }
            s = __fadd_rn(s, __fmul_rn(lc, log_<FAST>(prod)));
          }
          cidx += nc;
        }
        int qidx = 0;
        for (int g = 0; g < L.n_quad; ++g) {
          const float lc = sco[(size_t)w * CK + kk];
          ++w;
          const int nc = L.quad_cols[g];
          const int d = L.quad_d[g];
          for (int j0 = 0; j0 < nc; j0 += 4) {
            const int j1 = min(j0 + 4, nc);
            float prod = F(1.0);
            for (int j = j0; j < j1; ++j) {
              const float* v = sq + qidx * SCORE_THREADS + tid;
              const float* co = sco + (size_t)w * CK + kk;
              float q;
              switch (d) {
                case 1: q = quad_form<1>(v, co, CK); break;
                case 2: q = quad_form<2>(v, co, CK); break;
                case 3: q = quad_form<3>(v, co, CK); break;
                case 4: q = quad_form<4>(v, co, CK); break;
                case 5: q = quad_form<5>(v, co, CK); break;
                case 6: q = quad_form<6>(v, co, CK); break;
                case 7: q = quad_form<7>(v, co, CK); break;
                case 8: q = quad_form<8>(v, co, CK); break;
                case 9: q = quad_form<9>(v, co, CK); break;
                case 10: q = quad_form<10>(v, co, CK); break;
                case 11: q = quad_form<11>(v, co, CK); break;
                case 12: q = quad_form<12>(v, co, CK); break;
                case 13: q = quad_form<13>(v, co, CK); break;
                case 14: q = quad_form<14>(v, co, CK); break;
                case 15: q = quad_form<15>(v, co, CK); break;
                default: q = quad_form<16>(v, co, CK); break;
              }
              w += d + d * (d + 1) / 2;
              qidx += d;
              const float f = __fadd_rn(F(1.0), q);
              prod = (j == j0) ? f : __fmul_rn(prod, f);
            }
            s = __fadd_rn(s, __fmul_rn(lc, log_<FAST>(prod)));
          }
        }
        for (int j = 0; j < L.n_tab; ++j)
          s = __fadd_rn(
              s, __ldg(tables + (size_t)srow[j * SCORE_THREADS + tid] * C + k));
        dr.visit(pass, row, k, C, s, noise);
      }
    }
  }
}

template <int MODE, bool FAST>
__global__ void __launch_bounds__(SCORE_THREADS)
fused_v3_score_sample(const float* __restrict__ values,
                      const float* __restrict__ qvalues,
                      const int* __restrict__ table_idx,
                      const float* __restrict__ cl,
                      const float* __restrict__ coeffs,
                      const float* __restrict__ qcoeffs,
                      const float* __restrict__ tables,
                      const float* __restrict__ noise,
                      int* __restrict__ out, int B, int C, Layout L, int CK,
                      unsigned long long seed,
                      const unsigned long long* __restrict__ seed_ptr) {
  Draw<MODE, FAST> dr;
  score_and_draw<MODE, FAST>(values, qvalues, table_idx, cl, coeffs, qcoeffs,
                             tables, noise, B, C, L, CK,
                             seed_ptr ? *seed_ptr : seed, dr);
  const int row = blockIdx.x * SCORE_THREADS + threadIdx.x;
  if (row < B) out[row] = dr.result();
}

// -- the pair kernel ---------------------------------------------------------
//
// Replaces pallas_kernels.py::_fused_pair_kernel (wrapper
// fused_score_sample_pair): the score of every row against the C slots of
// ONE shard of a wider slot axis, and per row the first maximal local slot
// and its (perturbed) score; no stat sums, because the winner over all
// shards is known only after the caller's pair reduce.  It is the split
// walk of K2 with `best` written too and slot_offset = the global id of
// the shard's slot 0.  MODE is 'argmax', 'gumbel' or 'gumbel_host': a cdf
// draw has no pair reduce.  With one seed for all shards of a row block,
// the shards' pairs reduced by (largest best, then lowest global slot)
// give exactly the slot that fused_v3_launch draws on the whole slot axis.

// -- kernels 2 and 3: the stat stage of fused_stats.cuh ----------------------
//
// stat_partials<MixedRows<NC, QD>> and stat_reduce: the count tables and
// the per-block partials of the float features [nich 1 | v | v^2 ; per
// niw column 1 | v | v_a v_b], then a fixed-order reduce over blocks; an
// exact shape for 0-1 nich columns and one niw column of d = 2 (niw2mix),
// the run-time one (QD = 0) for every other layout.

static inline int imin(int a, int b) { return a < b ? a : b; }

template <int MODE>
static void launch_score(bool fast, dim3 grid, size_t smem, cudaStream_t st,
                         const float* values, const float* qvalues,
                         const int* table_idx, const float* cl,
                         const float* coeffs, const float* qcoeffs,
                         const float* tables, const float* noise, int* out,
                         int B, int C, const Layout& L, int CK,
                         unsigned long long seed,
                         const unsigned long long* seed_ptr) {
  if (fast)
    fused_v3_score_sample<MODE, true><<<grid, SCORE_THREADS, smem, st>>>(
        values, qvalues, table_idx, cl, coeffs, qcoeffs, tables, noise, out,
        B, C, L, CK, seed, seed_ptr);
  else
    fused_v3_score_sample<MODE, false><<<grid, SCORE_THREADS, smem, st>>>(
        values, qvalues, table_idx, cl, coeffs, qcoeffs, tables, noise, out,
        B, C, L, CK, seed, seed_ptr);
}

extern "C" const char* fused_v3_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Fill L from the per-family counts; *qdim gets the width of the niw stat
// sums.  Returns false on a layout beyond the caps above.
static bool make_layout(int n_nich, const int* nich_cols, int n_quad,
                        const int* quad_cols, const int* quad_d, int n_tab,
                        const int* table_vs, Layout* Lp, int* qdim) {
  Layout& L = *Lp;
  if (n_nich < 0 || n_nich > MAX_GROUPS || n_quad < 0 ||
      n_quad > MAX_GROUPS || n_tab < 0 || n_tab > MAX_TABLE_COLS)
    return false;
  memset(&L, 0, sizeof(L));
  L.n_nich = n_nich;
  L.n_quad = n_quad;
  L.n_tab = n_tab;
  L.W = 1;
  *qdim = 0;
  for (int g = 0; g < n_nich; ++g) {
    if (nich_cols[g] < 1) return false;
    L.nich_cols[g] = nich_cols[g];
    L.ncols += nich_cols[g];
    L.W += 1 + 2 * nich_cols[g];
  }
  for (int g = 0; g < n_quad; ++g) {
    const int nc = quad_cols[g], d = quad_d[g];
    if (nc < 1 || d < 1 || d > MAX_D) return false;
    L.quad_cols[g] = nc;
    L.quad_d[g] = d;
    L.qvals += nc * d;
    L.W += 1 + nc * (d + d * (d + 1) / 2);
    *qdim += nc * (1 + d + d * (d + 1) / 2);
  }
  for (int j = 0; j < n_tab; ++j) {
    if (table_vs[j] < 1) return false;
    L.tab_off[j] = L.vtot;
    L.vtot += table_vs[j];
  }
  return L.ncols <= MAX_COLS && L.qvals <= MAX_QVALS;
}

// Slots per staged chunk and the score kernels' dynamic shared memory.
static int score_chunk(const Layout& L, int C, size_t* smem) {
  const int per_thread = L.ncols + L.qvals + L.n_tab;
  const int CK = imin(C, (SMEM_FLOATS - SCORE_THREADS * per_thread) / L.W);
  *smem =
      ((size_t)L.W * CK + (size_t)SCORE_THREADS * per_thread) * sizeof(float);
  return CK;
}

// The split kernel of one draw for the shape `SH`, handed to fn with the
// record floats and staged row floats of layout S on it.
template <class SH, class Fn>
static void with_split_shape(const SplitLayout& S, int mode, bool fast,
                             Fn&& fn) {
  const int P = split_record_floats<SH>(S), R = split_row_floats<SH>(S);
#define SPLIT(MODE)                                                      \
  (fast ? fn(split_score_sample<MODE, true, PHASE_FULL, SH>, P, R)       \
        : fn(split_score_sample<MODE, false, PHASE_FULL, SH>, P, R))
  switch (mode) {
    case MODE_ARGMAX: SPLIT(MODE_ARGMAX); break;
    case MODE_GUMBEL: SPLIT(MODE_GUMBEL); break;
    default: SPLIT(MODE_GUMBEL_HOST); break;
  }
#undef SPLIT
}

// niw2mix: one nich column, one niw column of d = 2, one table column
using ShapeNiw2Mix = Shape<1, 1, 2, 1>;
// bbddgp: three table columns
using ShapeTables3 = Shape<0, 0, 1, 3>;
// bb: one table column of at most four values, ShapeTable1Folded
// niw16: one niw column of d = 16, ShapeNiw16

// The split shapes, as fused_v3_split_shape names them
// (ops/fused_kernels.py SPLIT_SHAPES, in this order).
enum { SHAPE_WIDE = 0, SHAPE_NIW2MIX = 1, SHAPE_TABLES3 = 2,
       SHAPE_TABLE1_FOLDED = 3, SHAPE_NIW16 = 4, SHAPE_WIDE_D16 = 5 };

// The main path's exact shapes, a wide one for every other layout: the
// wide shape of niw columns of d <= 4, or the one of d <= 16.
static int split_shape(const SplitLayout& S) {
  if (split_fits<ShapeNiw2Mix>(S)) return SHAPE_NIW2MIX;
  if (split_fits<ShapeTables3>(S)) return SHAPE_TABLES3;
  if (split_fits<ShapeTable1Folded>(S)) return SHAPE_TABLE1_FOLDED;
  if (split_fits<ShapeNiw16>(S)) return SHAPE_NIW16;
  if (split_fits<WideShape>(S)) return SHAPE_WIDE;
  return SHAPE_WIDE_D16;
}

// fn(kernel, record floats, staged row floats) on the kernel of S's shape.
template <class Fn>
static void with_split_kernel(const SplitLayout& S, int mode, bool fast,
                              Fn&& fn) {
  switch (split_shape(S)) {
    case SHAPE_NIW2MIX:
      with_split_shape<ShapeNiw2Mix>(S, mode, fast, fn);
      break;
    case SHAPE_TABLES3:
      with_split_shape<ShapeTables3>(S, mode, fast, fn);
      break;
    case SHAPE_TABLE1_FOLDED:
      with_split_shape<ShapeTable1Folded>(S, mode, fast, fn);
      break;
    case SHAPE_NIW16:
      with_split_shape<ShapeNiw16>(S, mode, fast, fn);
      break;
    case SHAPE_WIDE_D16:
      with_split_shape<WideShapeD16>(S, mode, fast, fn);
      break;
    default:
      with_split_shape<WideShape>(S, mode, fast, fn);
  }
}

static SplitLayout split_of(const Layout& L, const int* nich_cols,
                            const int* quad_cols, const int* quad_d) {
  SplitLayout S;
  split_layout(L.n_nich, nich_cols, L.n_quad, quad_cols, quad_d, L.n_tab,
               L.tab_off, &S);
  S.vtot = L.vtot;
  return S;
}

// Launch the split walk: K2's score + sample when best is null, K3's pair
// kernel otherwise.
static int launch_split(const float* values, const float* qvalues,
                        const int* table_idx, const float* cl,
                        const float* coeffs, const float* qcoeffs,
                        const float* tables, const float* noise, int* out,
                        float* best, int B, int C, const SplitLayout& S,
                        int mode, int fast, unsigned long long seed,
                        const unsigned long long* seed_ptr, int slot_offset,
                        cudaStream_t st) {
  SplitArgs a = SplitArgs();
  a.values = values;
  a.qvalues = qvalues;
  a.table_idx = table_idx;
  a.cl = cl;
  a.coeffs = coeffs;
  a.qcoeffs = qcoeffs;
  a.tables = tables;
  a.noise = noise;
  a.out = out;
  a.best = best;
  a.B = B;
  a.C = C;
  a.slot_offset = slot_offset;
  a.seed = seed;
  a.seed_ptr = seed_ptr;
  const dim3 grid((B + SPLIT_BLOCK_ROWS - 1) / SPLIT_BLOCK_ROWS);
  bool fits = true;
  with_split_kernel(S, mode, fast != 0, [&](auto kern, int P, int rows) {
    size_t smem = 0;
    fits = split_geometry(P, rows, &a, &smem);
    if (fits) kern<<<grid, SPLIT_THREADS, smem, st>>>(a, S);
    return 0;
  });
  return fits ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

// The stat stage of the layout L (qdim: the niw features) on the rows
// values / qvalues / table_idx at the slots `assign`: MixedRows<NC, QD>
// filled from L, launched.
template <int NC, int QD>
static int mixed_stage(const Layout& L, int qdim, const float* values,
                       const float* qvalues, const int* table_idx,
                       const int* assign, float* partials, unsigned* bmask,
                       float* sums, float* qsums, int* tcounts_i,
                       float* tcounts, int B, int C, cudaStream_t st) {
  MixedRows<NC, QD> r;
  memset(&r, 0, sizeof(r));
  r.values = values;
  r.qvalues = qvalues;
  r.table_idx = table_idx;
  r.ncols = L.ncols;
  r.qvals = L.qvals;
  r.n_tab = L.n_tab;
  r.n_quad = L.n_quad;
  r.nvtot = L.vtot;
  r.qdim = qdim;
  for (int g = 0; g < L.n_quad; ++g) {
    r.quad_cols[g] = L.quad_cols[g];
    r.quad_d[g] = L.quad_d[g];
  }
  for (int j = 0; j < L.n_tab; ++j) r.tab_off[j] = L.tab_off[j];
  return stat_stage_launch(r, assign, partials, bmask, sums, qsums,
                           3 * L.ncols, tcounts_i, tcounts, B, C, st);
}

static int launch_mixed_stage(const Layout& L, int qdim, const float* values,
                              const float* qvalues, const int* table_idx,
                              const int* assign, float* partials,
                              unsigned* bmask, float* sums, float* qsums,
                              int* tcounts_i, float* tcounts, int B, int C,
                              cudaStream_t st) {
  const bool niw2 = L.n_quad == 1 && L.quad_cols[0] == 1 &&
                    L.quad_d[0] == 2 && L.n_nich <= 1;
  if (niw2 && L.ncols == 1)
    return mixed_stage<1, 2>(L, qdim, values, qvalues, table_idx, assign,
                             partials, bmask, sums, qsums, tcounts_i, tcounts,
                             B, C, st);
  if (niw2 && L.ncols == 0)
    return mixed_stage<0, 2>(L, qdim, values, qvalues, table_idx, assign,
                             partials, bmask, sums, qsums, tcounts_i, tcounts,
                             B, C, st);
  return mixed_stage<0, 0>(L, qdim, values, qvalues, table_idx, assign,
                           partials, bmask, sums, qsums, tcounts_i, tcounts,
                           B, C, st);
}

// nich_cols[n_nich], quad_cols[n_quad], quad_d[n_quad], table_vs[n_tab]
// describe the layout; values / qvalues / table_idx and their coefficient
// arrays may be null when their count is 0.  partials is scratch of
// [nblocks, S, C] floats and bmask of [nblocks, ceil(C / 32)] words
// (nblocks = ceil(B / stat_rows_per_block(B)), S = 3 * ncols + qdim;
// fused_stats.cuh), tcounts_i of [C, Vtot] ints.
// seed_ptr: null, or the seed in device memory in place of `seed`.
extern "C" int fused_v3_launch(
    const float* values, const float* qvalues, const int* table_idx,
    const float* cl, const float* coeffs, const float* qcoeffs,
    const float* tables, const float* noise, int* out, float* partials,
    unsigned* bmask, float* sums, float* qsums, int* tcounts_i,
    float* tcounts, int B, int C, int n_nich, const int* nich_cols,
    int n_quad, const int* quad_cols, const int* quad_d, int n_tab,
    const int* table_vs, int mode, int fast, unsigned long long seed,
    const unsigned long long* seed_ptr, void* stream) {
  if (B < 1 || C < 1 || mode < MODE_ARGMAX || mode > MODE_CDF_HOST)
    return (int)cudaErrorInvalidValue;
  Layout L;
  int qdim = 0;
  if (!make_layout(n_nich, nich_cols, n_quad, quad_cols, quad_d, n_tab,
                   table_vs, &L, &qdim))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == MODE_CDF || mode == MODE_CDF_HOST) {
    size_t smem1 = 0;
    const int CK = score_chunk(L, C, &smem1);
    if (CK < 1) return (int)cudaErrorInvalidValue;
    const dim3 grid1((B + SCORE_THREADS - 1) / SCORE_THREADS);
    if (mode == MODE_CDF)
      launch_score<MODE_CDF>(fast, grid1, smem1, st, values, qvalues,
                             table_idx, cl, coeffs, qcoeffs, tables, noise,
                             out, B, C, L, CK, seed, seed_ptr);
    else
      launch_score<MODE_CDF_HOST>(fast, grid1, smem1, st, values, qvalues,
                                  table_idx, cl, coeffs, qcoeffs, tables,
                                  noise, out, B, C, L, CK, seed, seed_ptr);
  } else {
    const int rc = launch_split(
        values, qvalues, table_idx, cl, coeffs, qcoeffs, tables, noise, out,
        nullptr, B, C, split_of(L, nich_cols, quad_cols, quad_d), mode, fast,
        seed, seed_ptr, 0, st);
    if (rc != 0) return rc;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_mixed_stage(L, qdim, values, qvalues, table_idx, out,
                            partials, bmask, sums, qsums, tcounts_i, tcounts,
                            B, C, st);
}

// The stat stage alone on the slots `assign` [B] (a slot outside [0, C)
// adds nothing): the outputs and scratch of fused_v3_launch for the rows
// values / qvalues / table_idx of the layout.
extern "C" int fused_v3_stats_launch(
    const float* values, const float* qvalues, const int* table_idx,
    const int* assign, float* partials, unsigned* bmask, float* sums,
    float* qsums, int* tcounts_i, float* tcounts, int B, int C, int n_nich,
    const int* nich_cols, int n_quad, const int* quad_cols,
    const int* quad_d, int n_tab, const int* table_vs, void* stream) {
  Layout L;
  int qdim = 0;
  if (B < 1 || C < 1 ||
      !make_layout(n_nich, nich_cols, n_quad, quad_cols, quad_d, n_tab,
                   table_vs, &L, &qdim))
    return (int)cudaErrorInvalidValue;
  return launch_mixed_stage(L, qdim, values, qvalues, table_idx, assign,
                            partials, bmask, sums, qsums, tcounts_i, tcounts,
                            B, C, (cudaStream_t)stream);
}

// How the stat stage cuts a launch of B rows of this layout against C
// slots: info[0..6] as stat_plan_info's (fused_stats.cuh).
extern "C" int fused_v3_stat_plan(int B, int C, int n_nich,
                                  const int* nich_cols, int n_quad,
                                  const int* quad_cols, const int* quad_d,
                                  int n_tab, const int* table_vs, int* info) {
  Layout L;
  int qdim = 0;
  if (!make_layout(n_nich, nich_cols, n_quad, quad_cols, quad_d, n_tab,
                   table_vs, &L, &qdim))
    return (int)cudaErrorInvalidValue;
  return stat_plan_info(B, C, 3 * L.ncols + qdim, L.ncols, L.qvals, L.n_tab,
                        L.vtot, info);
}

// The pair kernel over one shard's C slots: out[B] local slot ids, best[B]
// their (perturbed) scores.  The layout arguments are those of
// fused_v3_launch; mode is MODE_ARGMAX, MODE_GUMBEL or MODE_GUMBEL_HOST
// (noise [B, C]); slot_offset >= 0 is the global id of the shard's slot 0.
// seed_ptr: null, or the seed in device memory in place of `seed`, as in
// fused_v3_launch (a CUDA graph's replays refill it).
extern "C" int fused_v3_pair_launch(
    const float* values, const float* qvalues, const int* table_idx,
    const float* cl, const float* coeffs, const float* qcoeffs,
    const float* tables, const float* noise, int* out, float* best, int B,
    int C, int n_nich, const int* nich_cols, int n_quad, const int* quad_cols,
    const int* quad_d, int n_tab, const int* table_vs, int mode, int fast,
    unsigned long long seed, const unsigned long long* seed_ptr,
    int slot_offset, void* stream) {
  if (B < 1 || C < 1 || slot_offset < 0 || mode < MODE_ARGMAX ||
      mode > MODE_GUMBEL_HOST)
    return (int)cudaErrorInvalidValue;
  Layout L;
  int qdim = 0;
  if (!make_layout(n_nich, nich_cols, n_quad, quad_cols, quad_d, n_tab,
                   table_vs, &L, &qdim))
    return (int)cudaErrorInvalidValue;
  return launch_split(values, qvalues, table_idx, cl, coeffs, qcoeffs,
                      tables, noise, out, best, B, C,
                      split_of(L, nich_cols, quad_cols, quad_d), mode, fast,
                      seed, seed_ptr, slot_offset, (cudaStream_t)stream);
}

// The split shape (SHAPE_*) that fused_v3_launch and fused_v3_pair_launch
// take for this layout in 'argmax', 'gumbel' and 'gumbel_host': *shape.
extern "C" int fused_v3_split_shape(int n_nich, const int* nich_cols,
                                    int n_quad, const int* quad_cols,
                                    const int* quad_d, int n_tab,
                                    const int* table_vs, int* shape) {
  Layout L;
  int qdim = 0;
  if (!make_layout(n_nich, nich_cols, n_quad, quad_cols, quad_d, n_tab,
                   table_vs, &L, &qdim))
    return (int)cudaErrorInvalidValue;
  *shape = split_shape(split_of(L, nich_cols, quad_cols, quad_d));
  return 0;
}

// The split kernel that fused_v3_launch takes for this layout and draw at
// C slots (slot_offset 0): info[0..6] as fused_v2_occupancy's.
extern "C" int fused_v3_occupancy(int C, int n_nich, const int* nich_cols,
                                  int n_quad, const int* quad_cols,
                                  const int* quad_d, int n_tab,
                                  const int* table_vs, int mode, int fast,
                                  int* info) {
  Layout L;
  int qdim = 0;
  if (C < 1 || mode < MODE_ARGMAX || mode > MODE_GUMBEL_HOST ||
      !make_layout(n_nich, nich_cols, n_quad, quad_cols, quad_d, n_tab,
                   table_vs, &L, &qdim))
    return (int)cudaErrorInvalidValue;
  const SplitLayout S = split_of(L, nich_cols, quad_cols, quad_d);
  int rc = 0;
  with_split_kernel(S, mode, fast != 0, [&](auto kern, int P, int rows) {
    SplitArgs a = SplitArgs();
    a.C = C;
    size_t smem = 0;
    if (!split_geometry(P, rows, &a, &smem))
      return rc = (int)cudaErrorInvalidValue;
    return rc = split_occupancy(kern, P, a, smem, info);
  });
  return rc;
}
