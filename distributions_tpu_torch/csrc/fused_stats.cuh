// The stat stage of K1 and K2 for NVIDIA Hopper (sm_90a): per drawn slot,
// the sums of the rows' stat features, and for K2 the count tables.
//
// Replaces the stat-sum part of distributions_tpu/ops/pallas_kernels.py:
// the one-hot MXU contraction of [1 | v | v^2] in _fused_v2_kernel
// (_split_contract / _nich_stat_contraction, :506-532, used at :574-582)
// and, in _fused_v3_kernel, of [1 | v | v_a v_b (a <= b)] and the count
// tables (:821-844).  On the TPU each grid step adds its block's one-hot
// product into an accumulator that the sequential grid carries; on the
// card the blocks run at once, so the stage is two kernels:
//
//   stat_partials  each block sums its rows into a partial of its own,
//                  [S, C] per block, written only where its rows drew a
//                  slot, with a bit per (block, slot) that says so;
//   stat_reduce    sums the partials over blocks in a fixed order into
//                  the [C, S] result (and turns the int count tables into
//                  f32).
//
// What bounds it: bytes, nominally -- each row's values and slot read
// once, the [C, S] sums written once, about 1.6 MB at the main path's
// nich2 tile of 131,072 rows, 0.5 us at 3.35 TB/s.  What holds it back
// is latency: a slot's sum is a chain of dependent adds, and the rows of
// a launch are few against the card (16,384-131,072 rows on 132 SMs).
// The design:
//
//   - The grid aims at one block per SM (STAT_GRID) whatever the rows:
//     rows per block = B / STAT_GRID rounded up to 32, at most
//     STAT_MAX_ROWS, so a launch's time follows its rows.
//   - A block first stages its rows in shared memory with coalesced
//     16-byte loads (the slots, the nich values, for K2 the niw values
//     and table indices); no global load is left in the walk.
//   - The walk is split across the block's W warps: warp w walks its own
//     contiguous span of the block's rows in row order, and lane l owns
//     the slots k = l (mod 32) of the current slot chunk.  At each row
//     only the owning lane works, adding the row's features into the
//     warp's private [S, chunk] region of shared memory, so no two
//     threads ever add to one address and no atomics are needed.  Each
//     warp's walk is rows / W steps whatever the partition's skew.
//   - A lane keeps one bit per owned slot of the chunk (32 lanes x 32
//     bits = STAT_CHUNK slots) that says the slot was touched: the first
//     row of a slot writes its features, later rows add, so the regions
//     are never zeroed.  The block lists the chunk's slots that its rows
//     drew (a ballot a word, a prefix sum over the words), sets their bits
//     in its [C / 32] word table, and combines only those: per drawn slot
//     and feature, the sums of the warps that touched the slot, in warp
//     order, W loads at once (W is a template parameter).  The combine's
//     work follows the rows as the walk's does.
//   - The main path's rows (1-4 nich columns; niw2mix's nich column and
//     niw column of d = 2) take an exact shape: the row's features are
//     known at compile time, and the owning lane loads all of a slot's
//     current sums before it stores any, so a step waits on one
//     shared-memory latency; other layouts loop over theirs at run time.
//   - Shared memory is opted in up to what a block may hold (227 KB):
//     W = 8 where the W regions fit a chunk of min(C, 1024) slots, else
//     4, 2, 1.  Above 1024 slots the slot axis is cut into chunks and the
//     staged rows are walked once per chunk.
//   - The reduce adds a slot's partials only where the block's bit is
//     set; where the partials are small (STAT_DENSE_FLOATS) it loads them
//     beside the bits, else after them, so its traffic at C = 8192
//     follows the rows, not blocks x C.
//   - Count tables (K2) are int: a block counts its rows into a [C, Vtot]
//     histogram in shared memory with shared int atomics where it fits
//     (STAT_HIST_BYTES) and adds each non-zero entry to the [C, Vtot]
//     int table in device memory with one atomicAdd; otherwise every row
//     adds to device memory.  Ints sum exactly in any order.
//
// Determinism: every float sum is taken in an order fixed by the launch's
// shape (B, C and the layout) -- rows in order within a warp's span, the
// warps of a block in order, the reduce's warps over blocks b = w, w + 16,
// ... in order and then in warp order.  No float atomics.  A slot that no
// row drew sums to +0.  Rows whose slot lies outside [0, C) add nothing.
//
// The feature set of a row is a template parameter: NichRows<NC> (K1:
// nich [1 | v | v^2]) and MixedRows<NC, QD> (K2: nich, niw [1 | v |
// v_a v_b], tables).

#pragma once

#include "fused_common.cuh"

#define STAT_GRID 132            // blocks a launch aims at: the H100's SMs
#define STAT_MAX_ROWS 1024       // rows a block at most
#define STAT_MAX_WARPS 8
#define STAT_CHUNK 1024          // slots a chunk at most: 32 lanes x 32 bits
#define STAT_SMEM_BYTES 232448   // dynamic shared memory a block may opt in to
#define STAT_STAGE_BYTES 65536   // staged rows at most
#define STAT_HIST_BYTES 65536    // a block's count table in shared memory
#define STAT_REDUCE_WARPS 16
#define STAT_REDUCE_UNROLL 8
#define STAT_DENSE_FLOATS (1 << 20)   // partials the reduce loads densely
#define STAT_MAX_NIW 8
#define STAT_MAX_TABLES 16

// How a launch of B rows against C slots is cut; sizes and offsets in
// bytes of dynamic shared memory.
struct StatPlan {
  int rows;      // rows a block (the last block takes what is left)
  int piece;     // rows staged at once
  int warps;     // W
  int cks;       // slots a chunk (0 when a row has no float features)
  int hist;      // 1: count tables in shared memory, 0: device atomics
  int nblocks;
  int words;     // slot bit words a block: ceil(C / 32)
  size_t smem;
  size_t off_masks, off_assign, off_f1, off_f2, off_i, off_hist;
};

static inline size_t stat_align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// Rows per block and blocks of a launch of B rows: a function of B alone
// (ops/fused_kernels.py stat_blocks() mirrors it to size the partials).
static inline int stat_rows_per_block(int B) {
  int rows = (B + STAT_GRID - 1) / STAT_GRID;
  rows = (rows + 31) / 32 * 32;
  return rows < STAT_MAX_ROWS ? rows : STAT_MAX_ROWS;
}

// The plan of a launch whose rows have S float features and stage f1 + f2
// floats and ni ints each (besides the slot), with count tables of vtot
// columns.  False when the layout cannot be staged.
static bool stat_plan(int B, int C, int S, int f1, int f2, int ni, int vtot,
                      StatPlan* p) {
  if (B < 1 || C < 1 || S < 0 || (S == 0 && vtot == 0)) return false;
  p->rows = stat_rows_per_block(B);
  p->nblocks = (B + p->rows - 1) / p->rows;
  p->words = (C + 31) / 32;
  const size_t row_bytes = 4 * (size_t)(1 + f1 + f2 + ni);
  int piece = p->rows;
  if ((size_t)piece * row_bytes > STAT_STAGE_BYTES)
    piece = (int)(STAT_STAGE_BYTES / row_bytes) / 32 * 32;
  if (piece < 32) return false;
  p->piece = piece;
  const size_t s_assign = stat_align16((size_t)piece * 4);
  const size_t s_f1 = stat_align16((size_t)piece * f1 * 4);
  const size_t s_f2 = stat_align16((size_t)piece * f2 * 4);
  const size_t s_i = stat_align16((size_t)piece * ni * 4);
  p->hist = vtot > 0 && (size_t)C * vtot * 4 <= STAT_HIST_BYTES;
  const size_t s_hist = p->hist ? stat_align16((size_t)C * vtot * 4) : 0;
  // the warps' slot bits, then the chunk's drawn slots: their bit words,
  // word offsets, slots and warp sets
  const size_t s_masks = (STAT_MAX_WARPS * 32 + 2 * 32 + 2 * STAT_CHUNK) * 4;
  const size_t fixed = s_masks + s_assign + s_f1 + s_f2 + s_i + s_hist;
  if (fixed > STAT_SMEM_BYTES) return false;
  const size_t avail = STAT_SMEM_BYTES - fixed;
  p->warps = STAT_MAX_WARPS;
  p->cks = 0;
  if (S > 0) {
    // W warps' regions of a chunk of min(C, STAT_CHUNK) slots, the warps
    // halved until they fit; where even one warp's region holds less than
    // that, smaller chunks of whole words of 32 slots
    int w = STAT_MAX_WARPS, cks = C < STAT_CHUNK ? C : STAT_CHUNK;
    while (w > 1 && (size_t)w * S * cks * 4 > avail) w /= 2;
    if ((size_t)w * S * cks * 4 > avail)
      cks = (int)(avail / ((size_t)S * 4)) / 32 * 32;
    if (cks < 1) return false;
    p->warps = w;
    p->cks = cks;
  }
  size_t off = stat_align16((size_t)p->warps * S * p->cks * 4);
  p->off_masks = off;
  off += s_masks;
  p->off_assign = off;
  off += s_assign;
  p->off_f1 = off;
  off += s_f1;
  p->off_f2 = off;
  off += s_f2;
  p->off_i = off;
  off += s_i;
  p->off_hist = off;
  off += s_hist;
  p->smem = off;
  return true;
}

// Copy n 32-bit words from device memory into shared memory, 16 bytes a
// load where both ends are 16-byte aligned.
__device__ __forceinline__ void stat_stage_words(void* dst, const void* src,
                                                 int n, int tid,
                                                 int nthreads) {
  uint32_t* d = (uint32_t*)dst;
  const uint32_t* s = (const uint32_t*)src;
  int i0 = 0;
  if ((((uintptr_t)d | (uintptr_t)s) & 15) == 0) {
    const int n4 = n >> 2;
    for (int i = tid; i < n4; i += nthreads)
      ((uint4*)d)[i] = __ldg((const uint4*)s + i);
    i0 = n4 << 2;
  }
  for (int i = i0 + tid; i < n; i += nthreads) d[i] = __ldg(s + i);
}

// One feature of one slot: the first row of the slot writes it, later
// rows add to it.
__device__ __forceinline__ void stat_put(float* a, float f, bool first) {
  *a = first ? f : __fadd_rn(*a, f);
}

// A row's N features f into a slot's features (`st` floats apart), as
// stat_put, with every current value loaded before any is stored: the
// adds wait on one shared-memory latency, not on one per feature.
template <int N>
__device__ __forceinline__ void stat_apply(float* a, int st,
                                           const float (&f)[N], bool first) {
  float cur[N];
#pragma unroll
  for (int x = 0; x < N; ++x) cur[x] = a[(size_t)x * st];
#pragma unroll
  for (int x = 0; x < N; ++x)
    a[(size_t)x * st] = first ? f[x] : __fadd_rn(cur[x], f[x]);
}

// K1: nich columns, features [1 (cols) | v (cols) | v^2 (cols)].  NC > 0:
// exactly NC columns, known at compile time (the main path's shapes);
// NC = 0: `cols` columns at run time.
template <int NC>
struct NichRows {
  const float* values;  // [B, cols]
  int cols;

  __host__ __device__ int S() const { return 3 * cols; }
  __host__ __device__ int f1() const { return cols; }
  __host__ __device__ int f2() const { return 0; }
  __host__ __device__ int ni() const { return 0; }
  __host__ __device__ int vtot() const { return 0; }

  __device__ void stage(float* s1, float*, int*, int r0, int n, int tid,
                        int nthreads) const {
    stat_stage_words(s1, values + (size_t)r0 * cols, n * cols, tid,
                     nthreads);
  }

  // a: the slot's feature 0, features `st` floats apart
  __device__ void add(float* a, int st, const float* v1, const float*,
                      bool first) const {
    if constexpr (NC > 0) {
      float f[3 * NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float v = v1[c];
        f[c] = F(1.0);
        f[NC + c] = v;
        f[2 * NC + c] = __fmul_rn(v, v);
      }
      stat_apply(a, st, f, first);
    } else {
      for (int c = 0; c < cols; ++c) {
        const float v = v1[c];
        stat_put(a + (size_t)c * st, F(1.0), first);
        stat_put(a + (size_t)(cols + c) * st, v, first);
        stat_put(a + (size_t)(2 * cols + c) * st, __fmul_rn(v, v), first);
      }
    }
  }

  __device__ void count(int*, int, const int*) const {}
};

// K2: nich columns as NichRows, then per niw column of dimension d the
// features [1 | v (d) | v_a v_b (a <= b, row-major upper triangle)], and
// table columns counted into [C, vtot] at their offsets.  QD > 0: exactly
// NC nich columns and one niw column of dimension QD, known at compile
// time (the main path's niw2mix: NC = 1, QD = 2); QD = 0: the layout at
// run time.
template <int NC, int QD>
struct MixedRows {
  const float* values;     // [B, ncols] (null when ncols == 0)
  const float* qvalues;    // [B, qvals]
  const int* table_idx;    // [B, n_tab]
  int ncols, qvals, n_tab, n_quad, nvtot, qdim;
  int quad_cols[STAT_MAX_NIW];
  int quad_d[STAT_MAX_NIW];
  int tab_off[STAT_MAX_TABLES];

  __host__ __device__ int S() const { return 3 * ncols + qdim; }
  __host__ __device__ int f1() const { return ncols; }
  __host__ __device__ int f2() const { return qvals; }
  __host__ __device__ int ni() const { return n_tab; }
  __host__ __device__ int vtot() const { return nvtot; }

  __device__ void stage(float* s1, float* s2, int* si, int r0, int n,
                        int tid, int nthreads) const {
    if (ncols > 0)
      stat_stage_words(s1, values + (size_t)r0 * ncols, n * ncols, tid,
                       nthreads);
    if (qvals > 0)
      stat_stage_words(s2, qvalues + (size_t)r0 * qvals, n * qvals, tid,
                       nthreads);
    if (n_tab > 0)
      stat_stage_words(si, table_idx + (size_t)r0 * n_tab, n * n_tab, tid,
                       nthreads);
  }

  __device__ void add(float* a, int st, const float* v1, const float* v2,
                      bool first) const {
    if constexpr (QD > 0) {
      float f[3 * NC + 1 + QD + QD * (QD + 1) / 2];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float v = v1[c];
        f[c] = F(1.0);
        f[NC + c] = v;
        f[2 * NC + c] = __fmul_rn(v, v);
      }
      f[3 * NC] = F(1.0);
#pragma unroll
      for (int x = 0; x < QD; ++x) f[3 * NC + 1 + x] = v2[x];
      int o = 3 * NC + 1 + QD;
#pragma unroll
      for (int x = 0; x < QD; ++x)
#pragma unroll
        for (int y = x; y < QD; ++y) f[o++] = __fmul_rn(v2[x], v2[y]);
      stat_apply(a, st, f, first);
    } else {
      for (int c = 0; c < ncols; ++c) {
        const float v = v1[c];
        stat_put(a + (size_t)c * st, F(1.0), first);
        stat_put(a + (size_t)(ncols + c) * st, v, first);
        stat_put(a + (size_t)(2 * ncols + c) * st, __fmul_rn(v, v), first);
      }
      int q = 3 * ncols;
      const float* qv = v2;
      for (int g = 0; g < n_quad; ++g) {
        const int d = quad_d[g];
        for (int j = 0; j < quad_cols[g]; ++j) {
          stat_put(a + (size_t)q * st, F(1.0), first);
          for (int x = 0; x < d; ++x)
            stat_put(a + (size_t)(q + 1 + x) * st, qv[x], first);
          int o = q + 1 + d;
          for (int x = 0; x < d; ++x)
            for (int y = x; y < d; ++y) {
              stat_put(a + (size_t)o * st, __fmul_rn(qv[x], qv[y]), first);
              ++o;
            }
          q = o;
          qv += d;
        }
      }
    }
  }

  // t: [C, vtot] ints (shared or device memory); a: the row's slot
  __device__ void count(int* t, int a, const int* idx) const {
    for (int j = 0; j < n_tab; ++j)
      atomicAdd(t + (size_t)a * nvtot + tab_off[j] + idx[j], 1);
  }
};

// The warps (bit v: warp v) whose lanes touched slot kk of the chunk.
template <int W>
__device__ __forceinline__ unsigned stat_touched_by(const unsigned* masks,
                                                    int kk) {
  const unsigned bit = 1u << (kk >> 5);
  unsigned who = 0u;
#pragma unroll
  for (int v = 0; v < W; ++v)
    who |= (masks[v * 32 + (kk & 31)] & bit) ? 1u << v : 0u;
  return who;
}

// -- kernel 2: per-block partials --------------------------------------------
//
// Block b takes rows [b * p.rows, min(B, (b + 1) * p.rows)) with W warps.
// Writes partials[b, x, k] (float feature x of slot k) where bmask[b, k /
// 32] has bit k % 32 set -- the slots that the block's rows drew -- and
// every word of bmask[b]; adds the block's counts into tcounts_i [C, vtot]
// (zeroed before the launch).

template <class R, int W>
__global__ void __launch_bounds__(32 * STAT_MAX_WARPS)
stat_partials(R rows, const int* __restrict__ assign,
              float* __restrict__ partials, unsigned* __restrict__ bmask,
              int* __restrict__ tcounts_i, int B, int C, StatPlan p) {
  extern __shared__ __align__(16) unsigned char stat_smem[];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int nthreads = 32 * W;
  const int S = rows.S(), vtot = rows.vtot();
  const int r0 = blockIdx.x * p.rows;
  const int r1 = min(B, r0 + p.rows);
  float* acc = (float*)stat_smem;                          // [W][S][cks]
  unsigned* masks = (unsigned*)(stat_smem + p.off_masks);  // [W][32]
  int* sassign = (int*)(stat_smem + p.off_assign);         // [piece]
  float* sf1 = (float*)(stat_smem + p.off_f1);             // [piece][f1]
  float* sf2 = (float*)(stat_smem + p.off_f2);             // [piece][f2]
  int* si = (int*)(stat_smem + p.off_i);                   // [piece][ni]
  int* hist = (int*)(stat_smem + p.off_hist);              // [C][vtot]
  int* counts = p.hist ? hist : tcounts_i;
  const int f1 = rows.f1(), f2 = rows.f2(), ni = rows.ni();

  if (p.hist)
    for (int i = tid; i < C * vtot; i += nthreads) hist[i] = 0;
  const int npieces = (r1 - r0 + p.piece - 1) / p.piece;
  const int nchunks = S > 0 ? (C + p.cks - 1) / p.cks : 1;
  for (int ch = 0; ch < nchunks; ++ch) {
    const int c0 = ch * p.cks;
    const int n = S > 0 ? min(p.cks, C - c0) : 0;
    float* accw = acc + (size_t)w * S * p.cks;
    unsigned touched = 0u;   // bit j: slot c0 + 32 j + lane has a row
    for (int pc = 0; pc < npieces; ++pc) {
      const int q0 = r0 + pc * p.piece;
      const int np = min(p.piece, r1 - q0);
      if (npieces > 1 || ch == 0) {
        __syncthreads();   // the walk of the previous piece is done
        stat_stage_words(sassign, assign + q0, np, tid, nthreads);
        rows.stage(sf1, sf2, si, q0, np, tid, nthreads);
        __syncthreads();
      }
      if (ch == 0 && vtot > 0)
        for (int i = tid; i < np; i += nthreads) {
          const int a = sassign[i];
          if (a >= 0 && a < C) rows.count(counts, a, si + (size_t)i * ni);
        }
      if (n == 0) continue;
      // warp w walks its own span of the piece in row order; the lane
      // that owns the row's slot adds the row's features
      const int span = (np + W - 1) / W;
      const int i0 = min(np, w * span), i1 = min(np, i0 + span);
      int a_next = i0 < i1 ? sassign[i0] : 0;
      for (int i = i0; i < i1; ++i) {
        // the next row's slot is loaded before this row's adds
        const int k = a_next - c0;
        a_next = i + 1 < i1 ? sassign[i + 1] : 0;
        if ((unsigned)k < (unsigned)n && (k & 31) == lane) {
          const unsigned bit = 1u << (k >> 5);
          rows.add(accw + k, p.cks, sf1 + (size_t)i * f1,
                   sf2 + (size_t)i * f2, (touched & bit) == 0u);
          touched |= bit;
        }
      }
    }
    if (n == 0) continue;
    masks[w * 32 + lane] = touched;
    __syncthreads();
    // the chunk's slots that the block's rows drew, listed in slot order
    // with the warps that touched each: a bit word per 32 slots ...
    const int nwords = (n + 31) >> 5;
    unsigned* wbits = masks + W * 32;          // [32]
    int* woff = (int*)(wbits + 32);            // [32]
    int* list = woff + 32;                     // [STAT_CHUNK]
    unsigned* lwho = (unsigned*)(list + STAT_CHUNK);  // [STAT_CHUNK]
    for (int kk = tid; kk < nwords * 32; kk += nthreads) {
      const unsigned word = __ballot_sync(
          0xffffffffu, kk < n && stat_touched_by<W>(masks, kk) != 0u);
      if ((kk & 31) == 0) {
        wbits[kk >> 5] = word;
        bmask[(size_t)blockIdx.x * p.words + ((c0 + kk) >> 5)] = word;
      }
    }
    __syncthreads();
    // ... their offsets (a prefix sum over the words, by warp 0) ...
    if (w == 0) {
      const int c = lane < nwords ? __popc(wbits[lane]) : 0;
      int incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      woff[lane] = incl - c;
    }
    __syncthreads();
    // ... and the list; the drawn count is the last word's offset + bits
    for (int kk = tid; kk < n; kk += nthreads) {
      const unsigned word = wbits[kk >> 5];
      const unsigned below = word & ((1u << (kk & 31)) - 1u);
      if ((word >> (kk & 31)) & 1u) {
        const int e = woff[kk >> 5] + __popc(below);
        list[e] = kk;
        lwho[e] = stat_touched_by<W>(masks, kk);
      }
    }
    __syncthreads();
    const int ndrawn = woff[nwords - 1] + __popc(wbits[nwords - 1]);
    // the block's partial of the chunk: per drawn slot and feature, the
    // sums of the warps that touched the slot, in warp order (W loads at
    // once); consecutive threads take consecutive slots of one feature
    for (int it = tid; it < ndrawn * S; it += nthreads) {
      const int x = it / ndrawn, e = it - x * ndrawn;
      const int kk = list[e];
      const unsigned who = lwho[e];
      float t[W];
#pragma unroll
      for (int v = 0; v < W; ++v)
        t[v] = acc[((size_t)v * S + x) * p.cks + kk];
      float sum = F(0.0);
      bool any = false;
#pragma unroll
      for (int v = 0; v < W; ++v)
        if ((who >> v) & 1u) {
          sum = any ? __fadd_rn(sum, t[v]) : t[v];
          any = true;
        }
      partials[((size_t)blockIdx.x * S + x) * C + c0 + kk] = sum;
    }
    __syncthreads();   // the next chunk writes the regions and masks
  }
  if (p.hist) {
    __syncthreads();
    for (int i = tid; i < C * vtot; i += nthreads) {
      const int c = hist[i];
      if (c != 0) atomicAdd(tcounts_i + i, c);
    }
  }
}

// -- kernel 3: the fixed-order reduce ----------------------------------------
//
// Block (g, x) sums feature x of slots [32 g, 32 g + 32) over the blocks
// that drew them: warp w takes blocks w, w + STAT_REDUCE_WARPS, ... in
// order, then warp 0 adds the warps' sums in warp order.  With `dense`
// (partials of at most STAT_DENSE_FLOATS) a partial is loaded beside its
// bit, not after it, and dropped where the bit is clear: the same sums,
// one latency less a round.  Features x < S1
// go to sums [C, S1], the rest to qsums [C, S - S1].  Block (g, S), when
// there are count tables, turns the int counts of its slots into f32.

__global__ void __launch_bounds__(32 * STAT_REDUCE_WARPS)
stat_reduce(const float* __restrict__ partials,
            const unsigned* __restrict__ bmask, int nblocks, int words,
            int C, int S, int S1, float* __restrict__ sums,
            float* __restrict__ qsums, const int* __restrict__ tcounts_i,
            float* __restrict__ tcounts, int vtot, int dense) {
  __shared__ float wsum[STAT_REDUCE_WARPS][32];
  __shared__ int wany[STAT_REDUCE_WARPS][32];
  const int g = blockIdx.x, x = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  if (x == S) {
    const size_t base = (size_t)g * 32 * vtot;
    const int m = min(32, C - g * 32) * vtot;
    for (int i = tid; i < m; i += blockDim.x)
      tcounts[base + i] = (float)tcounts_i[base + i];
    return;
  }
  const int k = g * 32 + lane;
  float s = F(0.0);
  bool any = false;
  // STAT_REDUCE_UNROLL blocks at once: their bit words, then the partials
  // where a bit is set, then the adds in block order
  for (int b0 = w; b0 < nblocks;
       b0 += STAT_REDUCE_WARPS * STAT_REDUCE_UNROLL) {
    unsigned m[STAT_REDUCE_UNROLL];
    float t[STAT_REDUCE_UNROLL];
#pragma unroll
    for (int j = 0; j < STAT_REDUCE_UNROLL; ++j) {
      const int b = b0 + j * STAT_REDUCE_WARPS;
      m[j] = b < nblocks ? (__ldg(bmask + (size_t)b * words + g) >> lane) & 1u
                         : 0u;
    }
#pragma unroll
    for (int j = 0; j < STAT_REDUCE_UNROLL; ++j) {
      const int b = b0 + j * STAT_REDUCE_WARPS;
      t[j] = (dense ? b < nblocks : m[j] != 0u)
                 ? __ldg(partials + ((size_t)b * S + x) * C + k)
                 : F(0.0);
    }
#pragma unroll
    for (int j = 0; j < STAT_REDUCE_UNROLL; ++j)
      if (m[j]) {
        s = any ? __fadd_rn(s, t[j]) : t[j];
        any = true;
      }
  }
  wsum[w][lane] = s;
  wany[w][lane] = any;
  __syncthreads();
  if (w != 0 || k >= C) return;
  float t = F(0.0);
  bool a = false;
  for (int v = 0; v < STAT_REDUCE_WARPS; ++v)
    if (wany[v][lane]) {
      t = a ? __fadd_rn(t, wsum[v][lane]) : wsum[v][lane];
      a = true;
    }
  if (x < S1)
    sums[(size_t)k * S1 + x] = t;
  else
    qsums[(size_t)k * (S - S1) + (x - S1)] = t;
}

template <class R, int W>
static cudaError_t stat_partials_launch(const R& rows, const int* assign,
                                        float* partials, unsigned* bmask,
                                        int* tcounts_i, int B, int C,
                                        const StatPlan& p, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      stat_partials<R, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p.smem);
  if (err != cudaSuccess) return err;
  stat_partials<R, W><<<p.nblocks, 32 * W, p.smem, st>>>(
      rows, assign, partials, bmask, tcounts_i, B, C, p);
  return cudaGetLastError();
}

// Launch the stat stage of `rows` with the slots `assign` [B] on stream
// st.  partials: scratch of [nblocks, S, C] floats, bmask of [nblocks,
// ceil(C / 32)] words (nblocks = ceil(B / stat_rows_per_block(B)));
// sums [C, S1] and qsums [C, S - S1] the float results; tcounts_i [C,
// vtot] int scratch and tcounts [C, vtot] the counts as f32.
template <class R>
static int stat_stage_launch(const R& rows, const int* assign,
                             float* partials, unsigned* bmask, float* sums,
                             float* qsums, int S1, int* tcounts_i,
                             float* tcounts, int B, int C, cudaStream_t st) {
  StatPlan p;
  const int S = rows.S(), vtot = rows.vtot();
  if (!stat_plan(B, C, S, rows.f1(), rows.f2(), rows.ni(), vtot, &p))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (vtot > 0) {
    err = cudaMemsetAsync(tcounts_i, 0, (size_t)C * vtot * sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
  }
  switch (p.warps) {
    case 8: err = stat_partials_launch<R, 8>(rows, assign, partials, bmask,
                                              tcounts_i, B, C, p, st); break;
    case 4: err = stat_partials_launch<R, 4>(rows, assign, partials, bmask,
                                              tcounts_i, B, C, p, st); break;
    case 2: err = stat_partials_launch<R, 2>(rows, assign, partials, bmask,
                                              tcounts_i, B, C, p, st); break;
    default: err = stat_partials_launch<R, 1>(rows, assign, partials, bmask,
                                               tcounts_i, B, C, p, st);
  }
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.words, S + (vtot > 0 ? 1 : 0));
  const int dense = (size_t)p.nblocks * S * C <= STAT_DENSE_FLOATS;
  stat_reduce<<<grid, 32 * STAT_REDUCE_WARPS, 0, st>>>(
      partials, bmask, p.nblocks, p.words, C, S, S1, sums, qsums, tcounts_i,
      tcounts, vtot, dense);
  return (int)cudaGetLastError();
}

// The plan of a launch, for the wrappers' reports: info[0] rows a block,
// [1] rows staged at once, [2] warps, [3] slots a chunk, [4] count tables
// in shared memory, [5] blocks, [6] dynamic shared memory bytes.
static int stat_plan_info(int B, int C, int S, int f1, int f2, int ni,
                          int vtot, int* info) {
  StatPlan p;
  if (!stat_plan(B, C, S, f1, f2, ni, vtot, &p))
    return (int)cudaErrorInvalidValue;
  const int v[7] = {p.rows, p.piece, p.warps, p.cks, p.hist, p.nblocks,
                    (int)p.smem};
  for (int i = 0; i < 7; ++i) info[i] = v[i];
  return 0;
}
