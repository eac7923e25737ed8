// Device code shared by the column pass (colpass.cu), the nested column
// pass (nested_colpass.cu), the fused four-step kernel (fused_fourstep.cu)
// and the butterfly probe (bfly_probe.cu): two ways to run a whole
// (nn x TL) column tile of a plain or nested network, under a reduction
// policy (reductions.cuh: Harvey4, Harvey, Montgomery, Barrett) that every
// function takes as its last argument, `R`.
// column_tile (row-major; fused_fourstep.cu's) runs groups of DIF or DIT
// stages held in registers between exchanges through the tile (one stage
// a group is one stage per barrier) between sweeps of the tile that load
// it, apply the nested mid step and store it, each also callable on its
// own. column_tile_io (colpass.cu's, nested_colpass.cu's, and the fused
// kernel's tall steps) keeps a swizzled tile, and its groups also load,
// store and carry the nested mid multiply. column_empty (the last section)
// runs a network of zero stages, a one-row column's. column_tile runs one
// too: its loops over the stages do nothing, and its load and store keep
// row 0.
//
// Arithmetic: the policy's, bit for bit the uint32 operations of the
// plain PyTorch version (reductions.cuh states each). A DIF butterfly is
// (R.add(a, b), R.mulc(R.sub_for_mul(a, b), w)), a DIT one (R.add(u, wv),
// R.sub(u, wv)) of wv = R.mulc(v, w); values travel in the policy's domain
// and the store's canonicalize is R.canon. column_tile_io's conditional
// subtracts are unsigned mins, column_tile's selects (reductions.cuh kMin).
// Harvey4 runs the operations these kernels ran before the policies came.
//
// A network is a generic stage list from ntt_aie_tpu_torch.twiddles
// .col_network: a stage of half size t pairs rows (b*2t + j, b*2t + t + j)
// and multiplies by tw[off + j]. The nested R x S network (nn >= 256)
// runs phase 0, the mid step (DIF: x[r] *= mid[r], then the row at r*S + s
// moves to s*R + r; DIT: the inverse move, then the multiply), then
// phase 1. The move is not done in memory: phase 1 and the store address
// logical row l at physical row
//   (l mod A) * (nn / A) + l / A,   A = R for DIF, A = S for DIT.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "reductions.cuh"

namespace colpass_tile {

constexpr int kMaxStages = 16;

// One column network over nn rows.
struct Network {
  const uint32_t* tw_w;   // stage twiddles, all stages concatenated
  const uint32_t* tw_s;   // their packed Shoup halves
  const uint32_t* mid_w;  // nested mid vector (nn,), or null for plain
  const uint32_t* mid_s;
  int nn, log_nn;
  int nstages, k0;  // stages in all; stages in phase 0
  int log_a;        // log2 of A for the nested row map, -1 when plain
  int dit;
  int t[kMaxStages];
  int off[kMaxStages];
};

// One pass's tile operands, the same for every tile of a launch (kernel
// parameters). Element (l, c) of a tile is src[l * ncols + col0 + c]; the
// store writes it to the same index of dst, or, transposed, to
// dst[(col0 + c) * nn + l]. pre is indexed like src, mat like dst.
struct TileOps {
  const uint32_t* pre_w;  // multiply on load (Load::kPre)
  const uint32_t* pre_s;
  const uint32_t* mat_w;  // multiply on store (kMat)
  const uint32_t* mat_s;
  int ncols, log_tl;
  int canonicalize;
};

// How a tile is loaded: plainly, times pre, or through L2 only (for data
// this grid wrote).
enum class Load { kPlain, kPre, kL2 };

// Physical shared-memory row of logical row l (identity when log_a < 0).
__device__ __forceinline__ int row_of(int l, int log_a, int log_nn) {
  if (log_a < 0) return l;
  return ((l & ((1 << log_a) - 1)) << (log_nn - log_a)) | (l >> log_a);
}

// DIF stages s0 .. s0 + K - 1 of one phase (half sizes t_last << (K-1)
// down to t_last) as radix-2^K butterflies held in registers, then one
// barrier. Each thread loads the 2^K rows base + m * t_last (m < 2^K) of
// one butterfly, runs the K stages on them in the same per-butterfly
// operation order as one stage at a time — sub-stage q pairs m with
// m + 2^(K-1-q) and takes the twiddle at ((m mod 2^(K-1-q)) * t_last + j)
// — and writes the 2^K results back. So the outputs do not depend on how
// the stages are grouped; K = 1 is one DIF stage per barrier. log_a: the
// row map of this phase (-1 for phase 0).
template <int K, class Red>
__device__ __forceinline__ void run_group(uint32_t* tile, const Network& N,
                                          int s0, int log_a, int log_tl,
                                          Red R) {
  const int t_last = N.t[s0 + K - 1];
  const int log_t = __ffs(t_last) - 1;
  const int tl_mask = (1 << log_tl) - 1;
  const int total = (N.nn >> K) << log_tl;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int c = i & tl_mask;
    const int g = i >> log_tl;
    const int j = g & (t_last - 1);
    const int base = ((g >> log_t) << (log_t + K)) | j;
    uint32_t v[1 << K];
#pragma unroll
    for (int m = 0; m < (1 << K); ++m)
      v[m] = tile[(row_of(base + (m << log_t), log_a, N.log_nn) << log_tl)
                  + c];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int h = 1 << (K - 1 - q);  // the pair's distance in m
      const uint32_t* tw_w = N.tw_w + N.off[s0 + q];
      const uint32_t* tw_s = N.tw_s + N.off[s0 + q];
#pragma unroll
      for (int m = 0; m < (1 << K); ++m) {
        if (m & h) continue;
        const int idx = ((m & (h - 1)) << log_t) | j;
        const uint32_t a = v[m], b = v[m + h];
        v[m] = R.template add<false>(a, b);
        v[m + h] = R.mulc(R.sub_for_mul(a, b), __ldg(tw_w + idx),
                          __ldg(tw_s + idx));
      }
    }
#pragma unroll
    for (int m = 0; m < (1 << K); ++m)
      tile[(row_of(base + (m << log_t), log_a, N.log_nn) << log_tl) + c] =
          v[m];
  }
  __syncthreads();
}

// DIT stages s0 .. s0 + K - 1 of one phase (half sizes t_first up to
// t_first << (K-1)) as radix-2^K butterflies held in registers, then one
// barrier: the mirror of run_group. Each thread loads the 2^K rows
// base + m * t_first (m < 2^K) of one butterfly; sub-stage q pairs m with
// m + 2^q, takes the twiddle at ((m mod 2^q) * t_first + j) and runs
// the DIT butterfly's operations in their order (wv = v * w, then
// R.add(u, wv) and R.sub(u, wv)). K = 1 is one DIT stage per barrier.
template <int K, class Red>
__device__ __forceinline__ void run_group_dit(uint32_t* tile,
                                              const Network& N, int s0,
                                              int log_a, int log_tl,
                                              Red R) {
  const int t_first = N.t[s0];
  const int log_t = __ffs(t_first) - 1;
  const int tl_mask = (1 << log_tl) - 1;
  const int total = (N.nn >> K) << log_tl;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int c = i & tl_mask;
    const int g = i >> log_tl;
    const int j = g & (t_first - 1);
    const int base = ((g >> log_t) << (log_t + K)) | j;
    uint32_t v[1 << K];
#pragma unroll
    for (int m = 0; m < (1 << K); ++m)
      v[m] = tile[(row_of(base + (m << log_t), log_a, N.log_nn) << log_tl)
                  + c];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int h = 1 << q;  // the pair's distance in m
      const uint32_t* tw_w = N.tw_w + N.off[s0 + q];
      const uint32_t* tw_s = N.tw_s + N.off[s0 + q];
#pragma unroll
      for (int m = 0; m < (1 << K); ++m) {
        if (m & h) continue;
        const int idx = ((m & (h - 1)) << log_t) | j;
        const uint32_t u = v[m];
        const uint32_t wv =
            R.mulc(v[m + h], __ldg(tw_w + idx), __ldg(tw_s + idx));
        v[m] = R.template add<false>(u, wv);
        v[m + h] = R.template sub<false>(u, wv);
      }
    }
#pragma unroll
    for (int m = 0; m < (1 << K); ++m)
      tile[(row_of(base + (m << log_t), log_a, N.log_nn) << log_tl) + c] =
          v[m];
  }
  __syncthreads();
}

// A group of a runtime k <= K stages (run_group, or run_group_dit when
// kDit): instantiates only groups up to K.
template <int K, bool kDit, class Red>
__device__ __forceinline__ void run_group_upto(int k, uint32_t* tile,
                                               const Network& N, int s0,
                                               int log_a, int log_tl,
                                               Red R) {
  if constexpr (K > 1) {
    if (k < K) {
      run_group_upto<K - 1, kDit>(k, tile, N, s0, log_a, log_tl, R);
      return;
    }
  }
  if constexpr (kDit)
    run_group_dit<K>(tile, N, s0, log_a, log_tl, R);
  else
    run_group<K>(tile, N, s0, log_a, log_tl, R);
}

// Stages [s_begin, s_end) of one phase, DIF or DIT as N.dit says, in groups
// of min(kFuse, stages left); a group never crosses the phase's end.
template <int kFuse, class Red>
__device__ __forceinline__ void run_phase(uint32_t* tile, const Network& N,
                                          int s_begin, int s_end, int log_a,
                                          int log_tl, Red R) {
  for (int s = s_begin; s < s_end;) {
    const int k = min(kFuse, s_end - s);
    if (N.dit)
      run_group_upto<kFuse, true>(k, tile, N, s, log_a, log_tl, R);
    else
      run_group_upto<kFuse, false>(k, tile, N, s, log_a, log_tl, R);
    s += k;
  }
}

// Loads one tile with the whole block: reads along the column axis (TL * 4
// contiguous bytes per row), then a barrier. src is this batch row's input;
// col0 is the tile's first column.
template <Load kLoad, class Red>
__device__ __forceinline__ void load_tile(uint32_t* tile, const Network& N,
                                          const TileOps& O,
                                          const uint32_t* src, size_t col0,
                                          Red R) {
  const int tl = 1 << O.log_tl;
  const int n_tile = N.nn << O.log_tl;
  for (int i = threadIdx.x; i < n_tile; i += blockDim.x) {
    const size_t o =
        (size_t)(i >> O.log_tl) * O.ncols + col0 + (i & (tl - 1));
    if constexpr (kLoad == Load::kL2)
      tile[i] = __ldcg(src + o);
    else if constexpr (kLoad == Load::kPre)
      tile[i] = R.mulc(src[o], __ldg(O.pre_w + o), __ldg(O.pre_s + o));
    else
      tile[i] = src[o];
  }
  __syncthreads();
}

// The nested network's mid step: DIF multiplies before the row move
// (physical rows), DIT after it (logical rows through the map); then a
// barrier.
template <class Red>
__device__ __forceinline__ void mid_step(uint32_t* tile, const Network& N,
                                         int log_tl, Red R) {
  const int tl = 1 << log_tl;
  const int n_tile = N.nn << log_tl;
  const int map_a = N.dit ? N.log_a : -1;
  for (int i = threadIdx.x; i < n_tile; i += blockDim.x) {
    const int l = i >> log_tl;
    uint32_t* e =
        tile + (row_of(l, map_a, N.log_nn) << log_tl) + (i & (tl - 1));
    *e = R.mulc(*e, __ldg(N.mid_w + l), __ldg(N.mid_s + l));
  }
  __syncthreads();
}

// Stores one tile (logical row l from physical row row_of(l)): coalesced
// along nn when kTranspose, times mat when kMat, then canonicalize if asked.
// dst is this batch row's output.
template <bool kTranspose, bool kMat, class Red>
__device__ __forceinline__ void store_tile(const uint32_t* tile,
                                           const Network& N, const TileOps& O,
                                           uint32_t* dst, size_t col0,
                                           Red R) {
  const int tl = 1 << O.log_tl;
  const int n_tile = N.nn << O.log_tl;
  for (int i = threadIdx.x; i < n_tile; i += blockDim.x) {
    const int l = kTranspose ? i & (N.nn - 1) : i >> O.log_tl;
    const int c = kTranspose ? i >> N.log_nn : i & (tl - 1);
    uint32_t v = tile[(row_of(l, N.log_a, N.log_nn) << O.log_tl) + c];
    const size_t o = kTranspose ? (col0 + c) * N.nn + l
                                : (size_t)l * O.ncols + col0 + c;
    if constexpr (kMat)
      v = R.mulc(v, __ldg(O.mat_w + o), __ldg(O.mat_s + o));
    if (O.canonicalize) v = R.template canon<false>(v);
    dst[o] = v;
  }
}

// Runs one tile with the whole block: load, every stage of N in shared
// memory, then one store. Each phase runs in register groups of up to
// kFuse stages (run_phase), one barrier a group; kFuse = 1 is one barrier a
// stage. Every kFuse gives the same bits.
// src and dst are this batch row's input and output; col0 is the tile's
// first column. Output domain: R's, or [0, p) with canonicalize. A caller
// that reuses the tile must __syncthreads() first. The options that change
// the loops are template parameters, so each kernel carries only the loops
// it runs.
template <Load kLoad, bool kTranspose, bool kMat, int kFuse = 1, class Red>
__device__ __forceinline__ void column_tile(uint32_t* tile, const Network& N,
                                            const TileOps& O,
                                            const uint32_t* src,
                                            uint32_t* dst, size_t col0,
                                            Red R) {
  load_tile<kLoad>(tile, N, O, src, col0, R);
  run_phase<kFuse>(tile, N, 0, N.k0, -1, O.log_tl, R);
  if (N.log_a >= 0) {
    mid_step(tile, N, O.log_tl, R);
    run_phase<kFuse>(tile, N, N.k0, N.nstages, N.log_a, O.log_tl, R);
  }
  store_tile<kTranspose, kMat>(tile, N, O, dst, col0, R);
}

// ---- Column tiles whose groups load, multiply and store ----
// (colpass.cu, nested_colpass.cu)
//
// column_tile_io keeps its tile in a swizzled layout. A tile of TL =
// 2^log_tl columns has 32-word lines of 2^b = 32 / TL rows; physical row r,
// column c sits at word
//   ((r XOR ((r >> s) mod 2^b)) << log_tl) + c,
// where s, the tile's shift, is log2(nn / A), the row map's: consecutive
// logical rows of phase 1 lie nn / A physical rows apart (row_of), so
// row-major they share one bank group (4-way conflicts at TL = 8), and the
// XOR with r >> s gives them distinct slots of their lines. A plain network
// has no row map and s = log2 nn (r >> s = 0: row-major). s is at least b,
// so the XOR keeps each row in its own line and the map is one to one.
// ops/colpass.py tile_address models it.

// The shift s of a tile of 2^log_tl columns of N (on the host: the kernel
// takes it as a parameter, which costs it no register).
inline int tile_shift(const Network& N, int log_tl) {
  const int s = N.log_a >= 0 ? N.log_nn - N.log_a : N.log_nn;
  return s > 5 - log_tl ? s : 5 - log_tl;
}

// column_tile_io's operand tables, each (w, packed w') pair one 8-byte
// word, loaded with one instruction.
struct PairTables {
  const uint2* tw;   // stage twiddles, stage s from Network::off[s]
  const uint2* mid;  // nested mid vector (nn,), or null for plain
  const uint2* mat;  // multiply on store (kMat), indexed like the output
  const uint2* pre;  // multiply on load (kPre's form), and its second
  const uint2* pre2;  // table (kOpFac: T2; kOpRank1: the column vector)
  const uint2* post;  // multiply after the stages (kPost's form), before
  const uint2* post2;  // mat and canonicalize, and its second table
  int log_s;  // kOpFac's split S = 2^log_s
  // A tall phase's view (kTallA, kTallB): log2 of the factor of the tall
  // nn that rides its columns, and of the tall array's columns; and log2
  // of the tall columns a transposing phase B's tile takes (tile_col0).
  int log_inner, log_ncols, log_tlc;
};

// The form of a 'pre' or 'post' operand (the reference's twiddle_pos
// matrix, wfac and rank1): kOpNone; kOpMat, a full (nn, ncols) table
// indexed like the input; kOpFac, the factored four-step matrix, T1
// (nn/S, ncols) at [l >> log_s][col], then T2 (S, ncols) at
// [l & (S - 1)][col]; kOpRank1, the row vector (nn,) at [l], then the
// column vector (ncols,) at [col]. l is the value's logical row, col its
// column in the input.
enum Operand : int { kOpNone = 0, kOpMat = 1, kOpFac = 2, kOpRank1 = 3 };

// A tall column: a nested network of nn rows, above one tile's, runs as
// two launches of plain networks (ops/colpass.py tall_phases), each over a
// view of the (nn, ncols) array in which the other factor of nn rides the
// columns: a launch's element (l, col) is the tall array's row
// l * inner + col / ncols, column col mod ncols (tall_row, tall_col).
// kTallA runs the network's phase 0 over the view (rows0, inner0 * ncols):
// the 'pre' operand on load, the nested mid multiply and the row move on
// store (row r * S + s to s * R + r for DIF, the inverse move for DIT:
// in the launch's terms, tall row l * inner + q goes to q * rows + l).
// kTallB runs phase 1 over (rows1, inner1 * ncols) of the moved array,
// whose layout the output keeps: the 'post' operand, the transpose, the
// 'post_t' multiply and canonicalize on store. kWhole is one launch of the
// whole column.
// A phase of more than a tile's rows (a column above 2^26 rows) runs as two
// launches of its own, split by stage group (ops/colpass.py phase_groups):
// with its rows numbered p * Q + q (P * Q rows, P and Q at most a tile's),
// the stages of half size t >= Q pair rows that share q: they are a P-row
// network ('hi') over the view (P, Q * inner * ncols), each half size t / Q,
// whose twiddle for the plain network's index idx at view column j is
// tw[off + idx * Q + j / (inner * ncols)] (the first launch whose twiddle
// depends on the column); the stages t < Q are a Q-row network ('lo') over
// P arrays (Q, inner * ncols) a batch row, array p of batch row b at the
// launch's batch row b * P + p, with the ordinary tables. DIF runs hi then
// lo, DIT lo then hi. A split phase A's first launch takes the 'pre'
// operand on load and stores in place (kTallPre; kTallB without store
// options where there is no 'pre'), its last stores the mid step (kTallA
// without 'pre'); a split phase B's first stores in place, its last with
// the store options.
enum Tall : int { kWhole = 0, kTallA = 1, kTallB = 2, kTallPre = 3 };

// What a tall launch knows of its view beyond PairTables (a kernel
// parameter after every field that a whole column's kernel reads).
struct TallView {
  int log_vc;    // log2 of the phase's view columns, inner * ncols
  int log_iq;    // log2 of the phase's inner (log_vc - PairTables log_ncols)
  int log_hq;    // a 'hi' launch's log2 Q, else 0
  int log_lp;    // a 'lo' launch's log2 P, else 0
  int log_rows;  // log2 of the phase's rows
  int log_tall;  // log2 of the tall column's rows
};

// Where a tall launch's element (l, col) lies: every launch's view is a
// reshape of the (nn, ncols) array, so the element at index F = sub +
// l * O.ncols + col of its batch row (sub: a 'lo' launch's array offset p
// * Q * inner * ncols) is the phase's row lp = F / (inner * ncols) and
// view column jv = F mod (inner * ncols), and the tall array's row
// lp * inner + iq (iq = jv / ncols) and column tc = jv mod ncols. A 'hi'
// launch's row l and column q * vc + jv are the phase's row l * Q + q; a
// 'lo' launch's array p, row l is the phase's row p * Q + l. The column
// parts are a thread's for a whole group (tall_cols); the row, a value's
// (tall_row).
struct TallCols {
  int q;      // a 'hi' launch's twiddle column (0 for every other launch)
  int iq;     // the view column's part of the tall row
  size_t tc;  // the tall array's column
};

// kGroup: a launch of a split phase; any other's column lies in its
// phase's view (q = 0, jv = col).
template <bool kGroup>
__device__ __forceinline__ TallCols tall_cols(size_t col, const PairTables& T,
                                              const TallView& V) {
  const size_t jv = kGroup ? col & (((size_t)1 << V.log_vc) - 1) : col;
  return {kGroup ? (int)(col >> V.log_vc) : 0, (int)(jv >> T.log_ncols),
          jv & (((size_t)1 << T.log_ncols) - 1)};
}

// The phase's row of a launch's row l (row_base: a 'lo' launch's p * Q;
// log_hq: a 'hi' launch's log2 Q).
__device__ __forceinline__ int phase_row(int l, int row_base, int log_hq,
                                         const TallCols& X) {
  return ((row_base + l) << log_hq) | X.q;
}

// (32-bit: a tall column has at most 2^32 rows)
__device__ __forceinline__ unsigned tall_row(int lp, const TallCols& X,
                                             const TallView& V) {
  return ((unsigned)lp << V.log_iq) | X.iq;
}

// A transposing phase B (kTallB with kTranspose) stores tall row
// l * inner + p of column c to word c * nn + l * inner + p: consecutive
// words are consecutive p, the view's columns ncols apart. Its tile is
// therefore 2^(log_tl - log_tlc) consecutive p by 2^log_tlc consecutive
// tall columns (tile column t = pl * 2^log_tlc + cl, view column col0 +
// pl * ncols + cl), its blocks enumerate the p blocks first, and its
// storing group gives consecutive threads consecutive p (tile_thread):
// a warp stores whole 32-byte runs of eight p where a plain tile stored one
// word a sector. Its loading group reads runs of 2^log_tlc words, the rest
// of each sector read by the next c block's blocks, inner / 2^(log_tl -
// log_tlc) blocks later, from L2.
// (gl_colpass.cu's kernels take the same three logs from their Params.)
template <bool kSplit>
__device__ __forceinline__ size_t tile_col0(int block, int log_tl,
                                            int log_inner, int log_ncols,
                                            int log_tlc) {
  if constexpr (kSplit) {
    const int log_tlp = log_tl - log_tlc;
    const int log_pb = log_inner - log_tlp;  // p blocks
    const size_t pb = block & ((1 << log_pb) - 1);
    const size_t cb = block >> log_pb;
    return ((pb << log_tlp) << log_ncols) | (cb << log_tlc);
  } else {
    return (size_t)block << log_tl;
  }
}

// log_tlc for a phase over 2^log_tl-column tiles (on the host): want's
// columns, fewer where the tall array has fewer, more where the phase's
// inner factor is under the tile's rest.
inline int tall_store_log_cols(int want, int log_tl, int log_inner,
                               int log_ncols) {
  int c = want < log_tl ? want : log_tl;
  if (log_tl - c > log_inner) c = log_tl - log_inner;
  return c < log_ncols ? c : log_ncols;
}

// The offset of a split tile's column c from col0 (tile_col0): the view
// column is col0 + tile_off(c).
__device__ __forceinline__ size_t tile_off(int c, int log_ncols,
                                           int log_tlc) {
  return ((size_t)(c >> log_tlc) << log_ncols) + (c & ((1 << log_tlc) - 1));
}

// A 'hi' launch of phase A (split by stage group) moves the phase's row
// l * Q + q of view column jv to word (jv / ncols) * rows + l * Q + q
// (times ncols): consecutive words are consecutive q, the launch's columns
// q * vc + jv vc apart. It takes the same split tile with vc for ncols and
// Q for inner: 2^(log_tl - log_tlc) consecutive q by 2^log_tlc consecutive
// jv, so a warp's store writes whole runs of eight q (tall_col0).

// The first launch column of block `block` of a tall launch: the split
// tile's (tile_col0) for a transposing phase B and for a 'hi' launch of
// phase A, the plain tile's for the others.
template <int kTall, bool kTranspose, bool kGroup>
__device__ __forceinline__ size_t tall_col0(int block, int log_tl,
                                            const PairTables& T,
                                            const TallView& V) {
  if constexpr (kTall == kTallB && kTranspose)
    return tile_col0<true>(block, log_tl, T.log_inner, T.log_ncols,
                           T.log_tlc);
  else if constexpr (kTall == kTallA && kGroup)
    return V.log_hq > 0 ? tile_col0<true>(block, log_tl, V.log_hq, V.log_vc,
                                          T.log_tlc)
                        : tile_col0<false>(block, log_tl, 0, 0, 0);
  else
    return tile_col0<false>(block, log_tl, 0, 0, 0);
}

// The tile column of thread index i in a split tile: its loading group's
// i mod TL (consecutive tall columns), its storing group's with
// consecutive p at consecutive i.
__device__ __forceinline__ int tile_thread(int i, int log_tl, bool store,
                                           int log_tlc) {
  if (!store) return i & ((1 << log_tl) - 1);
  const int log_tlp = log_tl - log_tlc;
  return ((i & ((1 << log_tlp) - 1)) << log_tlc) |
         ((i >> log_tlp) & ((1 << log_tlc) - 1));
}

// v times the kOpFac or kOpRank1 operand in tables a and b (the second
// multiply after the first, as the reference's two broadcast multiplies).
template <int kForm, class Red>
__device__ __forceinline__ uint32_t mul_factors(uint32_t v, const uint2* a,
                                                const uint2* b, int l,
                                                size_t col, int ncols,
                                                int log_s, Red R) {
  static_assert(kForm == kOpFac || kForm == kOpRank1, "a two-table form");
  if constexpr (kForm == kOpFac) {
    v = R.mulc(v, __ldg(a + (size_t)(l >> log_s) * ncols + col));
    return R.mulc(v, __ldg(b + (size_t)(l & ((1 << log_s) - 1)) * ncols +
                           col));
  } else {
    v = R.mulc(v, __ldg(a + l));
    return R.mulc(v, __ldg(b + col));
  }
}

// The word of logical row l's column 0 through the row map log_a.
__device__ __forceinline__ int word_of(int l, int log_a, int log_nn,
                                       int log_tl, int shift) {
  const int r = row_of(l, log_a, log_nn);
  return (r ^ ((r >> shift) & ((32 >> log_tl) - 1))) << log_tl;
}

// dw[m] = word_of(m << log_t) for m < 2^K, from the K words of the single
// bits: word_of is XOR-linear in l (row_of rotates l's bits, the swizzle
// XORs them), so the row base + (m << log_t), whose bits are disjoint from
// base's, is at word_of(base) ^ dw[m].
template <int K>
__device__ __forceinline__ void group_offsets(int (&dw)[1 << K], int log_t,
                                              int log_a, int log_nn,
                                              int log_tl, int shift) {
  dw[0] = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = word_of(1 << (log_t + k), log_a, log_nn, log_tl, shift);
#pragma unroll
    for (int m = 0; m < (1 << k); ++m) dw[m + (1 << k)] = dw[m] ^ e;
  }
}

// DIF stages s0 .. s0 + K - 1 of one phase (half sizes t_last << (K-1)
// down to t_last) on the 2^K values v[m] = x[base + m * t_last] of one
// radix-2^K butterfly, in the same per-butterfly operation order as one
// stage at a time: sub-stage q pairs m with m + 2^(K-1-q) and takes the
// twiddle at ((m mod 2^(K-1-q)) * t_last + j). So the outputs do not depend
// on how the stages are grouped. kCol: a 'hi' launch's, the twiddle at
// idx * 2^log_hq + tq for its view column's tq.
template <int K, bool kCol = false, class Red>
__device__ __forceinline__ void dif_stages(uint32_t (&v)[1 << K],
                                           const Network& N,
                                           const uint2* tw, int s0,
                                           int log_t, int j, Red R,
                                           int log_hq = 0, int tq = 0) {
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int h = 1 << (K - 1 - q);  // the pair's distance in m
    const uint2* tw_q = tw + N.off[s0 + q];
#pragma unroll
    for (int m = 0; m < (1 << K); ++m) {
      if (m & h) continue;
      int idx = ((m & (h - 1)) << log_t) | j;
      if constexpr (kCol) idx = (idx << log_hq) | tq;
      const uint32_t a = v[m], b = v[m + h];
      v[m] = R.add(a, b);
      v[m + h] = R.mulc(R.sub_for_mul(a, b), __ldg(tw_q + idx));
    }
  }
}

// DIT stages s0 .. s0 + K - 1 of one phase (half sizes t_first up to
// t_first << (K-1)) on v[m] = x[base + m * t_first]: the mirror of
// dif_stages. Sub-stage q pairs m with m + 2^q, takes the twiddle at
// ((m mod 2^q) * t_first + j) and runs the DIT butterfly's operations in
// their order (wv = v * w, then R.add(u, wv) and R.sub(u, wv)). kCol as
// dif_stages'.
template <int K, bool kCol = false, class Red>
__device__ __forceinline__ void dit_stages(uint32_t (&v)[1 << K],
                                           const Network& N,
                                           const uint2* tw, int s0,
                                           int log_t, int j, Red R,
                                           int log_hq = 0, int tq = 0) {
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int h = 1 << q;  // the pair's distance in m
    const uint2* tw_q = tw + N.off[s0 + q];
#pragma unroll
    for (int m = 0; m < (1 << K); ++m) {
      if (m & h) continue;
      int idx = ((m & (h - 1)) << log_t) | j;
      if constexpr (kCol) idx = (idx << log_hq) | tq;
      const uint32_t u = v[m];
      const uint32_t wv = R.mulc(v[m + h], __ldg(tw_q + idx));
      v[m] = R.add(u, wv);
      v[m + h] = R.sub(u, wv);
    }
  }
}

// The row that phase A's store moves tall row lp * inner + iq to (DIF:
// row r * S + s to s * R + r; DIT: the inverse move): iq * rows + lp.
__device__ __forceinline__ unsigned moved_row(int lp, const TallCols& X,
                                              const TallView& V) {
  return ((unsigned)X.iq << V.log_rows) | lp;
}

// The output word of a tall launch's element in its batch row of the tall
// array, moved (kTallA) or transposed (kTallB with the transpose: (column,
// row) of (ncols, nn)); every other launch keeps the layout and stores at
// the element's own index.
template <bool kTranspose, int kTall>
__device__ __forceinline__ size_t tall_store_index(int lp, const TallCols& X,
                                                   const PairTables& T,
                                                   const TallView& V) {
  static_assert(kTall == kTallA || (kTall == kTallB && kTranspose),
                "a store that moves the element");
  if constexpr (kTall == kTallA)
    return ((size_t)moved_row(lp, X, V) << T.log_ncols) | X.tc;
  else
    return (X.tc << V.log_tall) + tall_row(lp, X, V);
}

// A DIF split phase A's last launch ('lo': log_hq = 0) moves tall row
// lp * inner + iq of column tc to word (iq * rows + lp) * ncols + tc: a run
// of ncols words a moved row, the runs of one view column iq (its rows lp)
// consecutive. In the group's mapping, a thread a view column, a warp's
// store lands its 32 words in 32 runs, rows * ncols words apart: one word
// a 32-byte sector at ncols = 1. Below 2^kStagedLogCols columns
// (staged_store) the launch's wrapper (colpass.cu pick_tall,
// fused_fourstep.cu make_steps) takes the staged instantiation
// (run_group_io's kStaged): its last group
// multiplies all its values by the mid vector in that mapping (the mid
// reads stay coalesced, and in flight together) and writes them back to
// the tile, and after one barrier store_moved reads the tile across the
// rows so that consecutive threads write consecutive words of the moved
// array (a warp whole 128-byte lines at TL = 32). The launch's tile then
// XORs each row's columns with the row, (l << lc) mod TL at lc = log2
// ncols (moved_xor): a warp of the group mapping (32 columns of one row at
// TL = 32) and a warp of the store's (32 consecutive words: 2^lc columns
// of 32 / 2^lc rows) each meet 32 banks. Wider arrays take the launch's
// other instantiation, which stores from its last group.
// kStagedLogCols = 1, from readings in turns (H100, PERF.md section 6):
// staged, the BabyBear (1, 2^27) launch took 1.09-1.10 ms against 2.40-2.42
// stored directly, but at 2 and 4 columns the staging costs more than it
// saves (1.08 and 2.14-2.15 ms against 1.00 and 1.91-1.94 at (2, 2^26) and
// (4, 2^26)), so those keep their direct store of 8 and 16 bytes a sector.
// (gl_colpass.cu has its own: 2.)
constexpr int kStagedLogCols = 1;

// Whether a launch (tall: a Tall) of a split phase (group) stages its
// moved store: a DIF phase A's last launch ('lo') over a tall array of
// 2^log_ncols columns, below 2^log_cols (kStagedLogCols; gl_colpass.cu's
// own for its planes).
inline bool staged_store(int tall, bool dit, bool group, int log_ncols,
                         int log_cols = kStagedLogCols) {
  return tall == kTallA && !dit && group && log_ncols < log_cols;
}

// The column XOR of logical row l in a staged launch's tile.
__device__ __forceinline__ int moved_xor(int l, int lc, int log_tl) {
  return (l << lc) & ((1 << log_tl) - 1);
}

// The staged store of a 'lo' phase A launch (see kStagedLogCols) over a
// tall array of 2^lc <= TL columns: the tile holds the launch's values
// after the mid multiply, logical row l, column c at word word_of(l) ^
// moved_xor(l) ^ c. The tile's 2^lc-column groups are its view columns,
// each one run of nn * 2^lc consecutive moved words (rows l, then columns
// c mod 2^lc): thread e of the block takes run e >> (log_nn + lc), place
// e mod 2^(log_nn + lc) in it, and move(run, place, w) stores tile word w
// there.
template <class Move>
__device__ __forceinline__ void store_moved(int log_nn, int log_a,
                                            int log_tl, int shift, int lc,
                                            Move move) {
  const int log_run = log_nn + lc;
#pragma unroll 4
  for (int e = threadIdx.x; e < (1 << (log_nn + log_tl)); e += blockDim.x) {
    const int run = e >> log_run, place = e & ((1 << log_run) - 1);
    const int l = place >> lc;
    move(run, place, word_of(l, log_a, log_nn, log_tl, shift) ^
                         moved_xor(l, lc, log_tl) ^ (run << lc) ^
                         (place & ((1 << lc) - 1)));
  }
}

// What one group of column_tile_io does beyond the tile: load its rows
// from device memory instead of the tile (the network's first group: rows
// where physical and logical rows agree), multiply by the nested mid
// vector (mid: DIF after its stages, the last group of phase 0, on
// physical rows; DIT before them, the first group of phase 1, on logical
// rows), and store its logical rows to device memory as store_tile would
// instead of to the tile (the network's last group; then no barrier
// follows). Where a DIF network's phase 0 is empty (R = 1, column_tile_io's
// kMayEmpty), the mid multiply goes before the stages of phase 1's first
// group instead (mid_swap); the row map is then the identity. Each value
// meets the same operations in the same order as through load_tile,
// mid_step and store_tile, so the bits do not change.
struct GroupEnds {
  const uint32_t* src;  // this batch row's input, or null
  uint32_t* dst;        // this batch row's output, or null
  bool mid, mid_swap;
};

// v[m] *= mid[base + m * 2^log_t] for the 2^K values of one group.
template <int K, class Red>
__device__ __forceinline__ void mid_multiply(uint32_t (&v)[1 << K],
                                             const uint2* mid, int base,
                                             int log_t, Red R) {
#pragma unroll
  for (int m = 0; m < (1 << K); ++m)
    v[m] = R.mulc(v[m], __ldg(mid + base + (m << log_t)));
}

// A group of K stages as run_group does it (DIT when kDit), on the
// swizzled tile, with the ends E. kMayEmpty (DIF): E may hold mid_swap,
// and the stages are written once, between a mid multiply before them and
// one after. kPre (an Operand form): a loading group multiplies each value
// by its 'pre' operand (T.pre, T.pre2) as it reads it from E.src; kPost: a
// storing group multiplies each value by its 'post' operand (T.post,
// T.post2), at the input's index of its logical row, before the kMat
// multiply and canonicalize. Both only under if constexpr, so a kernel
// without them keeps its code, and kMat keeps the code it had as a bool.
// kTall (a Tall): a launch of a tall column's route over the view V (p: a
// 'lo' launch's array of its batch row, else 0), whose operands and stores
// take each element's place in the tall array (tall_cols, phase_row): the
// matrix operands at its index there, the factored and rank-1 ones at its
// tall row and column, phase A's store the mid multiply and the row move,
// phase B's transposed store the tall array's index; a 'hi' launch's
// twiddle by its view column. kGroup: a launch of a split phase (a 'hi' or
// 'lo' group); without it the view's group parts are zero at compile time,
// so PR 19's tall launches keep their code. kL2: the
// loading group reads through L2 only (__ldcg: data that other blocks of
// the same launch wrote, the fused kernel's steps). kStaged: a DIF split
// phase A's 'lo' launch that stages its moved store (kStagedLogCols).
template <int K, bool kDit, bool kTranspose, bool kMat, bool kMayEmpty,
          int kPre, int kPost, int kTall, bool kL2, bool kGroup,
          bool kStaged, class Red>
__device__ __forceinline__ void run_group_io(uint32_t* tile, const Network& N,
                                             const TileOps& O,
                                             const PairTables& T,
                                             const GroupEnds& E, size_t col0,
                                             int s0, int log_a, int shift,
                                             const TallView& V, int p,
                                             Red R) {
  constexpr bool kSplit = kTall == kTallB && kTranspose;
  static_assert(!kStaged || (kTall == kTallA && kGroup && !kDit),
                "the staged store is a DIF split phase A's 'lo' launch's");
  // a split phase's launch: a 'hi' launch's log2 Q; a 'lo' launch's array,
  // its offset in the batch row and its first row
  const int log_hq = kGroup ? V.log_hq : 0;
  const size_t sub = kGroup ? (size_t)p * ((size_t)N.nn * O.ncols) : 0;
  const int row_base = kGroup ? p << N.log_nn : 0;
  const int log_tl = O.log_tl;
  const int t = kDit ? N.t[s0] : N.t[s0 + K - 1];
  const int log_t = __ffs(t) - 1;
  const int tl_mask = (1 << log_tl) - 1;
  const int total = (N.nn >> K) << log_tl;
  int dw[1 << K];
  group_offsets<K>(dw, log_t, log_a, N.log_nn, log_tl, shift);
  // a staged launch's tile: each row's columns XORed (moved_xor) by lc
  [[maybe_unused]] const int lc = T.log_ncols;
  if constexpr (kStaged) {
#pragma unroll
    for (int m = 1; m < (1 << K); ++m)
      dw[m] ^= moved_xor(m << log_t, lc, log_tl);
  }
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    // the tile column c, and the launch's column col0 + cc (a split tile
    // where tall_col0 takes one: a transposing phase B, a 'hi' phase A)
    const int c = kSplit || (kTall == kTallA && log_hq > 0)
                      ? tile_thread(i, log_tl, E.dst, T.log_tlc)
                      : i & tl_mask;
    const auto cc = [&] {
      if constexpr (kSplit)
        return tile_off(c, T.log_ncols, T.log_tlc);
      else if constexpr (kTall == kTallA && kGroup)
        return log_hq > 0 ? tile_off(c, V.log_vc, T.log_tlc) : (size_t)c;
      else
        return c;
    }();
    const int g = i >> log_tl;
    const int j = g & (t - 1);
    const int base = ((g >> log_t) << (log_t + K)) | j;
    int w0 = word_of(base, log_a, N.log_nn, log_tl, shift);
    if constexpr (kStaged)
      w0 ^= moved_xor(base, lc, log_tl) ^ c;
    else
      w0 += c;
    uint32_t v[1 << K];
    if (E.src) {
#pragma unroll
      for (int m = 0; m < (1 << K); ++m) {
        const size_t o = (size_t)(base + (m << log_t)) * O.ncols + col0 + cc;
        if constexpr (kTall != kWhole) {
          uint32_t x;
          if constexpr (kL2)
            x = __ldcg(E.src + o);
          else
            x = E.src[o];
          if constexpr (kPre == kOpMat) {
            x = R.mulc(x, __ldg(T.pre + sub + o));
          } else if constexpr (kPre != kOpNone) {
            const TallCols X = tall_cols<kGroup>(col0 + cc, T, V);
            x = mul_factors<kPre>(
                x, T.pre, T.pre2,
                (int)tall_row(
                    phase_row(base + (m << log_t), row_base, log_hq, X), X,
                    V),
                X.tc, 1 << T.log_ncols, T.log_s, R);
          }
          v[m] = x;
        } else if constexpr (kPre == kOpMat) {
          v[m] = R.mulc(E.src[o], __ldg(T.pre + o));
        } else if constexpr (kPre != kOpNone) {
          v[m] = mul_factors<kPre>(E.src[o], T.pre, T.pre2,
                                   base + (m << log_t), col0 + cc, O.ncols,
                                   T.log_s, R);
        } else {
          v[m] = E.src[o];
        }
      }
    } else {
#pragma unroll
      for (int m = 0; m < (1 << K); ++m) v[m] = tile[w0 ^ dw[m]];
    }
    if constexpr (kTall != kWhole) {  // a plain network: no mid in a group
      // a 'hi' launch's twiddle column (tall_cols' q)
      const int q = kGroup ? (int)((col0 + cc) >> V.log_vc) : 0;
      if constexpr (kDit)
        dit_stages<K, kGroup>(v, N, T.tw, s0, log_t, j, R, log_hq, q);
      else
        dif_stages<K, kGroup>(v, N, T.tw, s0, log_t, j, R, log_hq, q);
    } else if constexpr (kMayEmpty) {  // DIF: mid_swap, the stages, then mid
      if (E.mid_swap) mid_multiply<K>(v, T.mid, base, log_t, R);
      dif_stages<K>(v, N, T.tw, s0, log_t, j, R);
      if (E.mid) mid_multiply<K>(v, T.mid, base, log_t, R);
    } else if (E.mid) {  // DIF: the stages, then mid; DIT: mid, then the stages
      if constexpr (!kDit) dif_stages<K>(v, N, T.tw, s0, log_t, j, R);
      mid_multiply<K>(v, T.mid, base, log_t, R);
      if constexpr (kDit) dit_stages<K>(v, N, T.tw, s0, log_t, j, R);
    } else if constexpr (kDit) {
      dit_stages<K>(v, N, T.tw, s0, log_t, j, R);
    } else {
      dif_stages<K>(v, N, T.tw, s0, log_t, j, R);
    }
    if constexpr (kStaged) {
      if (E.dst) {  // every value's mid multiply, then back to the tile
        const TallCols X = tall_cols<kGroup>(col0 + cc, T, V);
#pragma unroll
        for (int m = 0; m < (1 << K); ++m) {
          const int lp = phase_row(base + (m << log_t), row_base, log_hq, X);
          v[m] = R.mulc(v[m], __ldg(T.mid + tall_row(lp, X, V)));
          if (O.canonicalize) v[m] = R.canon(v[m]);
        }
#pragma unroll
        for (int m = 0; m < (1 << K); ++m) tile[w0 ^ dw[m]] = v[m];
        continue;
      }
    }
    if (E.dst) {
      TallCols X = {};  // the storing thread's column parts (tall_cols)
      if constexpr (kTall != kWhole) X = tall_cols<kGroup>(col0 + cc, T, V);
#pragma unroll
      for (int m = 0; m < (1 << K); ++m) {
        const int l = base + (m << log_t);
        if constexpr (kTall != kWhole) {
          const size_t f = (size_t)l * O.ncols + col0 + cc;
          const int lp = phase_row(l, row_base, log_hq, X);
          uint32_t u = v[m];
          if constexpr (kTall == kTallA)  // the mid multiply, then the move
            u = R.mulc(u, __ldg(T.mid + (kDit ? moved_row(lp, X, V)
                                              : tall_row(lp, X, V))));
          if constexpr (kPost == kOpMat)
            u = R.mulc(u, __ldg(T.post + sub + f));
          else if constexpr (kPost != kOpNone)
            u = mul_factors<kPost>(u, T.post, T.post2,
                                   (int)tall_row(lp, X, V), X.tc,
                                   1 << T.log_ncols, T.log_s, R);
          if constexpr (kTall == kTallA || kSplit) {  // the tall batch row
            const size_t o = tall_store_index<kTranspose, kTall>(lp, X, T, V);
            if constexpr (kMat) u = R.mulc(u, __ldg(T.mat + o));
            if (O.canonicalize) u = R.canon(u);
            (E.dst - sub)[o] = u;
          } else {  // in place
            if (O.canonicalize) u = R.canon(u);
            E.dst[f] = u;
          }
        } else {
          const size_t o = kTranspose ? (col0 + cc) * N.nn + l
                                      : (size_t)l * O.ncols + col0 + cc;
          uint32_t u = v[m];
          if constexpr (kPost == kOpMat)
            u = R.mulc(u, __ldg(T.post + (size_t)l * O.ncols + col0 + cc));
          else if constexpr (kPost != kOpNone)
            u = mul_factors<kPost>(u, T.post, T.post2, l, col0 + cc, O.ncols,
                                   T.log_s, R);
          if constexpr (kMat) u = R.mulc(u, __ldg(T.mat + o));
          if (O.canonicalize) u = R.canon(u);
          E.dst[o] = u;
        }
      }
    } else {
#pragma unroll
      for (int m = 0; m < (1 << K); ++m) tile[w0 ^ dw[m]] = v[m];
    }
  }
  if constexpr (kStaged) {
    if (E.dst) {  // store_moved, after every thread's values
      __syncthreads();
      // the moved word of the tile's first view column's row l = 0 in this
      // batch row of the tall array (tall_store_index), and the distance
      // between two view columns' runs
      uint32_t* dst = E.dst - sub +
                      (((col0 >> lc << V.log_rows) | row_base) << lc);
      const int log_stride = V.log_rows + lc;
      store_moved(N.log_nn, log_a, log_tl, shift, lc,
                  [&](int run, int place, int w) {
                    dst[((size_t)run << log_stride) + place] = tile[w];
                  });
      return;
    }
  }
  if (!E.dst) __syncthreads();
}

// run_group_io for a runtime k <= K stages.
template <int K, bool kDit, bool kTranspose, bool kMat, bool kMayEmpty,
          int kPre, int kPost, int kTall, bool kL2, bool kGroup,
          bool kStaged, class Red>
__device__ __forceinline__ void run_group_io_upto(
    int k, uint32_t* tile, const Network& N, const TileOps& O,
    const PairTables& T, const GroupEnds& E, size_t col0, int s0, int log_a,
    int shift, const TallView& V, int p, Red R) {
  if constexpr (K > 1) {
    if (k < K) {
      run_group_io_upto<K - 1, kDit, kTranspose, kMat, kMayEmpty, kPre,
                        kPost, kTall, kL2, kGroup, kStaged>(
          k, tile, N, O, T, E, col0, s0, log_a, shift, V, p, R);
      return;
    }
  }
  run_group_io<K, kDit, kTranspose, kMat, kMayEmpty, kPre, kPost, kTall, kL2,
               kGroup, kStaged>(tile, N, O, T, E, col0, s0, log_a, shift, V,
                                p, R);
}

// One phase of column_tile_io in groups of min(kFuse, stages left), each
// with its GroupEnds: src on the phase's first group when load_src, dst on
// its last when store_dst, the mid multiply on its last group (DIF) or its
// first (DIT) when mid, mid_swap on its first when mid_swap. An empty
// phase runs no group.
template <int kFuse, bool kDit, bool kTranspose, bool kMat, bool kMayEmpty,
          int kPre, int kPost, int kTall, bool kL2, bool kGroup,
          bool kStaged, class Red>
__device__ __forceinline__ void run_phase_io(
    uint32_t* tile, const Network& N, const TileOps& O, const PairTables& T,
    const uint32_t* src, uint32_t* dst, size_t col0, int s_begin, int s_end,
    int log_a, int shift, bool load_src, bool store_dst, bool mid,
    bool mid_swap, const TallView& V, int p, Red R) {
  for (int s = s_begin; s < s_end;) {
    const int k = min(kFuse, s_end - s);
    const bool first = s == s_begin, last = s + k == s_end;
    const GroupEnds E = {load_src && first ? src : nullptr,
                         store_dst && last ? dst : nullptr,
                         mid && (kDit ? first : last),
                         mid_swap && first};
    run_group_io_upto<kFuse, kDit, kTranspose, kMat, kMayEmpty, kPre, kPost,
                      kTall, kL2, kGroup, kStaged>(k, tile, N, O, T, E, col0,
                                                   s, log_a, shift, V, p, R);
    s += k;
  }
}

// Runs one tile with the whole block in register groups of up to kFuse
// stages (run_phase_io), one barrier a group, on the swizzled tile: the
// network's first group loads from src and its last stores to dst, and the
// nested mid multiply rides in a group (GroupEnds), so no sweep of the tile
// loads, multiplies or stores it. The same bits as
// column_tile<Load::kPlain, kTranspose, kMat>. Output domain: R's, or
// [0, p) with canonicalize. A caller that reuses the tile must
// __syncthreads() first. N has at least one stage (a network of none is
// column_empty's) and is DIT exactly when kDit; shift is tile_shift(N,
// O.log_tl). A nested N has two phases of
// at least one stage each, or, with kMayEmpty (DIF only; nested_colpass.cu's),
// one of them may be empty (k0 = 0 or nstages: R = 1 or R = nn): the
// network's first group loads, its last stores, and with phase 0 empty the
// mid multiply rides before phase 1's first stages. colpass.cu never meets
// an empty phase and leaves kMayEmpty off, so its groups keep the code its
// kernels were timed with (PERF.md): kMayEmpty's group code gives them
// other registers and other times. kPre and kPost (colpass.cu's, not with
// kMayEmpty; Operand forms) add the 'pre' multiply to the loading group and
// the 'post' multiply to the storing group (run_group_io), the reference's
// 'pre' and 'post' operands, its wfac and its rank1: pre on load, before
// the stages; post after them, in the untransposed layout, before the
// 'post_t' (kMat) multiply and canonicalize. kTall (colpass.cu's tall
// route, the fused kernel's tall steps): N is one launch of a tall
// column's route, a plain network, run as Tall says over the view V (p:
// this block's 'lo' array of its batch row), with kTallA taking no 'post'
// operand nor
// store option, kTallB no 'pre' operand, kTallPre neither. kL2: read src
// through L2 only. kGroup: a launch of a split phase (run_group_io).
// kStaged: a DIF split phase A's 'lo' launch staging its moved store
// (kStagedLogCols).
template <bool kDit, bool kTranspose, bool kMat, int kFuse,
          bool kMayEmpty = false, int kPre = kOpNone, int kPost = kOpNone,
          int kTall = kWhole, bool kL2 = false, bool kGroup = false,
          bool kStaged = false, class Red>
__device__ __forceinline__ void column_tile_io(
    uint32_t* tile, const Network& N, const TileOps& O, const PairTables& T,
    const uint32_t* src, uint32_t* dst, size_t col0, int shift, Red R,
    const TallView& V = TallView{}, int p = 0) {
  static_assert(!(kMayEmpty && kDit), "an empty phase is DIF's only");
  static_assert(!(kMayEmpty && (kPre != kOpNone || kPost != kOpNone)),
                "pre and post ride a network with both phases");
  static_assert(!(kMayEmpty && kTall != kWhole), "a tall phase is plain");
  static_assert((kTall != kTallA && kTall != kTallPre) ||
                    (!kTranspose && !kMat && kPost == kOpNone),
                "phase A stores the moved array, or in place");
  static_assert(kTall != kTallB || kPre == kOpNone,
                "phase B loads phase A's output");
  static_assert(!kL2 || kTall != kWhole, "L2 loads are the tall steps'");
  static_assert(kTall == kWhole || !kMat || kTranspose,
                "a tall launch's 'post_t' rides its transposing store");
  const bool nested = N.log_a >= 0;
  // whether phase 0 and phase 1 run a stage (without kMayEmpty both do in
  // a nested network, and a plain one has no phase 1)
  const bool has0 = !kMayEmpty || N.k0 > 0;
  const bool has1 = kMayEmpty ? N.k0 < N.nstages : nested;
  run_phase_io<kFuse, kDit, kTranspose, kMat, kMayEmpty, kPre, kPost, kTall,
               kL2, kGroup, kStaged>(tile, N, O, T, src, dst, col0, 0, N.k0,
                                     -1, shift, true, !has1, nested && !kDit,
                                     false, V, p, R);
  if (has1)
    run_phase_io<kFuse, kDit, kTranspose, kMat, kMayEmpty, kPre, kPost,
                 kTall, kL2, kGroup, kStaged>(
        tile, N, O, T, src, dst, col0, N.k0, N.nstages, N.log_a, shift,
        !has0, true, kDit, !has0, V, p, R);
}

// ---- A column of one row (colpass.cu) ----
//
// A network of zero stages: the split (1, n)'s one-row side (cp1, icp1 and
// their negacyclic twins). Each value meets its pass's operands in the
// reference's order ('pre', 'post', the 'post_t' matrix, canonicalize) and
// nothing else; with one row the transposed output keeps the input's index
// c, and every operand of row 0 is indexed by c (kOpFac: T1[0][c] and
// T2[0][c]; kOpRank1: row[0] and col[c]). The forms are runtime values:
// the launch moves bytes, one multiply or two a value.

// v times the operand of this form in tables a and b at row 0, column c.
template <class Red>
__device__ __forceinline__ uint32_t mul_row0(uint32_t v, int form,
                                             const uint2* a, const uint2* b,
                                             size_t c, Red R) {
  if (form == kOpMat) return R.mulc(v, __ldg(a + c));
  if (form == kOpFac) return R.mulc(R.mulc(v, __ldg(a + c)), __ldg(b + c));
  if (form == kOpRank1) return R.mulc(R.mulc(v, __ldg(a)), __ldg(b + c));
  return v;
}

// One batch row's ncols values (src, dst: that row's input and output) in
// a grid-stride loop over the launch's blocks on grid.x.
template <class Red>
__device__ __forceinline__ void column_empty(const TileOps& O,
                                             const PairTables& T,
                                             int pre_form, int post_form,
                                             const uint32_t* src,
                                             uint32_t* dst, Red R) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t c = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       c < (size_t)O.ncols; c += stride) {
    uint32_t v = mul_row0(src[c], pre_form, T.pre, T.pre2, c, R);
    v = mul_row0(v, post_form, T.post, T.post2, c, R);
    if (T.mat) v = R.mulc(v, __ldg(T.mat + c));
    if (O.canonicalize) v = R.canon(v);
    dst[c] = v;
  }
}

inline int ilog2(int v) {
  int r = 0;
  while ((1 << r) < v) ++r;
  return r;
}

// Fills N from the host-side stage list (ts / offs: nstages half sizes and
// table offsets). Returns false if the list does not fit kMaxStages.
inline bool make_network(Network* N, int nn, int dit, int nstages, int k0,
                         const int* ts, const int* offs, const void* tw_w,
                         const void* tw_s, int log_a, const void* mid_w,
                         const void* mid_s) {
  if (nstages > kMaxStages || k0 > nstages) return false;
  N->tw_w = static_cast<const uint32_t*>(tw_w);
  N->tw_s = static_cast<const uint32_t*>(tw_s);
  N->mid_w = static_cast<const uint32_t*>(mid_w);
  N->mid_s = static_cast<const uint32_t*>(mid_s);
  N->nn = nn;
  N->log_nn = ilog2(nn);
  N->nstages = nstages;
  N->k0 = k0;
  N->log_a = log_a;
  N->dit = dit;
  for (int s = 0; s < kMaxStages; ++s) {
    N->t[s] = s < nstages ? ts[s] : 1;
    N->off[s] = s < nstages ? offs[s] : 0;
  }
  return true;
}

}  // namespace colpass_tile
