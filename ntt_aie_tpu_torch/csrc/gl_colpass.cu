// Goldilocks column-pass NTT kernel for NVIDIA Hopper (sm_90a), and the
// pointwise Goldilocks product between transforms.
//
// Replaces ntt_aie_tpu/ops/pallas_gl.py::build_gl_colpass (the Pallas TPU
// kernel) for the options the Goldilocks four-step plans run
// (ntt_aie_tpu/goldilocks_plan.py:222-270):
//   cp1  = DIF over n1, transpose_out, then the 'post_t' wmat multiply;
//   cp2  = DIF over n2;
//   icp2 = DIT over n2, transpose_out, then the 'post_t' iwmat multiply;
//   icp1 = DIT over n1;
// wmat_fold=False: cp2 = 'pre' wmat, DIF over n2; icp1 = 'pre' iwmat, DIT
// over n1 (cp1 and icp2 without 'post_t');
// wmat_factored=True: cp2 = 'pre' wfac, DIF over n2; icp2 = DIT over n2,
// 'post' wfac^-1 (1/n folded in), transpose_out (colpass_tile.cuh Operand
// kOpFac: T1[c1] then T2[c0] of the row c = c1*S + c0);
// and the distributed plan's passes (parallel/fourstep.py gl_dist_passes,
// ntt_aie_tpu/parallel/fourstep.py:812-846), none with the transpose (the
// transpose is the collective): full-matrix arm lcp1 = DIF over n1, 'post'
// wmat; lcp1n = 'pre' psi, DIF over n1, 'post' wmat; licp1n = 'pre'
// iwmat, DIT over n1, 'post' psi^-1; factored arm licp2 = DIT over n2,
// 'post' wfac^-1; lcp1n = 'pre' rank-1 psi (kOpRank1: row[r] then
// col[c]), DIF over n1; licp1n = DIT over n1, 'post' rank-1 psi^-1.
// pick_kernel instantiates those and no other combination.
// gl_mul_kernel is a helper, not a port of a TPU kernel: the
// reference leaves the pointwise product of polymul to XLA
// (goldilocks_plan.py:462); its second operand may be broadcast over the
// first's leading axes (psi over a batch).
//
// What it computes, per column of two (B, nn, ncols) uint32 planes (hi, lo)
// of values mod p = 2^64 - 2^32 + 1: every butterfly stage of
// ntt_aie_tpu_torch.twiddles.col_network (DIF (u+v, (u-v)*w), DIT
// (u+w*v, u-w*v); a stage of half size t pairs rows (b*2t + j,
// b*2t + t + j) and multiplies by tw[off + j]), with the nested R x S
// network's mid step and row move as colpass_tile.cuh states them. Store:
// optional transpose to (B, ncols, nn), then the elementwise multiply by a
// (ncols, nn)-oriented operand.
//
// Arithmetic (csrc/gl_arith.cuh, shared with the butterfly probe): every
// value stays canonical, [0, p), at every step, so any exact method gives
// the plain PyTorch version's bits.
//
// What bounds it on an H100: integer instructions issued in the SM, ahead
// of device memory. A pass reads and writes the 8 MB of one n = 2^20
// transform once (16 MB, about 5 us per transform at 3.35 TB/s), plus the
// 8 MB wmat of cp1/icp2, shared by the batch and mostly served from the
// 50 MB L2; but the H100 has no 64-bit integer multiplier, so a radix-2
// butterfly is some tens of 32-bit instructions (gl_arith.cuh counts them),
// 5.2 M butterflies per transform and pass. The first design paid on top
// of that for what turns of the 32-bit kernel found binding: a shared-memory
// round trip and a barrier a stage, sweeps of the tile that only loaded,
// multiplied by the mid vector or stored, and a branch on every
// shared-memory address (the nested row map). This design takes
// colpass_tile.cuh column_tile_io's structure onto uint64 values:
//   - one thread block per (batch row, tile of TL consecutive columns),
//     the tile 8,192 values (64 KB) where the column allows it
//     (colpass.tile_cols(itemsize=8)): TL = 8 at nn = 1024, so a row of
//     each plane is one whole 32-byte sector of device memory (TL = 4,
//     32 KB tiles, read 9 % slower for fwd_mat); the largest column is
//     kMaxRows = 8192 rows, in 2-column tiles (128 KB);
//   - register groups of kFuse radix-2 stages: each thread holds the 2^K
//     uint64 values of one radix-2^K butterfly between two exchanges
//     through the tile, one barrier a group instead of one a stage; every
//     K runs each butterfly's operations in the same order, so every K
//     gives the same bits;
//   - the network's first group joins hi and lo from device memory into
//     registers and its last splits and stores them (transposed, with the
//     'post_t' multiply, for cp1 and icp2); the nested mid multiply rides
//     in a group (DIF: after phase 0's last group's stages, physical rows;
//     DIT: before phase 1's first group's, logical rows): no sweep of the
//     tile remains;
//   - the tile is two uint32 planes (hi, then lo), each on the 32-bit
//     kernel's swizzled map (colpass_tile.cuh word_of, shift a kernel
//     parameter), so phase 1's rows land in distinct banks; a group takes
//     its words from one base word and K XOR offsets (group_offsets),
//     computed once a group, with the row map's log_a a constant of the
//     phase instead of a branch a value.
// kFuse = 3 from readings in turns of K = 2 and 3 (PERF.md section 6; at 4
// a thread takes 125-128 registers and a 64-byte stack frame);
// ops.gl_colpass.kernel_info gives its registers and blocks per SM.
// The 'pre' and 'post' operands multiply in the loading and the storing
// group, as the 32-bit kernel's (colpass_tile.cuh run_group_io), under if
// constexpr: the fold plan's instantiations keep their code.
//
// The tall route (colpass.cu states it; colpass_tile.cuh Tall): a column of
// more than 2,048 rows (ops/colpass.py GL_LAUNCH_ROWS; one launch still
// takes kMaxRows, off the plans' path) runs as two launches of its nested
// network's phases, each a plain network over a view of the (nn, ncols)
// planes in which the other factor of nn rides the columns; launch A
// applies 'pre' on load and the mid multiply and the row move on store,
// launch B the rest on store. Goldilocks needs it most: a 16,384-row
// column is 128 KB a column, and a 32,768-row one (n = 2^29, 2^30) 256 KB,
// more than a block's 227 KB of shared memory, so no one-block tile holds
// it; an 8,192-row column's 2-column tile takes 128 KB, one block an SM
// (5.1 / 6.2 ms a pass at GL 2^27 against its route's 3.4 / 2.8 ms), and a
// 4,096-row column's DIT launch in 2-column tiles read 1.7x its route
// (PERF.md section 6); a phase of 64 to 128 rows takes a tile of 32
// columns (16 or 32 KB). A phase of more than 2,048 rows (Goldilocks
// n = 2^24 and up at a split with a side of at most 8) runs as two
// launches split by stage group, as colpass.cu's (colpass_tile.cuh Tall:
// the 'hi' launch's twiddle by its view column, the 'lo' launch's P arrays
// a batch row), and a one-row column (the split (1, n)) as
// gl_colpass_empty_kernel, its operands alone. A DIF split phase A's 'lo'
// launch over one or two tall columns takes the kStaged instantiation
// (colpass_tile::staged_store), which stages its moved store through the
// tile, each plane as colpass.cu states it for uint32 (kStagedLogCols).
//
// A column of 2 to 8 rows (a split with a side of at most 8: n = 2^28 at
// (2, 2^27)) has one group of at most 3 stages, so on the tile a
// 32-column block of 256 threads keeps one warp busy and leaves seven
// idle (8.1 ms a pass at (2, 2^27), 6.4x its bytes). It runs on
// gl_colpass_short_kernel instead: one thread a column, its values in
// registers through every stage, no shared memory and no barrier, the
// loads and the transposed stores whole sectors a warp, so it is bound by
// its bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "colpass_tile.cuh"
#include "gl_arith.cuh"

namespace {

using colpass_tile::group_offsets;
using colpass_tile::kOpFac;
using colpass_tile::kOpMat;
using colpass_tile::kOpNone;
using colpass_tile::kOpRank1;
using colpass_tile::kTallA;
using colpass_tile::kTallB;
using colpass_tile::kTallPre;
using colpass_tile::kWhole;
using colpass_tile::Network;
using colpass_tile::word_of;
using gl_arith::gl_add;
using gl_arith::gl_mul;
using gl_arith::gl_sub;

constexpr int kThreads = 256;
constexpr int kMaxSmemBytes = 227 * 1024;  // an H100 block's limit
constexpr int kMaxRows = 8192;
constexpr int kFuse = 3;  // radix-2 stages a register group (see above)
// The blocks per SM that a 64 KB tile leaves (227 KB / 64 KB), as the
// register budget (at most 85 a thread): with it the DIF kernels take
// 72-78 registers instead of 61-64 and fwd_mat reads 3.8 % faster
// (PERF.md section 6).
constexpr int kMinBlocks = 3;
// log2 of the tall columns of a transposing phase B's tile (colpass.cu's)
constexpr int kTallStoreLogCols = 2;
// The most blocks a batch row of a one-row column's launch takes (grid.x)
constexpr int kEmptyBlocks = 132 * 8;
// A DIF split phase A's 'lo' launch stages its moved store through the
// tile (colpass_tile.cuh store_moved) below 2^kStagedLogCols tall columns:
// staged, Goldilocks (1, 2^27) and (2, 2^27) took 2.04-2.05 and 4.00-4.04
// ms against 4.77-4.78 and 4.99 stored directly, (4, 2^26) 3.99-4.00
// against 3.86-3.87 (in turns on an H100, PERF.md section 6), so 4
// columns and up store directly.
constexpr int kStagedLogCols = 2;
// The tallest column gl_colpass_short_kernel takes (ops/colpass.py
// SHORT_ROWS), and its log2
constexpr int kShortRows = 8;
constexpr int kShortLog = 3;
static_assert(kShortRows == 1 << kShortLog, "kShortLog is log2 kShortRows");

struct Params {
  Network net;          // table pointers null: the kernel reads tw and mid
  const uint64_t* tw;   // stage twiddles, stage s from net.off[s]
  const uint64_t* mid;  // nested wmid (nn,), or null
  const uint64_t* mat;  // post_t operand (ncols, nn), or null
  // 'pre' and 'post' operands in their Operand form's tables (kOpMat: one
  // (nn, ncols) table; kOpFac: T1 (nn/S, ncols) and T2 (S, ncols);
  // kOpRank1: the row vector (nn,) and the column vector (ncols,)), or null
  const uint64_t* pre;
  const uint64_t* pre2;
  const uint64_t* post;
  const uint64_t* post2;
  int log_s;  // kOpFac's split S = 2^log_s
  // A tall phase's view (colpass_tile.cuh Tall): log2 of the factor of the
  // tall nn that rides its columns, and of the tall planes' columns; and
  // log2 of the tall columns a transposing phase B's tile takes
  // (colpass_tile.cuh tile_col0).
  int log_inner, log_ncols, log_tlc;
  const uint32_t* x_hi;
  const uint32_t* x_lo;
  uint32_t* out_hi;
  uint32_t* out_lo;
  int ncols, log_tl;
  int shift;  // the swizzled tile's (colpass_tile::tile_shift)
  // after every field a whole column's kernel reads: a tall launch's view
  // (colpass_tile::TallView's fields), and a one-row column's operand forms
  int log_vc, log_iq, log_hq, log_lp, log_rows, log_tall;
  int pre_form, post_form;
};

// One batch row's planes: the input and the output.
struct Rows {
  const uint32_t* src_hi;
  const uint32_t* src_lo;
  uint32_t* dst_hi;
  uint32_t* dst_lo;
};

// DIF stages s0 .. s0 + K - 1 of one phase on the 2^K values v[m] =
// x[base + m * t_last] of one radix-2^K butterfly, in the order of one
// stage at a time (colpass_tile.cuh dif_stages, on uint64; kCol: a 'hi'
// launch's twiddle at idx * 2^log_hq + tq).
template <int K, bool kCol = false>
__device__ __forceinline__ void dif_stages(uint64_t (&v)[1 << K],
                                           const Network& N,
                                           const uint64_t* tw, int s0,
                                           int log_t, int j, int log_hq = 0,
                                           int tq = 0) {
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int h = 1 << (K - 1 - q);  // the pair's distance in m
    const uint64_t* tw_q = tw + N.off[s0 + q];
#pragma unroll
    for (int m = 0; m < (1 << K); ++m) {
      if (m & h) continue;
      int idx = ((m & (h - 1)) << log_t) | j;
      if constexpr (kCol) idx = (idx << log_hq) | tq;
      const uint64_t a = v[m], b = v[m + h];
      v[m] = gl_add(a, b);
      v[m + h] = gl_mul(gl_sub(a, b), __ldg(tw_q + idx));
    }
  }
}

// DIT stages s0 .. s0 + K - 1 on v[m] = x[base + m * t_first]: the mirror
// (colpass_tile.cuh dit_stages, on uint64; kCol as dif_stages').
template <int K, bool kCol = false>
__device__ __forceinline__ void dit_stages(uint64_t (&v)[1 << K],
                                           const Network& N,
                                           const uint64_t* tw, int s0,
                                           int log_t, int j, int log_hq = 0,
                                           int tq = 0) {
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int h = 1 << q;  // the pair's distance in m
    const uint64_t* tw_q = tw + N.off[s0 + q];
#pragma unroll
    for (int m = 0; m < (1 << K); ++m) {
      if (m & h) continue;
      int idx = ((m & (h - 1)) << log_t) | j;
      if constexpr (kCol) idx = (idx << log_hq) | tq;
      const uint64_t u = v[m];
      const uint64_t wv = gl_mul(v[m + h], __ldg(tw_q + idx));
      v[m] = gl_add(u, wv);
      v[m + h] = gl_sub(u, wv);
    }
  }
}

// v times the kOpMat, kOpFac or kOpRank1 operand in tables a (and b) at
// logical row l, column col of an array of ncols columns
// (colpass_tile.cuh mul_factors, on uint64).
template <int kForm>
__device__ __forceinline__ uint64_t mul_operand(uint64_t v, const Params& P,
                                                const uint64_t* a,
                                                const uint64_t* b, int l,
                                                size_t col, int ncols) {
  static_assert(kForm == kOpMat || kForm == kOpFac || kForm == kOpRank1,
                "a GL kernel form");
  if constexpr (kForm == kOpMat) {
    return gl_mul(v, __ldg(a + (size_t)l * ncols + col));
  } else if constexpr (kForm == kOpRank1) {
    return gl_mul(gl_mul(v, __ldg(a + l)), __ldg(b + col));
  } else {
    v = gl_mul(v, __ldg(a + (size_t)(l >> P.log_s) * ncols + col));
    return gl_mul(v, __ldg(b + (size_t)(l & ((1 << P.log_s) - 1)) * ncols
                           + col));
  }
}

// A tall launch's element's place in the tall planes (colpass_tile.cuh
// TallCols, tall_cols, phase_row, tall_row, moved_row, on these Params):
// the column parts a thread's, the phase's row a value's.
struct TallCols {
  int q, iq;
  size_t tc;
};

template <bool kGroup>
__device__ __forceinline__ TallCols tall_cols(size_t col, const Params& P) {
  const size_t jv = kGroup ? col & (((size_t)1 << P.log_vc) - 1) : col;
  return {kGroup ? (int)(col >> P.log_vc) : 0, (int)(jv >> P.log_ncols),
          jv & (((size_t)1 << P.log_ncols) - 1)};
}

__device__ __forceinline__ int phase_row(int l, int row_base, int log_hq,
                                         const TallCols& X) {
  return ((row_base + l) << log_hq) | X.q;
}

__device__ __forceinline__ unsigned tall_row(int lp, const TallCols& X,
                                             const Params& P) {
  return ((unsigned)lp << P.log_iq) | X.iq;
}

__device__ __forceinline__ unsigned moved_row(int lp, const TallCols& X,
                                              const Params& P) {
  return ((unsigned)X.iq << P.log_rows) | lp;
}

// v times a factored or rank-1 operand (kForm) at a tall launch's
// element's tall row and column.
template <int kForm>
__device__ __forceinline__ uint64_t mul_tall(uint64_t v, const Params& P,
                                             const uint64_t* a,
                                             const uint64_t* b, int lp,
                                             const TallCols& X) {
  return mul_operand<kForm>(v, P, a, b, (int)tall_row(lp, X, P), X.tc,
                            1 << P.log_ncols);
}

// The output word of a whole column's element (l, col): its own index
// (transposed: (col, l) of (ncols, nn)).
template <bool kTranspose>
__device__ __forceinline__ size_t store_index(int l, size_t col,
                                              const Params& P) {
  return kTranspose ? col * P.net.nn + l : (size_t)l * P.ncols + col;
}

// The output word of a tall launch's element that its store moves
// (kTallA) or transposes (kTallB with the transpose), in its batch row of
// the tall planes (colpass_tile.cuh tall_store_index).
template <bool kTranspose, int kTall>
__device__ __forceinline__ size_t tall_store_index(int lp, const TallCols& X,
                                                   const Params& P) {
  if constexpr (kTall == kTallA)
    return ((size_t)moved_row(lp, X, P) << P.log_ncols) | X.tc;
  else
    return (X.tc << P.log_tall) + tall_row(lp, X, P);
}

// What one group does beyond the tile (colpass_tile.cuh GroupEnds): load
// its rows from device memory (the network's first group), multiply by the
// mid vector (DIF after the stages, DIT before them), store its logical
// rows to device memory (the network's last group; no barrier follows).
struct Ends {
  bool load, mid, store;
};

// A group of K stages on the swizzled two-plane tile, with the ends E.
// log_a: the phase's row map (-1 for phase 0). kPre, kPost: Operand forms,
// multiplied as the loading group reads a value and before the storing
// group's kMat multiply. kTall: a phase of a tall column (colpass_tile.cuh
// Tall): phase A's store multiplies by the mid vector (DIF at the row the
// value leaves, DIT at the row it reaches) and moves the row; kGroup: a
// launch of a split phase; kStaged: a DIF split phase A's 'lo' launch that
// stages its moved store through each plane of the tile (kStagedLogCols)
// (colpass_tile.cuh run_group_io's).
template <int K, bool kDit, bool kTranspose, bool kMat, int kPre, int kPost,
          int kTall, bool kGroup, bool kStaged>
__device__ __forceinline__ void run_group(uint32_t* tile, const Params& P,
                                          const Rows& R, const Ends E,
                                          size_t col0, int s0, int log_a,
                                          int p) {
  constexpr bool kSplit = kTall == kTallB && kTranspose;
  static_assert(!kStaged || (kTall == kTallA && kGroup && !kDit),
                "the staged store is a DIF split phase A's 'lo' launch's");
  // a split phase's launch: a 'hi' launch's log2 Q; a 'lo' launch's array
  // p, its offset in the batch row and its first row
  const int log_hq = kGroup ? P.log_hq : 0;
  const size_t sub = kGroup ? (size_t)p * ((size_t)P.net.nn * P.ncols) : 0;
  const int row_base = kGroup ? p << P.net.log_nn : 0;
  const Network& N = P.net;
  const int log_tl = P.log_tl;
  const int t = kDit ? N.t[s0] : N.t[s0 + K - 1];
  const int log_t = __ffs(t) - 1;
  const int tl_mask = (1 << log_tl) - 1;
  const int total = (N.nn >> K) << log_tl;
  uint32_t* tile_lo = tile + (N.nn << log_tl);
  int dw[1 << K];
  group_offsets<K>(dw, log_t, log_a, N.log_nn, log_tl, P.shift);
  // a staged launch's tile: each row's columns XORed (moved_xor) by lc
  [[maybe_unused]] const int lc = P.log_ncols;
  if constexpr (kStaged) {
#pragma unroll
    for (int m = 1; m < (1 << K); ++m)
      dw[m] ^= colpass_tile::moved_xor(m << log_t, lc, log_tl);
  }
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    // the tile column c, and the launch's column col0 + cc
    const int c = kSplit || (kTall == kTallA && log_hq > 0)
                      ? colpass_tile::tile_thread(i, log_tl, E.store,
                                                  P.log_tlc)
                      : i & tl_mask;
    const auto cc = [&] {
      if constexpr (kSplit)
        return colpass_tile::tile_off(c, P.log_ncols, P.log_tlc);
      else if constexpr (kTall == kTallA && kGroup)
        return log_hq > 0 ? colpass_tile::tile_off(c, P.log_vc, P.log_tlc)
                          : (size_t)c;
      else
        return c;
    }();
    const int g = i >> log_tl;
    const int j = g & (t - 1);
    const int base = ((g >> log_t) << (log_t + K)) | j;
    int w0 = word_of(base, log_a, N.log_nn, log_tl, P.shift);
    if constexpr (kStaged)
      w0 ^= colpass_tile::moved_xor(base, lc, log_tl) ^ c;
    else
      w0 += c;
    uint64_t v[1 << K];
    if (E.load) {
#pragma unroll
      for (int m = 0; m < (1 << K); ++m) {
        const size_t o = (size_t)(base + (m << log_t)) * P.ncols + col0 + cc;
        v[m] = ((uint64_t)R.src_hi[o] << 32) | R.src_lo[o];
        if constexpr (kPre == kOpMat && kTall != kWhole)
          v[m] = gl_mul(v[m], __ldg(P.pre + sub + o));
        else if constexpr (kPre != kOpNone && kTall != kWhole)
          v[m] = mul_tall<kPre>(
              v[m], P, P.pre, P.pre2,
              phase_row(base + (m << log_t), row_base, log_hq,
                        tall_cols<kGroup>(col0 + cc, P)),
              tall_cols<kGroup>(col0 + cc, P));
        else if constexpr (kPre != kOpNone)
          v[m] = mul_operand<kPre>(v[m], P, P.pre, P.pre2,
                                   base + (m << log_t), col0 + cc, P.ncols);
      }
    } else {
#pragma unroll
      for (int m = 0; m < (1 << K); ++m)
        v[m] = ((uint64_t)tile[w0 ^ dw[m]] << 32) | tile_lo[w0 ^ dw[m]];
    }
    if constexpr (kTall != kWhole) {  // a plain network: no mid in a group
      // a 'hi' launch's twiddle column (tall_cols' q)
      const int q = kGroup ? (int)((col0 + cc) >> P.log_vc) : 0;
      if constexpr (kDit)
        dit_stages<K, kGroup>(v, N, P.tw, s0, log_t, j, log_hq, q);
      else
        dif_stages<K, kGroup>(v, N, P.tw, s0, log_t, j, log_hq, q);
    } else if (E.mid) {  // DIF: the stages, then mid; DIT: mid, the stages
      if constexpr (!kDit) dif_stages<K>(v, N, P.tw, s0, log_t, j);
#pragma unroll
      for (int m = 0; m < (1 << K); ++m)
        v[m] = gl_mul(v[m], __ldg(P.mid + base + (m << log_t)));
      if constexpr (kDit) dit_stages<K>(v, N, P.tw, s0, log_t, j);
    } else if constexpr (kDit) {
      dit_stages<K>(v, N, P.tw, s0, log_t, j);
    } else {
      dif_stages<K>(v, N, P.tw, s0, log_t, j);
    }
    if constexpr (kStaged) {
      if (E.store) {  // every value's mid multiply, then back to the tile
        const TallCols X = tall_cols<kGroup>(col0 + cc, P);
#pragma unroll
        for (int m = 0; m < (1 << K); ++m) {
          const int lp = phase_row(base + (m << log_t), row_base, log_hq, X);
          v[m] = gl_mul(v[m], __ldg(P.mid + tall_row(lp, X, P)));
        }
#pragma unroll
        for (int m = 0; m < (1 << K); ++m) {
          tile[w0 ^ dw[m]] = (uint32_t)(v[m] >> 32);
          tile_lo[w0 ^ dw[m]] = (uint32_t)v[m];
        }
        continue;
      }
    }
    if (E.store) {
      TallCols X = {};  // the storing thread's column parts (tall_cols)
      if constexpr (kTall != kWhole) X = tall_cols<kGroup>(col0 + cc, P);
#pragma unroll
      for (int m = 0; m < (1 << K); ++m) {
        const int l = base + (m << log_t);
        if constexpr (kTall != kWhole) {
          const size_t f = (size_t)l * P.ncols + col0 + cc;
          const int lp = phase_row(l, row_base, log_hq, X);
          uint64_t u = v[m];
          if constexpr (kTall == kTallA)  // the mid multiply, then the move
            u = gl_mul(u, __ldg(P.mid + (kDit ? moved_row(lp, X, P)
                                              : tall_row(lp, X, P))));
          if constexpr (kPost == kOpMat)
            u = gl_mul(u, __ldg(P.post + sub + f));
          else if constexpr (kPost != kOpNone)
            u = mul_tall<kPost>(u, P, P.post, P.post2, lp, X);
          if constexpr (kTall == kTallA || kSplit) {  // the tall batch row
            const size_t o = tall_store_index<kTranspose, kTall>(lp, X, P);
            if constexpr (kMat) u = gl_mul(u, __ldg(P.mat + o));
            (R.dst_hi - sub)[o] = (uint32_t)(u >> 32);
            (R.dst_lo - sub)[o] = (uint32_t)u;
          } else {  // in place
            R.dst_hi[f] = (uint32_t)(u >> 32);
            R.dst_lo[f] = (uint32_t)u;
          }
        } else {
          const size_t o = store_index<kTranspose>(l, col0 + cc, P);
          uint64_t u = v[m];
          if constexpr (kPost != kOpNone)
            u = mul_operand<kPost>(u, P, P.post, P.post2, l, col0 + cc,
                                   P.ncols);
          if constexpr (kMat) u = gl_mul(u, __ldg(P.mat + o));
          R.dst_hi[o] = (uint32_t)(u >> 32);
          R.dst_lo[o] = (uint32_t)u;
        }
      }
    } else {
#pragma unroll
      for (int m = 0; m < (1 << K); ++m) {
        tile[w0 ^ dw[m]] = (uint32_t)(v[m] >> 32);
        tile_lo[w0 ^ dw[m]] = (uint32_t)v[m];
      }
    }
  }
  if constexpr (kStaged) {
    if (E.store) {  // store_moved, after every thread's values
      __syncthreads();
      // the moved word of the tile's first view column's row l = 0 in this
      // batch row of the planes (tall_store_index), and the distance
      // between two view columns' runs
      const size_t o0 = ((col0 >> lc << P.log_rows) | row_base) << lc;
      uint32_t* dst_hi = R.dst_hi - sub + o0;
      uint32_t* dst_lo = R.dst_lo - sub + o0;
      const int log_stride = P.log_rows + lc;
      colpass_tile::store_moved(
          N.log_nn, log_a, log_tl, P.shift, lc,
          [&](int run, int place, int w) {
            const size_t o = ((size_t)run << log_stride) + place;
            dst_hi[o] = tile[w];
            dst_lo[o] = tile_lo[w];
          });
      return;
    }
  }
  if (!E.store) __syncthreads();
}

// run_group for a runtime k <= K stages.
template <int K, bool kDit, bool kTranspose, bool kMat, int kPre, int kPost,
          int kTall, bool kGroup, bool kStaged>
__device__ __forceinline__ void run_group_upto(int k, uint32_t* tile,
                                               const Params& P,
                                               const Rows& R, const Ends E,
                                               size_t col0, int s0,
                                               int log_a, int p) {
  if constexpr (K > 1) {
    if (k < K) {
      run_group_upto<K - 1, kDit, kTranspose, kMat, kPre, kPost, kTall,
                     kGroup, kStaged>(k, tile, P, R, E, col0, s0, log_a, p);
      return;
    }
  }
  run_group<K, kDit, kTranspose, kMat, kPre, kPost, kTall, kGroup, kStaged>(
      tile, P, R, E, col0, s0, log_a, p);
}

// Stages [s_begin, s_end) of one phase in groups of min(kFuse, stages
// left): the first loads when load, the last stores when store, and the
// mid multiply rides on the last (DIF) or the first (DIT) when mid.
template <bool kDit, bool kTranspose, bool kMat, int kPre, int kPost,
          int kTall, bool kGroup, bool kStaged>
__device__ __forceinline__ void run_phase(uint32_t* tile, const Params& P,
                                          const Rows& R, size_t col0,
                                          int s_begin, int s_end, int log_a,
                                          bool load, bool store, bool mid,
                                          int p) {
  for (int s = s_begin; s < s_end;) {
    const int k = min(kFuse, s_end - s);
    const bool first = s == s_begin, last = s + k == s_end;
    const Ends E = {load && first, mid && (kDit ? first : last),
                    store && last};
    run_group_upto<kFuse, kDit, kTranspose, kMat, kPre, kPost, kTall,
                   kGroup, kStaged>(k, tile, P, R, E, col0, s, log_a, p);
    s += k;
  }
}

// One thread block per (batch row, tile of TL columns). A nested network
// has two phases of at least one stage each; a plain one, one phase (a
// launch of a tall column's route under kTall: a 'lo' launch's block
// takes array p = blockIdx.y mod P of its batch row; kStaged: run_group's).
template <bool kDit, bool kTranspose, bool kMat, int kPre = kOpNone,
          int kPost = kOpNone, int kTall = kWhole, bool kGroup = false,
          bool kStaged = false>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gl_colpass_kernel(const Params P) {
  static_assert((kTall != kTallA && kTall != kTallPre) ||
                    (!kTranspose && !kMat && kPost == kOpNone),
                "phase A stores the moved planes, or in place");
  static_assert(kTall != kTallB || kPre == kOpNone,
                "phase B loads phase A's output");
  extern __shared__ uint32_t tile[];
  const size_t plane = (size_t)P.net.nn * P.ncols;
  const size_t row = (size_t)blockIdx.y * plane;
  const Rows R = {P.x_hi + row, P.x_lo + row, P.out_hi + row,
                  P.out_lo + row};
  size_t col0;  // a split tile (colpass_tile.cuh tall_col0) where it takes one
  if constexpr (kTall == kTallA && kGroup)
    col0 = P.log_hq > 0
               ? colpass_tile::tile_col0<true>(blockIdx.x, P.log_tl, P.log_hq,
                                               P.log_vc, P.log_tlc)
               : colpass_tile::tile_col0<false>(blockIdx.x, P.log_tl, 0, 0,
                                                0);
  else
    col0 = colpass_tile::tile_col0<kTall == kTallB && kTranspose>(
        blockIdx.x, P.log_tl, P.log_inner, P.log_ncols, P.log_tlc);
  const bool nested = P.net.log_a >= 0;
  int p = 0;  // a 'lo' launch's array p of its batch row: row b * P + p
  if constexpr (kGroup) p = (int)(blockIdx.y & ((1u << P.log_lp) - 1));
  run_phase<kDit, kTranspose, kMat, kPre, kPost, kTall, kGroup, kStaged>(
      tile, P, R, col0, 0, P.net.k0, -1, true, !nested, nested && !kDit, p);
  if (nested)
    run_phase<kDit, kTranspose, kMat, kPre, kPost, kTall, kGroup, kStaged>(
        tile, P, R, col0, P.net.k0, P.net.nstages, P.net.log_a, false, true,
        kDit, p);
}

// v times the operand of this form in tables a and b at row 0, column c
// (colpass_tile.cuh mul_row0, on uint64).
__device__ __forceinline__ uint64_t mul_row0(uint64_t v, int form,
                                             const uint64_t* a,
                                             const uint64_t* b, size_t c) {
  if (form == kOpMat) return gl_mul(v, __ldg(a + c));
  if (form == kOpFac) return gl_mul(gl_mul(v, __ldg(a + c)), __ldg(b + c));
  if (form == kOpRank1) return gl_mul(gl_mul(v, __ldg(a)), __ldg(b + c));
  return v;
}

// A one-row column's pass (colpass_tile.cuh column_empty on uint64): each
// value times its 'pre', 'post' and 'post_t' operands, blocks on grid.x
// over the row's columns, batch rows on grid.y; no shared memory.
__global__ void __launch_bounds__(kThreads) gl_colpass_empty_kernel(
    const Params P) {
  const size_t row = (size_t)blockIdx.y * P.ncols;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t c = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       c < (size_t)P.ncols; c += stride) {
    uint64_t v = ((uint64_t)P.x_hi[row + c] << 32) | P.x_lo[row + c];
    v = mul_row0(v, P.pre_form, P.pre, P.pre2, c);
    v = mul_row0(v, P.post_form, P.post, P.post2, c);
    if (P.mat) v = gl_mul(v, __ldg(P.mat + c));
    P.out_hi[row + c] = (uint32_t)(v >> 32);
    P.out_lo[row + c] = (uint32_t)v;
  }
}

// A column's 2^K values, stored as one run of each plane from hi and lo
// (a transposed store's (col, 0) of (ncols, 2^K)): one 8-byte vector a
// plane at K = 1, 16-byte ones above.
template <int K>
__device__ __forceinline__ void store_run(uint32_t* hi, uint32_t* lo,
                                          const uint64_t (&v)[1 << K]) {
  if constexpr (K == 1) {
    *reinterpret_cast<uint2*>(hi) =
        make_uint2((uint32_t)(v[0] >> 32), (uint32_t)(v[1] >> 32));
    *reinterpret_cast<uint2*>(lo) = make_uint2((uint32_t)v[0], (uint32_t)v[1]);
  } else {
#pragma unroll
    for (int q = 0; q < (1 << K); q += 4) {
      *reinterpret_cast<uint4*>(hi + q) =
          make_uint4((uint32_t)(v[q] >> 32), (uint32_t)(v[q + 1] >> 32),
                     (uint32_t)(v[q + 2] >> 32), (uint32_t)(v[q + 3] >> 32));
      *reinterpret_cast<uint4*>(lo + q) =
          make_uint4((uint32_t)v[q], (uint32_t)v[q + 1], (uint32_t)v[q + 2],
                     (uint32_t)v[q + 3]);
    }
  }
}

// A whole column of 2^K rows, 2 <= 2^K <= kShortRows (ops/colpass.py
// SHORT_ROWS): on the tile, such a column leaves 7 of a block's 8 warps
// idle (a 32-column tile holds 32 * 2^K values for 256 threads; its one
// group of K stages takes 32 of them). Here one thread holds one (batch
// row, column)'s 2^K values in registers as uint64 from its load through
// every stage to its store; no shared memory and no barrier. Blocks on
// grid.x stride over the batch row's columns, as gl_colpass_empty_kernel's
// (as many as are resident at once: short_grid), batch rows on grid.y. A
// warp's load of a row is 32 consecutive words of each plane (and of each
// 'pre' table's row); the operands apply in the tile kernel's order ('pre'
// on load, the stages (dif_stages or dit_stages over the whole column),
// then 'post', the transpose, 'post_t'), every value canonical, so its bits
// are gl_colpass_plain's. Transposed, a column's 2^K values are one run a
// plane (store_run), a warp's 32 runs adjacent, and its 'post_t' operands
// one run of 16-byte loads.
template <int K, bool kDit, bool kTranspose, bool kMat, int kPre = kOpNone,
          int kPost = kOpNone>
__global__ void __launch_bounds__(kThreads) gl_colpass_short_kernel(
    const Params P) {
  static_assert(K >= 1 && K <= kShortLog, "a short column");
  constexpr int kRows = 1 << K;
  const size_t row = (size_t)blockIdx.y * ((size_t)P.ncols << K);
  const uint32_t* x_hi = P.x_hi + row;
  const uint32_t* x_lo = P.x_lo + row;
  uint32_t* out_hi = P.out_hi + row;
  uint32_t* out_lo = P.out_lo + row;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t c = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       c < (size_t)P.ncols; c += stride) {
    uint64_t v[kRows];
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const size_t o = (size_t)m * P.ncols + c;
      v[m] = ((uint64_t)x_hi[o] << 32) | x_lo[o];
      if constexpr (kPre != kOpNone)
        v[m] = mul_operand<kPre>(v[m], P, P.pre, P.pre2, m, c, P.ncols);
    }
    if constexpr (kDit)
      dit_stages<K>(v, P.net, P.tw, 0, 0, 0);
    else
      dif_stages<K>(v, P.net, P.tw, 0, 0, 0);
    if constexpr (kPost != kOpNone) {
#pragma unroll
      for (int m = 0; m < kRows; ++m)
        v[m] = mul_operand<kPost>(v[m], P, P.post, P.post2, m, c, P.ncols);
    }
    if constexpr (kTranspose) {
      const size_t o = c << K;  // (c, 0) of (ncols, 2^K)
      if constexpr (kMat) {
        const ulonglong2* mat = reinterpret_cast<const ulonglong2*>(P.mat + o);
#pragma unroll
        for (int q = 0; q < kRows / 2; ++q) {
          const ulonglong2 w = __ldg(mat + q);
          v[2 * q] = gl_mul(v[2 * q], w.x);
          v[2 * q + 1] = gl_mul(v[2 * q + 1], w.y);
        }
      }
      store_run<K>(out_hi + o, out_lo + o, v);
    } else {
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        const size_t o = (size_t)m * P.ncols + c;
        out_hi[o] = (uint32_t)(v[m] >> 32);
        out_lo[o] = (uint32_t)v[m];
      }
    }
  }
}

using KernelFn = void (*)(Params);

// The whole-column kernels of one family, by their options: the tile
// kernel's, and the short kernel's of 2^K-row columns.
struct TileKernels {
  template <bool kDit, bool kTranspose, bool kMat, int kPre, int kPost>
  static KernelFn get() {
    return gl_colpass_kernel<kDit, kTranspose, kMat, kPre, kPost>;
  }
};

template <int K>
struct ShortKernels {
  template <bool kDit, bool kTranspose, bool kMat, int kPre, int kPost>
  static KernelFn get() {
    return gl_colpass_short_kernel<K, kDit, kTranspose, kMat, kPre, kPost>;
  }
};

template <class Ks, bool kDit>
KernelFn pick_kernel(bool transpose_out, bool mat) {
  return !transpose_out
             ? Ks::template get<kDit, false, false, kOpNone, kOpNone>()
             : (mat ? Ks::template get<kDit, true, true, kOpNone, kOpNone>()
                    : Ks::template get<kDit, true, false, kOpNone, kOpNone>());
}

// The instantiation of family Ks for this direction, these store options
// (mat only with transpose_out) and these operands (pre, post: Operand
// forms), or null for a combination no plan runs (see the top).
template <class Ks>
KernelFn pick_kernel(bool dit, bool transpose_out, bool mat, int pre,
                     int post) {
  if (pre == kOpNone && post == kOpNone)
    return dit ? pick_kernel<Ks, true>(transpose_out, mat)
               : pick_kernel<Ks, false>(transpose_out, mat);
  if (mat) return nullptr;
  if (!transpose_out && post == kOpNone) {  // the entry arm, factored cp2
    if (pre == kOpMat)
      return dit ? Ks::template get<true, false, false, kOpMat, kOpNone>()
                 : Ks::template get<false, false, false, kOpMat, kOpNone>();
    if (pre == kOpFac && !dit)
      return Ks::template get<false, false, false, kOpFac, kOpNone>();
    if (pre == kOpRank1 && !dit)  // distributed factored lcp1n
      return Ks::template get<false, false, false, kOpRank1, kOpNone>();
  }
  if (dit && transpose_out && pre == kOpNone && post == kOpFac)  // icp2
    return Ks::template get<true, true, false, kOpNone, kOpFac>();
  if (transpose_out) return nullptr;
  // the distributed plan's passes with a 'post' operand
  if (!dit && post == kOpMat) {  // full-matrix lcp1, lcp1n
    if (pre == kOpNone)
      return Ks::template get<false, false, false, kOpNone, kOpMat>();
    if (pre == kOpMat)
      return Ks::template get<false, false, false, kOpMat, kOpMat>();
  }
  if (dit && pre == kOpMat && post == kOpMat)  // full-matrix licp1n
    return Ks::template get<true, false, false, kOpMat, kOpMat>();
  if (dit && pre == kOpNone) {  // factored licp2, licp1n
    if (post == kOpFac)
      return Ks::template get<true, false, false, kOpNone, kOpFac>();
    if (post == kOpRank1)
      return Ks::template get<true, false, false, kOpNone, kOpRank1>();
  }
  return nullptr;
}

// The short kernel of a 2^k-row column (1 <= k <= K), or null.
template <int K>
KernelFn pick_short(int k, bool dit, bool transpose_out, bool mat, int pre,
                    int post) {
  if constexpr (K > 1) {
    if (k < K)
      return pick_short<K - 1>(k, dit, transpose_out, mat, pre, post);
  }
  return k == K ? pick_kernel<ShortKernels<K>>(dit, transpose_out, mat, pre,
                                               post)
                : nullptr;
}

// The tall route's launch `tall` (kTallA, kTallB or kTallPre) of these
// options, the launch's own (ops/colpass.py launch_plan), or null; as
// colpass.cu's pick_tall (kG: a launch of a split phase; staged: a DIF
// split phase A's 'lo' launch that stages its moved store).
template <bool kG>
KernelFn pick_tall(int tall, bool dit, bool transpose_out, bool mat, int pre,
                   int post, bool staged) {
  if (tall == kTallA || tall == kTallPre) {
    if (transpose_out || mat || post != kOpNone) return nullptr;
    if (tall == kTallPre) {  // a split phase A's first launch only
      if constexpr (!kG) return nullptr;
      if (dit)
        return pre == kOpMat ? gl_colpass_kernel<true, false, false, kOpMat,
                                                 kOpNone, kTallPre, kG>
                             : nullptr;
      switch (pre) {
        case kOpMat:
          return gl_colpass_kernel<false, false, false, kOpMat, kOpNone,
                                   kTallPre, kG>;
        case kOpFac:
          return gl_colpass_kernel<false, false, false, kOpFac, kOpNone,
                                   kTallPre, kG>;
        case kOpRank1:
          return gl_colpass_kernel<false, false, false, kOpRank1, kOpNone,
                                   kTallPre, kG>;
      }
      return nullptr;
    }
    if (dit) {
      if (pre == kOpNone)
        return gl_colpass_kernel<true, false, false, kOpNone, kOpNone, kTallA,
                                 kG>;
      if (pre == kOpMat)
        return gl_colpass_kernel<true, false, false, kOpMat, kOpNone, kTallA,
                                 kG>;
      return nullptr;
    }
    switch (pre) {
      case kOpNone:
        if constexpr (kG) {
          if (staged)
            return gl_colpass_kernel<false, false, false, kOpNone, kOpNone,
                                     kTallA, kG, true>;
        }
        return gl_colpass_kernel<false, false, false, kOpNone, kOpNone,
                                 kTallA, kG>;
      case kOpMat:
        return gl_colpass_kernel<false, false, false, kOpMat, kOpNone, kTallA,
                                 kG>;
      case kOpFac:
        return gl_colpass_kernel<false, false, false, kOpFac, kOpNone, kTallA,
                                 kG>;
      case kOpRank1:
        return gl_colpass_kernel<false, false, false, kOpRank1, kOpNone,
                                 kTallA, kG>;
    }
    return nullptr;
  }
  if (tall != kTallB || pre != kOpNone || (mat && !transpose_out))
    return nullptr;
  if (post == kOpNone) {
    if (dit)
      return !transpose_out ? gl_colpass_kernel<true, false, false, kOpNone,
                                                kOpNone, kTallB, kG>
             : mat ? gl_colpass_kernel<true, true, true, kOpNone, kOpNone,
                                       kTallB, kG>
                   : gl_colpass_kernel<true, true, false, kOpNone, kOpNone,
                                       kTallB, kG>;
    return !transpose_out ? gl_colpass_kernel<false, false, false, kOpNone,
                                              kOpNone, kTallB, kG>
           : mat ? gl_colpass_kernel<false, true, true, kOpNone, kOpNone,
                                     kTallB, kG>
                 : gl_colpass_kernel<false, true, false, kOpNone, kOpNone,
                                     kTallB, kG>;
  }
  if (mat) return nullptr;
  if (post == kOpMat && !transpose_out)  // distributed lcp1, lcp1n, licp1n
    return dit ? gl_colpass_kernel<true, false, false, kOpNone, kOpMat, kTallB,
                                   kG>
               : gl_colpass_kernel<false, false, false, kOpNone, kOpMat,
                                   kTallB, kG>;
  if (post == kOpRank1 && dit && !transpose_out)  // distributed licp1n
    return gl_colpass_kernel<true, false, false, kOpNone, kOpRank1, kTallB,
                             kG>;
  if (post == kOpFac && dit)  // the factored arm's icp2; distributed licp2
    return transpose_out
               ? gl_colpass_kernel<true, true, false, kOpNone, kOpFac, kTallB,
                                   kG>
               : gl_colpass_kernel<true, false, false, kOpNone, kOpFac,
                                   kTallB, kG>;
  return nullptr;
}

// The kernel of a launch: a one-row column's (nn = 1)
// gl_colpass_empty_kernel, the short kernel for a whole column of at most
// kShortRows rows where the launch asks for it (short_col), pick_kernel for
// a whole column (tall = kWhole), pick_tall for a launch of a tall one.
KernelFn pick(int tall, bool dit, bool transpose_out, bool mat, int pre,
              int post, int nn, bool group, bool staged, bool short_col) {
  if (short_col)
    return tall == kWhole && nn > 1 && nn <= kShortRows
               ? pick_short<kShortLog>(colpass_tile::ilog2(nn), dit,
                                       transpose_out, mat, pre, post)
               : nullptr;
  if (nn == 1)
    return tall == kWhole &&
                   pick_kernel<TileKernels>(dit, transpose_out, mat, pre,
                                            post)
               ? gl_colpass_empty_kernel
               : nullptr;
  if (tall == kWhole)
    return pick_kernel<TileKernels>(dit, transpose_out, mat, pre, post);
  return group ? pick_tall<true>(tall, dit, transpose_out, mat, pre, post,
                                 staged)
               : pick_tall<false>(tall, dit, transpose_out, mat, pre, post,
                                  false);
}

// Opts kernel in to smem dynamic bytes above 48 KB.
cudaError_t allow_smem(KernelFn kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// o = a * b over n elements; with kBroadcast b has nb elements, b[i mod
// nb] (a mask where nb is a power of two).
template <bool kBroadcast>
__global__ void __launch_bounds__(kThreads) gl_mul_kernel(
    const uint32_t* __restrict__ ah, const uint32_t* __restrict__ al,
    const uint32_t* __restrict__ bh, const uint32_t* __restrict__ bl,
    uint32_t* __restrict__ oh, uint32_t* __restrict__ ol, size_t n,
    size_t nb) {
  const bool pow2 = (nb & (nb - 1)) == 0;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    size_t j = i;
    if constexpr (kBroadcast) j = pow2 ? i & (nb - 1) : i % nb;
    const uint64_t r = gl_mul(((uint64_t)ah[i] << 32) | al[i],
                              ((uint64_t)bh[j] << 32) | bl[j]);
    oh[i] = (uint32_t)(r >> 32);
    ol[i] = (uint32_t)r;
  }
}

// Whether a short launch (ntt_gl_colpass's short_col) has what
// gl_colpass_short_kernel takes: a whole column of 2 to kShortRows rows,
// log_tl 0, the plain network's stages in order (DIF half sizes nn/2 ..
// 1, DIT 1 .. nn/2), and the output planes and 'post_t' table aligned for
// its vector stores and loads (the wrapper's fresh outputs are).
bool short_ok(int nn, int log_tl, int dit, int nstages, const int* ts,
              int log_a, int tall, const void* out_hi, const void* out_lo,
              const void* mat) {
  if (nn < 2 || nn > kShortRows || log_tl != 0 || log_a >= 0 ||
      tall != kWhole || nstages != colpass_tile::ilog2(nn))
    return false;
  for (int s = 0; s < nstages; ++s)
    if (ts[s] != (dit ? 1 << s : nn >> (s + 1))) return false;
  const uintptr_t run = nn == 2 ? 8 : 16;
  return (reinterpret_cast<uintptr_t>(out_hi) % run) == 0 &&
         (reinterpret_cast<uintptr_t>(out_lo) % run) == 0 &&
         (reinterpret_cast<uintptr_t>(mat) % 16) == 0;
}

// The blocks of a batch row of a short launch (grid.x): enough for its
// columns, at most as many as the card holds at once.
cudaError_t short_grid(KernelFn kernel, int ncols, int* blocks) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  const int need = (ncols + kThreads - 1) / kThreads;
  const int most = sms * per_sm > 0 ? sms * per_sm : 1;
  *blocks = need < most ? need : most;
  return err;
}

}  // namespace

extern "C" {

int ntt_gl_colpass_max_rows() { return kMaxRows; }

int ntt_gl_colpass_short_rows() { return kShortRows; }

const char* ntt_gl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// This build's register group size, and for the kernel of this direction,
// these store options and these operands (pre, post: Operand forms), of a
// whole column or one launch of a tall one (tall: colpass_tile::Tall;
// group: 0, or for a launch of a split phase 1 + log2 of the tall planes'
// columns, which colpass_tile::staged_store reads at kStagedLogCols;
// short_col: the short kernel's), at an nn x 2^log_tl tile (a launch's
// rows): its registers a thread and its co-resident blocks per SM.
// Returns 0 or a cudaError_t.
int ntt_gl_colpass_kernel_info(int short_col, int tall, int group, int dit,
                               int transpose_out, int mat, int pre, int post,
                               int nn, int log_tl, int* kfuse, int* regs,
                               int* per_sm) {
  const KernelFn kernel =
      pick(tall, dit != 0, transpose_out != 0, mat != 0, pre, post, nn,
           group > 0,
           colpass_tile::staged_store(tall, dit != 0, group > 0, group - 1,
                                      kStagedLogCols),
           short_col != 0);
  *kfuse = kFuse;
  *regs = 0;
  if (!kernel) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      nn == 1 || short_col ? 0 : (size_t)nn << log_tl << 3;
  cudaFuncAttributes attr = {};
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) err = allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                        kThreads, smem);
  *kfuse = kFuse;
  *regs = attr.numRegs;
  return static_cast<int>(err);
}

// Launches one Goldilocks column pass on `stream`. x_hi/x_lo: (batch, nn,
// ncols) uint32 planes; out_hi/out_lo: (batch, nn, ncols), or (batch,
// ncols, nn) with transpose_out. ts / offs: host arrays of nstages half
// sizes and table offsets into tw (uint64). log_a < 0 for a plain network
// (mid null); a nested one has k0 stages in phase 0 and at least one in
// each phase; a one-row column (nn = 1) none (its launch applies the
// operands alone). mat null for no post_t multiply (which needs
// transpose_out). pre_form, post_form: the Operand forms of the 'pre' and
// 'post' operands (uint64 tables: kOpMat pre and null pre2, indexed like
// x; kOpFac T1 and T2 of the split 2^log_s; kOpRank1 the row and the
// column vector; null for kOpNone). tall (colpass_tile::Tall): kWhole,
// one launch of the whole column; kTallA, kTallB or kTallPre, one launch
// of a tall column's route (ops/colpass.py launch_plan): nn, ncols and the
// stage list are the launch's (a plain network, log_a < 0) over its view,
// log_inner is log2 of the factor of the tall nn that rides the view's
// columns, the operands are those the launch applies, and mid is the tall
// network's (nn_tall,) vector; a split phase's launch has log_hq ('hi')
// or log_lp ('lo', batch the planes' batch rows times P), as colpass.cu's
// ntt_colpass. short_col: a whole column of 2 to kShortRows rows on
// gl_colpass_short_kernel (log_tl 0; its network the plain one, every
// stage in order). Returns cudaGetLastError() after the launch (0 =
// launched), or cudaErrorInvalidValue for a shape or an operand
// combination the kernels do not take.
int ntt_gl_colpass(const void* x_hi, const void* x_lo, void* out_hi,
                   void* out_lo, int batch, int nn, int ncols, int log_tl,
                   int dit, int nstages, int k0, const int* ts,
                   const int* offs, const void* tw, int log_a,
                   const void* mid, const void* mat, int pre_form,
                   const void* pre, const void* pre2, int post_form,
                   const void* post, const void* post2, int log_s,
                   int transpose_out, int tall, int log_inner, int log_hq,
                   int log_lp, int short_col, void* stream) {
  const bool empty = nn == 1;
  const size_t smem = empty || short_col ? 0 : (size_t)nn << log_tl << 3;
  const bool nested = log_a >= 0;
  const bool phase = tall != kWhole;
  Params P;
  if ((short_col && !short_ok(nn, log_tl, dit, nstages, ts, log_a, tall,
                              out_hi, out_lo, mat)) ||
      nn > kMaxRows || smem > (size_t)kMaxSmemBytes || log_tl < 0 ||
      log_tl > 5 || (ncols >> log_tl) < 1 || batch < 1 || batch > 65535 ||
      nstages != colpass_tile::ilog2(nn) || (empty && (phase || nested)) ||
      (!empty && (nested || phase) != (mid != nullptr)) ||
      log_hq < 0 || log_lp < 0 || (!phase && (log_hq || log_lp)) ||
      (log_hq && log_lp) || log_hq > log_inner ||
      (batch & ((1 << log_lp) - 1)) ||
      (phase && (nested || log_inner < 1 || (ncols >> log_inner) < 1)) ||
      (nested && (k0 < 1 || k0 >= nstages)) ||
      (mat != nullptr && !transpose_out) ||
      !colpass_tile::make_network(&P.net, nn, dit, nstages, k0, ts, offs,
                                  nullptr, nullptr, log_a, nullptr, nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  P.tw = static_cast<const uint64_t*>(tw);
  P.mid = static_cast<const uint64_t*>(mid);
  P.mat = static_cast<const uint64_t*>(mat);
  P.pre = static_cast<const uint64_t*>(pre);
  P.pre2 = static_cast<const uint64_t*>(pre2);
  P.post = static_cast<const uint64_t*>(post);
  P.post2 = static_cast<const uint64_t*>(post2);
  P.log_s = log_s;
  P.log_inner = phase ? log_inner : 0;
  P.log_ncols = phase ? colpass_tile::ilog2(ncols) - log_inner : 0;
  P.log_vc = P.log_ncols + P.log_inner - log_hq;
  P.log_iq = P.log_inner - log_hq;
  // the split tile's q by columns (colpass.cu's ntt_colpass)
  const bool hi_a = tall == kTallA && log_hq > 0;
  const int split_inner = hi_a ? log_hq : P.log_inner;
  P.log_tlc = colpass_tile::tall_store_log_cols(
      kTallStoreLogCols, log_tl, split_inner, hi_a ? P.log_vc : P.log_ncols);
  P.log_hq = log_hq;
  P.log_lp = log_lp;
  P.log_rows = P.net.log_nn + log_hq + log_lp;
  P.log_tall = P.log_rows + P.log_vc - P.log_ncols;
  P.pre_form = pre_form;
  P.post_form = post_form;
  P.x_hi = static_cast<const uint32_t*>(x_hi);
  P.x_lo = static_cast<const uint32_t*>(x_lo);
  P.out_hi = static_cast<uint32_t*>(out_hi);
  P.out_lo = static_cast<uint32_t*>(out_lo);
  P.ncols = ncols;
  P.log_tl = log_tl;
  P.shift = colpass_tile::tile_shift(P.net, log_tl);
  const auto tables_ok = [](int form, const void* a, const void* b) {
    return form == kOpNone ? !a && !b
           : form == kOpMat ? a && !b
           : (form == kOpFac || form == kOpRank1) && a && b;
  };
  const bool fac = pre_form == kOpFac || post_form == kOpFac;
  // a factored operand's split S = 2^log_s: S = 1 only on a short column
  // (n2 = 2's, twiddles.default_wfac_split)
  if (!tables_ok(pre_form, pre, pre2) || !tables_ok(post_form, post, post2) ||
      log_s < 0 || (fac && (log_s < !short_col || log_s >= P.log_tall)) ||
      (phase && log_tl - P.log_tlc > split_inner))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool group = log_hq != 0 || log_lp != 0;
  const KernelFn kernel =
      pick(tall, dit != 0, transpose_out != 0, mat != nullptr, pre_form,
           post_form, nn, group,
           colpass_tile::staged_store(tall, dit != 0, group, P.log_ncols,
                                      kStagedLogCols),
           short_col != 0);
  if (!kernel) return static_cast<int>(cudaErrorInvalidValue);
  if (short_col) {
    int blocks = 0;
    const cudaError_t err = short_grid(kernel, ncols, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(blocks, batch), kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(P);
    return static_cast<int>(cudaGetLastError());
  }
  if (empty) {
    const int blocks = (ncols + kThreads - 1) / kThreads;
    dim3 grid(blocks < kEmptyBlocks ? blocks : kEmptyBlocks, batch);
    kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(P);
    return static_cast<int>(cudaGetLastError());
  }
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(ncols >> log_tl, batch);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// Launches the pointwise product o = a * b mod p over n elements given as
// uint32 limb planes, on `stream`; b has nb elements, nb = n or a divisor
// of n (b broadcast over a's leading axes: b[i mod nb]). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for sizes it does not take.
int ntt_gl_mul(const void* a_hi, const void* a_lo, const void* b_hi,
               const void* b_lo, void* out_hi, void* out_lo, long long n,
               long long nb, void* stream) {
  if (n < 1 || nb < 1 || n % nb != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks_needed = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(
      blocks_needed < 132 * 64 ? blocks_needed : 132 * 64);
  const auto kernel = nb == n ? &gl_mul_kernel<false> : &gl_mul_kernel<true>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a_hi), static_cast<const uint32_t*>(a_lo),
      static_cast<const uint32_t*>(b_hi), static_cast<const uint32_t*>(b_lo),
      static_cast<uint32_t*>(out_hi), static_cast<uint32_t*>(out_lo),
      static_cast<size_t>(n), static_cast<size_t>(nb));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
