// Column-pass NTT kernel for NVIDIA Hopper (sm_90a).
//
// Replaces ntt_aie_tpu/ops/pallas_ntt.py::build_colpass (the Pallas TPU
// kernel) for the options the four-step fold plan runs, under one of the
// reductions of reductions.cuh (Harvey4, Harvey, Montgomery, Barrett: the
// reference's `red` argument). Each library is built for one, with
// -DNTT_REDUCTION=<kind> (ops/colpass.py build_library):
//   cp1  = DIF over n1, then the 'post_t' wmat multiply, transpose_out;
//   cp2  = DIF over n2, then canonicalize;
//   icp2 = DIT over n2, then the 'post_t' iwmat multiply, transpose_out;
//   icp1 = DIT over n1, then canonicalize;
// and the 'pre' and 'post' operands the other plan arms run (plan.py
// fold_passes), each a full (nn, ncols) table indexed like the input:
//   ncp1 (negacyclic, fold)  = 'pre' psi, DIF over n1, 'post_t' wmat,
//                              transpose_out;
//   nicp1 (negacyclic, fold) = DIT over n1, 'post' psi^-1, canonicalize;
//   wmat_fold=False: cp2 = 'pre' wmat, DIF over n2, canonicalize; icp1 =
//     'pre' iwmat, DIT over n1, canonicalize; ncp1 = 'pre' psi, DIF over
//     n1, transpose_out; nicp1 = 'pre' iwmat, DIT over n1, 'post' psi^-1,
//     canonicalize;
// and the wmat_factored=True arm's factored and rank-1 operands
// (colpass_tile.cuh Operand: kOpFac, the four-step matrix as T1[c1] *
// T2[c0] over the row c = c1*S + c0; kOpRank1, psi as row[r] * col[c]):
//   cp2  = 'pre' wfac, DIF over n2, canonicalize;
//   icp2 = DIT over n2, 'post' wfac^-1 (1/n folded in), transpose_out;
//   ncp1 = 'pre' rank-1 psi, DIF over n1, transpose_out;
//   nicp1 = DIT over n1, 'post' rank-1 psi^-1, canonicalize.
// The distributed plan (parallel/fourstep.py dist_passes) runs its passes
// without the transpose (the transpose is the collective), which adds:
//   lcp1 (full-matrix arm)  = DIF over n1, 'post' wmat;
//   lcp1n (full-matrix arm) = 'pre' psi, DIF over n1, 'post' wmat;
//   lcp1n (factored arm)    = 'pre' rank-1 psi, DIF over n1;
//   licp2 (factored arm)    = DIT over n2, 'post' wfac^-1 (1/n folded in);
// its other passes are instantiations above.
// pick_kernel instantiates those combinations and no other.
//
// The tall route. A column of more than kMaxRows rows (BabyBear's and
// Goldilocks's largest transforms: nn = 16,384 and 32,768 at n = 2^27 -
// 2^30, or any pinned split with a side above 8,192) does not fit one
// block's tile. Its nested R x S network (the reference's, nn >= 256) is
// run as two launches of plain networks (colpass_tile.cuh Tall):
//   launch A, phase 0 over the view (B, rows0, inner0 * ncols) of the
//     (B, nn, ncols) input, which has its memory layout: 'pre' on load,
//     the mid multiply and the row move on the store;
//   launch B, phase 1 over the view (B, rows1, inner1 * ncols) of A's
//     output: 'post', the transpose, 'post_t' and canonicalize on store.
// Each phase is a plain network of R or S points (at most kMaxRows), so
// its tiles are the kernels' own and every group is column_tile_io's.
// The plans take this route from above ops/colpass.py LAUNCH_ROWS = 4,096
// rows: an 8,192-row column fits one tile (TL = 4, 128 KB), but at one
// block an SM it took longer than its route's two launches of 16 KB tiles
// (BabyBear n = 2^27's cp1 and icp1, PERF.md section 6).
// pick_tall takes the combinations pick_kernel takes, with their phase
// A by the direction and 'pre' form and their phase B by the direction,
// store options and 'post' form. Each launch reads and writes the whole
// array once and runs half the butterflies: its bound is the array's
// bytes over 3.35 TB/s (0.32 ms at n = 2^27 in uint32) where a whole
// pass's is its butterflies (0.571 ms under montgomery), so the route
// pays one extra sweep of device memory. Launch A's store writes runs of
// ncols words (whole 32-byte sectors from ncols = 8). A transposing
// launch B writes tall rows rows0 apart in the view's columns; its tile
// is 8 of them by 4 columns (colpass_tile.cuh tile_col0, kTallStoreLogCols)
// so a warp writes whole sectors: with the plain tile, one word a
// sector, it took 13.9 ms at n = 2^27, 13x the other launches (PERF.md).
// A phase of more than LAUNCH_ROWS rows (a 32-bit column above 2^24 rows,
// BabyBear (1, 2^27); Goldilocks's gl_colpass.cu: above 8,192 rows) runs
// as two launches of its own, split by stage group (colpass_tile.cuh
// Tall, ops/colpass.py phase_groups): its rows p * Q + q, the stages of
// half size t >= Q a P-row network over the view (P, Q * inner * ncols)
// with the twiddle taken by the view column, the stages t < Q a Q-row
// network over P arrays a batch row (the launch's batch B * P). Every
// launch of the route reads and writes the array once, so a split phase
// pays one more sweep of device memory.
// The DIF split phase A's last launch ('lo') moves the rows: a thread of
// its groups holds one view column iq, whose moved rows iq * rows + lp
// are a run of rows * ncols words, so a warp of the group's mapping
// stores 32 runs apart, one word a sector at ncols = 1 (BabyBear (1,
// 2^27): 2.42 ms, 3.8x its bound). At one column (colpass_tile.cuh
// kStagedLogCols; pick_tall takes the kStaged instantiation where
// colpass_tile::staged_store says)
// it stages the store instead: the last group runs its
// stages and the mid multiply in the group's mapping (the mid reads stay
// coalesced; all its values' before any store), writes the values back to
// the tile, and after one barrier store_moved reads the tile across the
// rows, so consecutive threads write consecutive moved words (whole
// 128-byte lines at TL = 32); the launch's tile XORs each row's columns
// with the row (moved_xor) so that both the group's accesses and the
// store's transposing reads meet 32 banks: 1.09-1.10 ms. The staging
// takes the tile the launch already holds: no shared memory more, no other
// kernel, the same grid. Readings in turns (PERF.md section 6) chose it
// over its variants: 16-byte vector stores, a whole last group (3, 1, 3
// stages) and no barrier (racy, for the reading) each moved it by 4 % or
// less, and a launch with no global store at all took 1.02 ms, so what is
// left is the launch's stages and mid multiply, not the store; at 2 and 4
// columns the staging costs more than the direct store's 8 and 16 bytes a
// sector saves, and they keep the instantiation they had. A TMA 2-D bulk
// store (cp.async.bulk.tensor from a [TL][Q * ncols] box, a tensor map
// built in the wrapper) would replace only the store, the part those
// readings found cheap, and was not built.
//
// A column of one row (the split (1, n): cp1, icp1, ncp1, nicp1 over one
// row) is a network of zero stages: colpass_empty_kernel applies its
// operands, 'pre', 'post', 'post_t' and canonicalize, to each value
// (colpass_tile.cuh column_empty), one launch like any pass: the reference
// runs the same pass, its multiply and canonicalize included. Its bound is
// its bytes.
//
// What it computes, per column of a (B, nn, ncols) uint32 array: the
// optional 'pre' multiply as the values load, every butterfly stage of the
// column network (colpass_tile.cuh, which also states the arithmetic and
// the nested row map), the optional 'post' multiply. Store: optional
// transpose to (B, ncols, nn), then the elementwise multiply by a
// (ncols, nn)-oriented matrix ('post_t'), then canonicalize. The order is
// the reference's (build_colpass: pre, stages, post, transpose, post_t,
// canonicalize).
// Output domain: the reduction's ([0, 4p) Harvey4, [0, 2p) Harvey, [0, p)
// Montgomery and Barrett) without canonicalize, [0, p) with it.
//
// What bounds it on an H100. A pass's floor is the larger of its bytes
// (the 4 MB matrix of one n = 2^20 transform read and written once, plus
// 8 MB of (w, w') wmat for cp1/icp2, held in L2 across the batch) over
// 3.35 TB/s and its butterflies (nn/2 * log2 nn a column) over the
// measured ideal butterfly rate: both near 2.5 us a transform at
// 1024 x 1024. What held the first design at 6x that floor was the work
// inside the SM: one shared-memory round trip and one barrier a radix-2
// stage, sweeps of the tile that only moved data (load, nested mid step,
// store), and bank conflicts where phase 1's row map and the transposed
// store touched rows 32 apart. Timed in turns on an H100 80GB HBM3 at
// 700 W (PERF.md section 6), the kernel turned out bound by instructions
// issued, not by shared-memory wavefronts: a layout that removed every
// conflict at the cost of a few instructions an element was slower. The
// design (colpass_tile.cuh column_tile_io):
//   - one thread block per (batch row, tile of TL consecutive columns);
//     the caller picks TL so a tile takes 32 KB where it can (TL = 8 at
//     nn = 1024), never narrower than 4 columns; the largest column is
//     kMaxRows = 8192 rows (TL = 4, 128 KB);
//   - register groups of kFuse radix-2 stages: each thread holds the 2^K
//     values of one radix-2^K butterfly between two exchanges through the
//     tile, one barrier a group instead of one a stage;
//   - the first group reads its values from device memory and the last
//     writes them there (TL*4 contiguous bytes a row; transposed, runs of
//     32/TL values down each output column, 16 bytes at TL = 8), and the
//     nested mid multiply rides in a group, so no sweep of the tile
//     remains;
//   - the tile is swizzled: row r takes slot (r XOR (r >> s)) mod 32/TL of
//     its 32-word line, with s the row map's shift, so phase 1's rows land
//     in distinct banks; the words of a group's rows come from one base
//     word and K XOR offsets, computed once a group;
//   - each (w, w') table pair is one 8-byte load (PairTables: ColPass's
//     tw_pairs, wmid_pairs and interleaved wmat);
//   - one kernel per direction and store options (no runtime branch on
//     the direction), and csub as one unsigned min.
// kFuse = 3 from readings in turns of kFuse 1-4 (PERF.md): at 4 a thread
// holds 16 values, the registers pass 100 and 2 blocks fit an SM. At
// kFuse 3, cp1's kernel takes 40 registers a thread and 6 blocks of 256
// threads per SM (where the 33 KB of shared memory a block binds too),
// cp2's 48 and 5 (registers bind; ntt_colpass_kernel_info). Those are
// Harvey4's numbers, the main path's; the other reductions run the same
// design as it stands (a Montgomery or Barrett table's second word is zero
// and still loaded with the pair, PERF.md gives their readings).
// The 'pre' and 'post' instantiations add one 8-byte load and one
// multiply a value to the loading or the storing group and leave the
// other groups as they are: the fold's ncp1 keeps cp1's 40 registers and
// 6 blocks per SM, the entry arm's cp2 takes cp2's 48 and 5, its ncp1 54
// and 4, and the DIT ones 62-64 and 4, as icp1 does (harvey4, read with
// ntt_colpass_kernel_info on an H100 80GB HBM3 at 700 W, PERF.md).
// The factored and rank-1 forms add two 8-byte loads and two multiplies a
// value to the same group. Their tables are (n2/S + S) x n1 pairs (512 KB
// at n = 2^20, S = 32) and n1 + n2 pairs, against the full matrix's 8 MB:
// they stay in L2, and the loads are a simple kernel's, not yet tuned.

#include "colpass_tile.cuh"

#ifndef NTT_REDUCTION
#error "build with -DNTT_REDUCTION=<harvey4|harvey|montgomery|barrett>"
#endif

namespace {

using colpass_tile::Network;
using colpass_tile::TileOps;
using Red = reductions::Built;

constexpr int kThreads = 256;
constexpr int kMaxSmemBytes = 227 * 1024;  // an H100 block's limit
constexpr int kMaxRows = 8192;
constexpr int kFuse = 3;  // radix-2 stages a register group (see above)
// log2 of the tall columns of a transposing phase B's tile
// (colpass_tile.cuh tile_col0): 4 columns by 8 consecutive moved rows at
// TL = 32, so its store writes whole 32-byte sectors
constexpr int kTallStoreLogCols = 2;
// The most blocks a batch row of a one-row column's launch takes (grid.x;
// each thread then loops over its columns): 8 blocks of 256 threads an SM
constexpr int kEmptyBlocks = 132 * 8;

struct Params {
  Network net;  // table pointers null: the kernel reads `tables`
  TileOps ops;
  colpass_tile::PairTables tables;
  const uint32_t* x;
  uint32_t* out;
  int shift;  // the swizzled tile's (colpass_tile::tile_shift)
  Red red;    // the reduction and its constants
  // after every field a whole column's kernel reads, so its code keeps its
  // parameter offsets: a tall launch's view, and the operand forms of a
  // one-row column's launch (colpass_empty_kernel)
  colpass_tile::TallView view;
  int pre_form, post_form;
};

using colpass_tile::kOpFac;
using colpass_tile::kOpMat;
using colpass_tile::kOpNone;
using colpass_tile::kOpRank1;
using colpass_tile::kTallA;
using colpass_tile::kTallB;
using colpass_tile::kTallPre;
using colpass_tile::kWhole;

// One thread block per (batch row, tile of TL columns). kPre, kPost:
// colpass_tile::Operand forms; kTall: colpass_tile::Tall; kGroup: a launch
// of a split phase; kStaged: a DIF split phase A's 'lo' launch that stages
// its moved store (column_tile_io's).
template <bool kDit, bool kTranspose, bool kMat, int kPre = kOpNone,
          int kPost = kOpNone, int kTall = kWhole, bool kGroup = false,
          bool kStaged = false>
__global__ void __launch_bounds__(kThreads) colpass_kernel(const Params P) {
  extern __shared__ uint32_t tile[];
  const size_t plane = (size_t)P.net.nn * P.ops.ncols;
  if constexpr (kTall == kWhole) {
    colpass_tile::column_tile_io<kDit, kTranspose, kMat, kFuse, false, kPre,
                                 kPost, kTall>(
        tile, P.net, P.ops, P.tables, P.x + (size_t)blockIdx.y * plane,
        P.out + (size_t)blockIdx.y * plane,
        colpass_tile::tile_col0<kTall == kTallB && kTranspose>(
            blockIdx.x, P.ops.log_tl, P.tables.log_inner, P.tables.log_ncols,
            P.tables.log_tlc),
        P.shift, P.red);
  } else {  // a 'lo' launch's array p of its batch row: batch row b * P + p
    const int p =
        kGroup ? (int)(blockIdx.y & ((1u << P.view.log_lp) - 1)) : 0;
    colpass_tile::column_tile_io<kDit, kTranspose, kMat, kFuse, false, kPre,
                                 kPost, kTall, false, kGroup, kStaged>(
        tile, P.net, P.ops, P.tables, P.x + (size_t)blockIdx.y * plane,
        P.out + (size_t)blockIdx.y * plane,
        colpass_tile::tall_col0<kTall, kTranspose, kGroup>(
            blockIdx.x, P.ops.log_tl, P.tables, P.view),
        P.shift, P.red, P.view, p);
  }
}

// A one-row column's pass (colpass_tile::column_empty): blocks on grid.x
// over the row's columns, batch rows on grid.y; no shared memory.
__global__ void __launch_bounds__(kThreads) colpass_empty_kernel(
    const Params P) {
  const size_t row = (size_t)blockIdx.y * P.ops.ncols;
  colpass_tile::column_empty(P.ops, P.tables, P.pre_form, P.post_form,
                             P.x + row, P.out + row, P.red);
}

using KernelFn = void (*)(Params);

template <bool kDit>
KernelFn pick_kernel(bool transpose_out, bool mat) {
  return !transpose_out ? (mat ? colpass_kernel<kDit, false, true>
                               : colpass_kernel<kDit, false, false>)
                        : (mat ? colpass_kernel<kDit, true, true>
                               : colpass_kernel<kDit, true, false>);
}

// The instantiation for this direction and these operands (pre, post:
// Operand forms), or null for a combination with 'pre' or 'post' that no
// plan runs (see the top).
KernelFn pick_kernel(bool dit, bool transpose_out, bool mat, int pre,
                     int post) {
  if (pre == kOpNone && post == kOpNone)
    return dit ? pick_kernel<true>(transpose_out, mat)
               : pick_kernel<false>(transpose_out, mat);
  if (mat) {  // ncp1 of the fold: 'pre' psi and the 'post_t' wmat
    if (!dit && transpose_out && pre == kOpMat && post == kOpNone)
      return colpass_kernel<false, true, true, kOpMat>;
    return nullptr;
  }
  if (!dit && post == kOpNone) {
    if (transpose_out) {  // ncp1: the entry arm's, the factored arm's
      if (pre == kOpMat) return colpass_kernel<false, true, false, kOpMat>;
      if (pre == kOpRank1)
        return colpass_kernel<false, true, false, kOpRank1>;
    } else {  // cp2: the entry arm's, the factored arm's; distributed lcp1n
      if (pre == kOpMat) return colpass_kernel<false, false, false, kOpMat>;
      if (pre == kOpFac) return colpass_kernel<false, false, false, kOpFac>;
      if (pre == kOpRank1)
        return colpass_kernel<false, false, false, kOpRank1>;
    }
  }
  if (!dit && !transpose_out && post == kOpMat) {  // distributed lcp1, lcp1n
    if (pre == kOpNone)
      return colpass_kernel<false, false, false, kOpNone, kOpMat>;
    if (pre == kOpMat)
      return colpass_kernel<false, false, false, kOpMat, kOpMat>;
  }
  if (dit && transpose_out) {  // icp2 of the factored arm
    if (pre == kOpNone && post == kOpFac)
      return colpass_kernel<true, true, false, kOpNone, kOpFac>;
  } else if (dit && pre == kOpNone && post == kOpFac) {  // distributed licp2
    return colpass_kernel<true, false, false, kOpNone, kOpFac>;
  } else if (dit) {
    if (pre == kOpNone) {  // nicp1: the fold's, the factored arm's
      if (post == kOpMat)
        return colpass_kernel<true, false, false, kOpNone, kOpMat>;
      if (post == kOpRank1)
        return colpass_kernel<true, false, false, kOpNone, kOpRank1>;
    } else if (pre == kOpMat) {  // the entry arm's icp1 and nicp1
      if (post == kOpNone) return colpass_kernel<true, false, false, kOpMat>;
      if (post == kOpMat)
        return colpass_kernel<true, false, false, kOpMat, kOpMat>;
    }
  }
  return nullptr;
}

// The tall route's launch `tall` (kTallA, kTallB or kTallPre) of these
// options, the launch's own (ops/colpass.py launch_plan), or null: kTallA
// by the direction and its 'pre' form (the whole phase A's; a split phase
// A's last takes none); kTallPre, a split phase A's first, by the
// direction and its 'pre' form; kTallB by the direction, the store options
// and the 'post' form (a split phase's in-place launch has none). Every
// 'pre' and 'post' form and store option a plan's pass runs has its
// launches here. kG: a launch of a split phase (colpass_kernel's kGroup);
// staged: a DIF split phase A's 'lo' launch that stages its moved store
// (colpass_tile::staged_store).
template <bool kG>
KernelFn pick_tall(int tall, bool dit, bool transpose_out, bool mat, int pre,
                   int post, bool staged) {
  if (tall == kTallA || tall == kTallPre) {
    if (transpose_out || mat || post != kOpNone) return nullptr;
    if (tall == kTallPre) {  // a split phase A's first launch only
      if constexpr (!kG) return nullptr;
      if (dit)
        return pre == kOpMat ? colpass_kernel<true, false, false, kOpMat,
                                              kOpNone, kTallPre, kG>
                             : nullptr;
      switch (pre) {
        case kOpMat:
          return colpass_kernel<false, false, false, kOpMat, kOpNone,
                                kTallPre, kG>;
        case kOpFac:
          return colpass_kernel<false, false, false, kOpFac, kOpNone,
                                kTallPre, kG>;
        case kOpRank1:
          return colpass_kernel<false, false, false, kOpRank1, kOpNone,
                                kTallPre, kG>;
      }
      return nullptr;
    }
    if (dit) {
      if (pre == kOpNone)
        return colpass_kernel<true, false, false, kOpNone, kOpNone, kTallA,
                              kG>;
      if (pre == kOpMat)
        return colpass_kernel<true, false, false, kOpMat, kOpNone, kTallA,
                              kG>;
      return nullptr;
    }
    switch (pre) {
      case kOpNone:
        if constexpr (kG) {
          if (staged)
            return colpass_kernel<false, false, false, kOpNone, kOpNone,
                                  kTallA, kG, true>;
        }
        return colpass_kernel<false, false, false, kOpNone, kOpNone, kTallA,
                              kG>;
      case kOpMat:
        return colpass_kernel<false, false, false, kOpMat, kOpNone, kTallA,
                              kG>;
      case kOpFac:
        return colpass_kernel<false, false, false, kOpFac, kOpNone, kTallA,
                              kG>;
      case kOpRank1:
        return colpass_kernel<false, false, false, kOpRank1, kOpNone,
                              kTallA, kG>;
    }
    return nullptr;
  }
  if (tall != kTallB || pre != kOpNone || (mat && !transpose_out))
    return nullptr;
  if (post == kOpNone) {
    if (dit)
      return !transpose_out ? colpass_kernel<true, false, false, kOpNone,
                                             kOpNone, kTallB, kG>
             : mat ? colpass_kernel<true, true, true, kOpNone, kOpNone, kTallB,
                                    kG>
                   : colpass_kernel<true, true, false, kOpNone, kOpNone,
                                    kTallB, kG>;
    return !transpose_out ? colpass_kernel<false, false, false, kOpNone,
                                           kOpNone, kTallB, kG>
           : mat ? colpass_kernel<false, true, true, kOpNone, kOpNone, kTallB,
                                  kG>
                 : colpass_kernel<false, true, false, kOpNone, kOpNone,
                                  kTallB, kG>;
  }
  if (mat) return nullptr;
  if (post == kOpMat && !transpose_out)  // distributed lcp1, lcp1n; nicp1
    return dit ? colpass_kernel<true, false, false, kOpNone, kOpMat, kTallB,
                                kG>
               : colpass_kernel<false, false, false, kOpNone, kOpMat, kTallB,
                                kG>;
  if (post == kOpRank1 && dit && !transpose_out)  // the factored nicp1
    return colpass_kernel<true, false, false, kOpNone, kOpRank1, kTallB, kG>;
  if (post == kOpFac && dit)  // the factored arm's icp2; distributed licp2
    return transpose_out
               ? colpass_kernel<true, true, false, kOpNone, kOpFac, kTallB,
                                kG>
               : colpass_kernel<true, false, false, kOpNone, kOpFac, kTallB,
                                kG>;
  return nullptr;
}

// The kernel of a launch: a one-row column's (nn = 1) colpass_empty_kernel,
// pick_kernel for a whole column (tall = kWhole), pick_tall for a launch of
// a tall one.
KernelFn pick(int tall, bool dit, bool transpose_out, bool mat, int pre,
              int post, int nn, bool group, bool staged) {
  if (nn == 1)
    return tall == kWhole && pick_kernel(dit, transpose_out, mat, pre, post)
               ? colpass_empty_kernel
               : nullptr;
  if (tall == kWhole) return pick_kernel(dit, transpose_out, mat, pre, post);
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

}  // namespace

extern "C" {

int ntt_colpass_max_rows() { return kMaxRows; }

// The reduction this library is built for (ops/reductions.py's kind).
const char* ntt_reduction_name() { return reductions::kBuiltName; }

// This build's register group size, and for the kernel of this direction
// and these operands (pre, post: Operand forms), of a whole column or one
// launch of a tall one (tall: colpass_tile::Tall; group: 0, or for a
// launch of a split phase 1 + log2 of the tall array's columns, which
// colpass_tile::staged_store reads), at an nn x 2^log_tl tile (a launch's
// rows): its registers a thread and its co-resident blocks per SM.
// Returns 0 or a cudaError_t.
int ntt_colpass_kernel_info(int tall, int group, int dit, int transpose_out,
                            int mat, int pre, int post, int nn, int log_tl,
                            int* kfuse, int* regs, int* per_sm) {
  const KernelFn kernel =
      pick(tall, dit != 0, transpose_out != 0, mat != 0, pre, post, nn,
           group > 0,
           colpass_tile::staged_store(tall, dit != 0, group > 0, group - 1));
  *kfuse = kFuse;
  *regs = 0;
  if (!kernel) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = nn == 1 ? 0 : (size_t)nn << log_tl << 2;
  cudaFuncAttributes attr = {};
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) err = allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                        kThreads, smem);
  *regs = attr.numRegs;
  return static_cast<int>(err);
}

const char* ntt_colpass_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches one column pass on `stream`. x: (batch, nn, ncols) uint32;
// out: (batch, nn, ncols), or (batch, ncols, nn) with transpose_out. ts /
// offs: host arrays of nstages half sizes and table offsets (in pairs).
// tw, mid, mat: (w, packed w') pairs, 8 bytes each: the stage twiddles,
// the nested mid vector (null with log_a < 0, a plain network), the
// post_t operand indexed like out (null for none). pre_form, post_form:
// the Operand forms of the 'pre' and 'post' operands, each in one table
// (kOpMat, indexed like x) or two (kOpFac: T1, T2 of the split 2^log_s;
// kOpRank1: the row and the column vector), pairs too; every batch row
// reads the same tables. p, c1, c2: the reduction's prime and constants
// (Red::make). A one-row column (nn = 1) has no stage (nstages = 0): its
// launch applies the operands alone. tall (colpass_tile::Tall): kWhole,
// one launch of the whole column; kTallA, kTallB or kTallPre, one launch
// of a tall column's route (ops/colpass.py launch_plan): then nn, ncols
// and the stage list are the launch's (a plain network, log_a < 0) over
// its view, log_inner is log2 of the factor of the tall nn that rides the
// view's columns, the operands are those the launch applies, and mid is
// the tall network's (nn_tall,) vector; a launch of a split phase has
// log_hq (a 'hi' launch: log2 Q, its twiddle by the view column) or log_lp
// (a 'lo' launch: log2 P, batch the tall array's batch rows times P).
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape or an operand combination the kernels
// do not take.
int ntt_colpass(const void* x, void* out, int batch, int nn, int ncols,
                int log_tl, int dit, int nstages, int k0, const int* ts,
                const int* offs, const void* tw, int log_a, const void* mid,
                const void* mat, int pre_form, const void* pre,
                const void* pre2, int post_form, const void* post,
                const void* post2, int log_s, int transpose_out,
                int canonicalize, int tall, int log_inner, int log_hq,
                int log_lp, unsigned int p, unsigned int c1, unsigned int c2,
                void* stream) {
  const bool empty = nn == 1;
  const size_t smem = empty ? 0 : (size_t)nn << log_tl << 2;
  const bool phase = tall != kWhole;
  Params P;
  if (nn > kMaxRows || smem > (size_t)kMaxSmemBytes || log_tl < 0 ||
      log_tl > 5 || (ncols >> log_tl) < 1 || batch < 1 || batch > 65535 ||
      nstages != colpass_tile::ilog2(nn) ||
      (empty && (phase || log_a >= 0)) || log_hq < 0 || log_lp < 0 ||
      (!phase && (log_hq || log_lp)) || (log_hq && log_lp) ||
      log_hq > log_inner || (batch & ((1 << log_lp) - 1)) ||
      (phase && (log_a >= 0 || log_inner < 1 || (ncols >> log_inner) < 1 ||
                 !mid)) ||
      !colpass_tile::make_network(&P.net, nn, dit, nstages, k0, ts, offs,
                                  nullptr, nullptr, log_a, nullptr, nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  P.ops.pre_w = P.ops.pre_s = P.ops.mat_w = P.ops.mat_s = nullptr;
  P.tables.tw = static_cast<const uint2*>(tw);
  P.tables.mid = static_cast<const uint2*>(mid);
  P.tables.mat = static_cast<const uint2*>(mat);
  P.tables.pre = static_cast<const uint2*>(pre);
  P.tables.pre2 = static_cast<const uint2*>(pre2);
  P.tables.post = static_cast<const uint2*>(post);
  P.tables.post2 = static_cast<const uint2*>(post2);
  P.tables.log_s = log_s;
  P.tables.log_inner = phase ? log_inner : 0;
  P.tables.log_ncols = phase ? colpass_tile::ilog2(ncols) - log_inner : 0;
  P.view.log_vc = P.tables.log_ncols + P.tables.log_inner - log_hq;
  P.view.log_iq = P.tables.log_inner - log_hq;
  // the split tile's q by columns (tall_col0): a transposing phase B's
  // over inner and ncols, a 'hi' phase A's over Q and vc
  const bool hi_a = tall == kTallA && log_hq > 0;
  const int split_inner = hi_a ? log_hq : P.tables.log_inner;
  P.tables.log_tlc = colpass_tile::tall_store_log_cols(
      kTallStoreLogCols, log_tl, split_inner,
      hi_a ? P.view.log_vc : P.tables.log_ncols);
  P.view.log_hq = log_hq;
  P.view.log_lp = log_lp;
  P.view.log_rows = P.net.log_nn + log_hq + log_lp;
  P.view.log_tall = P.view.log_rows + P.view.log_vc - P.tables.log_ncols;
  P.pre_form = pre_form;
  P.post_form = post_form;
  P.ops.ncols = ncols;
  P.ops.log_tl = log_tl;
  P.ops.canonicalize = tall == kTallA || tall == kTallPre ? 0 : canonicalize;
  P.x = static_cast<const uint32_t*>(x);
  P.out = static_cast<uint32_t*>(out);
  P.shift = colpass_tile::tile_shift(P.net, log_tl);
  P.red = Red::make(p, c1, c2);
  const auto tables_ok = [](int form, const void* a, const void* b) {
    return form == kOpNone ? !a && !b
           : form == kOpMat ? a && !b
           : (form == kOpFac || form == kOpRank1) && a && b;
  };
  const bool fac = pre_form == kOpFac || post_form == kOpFac;
  if (!tables_ok(pre_form, pre, pre2) || !tables_ok(post_form, post, post2) ||
      log_s < 0 || (fac && (log_s < 1 || log_s >= P.view.log_tall)) ||
      (phase && log_tl - P.tables.log_tlc > split_inner))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool group = log_hq != 0 || log_lp != 0;
  const KernelFn kernel =
      pick(tall, dit != 0, transpose_out != 0, mat != nullptr, pre_form,
           post_form, nn, group,
           colpass_tile::staged_store(tall, dit != 0, group,
                                      P.tables.log_ncols));
  if (!kernel) return static_cast<int>(cudaErrorInvalidValue);
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

}  // extern "C"
