// Fused four-step NTT kernel for NVIDIA Hopper (sm_90a): a whole
// transform in one cooperative launch.
//
// Replaces ntt_aie_tpu/ops/pallas_ntt.py::build_fused_fourstep (the Pallas
// TPU kernel), under one of the reductions of reductions.cuh (the
// reference's `reduction` argument; a library per reduction, built with
// -DNTT_REDUCTION=<kind>). Over an (nn_a, nn_b) matrix per batch row:
//   forward: [pre *] DIF down the nn_a-row columns -> transpose -> * wmid
//            -> DIF down the nn_b-row columns -> [post *] -> canonicalize
//   inverse: the DIT mirror with the inverse twiddles, where the caller
//            passes (nn_a, nn_b) = (n2, n1).
// Input (B, nn_a, nn_b) uint32; output (B, nn_b, nn_a) canonical uint32.
// pre is (nn_a, nn_b), in input orientation; wmid and post are (nn_b,
// nn_a), in output orientation. Each side runs its own column network,
// plain or nested, with its own nested mid vector (colpass_tile.cuh).
//
// What bounds it on an H100, and the design. The TPU kernel holds the
// whole matrix in VMEM and transposes it in registers. An H100 block has
// 227 KB of shared memory and the matrix of one n = 2^20 transform is
// 4 MB, more than even a 16-block cluster's shared memory. So this kernel
// computes the same function with the matrix in device memory between the
// two sides, in one launch:
//   phase A: each (batch row, TL_a-column tile of nn_b) is loaded into
//            shared memory (times pre on load), runs side a, and is stored
//            transposed, times wmid, into a (B, nn_b, nn_a) scratch buffer
//            that the caller allocates (in the reduction's domain);
//   cooperative_groups grid sync, which also orders the scratch writes
//            before the reads;
//   phase B: each (batch row, TL_b-column tile of nn_a) of the scratch is
//            loaded through L2, runs side b, and is stored times post,
//            canonicalized, to the output.
// The blocks are persistent: grid = min(tiles, co-resident blocks), from
// the occupancy API at this kernel's registers and shared memory. The floor
// is device-memory bytes: the input, the scratch and the output each cross
// once; at B = 1 the 4 MB scratch stays in the 50 MB L2.
//
// What held the first design back, 7.68x its bound at B = 256 (PERF.md):
// a static schedule, block b taking tiles b, b + grid, ..., so a block that
// drew slow tiles set the phase's end for all; and one shared-memory round
// trip and one barrier per radix-2 stage, ten stages a side at 1024 x 1024.
// What this design does about each:
//   - a dynamic tile schedule: in each phase a block takes its next tile
//     from an atomic counter (thread 0 adds, the index reaches the block
//     through shared memory and a barrier), so blocks finish a phase
//     together. The two counters are a small int32 buffer that the caller
//     owns, one per transform object and stream, zeroed once when it is
//     made; the kernel resets them itself, with no memset launch: block 0
//     zeroes phase B's counter before the grid sync (no block takes a
//     phase-B tile before it) and phase A's after it (every block has left
//     phase A), so every launch finds phase A's counter at zero. Launches
//     that share a buffer must therefore not overlap, which launches on one
//     stream never do;
//   - register stage groups: each phase of each side runs in groups of up
//     to kFuse radix-2 stages held in registers between two exchanges
//     (colpass_tile.cuh run_phase: DIF run_group, DIT run_group_dit), one
//     barrier a group instead of one a stage, in the same per-butterfly
//     operation order, so the output bits do not change. At 1024 x 1024
//     each side is nested 32 x 32, five stages a phase: groups of 3 + 2
//     (or 4 + 1) replace five barriers by two. kFuse = 3 was chosen from
//     fwd_mat at B = 256, 1024 x 1024, on an H100 80GB HBM3 at 700 W, timed
//     in turns against builds with kFuse = 4 and 1 and the first design:
//     at 4 the registers a thread rise and the blocks per SM fall, and it
//     is slower than 3 (PERF.md section 6 gives the readings and how they
//     were taken).
//
// Sides above one launch (a side of more than ops/colpass.py LAUNCH_ROWS
// = 4,096 rows: BabyBear n = 2^27 at 8192 x 16384, n = 2^17 at 8 x 16384
// or 16384 x 8, a flat split's inner 2^14 x 2^13 from n = 2^27), and sides
// of one row (the split (1, n)), make the launch a short list of steps
// instead of the two phases above, with a grid sync between consecutive
// steps (fused_steps_kernel). Each side runs the launches its column pass
// would run on the card (ops/colpass.py launch_plan, ops/fused_fourstep.py
// fused_steps): one whole-column step (column_tile, as above), or its tall
// route's phase A and phase B, each one step or, above LAUNCH_ROWS rows,
// two (colpass_tile.cuh Tall), on column_tile_io's swizzled tile; a side
// of one row is one elementwise step (row_step). Side a is DIF (DIT) over
// nn_a with 'pre' on its first step's load and wmid, the transposing
// store's 'post_t', on its last step's; side b over nn_b with 'post' and
// canonicalize on its last step's store. The buffers ping-pong between
// out and scratch so that the last step writes out (forward with both
// sides tall: aA: x -> scratch, aB: scratch -> out, bA: out -> scratch,
// bB: scratch -> out). Every step after the first reads what other blocks
// of the launch wrote, through L2 only (Load::kL2, column_tile_io's kL2,
// row_step: __ldcg): L1 keeps no line of it across the grid sync. The
// launch with two whole sides is fused_kernel, whose code and times are
// the ones above.
//
// What held the step list's first design back, 8.5x its bound at BabyBear
// n = 2^27 and 26-69x at n = 2^17-2^20 (PERF.md section 6, row 2t), and
// what this one does about each:
//   - the launch's shared memory is its largest step's, and an 8,192-row
//     whole side took 128 KB, so every step ran one block an SM: no step
//     holds a tile above LAUNCH_ROWS rows now (an 8,192-row side is its
//     tall route's two steps, 16 KB tiles), and the launch is sized from
//     the steps it has;
//   - one kernel a direction held the code of every step kind, 64 / 80
//     registers (DIF / DIT): a list's kernel is the instantiation of the
//     step kinds it holds (StepSet), so a list of whole tall phases
//     carries neither the whole side's row-major code nor the split
//     phases' index arithmetic, and every instantiation has a minimum of
//     blocks an SM (kStepMinBlocks);
//   - a one-row side was a whole step of zero stages at TL = 32, a
//     counter add and two barriers for every 32 values (32,768 tiles at
//     (1, 2^20)): it is one grid-stride loop with no counter; and a whole
//     side of 2 or 4 rows takes a tile as wide as makes 256 values (up to
//     256 columns), one counter add for as many values as the block has
//     threads.
// PERF.md section 6 gives what a grid sync costs, read with
// scripts/grid_sync.cu (python -m ntt_aie_tpu_torch.scripts.fused_turns
// --sync).

// The tile counters. fused_kernel's two, and fused_steps_kernel's one a
// step (the wrapper's buffer, at most kMaxSteps), follow one rule: block 0
// zeroes every counter but step 0's as the launch starts (no block takes
// a tile of step k >= 1 before the grid sync that ends step k - 1, which
// block 0 reaches after its zeroing), and step 0's right after the first
// grid sync (every block has left step 0). So every launch finds step 0's
// counter at zero and leaves it so; launches that share the buffer must
// not overlap, which launches on one stream never do.

#include <cooperative_groups.h>

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
constexpr int kFuse = 3;  // radix-2 stages a register group (see above)
constexpr int kMaxSteps = 8;  // a side's launches: at most 4 (two split
                              // phases); a list at most 5 (a 2^27 side and
                              // a one-row side)

struct Params {
  Network a, b;     // side a over nn_a rows, side b over nn_b rows
  TileOps ops_a;    // [pre] on load; wmid (nn_b, nn_a) on the transposed
                    // store
  TileOps ops_b;    // L2 load; [post] (nn_b, nn_a) and canonicalize on
                    // store
  const uint32_t* x;
  uint32_t* scratch;
  uint32_t* out;
  int* counters;  // the tile counters of phases A and B (A zero at launch)
  int batch;
  Red red;  // the reduction and its constants
};

// The block's next tile from *counter: thread 0 takes it, the barrier hands
// it to every thread. The caller's next barrier (every column_tile has one
// after its load) orders these reads before thread 0's next write.
__device__ __forceinline__ int take_tile(int* counter, int* slot) {
  if (threadIdx.x == 0) *slot = atomicAdd(counter, 1);
  __syncthreads();
  return *slot;
}

template <bool kPre, bool kPost>
__global__ void __launch_bounds__(kThreads) fused_kernel(const Params P) {
  using colpass_tile::Load;
  extern __shared__ uint32_t tile[];
  __shared__ int slot;
  const size_t plane = (size_t)P.a.nn * P.b.nn;
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicExch(P.counters + 1, 0);

  const int per_row_a = P.b.nn >> P.ops_a.log_tl;
  const int tiles_a = P.batch * per_row_a;
  for (int t; (t = take_tile(P.counters, &slot)) < tiles_a;) {
    const size_t row = t / per_row_a;
    colpass_tile::column_tile<kPre ? Load::kPre : Load::kPlain, true, true,
                              kFuse>(
        tile, P.a, P.ops_a, P.x + row * plane, P.scratch + row * plane,
        (size_t)(t % per_row_a) << P.ops_a.log_tl, P.red);
    __syncthreads();
  }

  cooperative_groups::this_grid().sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicExch(P.counters, 0);

  const int per_row_b = P.a.nn >> P.ops_b.log_tl;
  const int tiles_b = P.batch * per_row_b;
  for (int t; (t = take_tile(P.counters + 1, &slot)) < tiles_b;) {
    const size_t row = t / per_row_b;
    colpass_tile::column_tile<Load::kL2, false, kPost, kFuse>(
        tile, P.b, P.ops_b, P.scratch + row * plane, P.out + row * plane,
        (size_t)(t % per_row_b) << P.ops_b.log_tl, P.red);
    __syncthreads();
  }
}

using KernelFn = void (*)(Params);

// ---- the step list (sides above one launch) ----

// What a step runs: a whole side (column_tile: side a with or without the
// 'pre' operand, side b with or without 'post'), or one launch of a side's
// tall route (column_tile_io with colpass_tile::Tall): A with or without
// the 'pre' operand, a split A's first launch with it, an in-place launch
// (a split phase's first; side b's last without 'post', canonicalizing),
// side a's transposing last launch (wmid as 'post_t'), side b's last with
// 'post' and canonicalize; or a side of one row (row_step). Whether the
// transform has 'pre' and 'post' is a code, not a template parameter.
enum StepCode : int {
  kStepWholeA = 0,
  kStepWholeAPre = 1,
  kStepWholeB = 2,
  kStepWholeBPost = 3,
  kStepTallAPre = 4,
  kStepTallA = 5,
  kStepTallPre = 6,
  kStepInPlace = 7,
  kStepTallBT = 8,
  kStepTallBPost = 9,
  kStepRow = 10,
  // not a host code: make_steps gives it a DIF split phase A's 'lo' step
  // (kStepTallA) that stages its moved store (colpass_tile.cuh
  // kStagedLogCols)
  kStepTallALo = 11,
};

// The step kernel's instantiations, by the steps a list holds, so that the
// main path's lists carry only the code (and the registers) their steps
// need: kSetTall, launches of whole tall phases and sides of one row
// (BabyBear n = 2^27 at 8192 x 16384, any split (1, n) of a side up to
// 2^24 rows); kSetAll, also whole sides (n = 2^17 at 8 x 16384) and the
// launches of split phases (colpass_tile.cuh run_group_io's kGroup).
enum StepSet : int { kSetTall = 0, kSetAll = 1 };

// The instantiations' __launch_bounds__ minimum of blocks an SM: 4, at
// most 64 registers a thread. Read in turns on an H100 at BabyBear
// n = 2^27 (PERF.md section 6): with no minimum nvcc gave the step
// kernels 96-112 registers, 2 blocks an SM (fused fwd_mat 4.16 ms); at 5
// (48 registers) the DIF kernel spilled in its loops and took 3.92 ms; at
// 4, 3.47 ms.
constexpr int kStepMinBlocks = 4;

enum StepBuf : int { kBufX = 0, kBufOut = 1, kBufScratch = 2 };

// One step: a whole side's network with its table planes and TileOps
// (column_tile's; a one-row side's operands as planes in ops.pre_* and
// ops.mat_*), or a tall launch's network over its view with its pair
// tables (column_tile_io's).
struct Step {
  Network net;
  TileOps ops;
  colpass_tile::PairTables tables;
  colpass_tile::TallView view;
  int code, src, dst;
  int batch_mult;  // the launch's batch rows a batch row: a 'lo' launch's P
  int shift;       // the swizzled tile's (column_tile_io's)
};

struct StepParams {
  Step steps[kMaxSteps];
  int nsteps;  // the steps the launch runs (a prefix, for the checks)
  const uint32_t* x;
  uint32_t* scratch;
  uint32_t* out;
  int* counters;  // one a step (step 0's zero at launch)
  int batch;
  Red red;
};

// One tile (block x of batch row y of the step's launch view) of a tall
// step. kGroup: the list holds a launch of a split phase, and every tall
// step runs the split kind (one instantiation takes a whole phase's and a
// split one's); without it the view's group parts are compile-time zeros.
template <bool kDit, bool kGroup>
__device__ __forceinline__ void tall_tile(uint32_t* tile, const Step& S,
                                          const uint32_t* src, uint32_t* dst,
                                          int bx, int y, Red R) {
  using colpass_tile::column_tile_io;
  using colpass_tile::kOpMat;
  using colpass_tile::kOpNone;
  using colpass_tile::kTallA;
  using colpass_tile::kTallB;
  using colpass_tile::kTallPre;
  const int p = kGroup ? y & ((1 << S.view.log_lp) - 1) : 0;  // 'lo' array
  const size_t col0 = colpass_tile::tall_col0<kTallB, false, kGroup>(
      bx, S.ops.log_tl, S.tables, S.view);
  const size_t col0_a =  // a 'hi' phase A's split tile
      colpass_tile::tall_col0<kTallA, false, kGroup>(bx, S.ops.log_tl,
                                                     S.tables, S.view);
  const auto& N = S.net;
  const auto& O = S.ops;
  const auto& T = S.tables;
  switch (S.code) {
    case kStepTallAPre:
      column_tile_io<kDit, false, false, kFuse, false, kOpMat, kOpNone,
                     kTallA, true, kGroup>(tile, N, O, T, src, dst, col0_a,
                                           S.shift, R, S.view, p);
      break;
    case kStepTallA:
      column_tile_io<kDit, false, false, kFuse, false, kOpNone, kOpNone,
                     kTallA, true, kGroup>(tile, N, O, T, src, dst, col0_a,
                                           S.shift, R, S.view, p);
      break;
    case kStepTallALo:  // a DIF split phase A's 'lo' launch, staged
      if constexpr (kGroup && !kDit)
        column_tile_io<kDit, false, false, kFuse, false, kOpNone, kOpNone,
                       kTallA, true, true, true>(tile, N, O, T, src, dst,
                                                 col0_a, S.shift, R, S.view,
                                                 p);
      break;
    case kStepTallPre:  // a split phase A's first launch only
      if constexpr (kGroup)
        column_tile_io<kDit, false, false, kFuse, false, kOpMat, kOpNone,
                       kTallPre, true, true>(tile, N, O, T, src, dst, col0,
                                             S.shift, R, S.view, p);
      break;
    case kStepInPlace:
      column_tile_io<kDit, false, false, kFuse, false, kOpNone, kOpNone,
                     kTallB, true, kGroup>(tile, N, O, T, src, dst, col0,
                                           S.shift, R, S.view, p);
      break;
    case kStepTallBT:
      column_tile_io<kDit, true, true, kFuse, false, kOpNone, kOpNone,
                     kTallB, true, kGroup>(
          tile, N, O, T, src, dst,
          colpass_tile::tall_col0<kTallB, true, kGroup>(bx, O.log_tl, T,
                                                        S.view),
          S.shift, R, S.view, p);
      break;
    case kStepTallBPost:
      column_tile_io<kDit, false, false, kFuse, false, kOpNone, kOpMat,
                     kTallB, true, kGroup>(tile, N, O, T, src, dst, col0,
                                           S.shift, R, S.view, p);
      break;
  }
}

// One tile of a whole-side step (column_tile, row-major).
__device__ __forceinline__ void whole_tile(uint32_t* tile, const Step& S,
                                           const uint32_t* s, uint32_t* d,
                                           size_t col0, Red R) {
  using colpass_tile::Load;
  switch (S.code) {
    case kStepWholeA:
      colpass_tile::column_tile<Load::kPlain, true, true, kFuse>(
          tile, S.net, S.ops, s, d, col0, R);
      break;
    case kStepWholeAPre:
      colpass_tile::column_tile<Load::kPre, true, true, kFuse>(
          tile, S.net, S.ops, s, d, col0, R);
      break;
    case kStepWholeB:
      colpass_tile::column_tile<Load::kL2, false, false, kFuse>(
          tile, S.net, S.ops, s, d, col0, R);
      break;
    case kStepWholeBPost:
      colpass_tile::column_tile<Load::kL2, false, true, kFuse>(
          tile, S.net, S.ops, s, d, col0, R);
      break;
  }
}

// A side of one row (the split (1, n); no stage): every value of every
// batch row times the side's operands, each indexed by its column c (side
// a: 'pre', then wmid, whose transposed store keeps a one-row side's
// index; side b: 'post'), then canonicalize where side b's store does. A
// grid-stride loop over the launch's threads: no tile, no counter, no
// barrier. Every load goes through L2 only (__ldcg): side b's reads what
// other blocks wrote in the step before.
__device__ __forceinline__ void row_step(const Step& S, const uint32_t* src,
                                         uint32_t* dst, int batch, Red R) {
  const TileOps& O = S.ops;
  const size_t n = (size_t)batch * O.ncols;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const size_t c = i & (size_t)(O.ncols - 1);
    uint32_t v = __ldcg(src + i);
    if (O.pre_w) v = R.mulc(v, __ldg(O.pre_w + c), __ldg(O.pre_s + c));
    if (O.mat_w) v = R.mulc(v, __ldg(O.mat_w + c), __ldg(O.mat_s + c));
    if (O.canonicalize) v = R.canon(v);
    dst[i] = v;
  }
}

// The launch of a step list, a grid sync between steps. A step takes its
// tiles from its own counter (the counters' rule: the top of this file),
// each block adding for its next tile before it runs the current one: the
// add's result waits in thread 0's register and reaches the block through
// one of two shared slots in turn, so its latency hides behind the tile
// (a block of a step with fewer tiles than blocks taking tile b on block
// b instead was no faster on an H100, PERF.md section 6). A
// one-row step takes no tile. P.nsteps is the steps the launch runs: a
// list's all, or for the card's checks a prefix of it (ntt_fused_steps'
// nrun), at the whole list's instantiation, grid and shared memory. A
// list has at least two steps; a launch of one step, a prefix that only
// the checks run, ends with a grid sync so that block 0 can reset step
// 0's counter after it.
template <bool kDit, int kSet>
__global__ void __launch_bounds__(kThreads, kStepMinBlocks)
    fused_steps_kernel(const __grid_constant__ StepParams P) {
  extern __shared__ uint32_t tile[];
  __shared__ int slot[2];
  if (blockIdx.x == 0 && threadIdx.x == 0)
    for (int k = 1; k < P.nsteps; ++k) atomicExch(P.counters + k, 0);
  for (int k = 0; k < P.nsteps; ++k) {
    if (k > 0) {
      cooperative_groups::this_grid().sync();
      if (k == 1 && blockIdx.x == 0 && threadIdx.x == 0)
        atomicExch(P.counters, 0);
    }
    const Step& S = P.steps[k];
    const uint32_t* src = S.src == kBufX     ? P.x
                          : S.src == kBufOut ? P.out
                                             : P.scratch;
    uint32_t* dst = S.dst == kBufOut ? P.out : P.scratch;
    if (S.code == kStepRow) {
      row_step(S, src, dst, P.batch, P.red);
      continue;
    }
    const size_t plane = (size_t)S.net.nn * S.ops.ncols;
    const int per_row = S.ops.ncols >> S.ops.log_tl;
    const int tiles = P.batch * S.batch_mult * per_row;
    int t = take_tile(P.counters + k, slot);
    for (int i = 1; t < tiles; ++i) {
      int next = 0;
      if (threadIdx.x == 0) next = atomicAdd(P.counters + k, 1);
      const int y = t / per_row, bx = t % per_row;
      const uint32_t* s = src + (size_t)y * plane;
      uint32_t* d = dst + (size_t)y * plane;
      if (kSet == kSetAll && S.code < kStepTallAPre)
        whole_tile(tile, S, s, d, (size_t)bx << S.ops.log_tl, P.red);
      else
        tall_tile<kDit, kSet == kSetAll>(tile, S, s, d, bx, y, P.red);
      if (threadIdx.x == 0) slot[i & 1] = next;
      __syncthreads();  // also: every thread is done with the tile
      t = slot[i & 1];
    }
  }
  if (P.nsteps == 1) {
    cooperative_groups::this_grid().sync();
    if (blockIdx.x == 0 && threadIdx.x == 0) atomicExch(P.counters, 0);
  }
}

using StepsFn = void (*)(StepParams);

template <bool kDit>
StepsFn pick_steps(int set) {
  return set == kSetTall ? fused_steps_kernel<kDit, kSetTall>
                         : fused_steps_kernel<kDit, kSetAll>;
}

StepsFn pick_steps(bool dit, int set) {
  return dit ? pick_steps<true>(set) : pick_steps<false>(set);
}

// The instantiation for these operands.
KernelFn pick_kernel(bool pre, bool post) {
  return !pre ? (post ? fused_kernel<false, true> : fused_kernel<false, false>)
              : (post ? fused_kernel<true, true> : fused_kernel<true, false>);
}

// Opts the kernel in to smem dynamic bytes and returns its co-resident
// blocks per SM (*per_sm) and the SM count; a cudaError_t on failure.
template <class Fn>
cudaError_t occupancy(Fn kernel, size_t smem, int* per_sm, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 48 * 1024)  // above 48 KB only opted in
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                        kThreads, smem);
  return err;
}

size_t tile_smem(int nn_a, int nn_b, int log_tl_a, int log_tl_b) {
  const size_t smem_a = (size_t)nn_a << log_tl_a << 2;
  const size_t smem_b = (size_t)nn_b << log_tl_b << 2;
  return smem_a > smem_b ? smem_a : smem_b;
}

// A step's host description (ops/fused_fourstep.py _step_args): kStepInts
// ints and kStepPtrs pointers a step, in these slots.
enum StepInt : int {
  kICode, kISrc, kIDst, kIRows, kINcols, kILogTl, kIBatchMult, kINstages,
  kIK0, kILogA, kICanon, kILogInner, kILogHq, kILogLp, kIShift, kITs,
  kIOffs = kITs + colpass_tile::kMaxStages,
  kStepInts = kIOffs + colpass_tile::kMaxStages,
};
enum StepPtr : int {
  // a whole step's planes (column_tile)
  kPTwW, kPTwS, kPMidW, kPMidS, kPPreW, kPPreS, kPMatW, kPMatS,
  // a tall step's pairs (column_tile_io)
  kPTw, kPMid, kPMat, kPPre, kPPost,
  kStepPtrs,
};

bool is_tall(int code) {
  return code >= kStepTallAPre && code <= kStepTallBPost;
}

// Fills P's steps from the host description and *set with the kernel
// instantiation they need (StepSet); false for one the kernel does not
// take (then P is not launched). A whole side's tile may be wider than a
// column kernel's (up to 256 columns: a tile of a side of 2 or 4 rows
// holds as many values as the block has threads); a one-row side's step
// has no tile.
bool make_steps(StepParams* P, int dit, int nsteps, const int* ints,
                const void* const* ptrs, int batch, size_t* smem,
                long long* tiles, int* set) {
  if (nsteps < 1 || nsteps > kMaxSteps || batch < 1) return false;
  *smem = 0;
  *tiles = 0;
  *set = kSetTall;
  for (int k = 0; k < nsteps; ++k) {
    const int* I = ints + k * kStepInts;
    const void* const* Q = ptrs + k * kStepPtrs;
    Step& S = P->steps[k];
    const int code = I[kICode], rows = I[kIRows], ncols = I[kINcols];
    const int log_tl = I[kILogTl];
    const bool tall = is_tall(code), row = code == kStepRow;
    if (code < kStepWholeA || code > kStepRow || rows > 8192 ||
        (row && (rows != 1 || (ncols & (ncols - 1)))) || log_tl < 0 ||
        log_tl > (tall ? 5 : 8) || (ncols >> log_tl) < 1 ||
        I[kIBatchMult] < 1 || I[kISrc] < kBufX || I[kISrc] > kBufScratch ||
        I[kIDst] < kBufOut || I[kIDst] > kBufScratch ||
        (k == 0) != (I[kISrc] == kBufX) || I[kISrc] == I[kIDst] ||
        I[kINstages] != colpass_tile::ilog2(rows) ||
        (tall && (I[kILogA] >= 0 || rows < 2)) ||
        !colpass_tile::make_network(
            &S.net, rows, dit, I[kINstages], I[kIK0],
            I + kITs, I + kIOffs, tall ? nullptr : Q[kPTwW],
            tall ? nullptr : Q[kPTwS], I[kILogA],
            tall ? nullptr : Q[kPMidW], tall ? nullptr : Q[kPMidS]))
      return false;
    S.code = code;
    S.src = I[kISrc];
    S.dst = I[kIDst];
    S.batch_mult = I[kIBatchMult];
    S.shift = I[kIShift];
    S.ops.pre_w = static_cast<const uint32_t*>(Q[kPPreW]);
    S.ops.pre_s = static_cast<const uint32_t*>(Q[kPPreS]);
    S.ops.mat_w = static_cast<const uint32_t*>(Q[kPMatW]);
    S.ops.mat_s = static_cast<const uint32_t*>(Q[kPMatS]);
    S.ops.ncols = ncols;
    S.ops.log_tl = log_tl;
    S.ops.canonicalize = I[kICanon];
    const int log_inner = tall ? I[kILogInner] : 0;
    const int log_hq = I[kILogHq], log_lp = I[kILogLp];
    S.tables.tw = static_cast<const uint2*>(Q[kPTw]);
    S.tables.mid = static_cast<const uint2*>(Q[kPMid]);
    S.tables.mat = static_cast<const uint2*>(Q[kPMat]);
    S.tables.pre = static_cast<const uint2*>(Q[kPPre]);
    S.tables.post = static_cast<const uint2*>(Q[kPPost]);
    S.tables.pre2 = S.tables.post2 = nullptr;
    S.tables.log_s = 0;
    S.tables.log_inner = log_inner;
    S.tables.log_ncols = tall ? colpass_tile::ilog2(ncols) - log_inner : 0;
    S.view.log_vc = S.tables.log_ncols + log_inner - log_hq;
    S.view.log_iq = log_inner - log_hq;
    // the split tile's (colpass.cu's ntt_colpass): a 'hi' phase A's over Q
    // and vc, a transposing phase B's over inner and ncols
    const bool hi_a =
        (code == kStepTallA || code == kStepTallAPre) && log_hq > 0;
    const int split_inner = hi_a ? log_hq : log_inner;
    S.tables.log_tlc = colpass_tile::tall_store_log_cols(
        2, log_tl, split_inner,
        hi_a ? S.view.log_vc : S.tables.log_ncols);
    S.view.log_hq = log_hq;
    S.view.log_lp = log_lp;
    S.view.log_rows = S.net.log_nn + log_hq + log_lp;
    S.view.log_tall = S.view.log_rows + S.view.log_vc - S.tables.log_ncols;
    if (tall && (log_inner < 1 || (ncols >> log_inner) < 1 || !Q[kPTw] ||
                 !Q[kPMid] || log_hq < 0 || log_lp < 0 ||
                 (log_hq && log_lp) || log_hq > log_inner ||
                 (1 << log_lp) != I[kIBatchMult] ||
                 log_tl - S.tables.log_tlc > split_inner))
      return false;
    if (!tall && (log_hq || log_lp || I[kIBatchMult] != 1)) return false;
    if (code == kStepTallA &&
        colpass_tile::staged_store(colpass_tile::kTallA, dit != 0,
                                   log_hq || log_lp, S.tables.log_ncols))
      S.code = kStepTallALo;
    if ((tall && (log_hq || log_lp)) || code == kStepTallPre ||
        (!tall && !row))
      *set = kSetAll;
    const size_t step_smem = row ? 0 : (size_t)rows << log_tl << 2;
    if (step_smem > *smem) *smem = step_smem;
    const long long t = (long long)batch * I[kIBatchMult] * (ncols >> log_tl);
    if (t > (1ll << 30)) return false;
    if (!row && t > *tiles) *tiles = t;
  }
  P->nsteps = nsteps;
  P->batch = batch;
  return *smem <= (size_t)kMaxSmemBytes;
}

// Launches P (filled by make_steps) cooperatively on `stream`: the
// instantiation of its set, the grid the smaller of its largest step's
// tiles and the co-resident blocks.
int launch_steps(StepParams* P, int dit, int set, size_t smem,
                 long long tiles, void* stream) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  const StepsFn kernel = pick_steps(dit != 0, set);
  err = occupancy(kernel, smem, &per_sm, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const long long capacity = (long long)per_sm * sms;
  const int grid = static_cast<int>(tiles > 0 && tiles < capacity ? tiles
                                                                  : capacity);
  void* args[] = {P};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(grid), dim3(kThreads),
      args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The reduction this library is built for (ops/reductions.py's kind).
const char* ntt_reduction_name() { return reductions::kBuiltName; }

const char* ntt_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// This build's register group size, and for the kernel of these operands
// (pre, post: nonzero when present) at these tile shapes: its registers a
// thread and its co-resident blocks per SM. Returns 0 or a cudaError_t.
int ntt_fused_kernel_info(int pre, int post, int nn_a, int nn_b,
                          int log_tl_a, int log_tl_b, int* kfuse, int* regs,
                          int* per_sm) {
  const KernelFn kernel = pick_kernel(pre != 0, post != 0);
  cudaFuncAttributes attr = {};
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  int sms = 0;
  if (err == cudaSuccess)
    err = occupancy(kernel, tile_smem(nn_a, nn_b, log_tl_a, log_tl_b),
                    per_sm, &sms);
  *kfuse = kFuse;
  *regs = attr.numRegs;
  return static_cast<int>(err);
}

// This build's register group size, and for the step kernel of this
// direction over these steps (the host description of ntt_fused_steps):
// its instantiation (*set: StepSet), registers a thread and co-resident
// blocks per SM at the steps' largest tile. Returns 0 or a cudaError_t.
int ntt_fused_steps_info(int dit, int nsteps, const int* ints,
                         const void* const* ptrs, int* kfuse, int* set,
                         int* regs, int* per_sm) {
  StepParams P;  // the host description's check only
  size_t smem = 0;
  long long tiles = 0;
  *kfuse = kFuse;
  *regs = 0;
  if (!make_steps(&P, dit, nsteps, ints, ptrs, 1, &smem, &tiles, set))
    return static_cast<int>(cudaErrorInvalidValue);
  const StepsFn kernel = pick_steps(dit != 0, *set);
  cudaFuncAttributes attr = {};
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  int sms = 0;
  if (err == cudaSuccess) err = occupancy(kernel, smem, per_sm, &sms);
  *regs = attr.numRegs;
  return static_cast<int>(err);
}

// Launches one fused transform of sides above one launch on `stream`,
// cooperatively, as a step list (fused_steps_kernel). x: (batch, nn_a,
// nn_b) uint32; scratch and out: (batch, nn_b, nn_a). counters: one int32 a
// step on the device, zero before the first launch (the rule at the top).
// nsteps steps, each kStepInts ints and kStepPtrs pointers (StepInt,
// StepPtr; ops/fused_fourstep.py _step_args); dit: the transform's
// direction. nrun: the steps to run, nsteps for the transform; a smaller
// count runs that prefix of the list at the whole list's instantiation,
// grid and shared memory (the card's checks of each step). p, c1, c2: the
// reduction's prime and constants. Returns 0 when launched, else a
// cudaError_t: cudaErrorInvalidValue for steps the kernel does not take,
// cudaErrorNotSupported for a device without cooperative launch, or the
// launch's own error.
int ntt_fused_steps(const void* x, void* scratch, void* out, void* counters,
                    int batch, int dit, int nsteps, int nrun,
                    const int* ints, const void* const* ptrs, unsigned int p,
                    unsigned int c1, unsigned int c2, void* stream) {
  StepParams P;  // the launch copies its arguments
  size_t smem = 0;
  long long tiles = 0;
  int set = kSetTall;
  if (!counters || nrun < 1 || nrun > nsteps ||
      !make_steps(&P, dit, nsteps, ints, ptrs, batch, &smem, &tiles, &set))
    return static_cast<int>(cudaErrorInvalidValue);
  P.nsteps = nrun;
  P.x = static_cast<const uint32_t*>(x);
  P.scratch = static_cast<uint32_t*>(scratch);
  P.out = static_cast<uint32_t*>(out);
  P.counters = static_cast<int*>(counters);
  P.red = Red::make(p, c1, c2);
  return launch_steps(&P, dit, set, smem, tiles, stream);
}

// Launches one fused transform on `stream`, cooperatively. x: (batch,
// nn_a, nn_b) uint32; scratch and out: (batch, nn_b, nn_a). counters: two
// int32 on the device, zero before the first launch; each launch leaves the
// first (phase A's) at zero and zeroes the second before phase B, so
// launches that use them must not overlap. Side s in {a, b}: ts_s /
// offs_s host arrays of nstages_s half sizes and table offsets, k0_s stages
// in phase 0, log_a_s < 0 for a plain network (then mid pointers null).
// pre/post pointers null when absent. p, c1, c2: the reduction's prime and
// constants (Red::make). Returns 0 when launched, else a
// cudaError_t: cudaErrorInvalidValue for arguments the kernel does not
// take, cudaErrorNotSupported for a device without cooperative launch, or
// the launch's own error.
int ntt_fused_fourstep(
    const void* x, void* scratch, void* out, void* counters, int batch,
    int nn_a, int nn_b, int log_tl_a, int log_tl_b, int dit,
    int nstages_a, int k0_a, const int* ts_a, const int* offs_a,
    const void* tw_a_w, const void* tw_a_s, int log_a_a,
    const void* mid_a_w, const void* mid_a_s,
    int nstages_b, int k0_b, const int* ts_b, const int* offs_b,
    const void* tw_b_w, const void* tw_b_s, int log_a_b,
    const void* mid_b_w, const void* mid_b_s,
    const void* wmid_w, const void* wmid_s, const void* pre_w,
    const void* pre_s, const void* post_w, const void* post_s,
    unsigned int p, unsigned int c1, unsigned int c2, void* stream) {
  const size_t smem = tile_smem(nn_a, nn_b, log_tl_a, log_tl_b);
  Params P;
  if (smem > (size_t)kMaxSmemBytes || batch < 1 || !counters ||
      (nn_b >> log_tl_a) < 1 || (nn_a >> log_tl_b) < 1 ||
      (long long)batch * (nn_b >> log_tl_a) > (1ll << 30) ||
      (long long)batch * (nn_a >> log_tl_b) > (1ll << 30) ||
      !colpass_tile::make_network(&P.a, nn_a, dit, nstages_a, k0_a, ts_a,
                                  offs_a, tw_a_w, tw_a_s, log_a_a, mid_a_w,
                                  mid_a_s) ||
      !colpass_tile::make_network(&P.b, nn_b, dit, nstages_b, k0_b, ts_b,
                                  offs_b, tw_b_w, tw_b_s, log_a_b, mid_b_w,
                                  mid_b_s))
    return static_cast<int>(cudaErrorInvalidValue);
  P.ops_a.pre_w = static_cast<const uint32_t*>(pre_w);
  P.ops_a.pre_s = static_cast<const uint32_t*>(pre_s);
  P.ops_a.mat_w = static_cast<const uint32_t*>(wmid_w);
  P.ops_a.mat_s = static_cast<const uint32_t*>(wmid_s);
  P.ops_a.ncols = nn_b;
  P.ops_a.log_tl = log_tl_a;
  P.ops_a.canonicalize = 0;
  P.ops_b.pre_w = P.ops_b.pre_s = nullptr;
  P.ops_b.mat_w = static_cast<const uint32_t*>(post_w);
  P.ops_b.mat_s = static_cast<const uint32_t*>(post_s);
  P.ops_b.ncols = nn_a;
  P.ops_b.log_tl = log_tl_b;
  P.ops_b.canonicalize = 1;
  P.x = static_cast<const uint32_t*>(x);
  P.scratch = static_cast<uint32_t*>(scratch);
  P.out = static_cast<uint32_t*>(out);
  P.counters = static_cast<int*>(counters);
  P.batch = batch;
  P.red = Red::make(p, c1, c2);

  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  const KernelFn kernel = pick_kernel(pre_w != nullptr, post_w != nullptr);
  err = occupancy(kernel, smem, &per_sm, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const long long tiles_a = (long long)batch * (nn_b >> log_tl_a);
  const long long tiles_b = (long long)batch * (nn_a >> log_tl_b);
  const long long tiles = tiles_a > tiles_b ? tiles_a : tiles_b;
  const long long capacity = (long long)per_sm * sms;
  const int grid = static_cast<int>(tiles < capacity ? tiles : capacity);
  void* args[] = {&P};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(grid), dim3(kThreads),
      args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
