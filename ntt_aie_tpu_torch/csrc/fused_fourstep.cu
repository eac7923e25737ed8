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

// The instantiation for these operands.
KernelFn pick_kernel(bool pre, bool post) {
  return !pre ? (post ? fused_kernel<false, true> : fused_kernel<false, false>)
              : (post ? fused_kernel<true, true> : fused_kernel<true, false>);
}

// Opts the kernel in to smem dynamic bytes and returns its co-resident
// blocks per SM (*per_sm) and the SM count; a cudaError_t on failure.
cudaError_t occupancy(KernelFn kernel, size_t smem, int* per_sm, int* sms) {
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
