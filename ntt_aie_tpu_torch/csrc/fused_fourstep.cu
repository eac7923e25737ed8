// Fused four-step NTT kernel for NVIDIA Hopper (sm_90a): a whole
// transform in one cooperative launch.
//
// Replaces ntt_aie_tpu/ops/pallas_ntt.py::build_fused_fourstep (the Pallas
// TPU kernel). Over an (nn_a, nn_b) matrix per batch row:
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
//            that the caller allocates (lazy, [0, 4p));
//   cooperative_groups grid sync, which also orders the scratch writes
//            before the reads;
//   phase B: each (batch row, TL_b-column tile of nn_a) of the scratch is
//            loaded through L2, runs side b, and is stored times post,
//            canonicalized, to the output.
// The blocks are persistent (grid = min(tiles, co-resident blocks)) and
// loop over the tiles of each phase. The floor is device-memory bytes:
// the input, the scratch and the output each cross once; at B = 1 the
// 4 MB scratch stays in the 50 MB L2. Like the column pass, this simple
// design is held by the in-SM work of one shared-memory round trip and one
// barrier per radix-2 stage, not by that floor.

#include <cooperative_groups.h>

#include "colpass_tile.cuh"

namespace {

using colpass_tile::Network;
using colpass_tile::TileOps;

constexpr int kThreads = 256;
constexpr int kMaxSmemBytes = 227 * 1024;  // an H100 block's limit

struct Params {
  Network a, b;     // side a over nn_a rows, side b over nn_b rows
  TileOps ops_a;    // [pre] on load; wmid (nn_b, nn_a) on the transposed
                    // store
  TileOps ops_b;    // L2 load; [post] (nn_b, nn_a) and canonicalize on
                    // store
  const uint32_t* x;
  uint32_t* scratch;
  uint32_t* out;
  int batch;
  uint32_t p;
};

template <bool kPre, bool kPost>
__global__ void __launch_bounds__(kThreads) fused_kernel(const Params P) {
  using colpass_tile::Load;
  extern __shared__ uint32_t tile[];
  const size_t plane = (size_t)P.a.nn * P.b.nn;

  const int per_row_a = P.b.nn >> P.ops_a.log_tl;
  for (int t = blockIdx.x; t < P.batch * per_row_a; t += gridDim.x) {
    const size_t row = t / per_row_a;
    colpass_tile::column_tile<kPre ? Load::kPre : Load::kPlain, true, true>(
        tile, P.a, P.ops_a, P.x + row * plane, P.scratch + row * plane,
        (size_t)(t % per_row_a) << P.ops_a.log_tl, P.p);
    __syncthreads();
  }

  cooperative_groups::this_grid().sync();

  const int per_row_b = P.a.nn >> P.ops_b.log_tl;
  for (int t = blockIdx.x; t < P.batch * per_row_b; t += gridDim.x) {
    const size_t row = t / per_row_b;
    colpass_tile::column_tile<Load::kL2, false, kPost>(
        tile, P.b, P.ops_b, P.scratch + row * plane, P.out + row * plane,
        (size_t)(t % per_row_b) << P.ops_b.log_tl, P.p);
    __syncthreads();
  }
}

}  // namespace

extern "C" {

const char* ntt_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches one fused transform on `stream`, cooperatively. x: (batch,
// nn_a, nn_b) uint32; scratch and out: (batch, nn_b, nn_a). Side s in
// {a, b}: ts_s / offs_s host arrays of nstages_s half sizes and table
// offsets, k0_s stages in phase 0, log_a_s < 0 for a plain network (then
// mid pointers null). pre/post pointers null when absent. Returns 0 when
// launched, else a cudaError_t: cudaErrorInvalidValue for arguments the
// kernel does not take, cudaErrorNotSupported for a device without
// cooperative launch, or the launch's own error.
int ntt_fused_fourstep(
    const void* x, void* scratch, void* out, int batch, int nn_a, int nn_b,
    int log_tl_a, int log_tl_b, int dit,
    int nstages_a, int k0_a, const int* ts_a, const int* offs_a,
    const void* tw_a_w, const void* tw_a_s, int log_a_a,
    const void* mid_a_w, const void* mid_a_s,
    int nstages_b, int k0_b, const int* ts_b, const int* offs_b,
    const void* tw_b_w, const void* tw_b_s, int log_a_b,
    const void* mid_b_w, const void* mid_b_s,
    const void* wmid_w, const void* wmid_s, const void* pre_w,
    const void* pre_s, const void* post_w, const void* post_s,
    unsigned int p, void* stream) {
  const size_t smem_a = (size_t)nn_a << log_tl_a << 2;
  const size_t smem_b = (size_t)nn_b << log_tl_b << 2;
  const size_t smem = smem_a > smem_b ? smem_a : smem_b;
  Params P;
  if (smem > (size_t)kMaxSmemBytes || batch < 1 ||
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
  P.batch = batch;
  P.p = p;

  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  void (*kernel)(Params) =
      !pre_w ? (post_w ? fused_kernel<false, true> : fused_kernel<false, false>)
             : (post_w ? fused_kernel<true, true> : fused_kernel<true, false>);
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic memory
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
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
