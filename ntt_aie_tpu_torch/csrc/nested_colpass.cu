// Nested R x S column-pass kernel for NVIDIA Hopper (sm_90a), with its
// radix-2 stages run in groups held in registers.
//
// Replaces scripts/proto_nested_colpass.py::nested_colpass (the round-4
// Pallas TPU prototype of the nested column pass). What it computes, per
// column of a (B, n1, ncols) uint32 array, over p < 2^29 with harvey4
// (colpass_tile.cuh states the arithmetic): a DIF over n1 rows as R x S,
//   phase 0: the log2 R stages of a DIF over R, with the S sub-rows of each
//            R-row riding inside the stage (half sizes (R >> (s+1)) * S);
//   mid:     row r*S + s times wmid[r*S + s] (the inner four-step matrix);
//   move:    the row at r*S + s moves to s*R + r;
//   phase 1: the log2 S stages of a DIF over S (half sizes (S >> (s+1)) * R).
// The move is not done in memory: phase 1 and the store address logical
// row l at physical row (l mod R) * S + l / R (colpass_tile.cuh row_of with
// log_a = log2 R), so the store writes rows in the prototype's order s*R + r.
// Output: lazy, [0, 4p), no canonicalize. Any power of two R dividing n1 is
// taken, also where the column pass (colpass.cu) would not nest.
//
// Stage groups. The prototype's `fuse` groups up to `fuse` consecutive
// stages of a phase into one radix-2^k step (k = min(fuse, stages left in
// the phase); a group never crosses the mid step). Here a group is k
// stages held in registers between two shared-memory exchanges
// (colpass_tile.cuh run_group / run_phase, which state the indexing): one
// __syncthreads per group instead of one per stage, in the same
// per-butterfly operation order. The outputs therefore do not depend on
// fuse (fuse = 1 is the plain one-stage-per-barrier kernel), and equal the
// plain PyTorch version's bit for bit.
//
// What bounds it on an H100: the floor is device-memory bytes — each
// element is read and written once (4 MB a way per 1024 x 1024 plane, about
// 2.5 us per plane at 3.35 TB/s) — but a stage-per-barrier pass is held by
// the work inside the SM: a shared-memory round trip and a barrier per
// radix-2 stage (PERF.md). Grouping cuts both by k, at the price of 2^k
// live registers a thread, which can lower the blocks resident per SM.
// Design otherwise as colpass.cu: one block per (batch row, tile of TL
// consecutive columns) in shared memory, 32 KB tiles (colpass.tile_cols).

#include "colpass_tile.cuh"

namespace {

using colpass_tile::Network;
using colpass_tile::TileOps;

constexpr int kThreads = 256;
constexpr int kMaxSmemBytes = 227 * 1024;  // an H100 block's limit
constexpr int kMaxRows = 8192;
constexpr int kMaxFuse = 5;  // 32 values a thread

struct Params {
  Network net;
  TileOps ops;
  const uint32_t* x;
  uint32_t* out;
  uint32_t p;
};

// One thread block per (batch row, tile of TL columns). One kernel per
// fuse, so a kernel holds only the registers of its own largest group.
template <int kFuse>
__global__ void __launch_bounds__(kThreads)
    nested_colpass_kernel(const Params P) {
  extern __shared__ uint32_t tile[];
  const size_t plane = (size_t)P.net.nn * P.ops.ncols;
  const size_t col0 = (size_t)blockIdx.x << P.ops.log_tl;
  colpass_tile::load_tile<colpass_tile::Load::kPlain>(
      tile, P.net, P.ops, P.x + (size_t)blockIdx.y * plane, col0, P.p);
  colpass_tile::run_phase<kFuse>(tile, P.net, 0, P.net.k0, -1,
                                 P.ops.log_tl, P.p);
  colpass_tile::mid_step(tile, P.net, P.ops.log_tl, P.p);
  colpass_tile::run_phase<kFuse>(tile, P.net, P.net.k0, P.net.nstages,
                                 P.net.log_a, P.ops.log_tl, P.p);
  colpass_tile::store_tile<false, false>(
      tile, P.net, P.ops, P.out + (size_t)blockIdx.y * plane, col0, P.p);
}

}  // namespace

extern "C" {

int ntt_nested_max_fuse() { return kMaxFuse; }

const char* ntt_nested_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches one nested column pass on `stream`. x, out: (batch, nn, ncols)
// uint32. ts / offs: host arrays of nstages half sizes and table offsets,
// k0 = log2 R of them in phase 0; log_a = log2 R; mid_w / mid_s the mid
// vector (nn,). Returns cudaGetLastError() after the launch (0 = launched).
int ntt_nested_colpass(const void* x, void* out, int batch, int nn,
                       int ncols, int log_tl, int fuse, int nstages, int k0,
                       const int* ts, const int* offs, const void* tw_w,
                       const void* tw_s, int log_a, const void* mid_w,
                       const void* mid_s, unsigned int p, void* stream) {
  const size_t smem = (size_t)nn << log_tl << 2;
  Params P;
  if (nn > kMaxRows || smem > (size_t)kMaxSmemBytes ||
      (ncols >> log_tl) < 1 || batch < 1 || batch > 65535 || fuse < 1 ||
      fuse > kMaxFuse || log_a < 0 || !mid_w || !mid_s ||
      !colpass_tile::make_network(&P.net, nn, 0, nstages, k0, ts, offs,
                                  tw_w, tw_s, log_a, mid_w, mid_s))
    return static_cast<int>(cudaErrorInvalidValue);
  P.ops.pre_w = P.ops.pre_s = nullptr;
  P.ops.mat_w = P.ops.mat_s = nullptr;
  P.ops.ncols = ncols;
  P.ops.log_tl = log_tl;
  P.ops.canonicalize = 0;
  P.x = static_cast<const uint32_t*>(x);
  P.out = static_cast<uint32_t*>(out);
  P.p = p;
  void (*const kernels[kMaxFuse])(Params) = {
      nested_colpass_kernel<1>, nested_colpass_kernel<2>,
      nested_colpass_kernel<3>, nested_colpass_kernel<4>,
      nested_colpass_kernel<5>};
  void (*kernel)(Params) = kernels[fuse - 1];
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic memory
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(ncols >> log_tl, batch);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
