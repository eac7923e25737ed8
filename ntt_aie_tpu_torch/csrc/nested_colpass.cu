// Nested R x S column-pass kernel for NVIDIA Hopper (sm_90a), its radix-2
// stages run in register groups of up to `fuse` stages.
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
// taken, R = 1 and R = n1 (an empty phase) included, also where the column
// pass would not nest.
//
// What bounds it on an H100: at B = 64 and 1024 x 1024 its bytes (each
// element read and written once, 512 MiB, and the (w, w') tables) take
// 0.160 ms at 3.35 TB/s and its butterflies (B * n1/2 * log2 n1 a column)
// 0.163 ms at the measured ideal harvey4 rate, so the two floors meet. What
// held the first design far above them (4.1x) was the work inside the SM,
// as it was in the column pass before its redesign: sweeps of a row-major
// tile that only moved data (load, mid step, store), phase 1's rows 32
// apart sharing a bank group, and two 4-byte loads a twiddle.
//
// Design: the column pass's (colpass.cu, which PERF.md measured step by
// step), colpass_tile.cuh column_tile_io<DIF, no transpose, no matrix,
// kFuse, kMayEmpty>:
//   - one thread block of 256 threads per (batch row, tile of TL
//     consecutive columns, colpass.tile_cols: 32 KB tiles where the column
//     allows), columns of at most kMaxRows = 8192 rows;
//   - register groups of up to kFuse radix-2 stages (a group never crosses
//     the mid step): each thread holds the 2^K values of one radix-2^K
//     butterfly between two exchanges through the tile, one barrier a
//     group, in the same per-butterfly operation order as a stage at a
//     time, so every fuse gives the same bits, equal to the plain PyTorch
//     version's;
//   - the network's first group loads its values from device memory, its
//     last stores them there, and the mid multiply rides in a group, so no
//     sweep of the tile remains; with R = 1 or R = n1 a phase is empty and
//     the mid multiply rides in the other phase's group (kMayEmpty);
//   - a swizzled tile (slot r XOR (r >> s) of its 32-word line, s =
//     log2(n1 / R) passed in as the kernel's `shift`), so phase 1's rows
//     land in distinct banks;
//   - each (w, w') twiddle and mid pair is one 8-byte load (PairTables:
//     ColPass.tw_pairs, wmid_pairs); csub is one unsigned min.
// One kernel per fuse, so each holds only the registers of its own largest
// group: 2^fuse values a thread, which can lower the blocks resident per SM
// (ntt_nested_kernel_info reports both).

#include "colpass_tile.cuh"

namespace {

using colpass_tile::Network;
using colpass_tile::TileOps;

constexpr int kThreads = 256;
constexpr int kMaxSmemBytes = 227 * 1024;  // an H100 block's limit
constexpr int kMaxRows = 8192;
constexpr int kMaxFuse = 5;  // 32 values a thread

struct Params {
  Network net;  // table pointers null: the kernel reads `tables`
  TileOps ops;
  colpass_tile::PairTables tables;
  const uint32_t* x;
  uint32_t* out;
  int shift;  // the swizzled tile's (colpass_tile::tile_shift)
  uint32_t p;
};

// One thread block per (batch row, tile of TL columns).
template <int kFuse>
__global__ void __launch_bounds__(kThreads)
    nested_colpass_kernel(const Params P) {
  extern __shared__ uint32_t tile[];
  const size_t plane = (size_t)P.net.nn * P.ops.ncols;
  colpass_tile::column_tile_io<false, false, false, kFuse, true>(
      tile, P.net, P.ops, P.tables, P.x + (size_t)blockIdx.y * plane,
      P.out + (size_t)blockIdx.y * plane, (size_t)blockIdx.x << P.ops.log_tl,
      P.shift, reductions::Harvey4{P.p});
}

using KernelFn = void (*)(Params);

// The kernel of this fuse, 1 <= fuse <= kMaxFuse.
KernelFn pick_kernel(int fuse) {
  switch (fuse) {
    case 1: return nested_colpass_kernel<1>;
    case 2: return nested_colpass_kernel<2>;
    case 3: return nested_colpass_kernel<3>;
    case 4: return nested_colpass_kernel<4>;
    default: return nested_colpass_kernel<5>;
  }
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

int ntt_nested_max_fuse() { return kMaxFuse; }

const char* ntt_nested_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The kernel of this fuse at an nn x 2^log_tl tile: its registers a thread
// and its co-resident blocks per SM. Returns 0 or a cudaError_t.
int ntt_nested_kernel_info(int fuse, int nn, int log_tl, int* regs,
                           int* per_sm) {
  if (fuse < 1 || fuse > kMaxFuse)
    return static_cast<int>(cudaErrorInvalidValue);
  const KernelFn kernel = pick_kernel(fuse);
  const size_t smem = (size_t)nn << log_tl << 2;
  cudaFuncAttributes attr = {};
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) err = allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                        kThreads, smem);
  *regs = attr.numRegs;
  return static_cast<int>(err);
}

// Launches one nested column pass on `stream`. x, out: (batch, nn, ncols)
// uint32. ts / offs: host arrays of nstages half sizes and table offsets
// (in pairs), k0 = log2 R of them in phase 0; log_a = log2 R. tw, mid:
// (w, packed w') pairs, 8 bytes each: the stage twiddles and the mid
// vector (nn,). Returns cudaGetLastError() after the launch (0 =
// launched).
int ntt_nested_colpass(const void* x, void* out, int batch, int nn,
                       int ncols, int log_tl, int fuse, int nstages, int k0,
                       const int* ts, const int* offs, const void* tw,
                       int log_a, const void* mid, unsigned int p,
                       void* stream) {
  const size_t smem = (size_t)nn << log_tl << 2;
  Params P;
  if (nn > kMaxRows || smem > (size_t)kMaxSmemBytes || log_tl < 0 ||
      log_tl > 5 || (ncols >> log_tl) < 1 || batch < 1 || batch > 65535 ||
      fuse < 1 || fuse > kMaxFuse || nstages < 1 || log_a < 0 || !tw ||
      !mid ||
      !colpass_tile::make_network(&P.net, nn, 0, nstages, k0, ts, offs,
                                  nullptr, nullptr, log_a, nullptr, nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  P.ops.pre_w = P.ops.pre_s = P.ops.mat_w = P.ops.mat_s = nullptr;
  P.ops.ncols = ncols;
  P.ops.log_tl = log_tl;
  P.ops.canonicalize = 0;
  P.tables.tw = static_cast<const uint2*>(tw);
  P.tables.mid = static_cast<const uint2*>(mid);
  P.tables.mat = P.tables.pre = P.tables.post = nullptr;
  P.tables.pre2 = P.tables.post2 = nullptr;
  P.tables.log_s = 0;
  P.x = static_cast<const uint32_t*>(x);
  P.out = static_cast<uint32_t*>(out);
  P.shift = colpass_tile::tile_shift(P.net, log_tl);
  P.p = p;
  const KernelFn kernel = pick_kernel(fuse);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(ncols >> log_tl, batch);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
