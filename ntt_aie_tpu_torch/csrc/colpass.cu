// Column-pass NTT kernel for NVIDIA Hopper (sm_90a).
//
// Replaces ntt_aie_tpu/ops/pallas_ntt.py::build_colpass (the Pallas TPU
// kernel) for the options the four-step fold plan runs:
//   cp1  = DIF over n1, then the 'post_t' wmat multiply, transpose_out;
//   cp2  = DIF over n2, then canonicalize;
//   icp2 = DIT over n2, then the 'post_t' iwmat multiply, transpose_out;
//   icp1 = DIT over n1, then canonicalize.
//
// What it computes, per column of a (B, nn, ncols) uint32 array: every
// butterfly stage of the column network (colpass_tile.cuh, which also
// states the arithmetic and the nested row map). Store: optional
// transpose to (B, ncols, nn), then the elementwise multiply by a
// (ncols, nn)-oriented matrix, then canonicalize.
// Output domain: [0, 4p) without canonicalize, [0, p) with it.
//
// What bounds it on an H100: the pass's floor is device-memory bytes. Each
// pass reads and writes the 4 MB matrix of one n = 2^20 transform once,
// plus 8 MB of (w, w') wmat for cp1/icp2 (about 2.5 and 5 us per transform
// at 3.35 TB/s). This simple design already moves each element once per
// pass, but does not reach that floor: it is held by the work inside the
// SM, one shared-memory round trip and one barrier per radix-2 stage
// (grouping stages in registers is the next step). The design: one
// thread block per (batch row, tile of TL consecutive
// columns) loads its nn x TL tile into shared memory with reads along the
// column axis (TL*4 contiguous bytes per row), runs every stage there with
// __syncthreads between stages, and writes the tile once (coalesced along
// nn when transposed). The caller picks TL so a tile takes 32 KB where it
// can (TL = 8 at nn = 1024: seven 256-thread blocks per SM; measured on an
// H100 80GB HBM3 at 700 W, cp1 took 16.0 us/pass/NTT at TL = 8 against
// 28.7 at TL = 16, whose 64 KB tiles fit three blocks per SM), and never
// narrower than 4 columns. The largest column the kernel takes is
// kMaxRows = 8192 rows (TL = 4, 128 KB).

#include "colpass_tile.cuh"

namespace {

using colpass_tile::Network;
using colpass_tile::TileOps;

constexpr int kThreads = 256;
constexpr int kMaxSmemBytes = 227 * 1024;  // an H100 block's limit
constexpr int kMaxRows = 8192;

struct Params {
  Network net;
  TileOps ops;
  const uint32_t* x;
  uint32_t* out;
  uint32_t p;
};

// One thread block per (batch row, tile of TL columns).
template <bool kTranspose, bool kMat>
__global__ void __launch_bounds__(kThreads) colpass_kernel(const Params P) {
  extern __shared__ uint32_t tile[];
  const size_t plane = (size_t)P.net.nn * P.ops.ncols;
  colpass_tile::column_tile<colpass_tile::Load::kPlain, kTranspose, kMat>(
      tile, P.net, P.ops, P.x + (size_t)blockIdx.y * plane,
      P.out + (size_t)blockIdx.y * plane, (size_t)blockIdx.x << P.ops.log_tl,
      P.p);
}

}  // namespace

extern "C" {

int ntt_colpass_max_rows() { return kMaxRows; }

const char* ntt_colpass_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches one column pass on `stream`. x: (batch, nn, ncols) uint32;
// out: (batch, nn, ncols), or (batch, ncols, nn) with transpose_out. ts /
// offs: host arrays of nstages half sizes and table offsets. log_a < 0
// for a plain network. mat_w/mat_s null for no post_t multiply. Returns
// cudaGetLastError() after the launch (0 = launched).
int ntt_colpass(const void* x, void* out, int batch, int nn, int ncols,
                int log_tl, int dit, int nstages, int k0, const int* ts,
                const int* offs, const void* tw_w, const void* tw_s,
                int log_a, const void* mid_w, const void* mid_s,
                const void* mat_w, const void* mat_s, int transpose_out,
                int canonicalize, unsigned int p, void* stream) {
  const size_t smem = (size_t)nn << log_tl << 2;
  Params P;
  if (nn > kMaxRows || smem > (size_t)kMaxSmemBytes ||
      (ncols >> log_tl) < 1 || batch < 1 || batch > 65535 ||
      !colpass_tile::make_network(&P.net, nn, dit, nstages, k0, ts, offs,
                                  tw_w, tw_s, log_a, mid_w, mid_s))
    return static_cast<int>(cudaErrorInvalidValue);
  P.ops.pre_w = P.ops.pre_s = nullptr;
  P.ops.mat_w = static_cast<const uint32_t*>(mat_w);
  P.ops.mat_s = static_cast<const uint32_t*>(mat_s);
  P.ops.ncols = ncols;
  P.ops.log_tl = log_tl;
  P.ops.canonicalize = canonicalize;
  P.x = static_cast<const uint32_t*>(x);
  P.out = static_cast<uint32_t*>(out);
  P.p = p;
  void (*kernel)(Params) =
      !transpose_out ? (mat_w ? colpass_kernel<false, true>
                              : colpass_kernel<false, false>)
                     : (mat_w ? colpass_kernel<true, true>
                              : colpass_kernel<true, false>);
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
