// Goldilocks column-pass NTT kernel for NVIDIA Hopper (sm_90a), and the
// pointwise Goldilocks product between transforms.
//
// Replaces ntt_aie_tpu/ops/pallas_gl.py::build_gl_colpass (the Pallas TPU
// kernel) for the options the Goldilocks four-step fold plan runs
// (ntt_aie_tpu/goldilocks_plan.py:244-259):
//   cp1  = DIF over n1, transpose_out, then the 'post_t' wmat multiply;
//   cp2  = DIF over n2;
//   icp2 = DIT over n2, transpose_out, then the 'post_t' iwmat multiply;
//   icp1 = DIT over n1.
// gl_mul_kernel is a helper, not a port of a TPU kernel: the reference
// leaves the pointwise product of polymul to XLA (goldilocks_plan.py:462).
//
// What it computes, per column of two (B, nn, ncols) uint32 planes (hi, lo)
// of values mod p = 2^64 - 2^32 + 1: every butterfly stage of
// ntt_aie_tpu_torch.twiddles.col_network, as a generic stage-list executor
// (DIF (u+v, (u-v)*w), DIT (u+w*v, u-w*v); a stage of half size t pairs
// rows (b*2t + j, b*2t + t + j) and multiplies by tw[off + j]). The nested
// R x S network runs phase 0, the mid step (DIF: x[r] *= wmid[r], then the
// row at r*S + s moves to s*R + r; DIT: the inverse move, then the
// multiply), then phase 1. As in csrc/colpass.cu the move is not done in
// memory: phase 1 and the epilogue address logical row l at physical row
//   (l mod A) * (nn / A) + l / A,   A = R for DIF, A = S for DIT.
// Epilogue: optional transpose to (B, ncols, nn), then the elementwise
// multiply by a (ncols, nn)-oriented operand.
//
// Arithmetic (csrc/gl_arith.cuh, shared with the butterfly probe): every
// value stays canonical, [0, p), at every step, so any exact method gives
// the plain PyTorch version's bits.
//
// What bounds it on an H100: the in-SM integer work, ahead of device
// memory. A pass reads and writes the 8 MB of one n = 2^20 transform once
// (16 MB, about 5 us per transform at 3.35 TB/s), plus the 8 MB wmat of
// cp1/icp2, shared by the batch and mostly served from the 50 MB L2. But the
// H100 has no 64-bit integer multiplier: a 64 x 64 -> 128-bit product takes
// several 32-bit IMADs, and with the reduction and the carry fix-ups a
// radix-2 butterfly costs some 50 integer instructions, 5.2 M butterflies
// per transform and pass. The design keeps the whole column in shared
// memory, so each element crosses device memory once per pass; holds an
// element as one uint64 (hi and lo joined on load, split on store), so a
// butterfly makes one shared-memory access per operand and uses the
// hardware's wide multiply instead of the TPU's 16-bit limb products; and
// sizes tiles at 32 KB (TL = 4 columns of 1024 rows, seven 256-thread
// blocks per SM), the tile size that gave the 32-bit kernel the most
// resident warps. Grouping stages in registers is the next step. The
// largest column the kernel takes is kMaxRows = 8192 rows, in 2-column
// tiles (TL = 2, 128 KB); up to 4096 rows the tiles are 4 or more columns
// wide (colpass.tile_cols).

#include <cuda_runtime.h>
#include <stdint.h>

#include "gl_arith.cuh"

namespace {

using gl_arith::gl_add;
using gl_arith::gl_mul;
using gl_arith::gl_sub;

constexpr int kThreads = 256;
constexpr int kMaxStages = 16;
constexpr int kMaxSmemBytes = 227 * 1024;  // an H100 block's limit
constexpr int kMaxRows = 8192;

struct Params {
  const uint32_t* x_hi;
  const uint32_t* x_lo;
  uint32_t* out_hi;
  uint32_t* out_lo;
  const uint64_t* tw;   // stage twiddles, all stages concatenated
  const uint64_t* mid;  // nested wmid (nn,), or null
  const uint64_t* mat;  // post_t operand (ncols, nn), or null
  int nn, log_nn, ncols, log_tl;
  int nstages, k0;  // stages in all; stages in phase 0
  int log_a;        // log2 of A for the nested row map, -1 when plain
  int dit, transpose_out;
  int t[kMaxStages];
  int off[kMaxStages];
};

// Physical shared-memory row of logical row l (identity when log_a < 0);
// the same map as csrc/colpass.cu.
__device__ __forceinline__ int row_of(int l, int log_a, int log_nn) {
  if (log_a < 0) return l;
  return ((l & ((1 << log_a) - 1)) << (log_nn - log_a)) | (l >> log_a);
}

__device__ void run_stage(uint64_t* tile, const Params& P, int s, int log_a) {
  const int t = P.t[s];
  const int log_t = __ffs(t) - 1;
  const uint64_t* tw = P.tw + P.off[s];
  const int tl_mask = (1 << P.log_tl) - 1;
  const int total = (P.nn >> 1) << P.log_tl;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int c = i & tl_mask;
    const int k = i >> P.log_tl;
    const int j = k & (t - 1);
    const int lu = ((k >> log_t) << (log_t + 1)) | j;
    uint64_t* pu = tile + (row_of(lu, log_a, P.log_nn) << P.log_tl) + c;
    uint64_t* pv = tile + (row_of(lu + t, log_a, P.log_nn) << P.log_tl) + c;
    const uint64_t u = *pu, v = *pv;
    const uint64_t w = __ldg(tw + j);
    if (!P.dit) {
      *pu = gl_add(u, v);
      *pv = gl_mul(gl_sub(u, v), w);
    } else {
      const uint64_t wv = gl_mul(v, w);
      *pu = gl_add(u, wv);
      *pv = gl_sub(u, wv);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) gl_colpass_kernel(const Params P) {
  extern __shared__ uint64_t tile[];
  const int tl = 1 << P.log_tl;
  const int n_tile = P.nn << P.log_tl;
  const size_t col0 = (size_t)blockIdx.x << P.log_tl;
  const size_t plane = (size_t)P.nn * P.ncols;
  const uint32_t* xh = P.x_hi + (size_t)blockIdx.y * plane;
  const uint32_t* xl = P.x_lo + (size_t)blockIdx.y * plane;
  uint32_t* oh = P.out_hi + (size_t)blockIdx.y * plane;
  uint32_t* ol = P.out_lo + (size_t)blockIdx.y * plane;

  for (int i = threadIdx.x; i < n_tile; i += blockDim.x) {
    const size_t g = (size_t)(i >> P.log_tl) * P.ncols + col0 + (i & (tl - 1));
    tile[i] = ((uint64_t)xh[g] << 32) | xl[g];
  }
  __syncthreads();

  for (int s = 0; s < P.k0; ++s) run_stage(tile, P, s, -1);
  if (P.log_a >= 0) {
    // mid step: DIF multiplies before the row move (physical rows), DIT
    // after it (logical rows through the map)
    const int map_a = P.dit ? P.log_a : -1;
    for (int i = threadIdx.x; i < n_tile; i += blockDim.x) {
      const int l = i >> P.log_tl;
      uint64_t* e = tile + (row_of(l, map_a, P.log_nn) << P.log_tl)
                    + (i & (tl - 1));
      *e = gl_mul(*e, __ldg(P.mid + l));
    }
    __syncthreads();
    for (int s = P.k0; s < P.nstages; ++s) run_stage(tile, P, s, P.log_a);
  }

  if (!P.transpose_out) {
    for (int i = threadIdx.x; i < n_tile; i += blockDim.x) {
      const int l = i >> P.log_tl;
      const int c = i & (tl - 1);
      const uint64_t v = tile[(row_of(l, P.log_a, P.log_nn) << P.log_tl) + c];
      const size_t o = (size_t)l * P.ncols + col0 + c;
      oh[o] = (uint32_t)(v >> 32);
      ol[o] = (uint32_t)v;
    }
  } else {
    for (int i = threadIdx.x; i < n_tile; i += blockDim.x) {
      const int l = i & (P.nn - 1);
      const int c = i >> P.log_nn;
      uint64_t v = tile[(row_of(l, P.log_a, P.log_nn) << P.log_tl) + c];
      const size_t o = (col0 + c) * P.nn + l;
      if (P.mat) v = gl_mul(v, __ldg(P.mat + o));
      oh[o] = (uint32_t)(v >> 32);
      ol[o] = (uint32_t)v;
    }
  }
}

__global__ void __launch_bounds__(kThreads) gl_mul_kernel(
    const uint32_t* __restrict__ ah, const uint32_t* __restrict__ al,
    const uint32_t* __restrict__ bh, const uint32_t* __restrict__ bl,
    uint32_t* __restrict__ oh, uint32_t* __restrict__ ol, size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const uint64_t r = gl_mul(((uint64_t)ah[i] << 32) | al[i],
                              ((uint64_t)bh[i] << 32) | bl[i]);
    oh[i] = (uint32_t)(r >> 32);
    ol[i] = (uint32_t)r;
  }
}

int ilog2(int v) {
  int r = 0;
  while ((1 << r) < v) ++r;
  return r;
}

}  // namespace

extern "C" {

int ntt_gl_colpass_max_rows() { return kMaxRows; }

const char* ntt_gl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches one Goldilocks column pass on `stream`. x_hi/x_lo: (batch, nn,
// ncols) uint32 planes; out_hi/out_lo: (batch, nn, ncols), or (batch,
// ncols, nn) with transpose_out. ts / offs: host arrays of nstages half
// sizes and table offsets into tw (uint64). log_a < 0 for a plain network
// (mid null). mat null for no post_t multiply. Returns cudaGetLastError()
// after the launch (0 = launched).
int ntt_gl_colpass(const void* x_hi, const void* x_lo, void* out_hi,
                   void* out_lo, int batch, int nn, int ncols, int log_tl,
                   int dit, int nstages, int k0, const int* ts,
                   const int* offs, const void* tw, int log_a,
                   const void* mid, const void* mat, int transpose_out,
                   void* stream) {
  const size_t smem = (size_t)nn << log_tl << 3;
  if (nstages > kMaxStages || k0 > nstages || nn > kMaxRows ||
      smem > (size_t)kMaxSmemBytes || (ncols >> log_tl) < 1 ||
      batch < 1 || batch > 65535 || (log_a >= 0) != (mid != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params P;
  P.x_hi = static_cast<const uint32_t*>(x_hi);
  P.x_lo = static_cast<const uint32_t*>(x_lo);
  P.out_hi = static_cast<uint32_t*>(out_hi);
  P.out_lo = static_cast<uint32_t*>(out_lo);
  P.tw = static_cast<const uint64_t*>(tw);
  P.mid = static_cast<const uint64_t*>(mid);
  P.mat = static_cast<const uint64_t*>(mat);
  P.nn = nn;
  P.log_nn = ilog2(nn);
  P.ncols = ncols;
  P.log_tl = log_tl;
  P.nstages = nstages;
  P.k0 = k0;
  P.log_a = log_a;
  P.dit = dit;
  P.transpose_out = transpose_out;
  for (int s = 0; s < kMaxStages; ++s) {
    P.t[s] = s < nstages ? ts[s] : 1;
    P.off[s] = s < nstages ? offs[s] : 0;
  }
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic memory
    const cudaError_t err = cudaFuncSetAttribute(
        gl_colpass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(ncols >> log_tl, batch);
  gl_colpass_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// Launches the pointwise product o = a * b mod p over n elements given as
// uint32 limb planes, on `stream`. Returns cudaGetLastError().
int ntt_gl_mul(const void* a_hi, const void* a_lo, const void* b_hi,
               const void* b_lo, void* out_hi, void* out_lo, long long n,
               void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks_needed = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(
      blocks_needed < 132 * 64 ? blocks_needed : 132 * 64);
  gl_mul_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a_hi), static_cast<const uint32_t*>(a_lo),
      static_cast<const uint32_t*>(b_hi), static_cast<const uint32_t*>(b_lo),
      static_cast<uint32_t*>(out_hi), static_cast<uint32_t*>(out_lo),
      static_cast<size_t>(n));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
