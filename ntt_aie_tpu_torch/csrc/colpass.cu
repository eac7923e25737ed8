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
// butterfly stage of ntt_aie_tpu_torch.twiddles.col_network, as a generic
// stage-list executor. A stage of half size t pairs rows (b*2t + j,
// b*2t + t + j) and multiplies by tw[off + j]. The nested R x S network
// (nn >= 256) runs phase 0, the mid step (DIF: x[r] *= wmid[r], then the
// row at r*S + s moves to s*R + r; DIT: the inverse move, then the
// multiply), then phase 1. The move is not done in memory: phase 1 and the
// epilogue address logical row l at physical row
//   (l mod A) * (nn / A) + l / A,   A = R for DIF, A = S for DIT.
// Epilogue: optional transpose to (B, ncols, nn), then the elementwise
// multiply by a (ncols, nn)-oriented matrix, then canonicalize.
//
// Arithmetic: harvey4, bit for bit the reference's uint32 operations.
// Values travel in the lazy domain [0, 4p) (p < 2^29); the sub feeding a
// multiply reaches [0, 8p) < 2^32. A constant multiply is the approximate
// Shoup product from three 16-bit partials of w' = floor(w * 2^32 / p),
// stored packed as (w'_hi << 16) | w'_lo; it lands in [0, 4p). Keeping the
// reference's exact operations (instead of an exact __umulhi Shoup) makes
// raw lazy outputs equal to the plain PyTorch version's bit for bit.
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStages = 16;
constexpr int kMaxSmemBytes = 227 * 1024;  // an H100 block's limit
constexpr int kMaxRows = 8192;

struct Params {
  const uint32_t* x;
  uint32_t* out;
  const uint32_t* tw_w;   // stage twiddles, all stages concatenated
  const uint32_t* tw_s;   // their packed Shoup halves
  const uint32_t* mid_w;  // nested wmid (nn,), or null
  const uint32_t* mid_s;
  const uint32_t* mat_w;  // post_t matrix (ncols, nn), or null
  const uint32_t* mat_s;
  int nn, log_nn, ncols, log_tl;
  int nstages, k0;  // stages in all; stages in phase 0
  int log_a;        // log2 of A for the nested row map, -1 when plain
  int dit, transpose_out, canonicalize;
  uint32_t p;
  int t[kMaxStages];
  int off[kMaxStages];
};

__device__ __forceinline__ uint32_t mulc(uint32_t x, uint32_t w, uint32_t ws,
                                         uint32_t p) {
  const uint32_t xl = x & 0xFFFFu, xh = x >> 16;
  const uint32_t wh = ws >> 16, wl = ws & 0xFFFFu;
  const uint32_t q = xh * wh + ((xl * wh) >> 16) + ((xh * wl) >> 16);
  return x * w - q * p;
}

__device__ __forceinline__ uint32_t csub(uint32_t x, uint32_t m) {
  return x >= m ? x - m : x;
}

// Physical shared-memory row of logical row l (identity when log_a < 0).
__device__ __forceinline__ int row_of(int l, int log_a, int log_nn) {
  if (log_a < 0) return l;
  return ((l & ((1 << log_a) - 1)) << (log_nn - log_a)) | (l >> log_a);
}

__device__ void run_stage(uint32_t* tile, const Params& P, int s, int log_a) {
  const int t = P.t[s];
  const int log_t = __ffs(t) - 1;
  const uint32_t* tw_w = P.tw_w + P.off[s];
  const uint32_t* tw_s = P.tw_s + P.off[s];
  const int tl_mask = (1 << P.log_tl) - 1;
  const int total = (P.nn >> 1) << P.log_tl;
  const uint32_t p4 = 4u * P.p;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int c = i & tl_mask;
    const int k = i >> P.log_tl;
    const int j = k & (t - 1);
    const int lu = ((k >> log_t) << (log_t + 1)) | j;
    uint32_t* pu = tile + (row_of(lu, log_a, P.log_nn) << P.log_tl) + c;
    uint32_t* pv = tile + (row_of(lu + t, log_a, P.log_nn) << P.log_tl) + c;
    const uint32_t u = *pu, v = *pv;
    const uint32_t w = __ldg(tw_w + j), ws = __ldg(tw_s + j);
    if (!P.dit) {
      *pu = csub(u + v, p4);
      *pv = mulc(u + (p4 - v), w, ws, P.p);
    } else {
      const uint32_t wv = mulc(v, w, ws, P.p);
      *pu = csub(u + wv, p4);
      *pv = csub(u + (p4 - wv), p4);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) colpass_kernel(const Params P) {
  extern __shared__ uint32_t tile[];
  const int tl = 1 << P.log_tl;
  const int n_tile = P.nn << P.log_tl;
  const size_t col0 = (size_t)blockIdx.x << P.log_tl;
  const size_t plane = (size_t)P.nn * P.ncols;
  const uint32_t* xb = P.x + (size_t)blockIdx.y * plane;
  uint32_t* ob = P.out + (size_t)blockIdx.y * plane;

  for (int i = threadIdx.x; i < n_tile; i += blockDim.x)
    tile[i] = xb[(size_t)(i >> P.log_tl) * P.ncols + col0 + (i & (tl - 1))];
  __syncthreads();

  for (int s = 0; s < P.k0; ++s) run_stage(tile, P, s, -1);
  if (P.log_a >= 0) {
    // mid step: DIF multiplies before the row move (physical rows), DIT
    // after it (logical rows through the map)
    const int map_a = P.dit ? P.log_a : -1;
    for (int i = threadIdx.x; i < n_tile; i += blockDim.x) {
      const int l = i >> P.log_tl;
      uint32_t* e = tile + (row_of(l, map_a, P.log_nn) << P.log_tl)
                    + (i & (tl - 1));
      *e = mulc(*e, __ldg(P.mid_w + l), __ldg(P.mid_s + l), P.p);
    }
    __syncthreads();
    for (int s = P.k0; s < P.nstages; ++s) run_stage(tile, P, s, P.log_a);
  }

  const uint32_t p2 = 2u * P.p;
  if (!P.transpose_out) {
    for (int i = threadIdx.x; i < n_tile; i += blockDim.x) {
      const int l = i >> P.log_tl;
      const int c = i & (tl - 1);
      uint32_t v = tile[(row_of(l, P.log_a, P.log_nn) << P.log_tl) + c];
      if (P.canonicalize) v = csub(csub(v, p2), P.p);
      ob[(size_t)l * P.ncols + col0 + c] = v;
    }
  } else {
    for (int i = threadIdx.x; i < n_tile; i += blockDim.x) {
      const int l = i & (P.nn - 1);
      const int c = i >> P.log_nn;
      uint32_t v = tile[(row_of(l, P.log_a, P.log_nn) << P.log_tl) + c];
      const size_t o = (col0 + c) * P.nn + l;
      if (P.mat_w) v = mulc(v, __ldg(P.mat_w + o), __ldg(P.mat_s + o), P.p);
      if (P.canonicalize) v = csub(csub(v, p2), P.p);
      ob[o] = v;
    }
  }
}

int ilog2(int v) {
  int r = 0;
  while ((1 << r) < v) ++r;
  return r;
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
  if (nstages > kMaxStages || k0 > nstages || nn > kMaxRows ||
      smem > (size_t)kMaxSmemBytes || (ncols >> log_tl) < 1 ||
      batch < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params P;
  P.x = static_cast<const uint32_t*>(x);
  P.out = static_cast<uint32_t*>(out);
  P.tw_w = static_cast<const uint32_t*>(tw_w);
  P.tw_s = static_cast<const uint32_t*>(tw_s);
  P.mid_w = static_cast<const uint32_t*>(mid_w);
  P.mid_s = static_cast<const uint32_t*>(mid_s);
  P.mat_w = static_cast<const uint32_t*>(mat_w);
  P.mat_s = static_cast<const uint32_t*>(mat_s);
  P.nn = nn;
  P.log_nn = ilog2(nn);
  P.ncols = ncols;
  P.log_tl = log_tl;
  P.nstages = nstages;
  P.k0 = k0;
  P.log_a = log_a;
  P.dit = dit;
  P.transpose_out = transpose_out;
  P.canonicalize = canonicalize;
  P.p = p;
  for (int s = 0; s < kMaxStages; ++s) {
    P.t[s] = s < nstages ? ts[s] : 1;
    P.off[s] = s < nstages ? offs[s] : 0;
  }
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic memory
    const cudaError_t err = cudaFuncSetAttribute(
        colpass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(ncols >> log_tl, batch);
  colpass_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      P);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
