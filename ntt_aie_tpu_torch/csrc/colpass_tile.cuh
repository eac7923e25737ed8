// Device code shared by the column pass (colpass.cu) and the fused
// four-step kernel (fused_fourstep.cu): harvey4 arithmetic, one radix-2
// stage on a shared-memory tile, and a whole (nn x TL) column tile — load,
// every stage of a plain or nested network, store.
//
// Arithmetic: harvey4, bit for bit the reference's uint32 operations.
// Values travel in the lazy domain [0, 4p) (p < 2^29); the sub feeding a
// multiply reaches [0, 8p) < 2^32. A constant multiply is the approximate
// Shoup product from three 16-bit partials of w' = floor(w * 2^32 / p),
// stored packed as (w'_hi << 16) | w'_lo; it lands in [0, 4p). Keeping the
// reference's exact operations (instead of an exact __umulhi Shoup) makes
// raw lazy outputs equal to the plain PyTorch version's bit for bit.
//
// A network is a generic stage list from ntt_aie_tpu_torch.twiddles
// .col_network: a stage of half size t pairs rows (b*2t + j, b*2t + t + j)
// and multiplies by tw[off + j]. The nested R x S network (nn >= 256)
// runs phase 0, the mid step (DIF: x[r] *= mid[r], then the row at r*S + s
// moves to s*R + r; DIT: the inverse move, then the multiply), then
// phase 1. The move is not done in memory: phase 1 and the store address
// logical row l at physical row
//   (l mod A) * (nn / A) + l / A,   A = R for DIF, A = S for DIT.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace colpass_tile {

constexpr int kMaxStages = 16;

// One column network over nn rows.
struct Network {
  const uint32_t* tw_w;   // stage twiddles, all stages concatenated
  const uint32_t* tw_s;   // their packed Shoup halves
  const uint32_t* mid_w;  // nested mid vector (nn,), or null for plain
  const uint32_t* mid_s;
  int nn, log_nn;
  int nstages, k0;  // stages in all; stages in phase 0
  int log_a;        // log2 of A for the nested row map, -1 when plain
  int dit;
  int t[kMaxStages];
  int off[kMaxStages];
};

// One pass's tile operands, the same for every tile of a launch (kernel
// parameters). Element (l, c) of a tile is src[l * ncols + col0 + c]; the
// store writes it to the same index of dst, or, transposed, to
// dst[(col0 + c) * nn + l]. pre is indexed like src, mat like dst.
struct TileOps {
  const uint32_t* pre_w;  // multiply on load (Load::kPre)
  const uint32_t* pre_s;
  const uint32_t* mat_w;  // multiply on store (kMat)
  const uint32_t* mat_s;
  int ncols, log_tl;
  int canonicalize;
};

// How a tile is loaded: plainly, times pre, or through L2 only (for data
// this grid wrote).
enum class Load { kPlain, kPre, kL2 };

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

__device__ __forceinline__ void run_stage(uint32_t* tile, const Network& N,
                                          int s, int log_a, int log_tl,
                                          uint32_t p) {
  const int t = N.t[s];
  const int log_t = __ffs(t) - 1;
  const uint32_t* tw_w = N.tw_w + N.off[s];
  const uint32_t* tw_s = N.tw_s + N.off[s];
  const int tl_mask = (1 << log_tl) - 1;
  const int total = (N.nn >> 1) << log_tl;
  const uint32_t p4 = 4u * p;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int c = i & tl_mask;
    const int k = i >> log_tl;
    const int j = k & (t - 1);
    const int lu = ((k >> log_t) << (log_t + 1)) | j;
    uint32_t* pu = tile + (row_of(lu, log_a, N.log_nn) << log_tl) + c;
    uint32_t* pv = tile + (row_of(lu + t, log_a, N.log_nn) << log_tl) + c;
    const uint32_t u = *pu, v = *pv;
    const uint32_t w = __ldg(tw_w + j), ws = __ldg(tw_s + j);
    if (!N.dit) {
      *pu = csub(u + v, p4);
      *pv = mulc(u + (p4 - v), w, ws, p);
    } else {
      const uint32_t wv = mulc(v, w, ws, p);
      *pu = csub(u + wv, p4);
      *pv = csub(u + (p4 - wv), p4);
    }
  }
  __syncthreads();
}

// Runs one tile with the whole block: load (reads along the column axis,
// TL * 4 contiguous bytes per row), every stage of N in shared memory with
// a barrier after each, then one store (coalesced along nn when
// kTranspose), times mat when kMat. src and dst are this batch row's input
// and output; col0 is the tile's first column. Output domain: [0, 4p), or
// [0, p) with canonicalize. A caller that reuses the tile must
// __syncthreads() first. The options that change the loops are template
// parameters, so each kernel carries only the loops it runs.
template <Load kLoad, bool kTranspose, bool kMat>
__device__ __forceinline__ void column_tile(uint32_t* tile, const Network& N,
                                            const TileOps& O,
                                            const uint32_t* src,
                                            uint32_t* dst, size_t col0,
                                            uint32_t p) {
  const int tl = 1 << O.log_tl;
  const int n_tile = N.nn << O.log_tl;
  for (int i = threadIdx.x; i < n_tile; i += blockDim.x) {
    const size_t o =
        (size_t)(i >> O.log_tl) * O.ncols + col0 + (i & (tl - 1));
    if constexpr (kLoad == Load::kL2)
      tile[i] = __ldcg(src + o);
    else if constexpr (kLoad == Load::kPre)
      tile[i] = mulc(src[o], __ldg(O.pre_w + o), __ldg(O.pre_s + o), p);
    else
      tile[i] = src[o];
  }
  __syncthreads();

  for (int s = 0; s < N.k0; ++s) run_stage(tile, N, s, -1, O.log_tl, p);
  if (N.log_a >= 0) {
    // mid step: DIF multiplies before the row move (physical rows), DIT
    // after it (logical rows through the map)
    const int map_a = N.dit ? N.log_a : -1;
    for (int i = threadIdx.x; i < n_tile; i += blockDim.x) {
      const int l = i >> O.log_tl;
      uint32_t* e = tile + (row_of(l, map_a, N.log_nn) << O.log_tl)
                    + (i & (tl - 1));
      *e = mulc(*e, __ldg(N.mid_w + l), __ldg(N.mid_s + l), p);
    }
    __syncthreads();
    for (int s = N.k0; s < N.nstages; ++s)
      run_stage(tile, N, s, N.log_a, O.log_tl, p);
  }

  const uint32_t p2 = 2u * p;
  for (int i = threadIdx.x; i < n_tile; i += blockDim.x) {
    const int l = kTranspose ? i & (N.nn - 1) : i >> O.log_tl;
    const int c = kTranspose ? i >> N.log_nn : i & (tl - 1);
    uint32_t v = tile[(row_of(l, N.log_a, N.log_nn) << O.log_tl) + c];
    const size_t o = kTranspose ? (col0 + c) * N.nn + l
                                : (size_t)l * O.ncols + col0 + c;
    if constexpr (kMat)
      v = mulc(v, __ldg(O.mat_w + o), __ldg(O.mat_s + o), p);
    if (O.canonicalize) v = csub(csub(v, p2), p);
    dst[o] = v;
  }
}

inline int ilog2(int v) {
  int r = 0;
  while ((1 << r) < v) ++r;
  return r;
}

// Fills N from the host-side stage list (ts / offs: nstages half sizes and
// table offsets). Returns false if the list does not fit kMaxStages.
inline bool make_network(Network* N, int nn, int dit, int nstages, int k0,
                         const int* ts, const int* offs, const void* tw_w,
                         const void* tw_s, int log_a, const void* mid_w,
                         const void* mid_s) {
  if (nstages > kMaxStages || k0 > nstages) return false;
  N->tw_w = static_cast<const uint32_t*>(tw_w);
  N->tw_s = static_cast<const uint32_t*>(tw_s);
  N->mid_w = static_cast<const uint32_t*>(mid_w);
  N->mid_s = static_cast<const uint32_t*>(mid_s);
  N->nn = nn;
  N->log_nn = ilog2(nn);
  N->nstages = nstages;
  N->k0 = k0;
  N->log_a = log_a;
  N->dit = dit;
  for (int s = 0; s < kMaxStages; ++s) {
    N->t[s] = s < nstages ? ts[s] : 1;
    N->off[s] = s < nstages ? offs[s] : 0;
  }
  return true;
}

}  // namespace colpass_tile
