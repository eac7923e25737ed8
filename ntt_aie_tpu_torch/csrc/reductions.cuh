// The 32-bit reduction strategies of the column and fused kernels, one
// policy struct each, bit for bit the uint32 operations of
// ntt_aie_tpu_torch/ops/reductions.py (the reference's
// ntt_aie_tpu/ops/reductions.py:96-178 and modops.py:98-135):
//
//   Harvey4    p < 2^29, lazy domain [0, 4p): the approximate Shoup product
//              from three 16-bit partials of w' = floor(w * 2^32 / p),
//              stored packed as (w'_hi << 16) | w'_lo; it lands in [0, 4p).
//              Keeping the reference's exact operations (instead of an
//              exact __umulhi Shoup) makes raw lazy outputs equal to the
//              plain PyTorch version's bit for bit.
//   Harvey     p < 2^30, lazy domain [0, 2p): the exact Shoup product,
//              q = __umulhi(x, w'), x*w - q*p in [0, 2p) for any x < 2^32.
//   Montgomery odd p < 2^31, canonical domain: a table holds w*R mod p
//              (R = 2^32); one REDC returns x*w mod p.
//   Barrett    p < 2^14, canonical domain: the reference's Barrett "2k"
//              (t = a*b < 2^28; every intermediate fits 32 bits).
//
// Every table reaches a kernel as (w, w2) pairs (ops/reductions.py
// Reduction.pair): Harvey4 (w, packed w'), Harvey (w, w'), Montgomery
// (w*R mod p, 0), Barrett (w, 0); mulc takes the pair as one uint2 or as two
// words. A DIF butterfly is (add(a, b), mulc(sub_for_mul(a, b), w)); a DIT
// butterfly's two outputs are add(u, wv) and sub(u, wv) of wv = mulc(v, w).
// canon folds the travel domain to [0, p) (the identity for the canonical
// kinds).
//
// kMin picks the form of each conditional subtract x >= m ? x - m : x: one
// unsigned min (kMin = true, column_tile_io's, as colpass.cu was tuned) or a
// select (false: the row-major column_tile's, as fused_fourstep.cu was
// tuned). The two give the same value.
//
// A library is built for one of them (-DNTT_REDUCTION=<kind>, the lower-case
// aliases at the end, ops/colpass.py build_library); its constants reach it
// as make(p, c1, c2) from the launch's arguments (ops/reductions.py
// Reduction.consts).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace reductions {

__device__ __forceinline__ uint32_t csub(uint32_t x, uint32_t m) {
  return x >= m ? x - m : x;
}

// csub as one unsigned min: x - m wraps above x exactly when x < m.
__device__ __forceinline__ uint32_t csub_min(uint32_t x, uint32_t m) {
  return min(x, x - m);
}

template <bool kMin>
__device__ __forceinline__ uint32_t cond_sub(uint32_t x, uint32_t m) {
  if constexpr (kMin)
    return csub_min(x, m);
  else
    return csub(x, m);
}

struct Harvey4 {
  uint32_t p;

  __host__ __device__ static Harvey4 make(uint32_t p, uint32_t, uint32_t) {
    return {p};
  }

  __device__ __forceinline__ uint32_t mulc(uint32_t x, uint32_t w,
                                           uint32_t ws) const {
    const uint32_t xl = x & 0xFFFFu, xh = x >> 16;
    const uint32_t wh = ws >> 16, wl = ws & 0xFFFFu;
    const uint32_t q = xh * wh + ((xl * wh) >> 16) + ((xh * wl) >> 16);
    return x * w - q * p;
  }
  __device__ __forceinline__ uint32_t mulc(uint32_t x, uint2 w) const {
    return mulc(x, w.x, w.y);
  }
  template <bool kMin = true>
  __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) const {
    return cond_sub<kMin>(a + b, 4u * p);
  }
  template <bool kMin = true>
  __device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) const {
    return cond_sub<kMin>(a + (4u * p - b), 4u * p);
  }
  // [0, 8p) < 2^32: legal only as mulc's input
  __device__ __forceinline__ uint32_t sub_for_mul(uint32_t a,
                                                  uint32_t b) const {
    return a + (4u * p - b);
  }
  template <bool kMin = true>
  __device__ __forceinline__ uint32_t canon(uint32_t x) const {
    return cond_sub<kMin>(cond_sub<kMin>(x, 2u * p), p);
  }
};

struct Harvey {
  uint32_t p;

  __host__ __device__ static Harvey make(uint32_t p, uint32_t, uint32_t) {
    return {p};
  }

  __device__ __forceinline__ uint32_t mulc(uint32_t x, uint32_t w,
                                           uint32_t ws) const {
    return x * w - __umulhi(x, ws) * p;
  }
  __device__ __forceinline__ uint32_t mulc(uint32_t x, uint2 w) const {
    return mulc(x, w.x, w.y);
  }
  template <bool kMin = true>
  __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) const {
    return cond_sub<kMin>(a + b, 2u * p);
  }
  template <bool kMin = true>
  __device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) const {
    return cond_sub<kMin>(a + (2u * p - b), 2u * p);
  }
  // [0, 4p) < 2^32: legal only as mulc's input
  __device__ __forceinline__ uint32_t sub_for_mul(uint32_t a,
                                                  uint32_t b) const {
    return a + (2u * p - b);
  }
  template <bool kMin = true>
  __device__ __forceinline__ uint32_t canon(uint32_t x) const {
    return cond_sub<kMin>(x, p);
  }
};

// add and sub of the canonical kinds: add_mod and sub_mod (a + b < 2p and
// a + (p - b) < 2p fit 32 bits for p < 2^31).
struct Canonical {
  uint32_t p;

  template <bool kMin = true>
  __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) const {
    return cond_sub<kMin>(a + b, p);
  }
  template <bool kMin = true>
  __device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) const {
    return cond_sub<kMin>(a + (p - b), p);
  }
  __device__ __forceinline__ uint32_t sub_for_mul(uint32_t a,
                                                  uint32_t b) const {
    return sub(a, b);
  }
  template <bool kMin = true>
  __device__ __forceinline__ uint32_t canon(uint32_t x) const {
    return x;
  }
};

struct Montgomery : Canonical {
  uint32_t neg_pinv;  // -p^-1 mod 2^32

  __host__ __device__ static Montgomery make(uint32_t p, uint32_t neg_pinv,
                                             uint32_t) {
    Montgomery r;
    r.p = p;
    r.neg_pinv = neg_pinv;
    return r;
  }

  // x * w * R^-1 mod p for x < 2^32 and w < p: t = x*w < p * 2^32, and
  // with m = lo(t) * neg_pinv the sum t + m*p is a multiple of 2^32 below
  // 2p * 2^32 < 2^64, so its high word is the REDC in [0, 2p): one wide
  // multiply, one multiply and one wide multiply-add. It equals the
  // reference's hi(t) + umulhi(m, p) + (lo(t) != 0) bit for bit: the low
  // words lo(t) + lo(m*p) sum to 0 or 2^32, carrying when lo(t) != 0.
  __device__ __forceinline__ uint32_t mulc(uint32_t x, uint32_t w,
                                           uint32_t) const {
    const uint64_t t = static_cast<uint64_t>(x) * w;
    const uint32_t m = static_cast<uint32_t>(t) * neg_pinv;
    return csub_min(
        static_cast<uint32_t>((t + static_cast<uint64_t>(m) * p) >> 32), p);
  }
  __device__ __forceinline__ uint32_t mulc(uint32_t x, uint2 w) const {
    return mulc(x, w.x, w.y);
  }
};

struct Barrett : Canonical {
  uint32_t w, u;  // w = bit length of p, u = floor(2^(2w) / p)

  __host__ __device__ static Barrett make(uint32_t p, uint32_t w,
                                          uint32_t u) {
    Barrett r;
    r.p = p;
    r.w = w;
    r.u = u;
    return r;
  }

  // a * b mod p for canonical a and b (p < 2^14)
  __device__ __forceinline__ uint32_t mulc(uint32_t a, uint32_t b,
                                           uint32_t) const {
    const uint32_t t = a * b;
    const uint32_t s = ((t >> (w - 2)) * u) >> (w + 2);
    return csub_min(t - s * p, p);
  }
  __device__ __forceinline__ uint32_t mulc(uint32_t x, uint2 tw) const {
    return mulc(x, tw.x, tw.y);
  }
};

// The names -DNTT_REDUCTION=<kind> takes (ops/reductions.py's kinds).
using harvey4 = Harvey4;
using harvey = Harvey;
using montgomery = Montgomery;
using barrett = Barrett;

}  // namespace reductions

#ifdef NTT_REDUCTION
#define NTT_REDUCTION_STR2(x) #x
#define NTT_REDUCTION_STR(x) NTT_REDUCTION_STR2(x)
// The reduction this library is built for, and its name.
namespace reductions {
using Built = NTT_REDUCTION;
constexpr const char* kBuiltName = NTT_REDUCTION_STR(NTT_REDUCTION);
}  // namespace reductions
#endif
