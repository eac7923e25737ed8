// Goldilocks arithmetic, p = 2^64 - 2^32 + 1, on canonical uint64 values:
// shared by the Goldilocks column pass (gl_colpass.cu) and the butterfly
// probe (bfly_probe.cu). Every function takes and returns values in
// [0, p). Add and subtract are native uint64 with a carry fix-up (a carry
// out of 2^64 adds 2^32 - 1, since 2^64 = 2^32 - 1 mod p). A product is
// a * b and __umul64hi(a, b), reduced with 2^64 = 2^32 - 1 and 2^96 = -1
// as native/oracle.cc:69-84 does.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gl_arith {

constexpr uint64_t kP = 0xFFFFFFFF00000001ull;
constexpr uint64_t kEps = 0xFFFFFFFFull;  // 2^64 mod p

// a, b in [0, p). A carry out of 2^64 adds eps; the wrapped sum is below
// 2^64 - 2^33 + 2, so that cannot wrap again and lands below p.
__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) s += kEps;
  return s >= kP ? s - kP : s;
}

__device__ __forceinline__ uint64_t gl_sub(uint64_t a, uint64_t b) {
  return a >= b ? a - b : a + (kP - b);
}

// (hi:lo) mod p: x = lo + n2 * (2^32 - 1) - n3 with n3:n2 = hi.
__device__ __forceinline__ uint64_t gl_reduce128(uint64_t hi, uint64_t lo) {
  const uint64_t n3 = hi >> 32;
  const uint64_t n2 = hi & 0xFFFFFFFFull;
  uint64_t r = lo >= kP ? lo - kP : lo;
  if (r < n3) r += kP;
  r -= n3;
  uint64_t s = r + ((n2 << 32) - n2);
  if (s < r) s += kEps;
  return s >= kP ? s - kP : s;
}

__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
  return gl_reduce128(__umul64hi(a, b), a * b);
}

}  // namespace gl_arith
