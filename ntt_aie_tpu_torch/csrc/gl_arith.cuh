// Goldilocks arithmetic, p = 2^64 - 2^32 + 1, on canonical uint64 values:
// shared by the Goldilocks column pass (gl_colpass.cu) and the butterfly
// probe (bfly_probe.cu). Every function takes and returns values in
// [0, p), so any exact method gives the same bits.
//
// The H100 has no 64-bit integer multiplier and no 64-bit compare-and-
// select, so each function here is written as one chain of 32-bit PTX
// instructions on the values' (hi, lo) limbs, carries and borrows passed
// in the carry flag, with no branch (tests/test_torch_gl_arith.py runs
// these instruction lists step by step in Python against exact
// arithmetic):
//   - gl_sub: a - b, and where that borrows out of 2^64, + p, which mod
//     2^64 is - eps (eps = 2^32 - 1 = 2^64 mod p): the borrow's mask
//     (0 or eps) subtracted from the low limb. 5 PTX instructions.
//   - gl_add: gl_sub(a, p - b) (p - b in (0, p]). 7 PTX instructions.
//   - gl_mul: the 128-bit product r3:r2:r1:r0 formed once from the four
//     32 x 32 -> 64-bit partial products with an explicit carry chain
//     (the first design formed a * b and __umul64hi(a, b) apart, which
//     recomputes the partial products), then reduced with 2^64 = eps and
//     2^96 = -1: x = (r1:r0) - r3 + r2 * eps, the borrow fixed as above,
//     r2 * eps = (r2 << 32) - r2, and the sum's carry (+ eps) and one
//     conditional - p (also + eps mod 2^64) folded into one select. 26
//     PTX instructions.
// The probe's loop (bfly_probe.cu probe_goldilocks, a DIF butterfly: add,
// sub, multiply by a constant; nvcc unrolls it four times) took 223 SASS
// instructions for four butterflies with the first design (a * b and
// __umul64hi apart, reduced and added through 64-bit compares and 56
// selects) and takes 164 with this one: some 55 and 40 a butterfly, loop
// included (scripts/sass_count.py on an H100 build; PERF.md section 6).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gl_arith {

__device__ __forceinline__ uint64_t join(uint32_t hi, uint32_t lo) {
  return ((uint64_t)hi << 32) | lo;
}

// (a - b) mod p.
__device__ __forceinline__ uint64_t gl_sub(uint64_t a, uint64_t b) {
  uint32_t lo, hi;
  asm("{\n\t"
      ".reg .u32 m;\n\t"
      "sub.cc.u32 %0, %2, %4;\n\t"
      "subc.cc.u32 %1, %3, %5;\n\t"
      "subc.u32 m, %6, %6;\n\t"
      "sub.cc.u32 %0, %0, m;\n\t"
      "subc.u32 %1, %1, %6;\n\t"
      "}"
      : "=&r"(lo), "=&r"(hi)
      : "r"((uint32_t)a), "r"((uint32_t)(a >> 32)), "r"((uint32_t)b),
        "r"((uint32_t)(b >> 32)), "r"(0u));
  return join(hi, lo);
}

// (a + b) mod p.
__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t b) {
  uint32_t lo, hi;
  asm("{\n\t"
      ".reg .u32 nl, nh, m;\n\t"
      "sub.cc.u32 nl, %6, %4;\n\t"
      "subc.u32 nh, %7, %5;\n\t"
      "sub.cc.u32 %0, %2, nl;\n\t"
      "subc.cc.u32 %1, %3, nh;\n\t"
      "subc.u32 m, %8, %8;\n\t"
      "sub.cc.u32 %0, %0, m;\n\t"
      "subc.u32 %1, %1, %8;\n\t"
      "}"
      : "=&r"(lo), "=&r"(hi)
      : "r"((uint32_t)a), "r"((uint32_t)(a >> 32)), "r"((uint32_t)b),
        "r"((uint32_t)(b >> 32)), "r"(1u), "r"(0xFFFFFFFFu), "r"(0u));
  return join(hi, lo);
}

// (a * b) mod p.
__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
  uint32_t lo, hi;
  asm("{\n\t"
      ".reg .u32 r0, r1, r2, r3, t0, t1, u0, u1, m, c;\n\t"
      ".reg .pred q;\n\t"
      "mul.lo.u32 r0, %2, %4;\n\t"
      "mul.hi.u32 r1, %2, %4;\n\t"
      "mad.lo.cc.u32 r1, %2, %5, r1;\n\t"
      "madc.hi.u32 r2, %2, %5, %6;\n\t"
      "mad.lo.cc.u32 r1, %3, %4, r1;\n\t"
      "madc.hi.cc.u32 r2, %3, %4, r2;\n\t"
      "madc.hi.u32 r3, %3, %5, %6;\n\t"
      "mad.lo.cc.u32 r2, %3, %5, r2;\n\t"
      "addc.u32 r3, r3, %6;\n\t"
      "sub.cc.u32 r0, r0, r3;\n\t"
      "subc.cc.u32 r1, r1, %6;\n\t"
      "subc.u32 m, %6, %6;\n\t"
      "sub.cc.u32 r0, r0, m;\n\t"
      "subc.u32 r1, r1, %6;\n\t"
      "sub.cc.u32 t0, %6, r2;\n\t"
      "subc.u32 t1, r2, %6;\n\t"
      "add.cc.u32 r0, r0, t0;\n\t"
      "addc.cc.u32 r1, r1, t1;\n\t"
      "addc.u32 c, %6, %6;\n\t"
      "add.cc.u32 u0, r0, %7;\n\t"
      "addc.cc.u32 u1, r1, %6;\n\t"
      "addc.u32 c, c, %6;\n\t"
      "setp.ne.u32 q, c, %6;\n\t"
      "selp.b32 %0, u0, r0, q;\n\t"
      "selp.b32 %1, u1, r1, q;\n\t"
      "}"
      : "=r"(lo), "=r"(hi)
      : "r"((uint32_t)a), "r"((uint32_t)(a >> 32)), "r"((uint32_t)b),
        "r"((uint32_t)(b >> 32)), "r"(0u), "r"(0xFFFFFFFFu));
  return join(hi, lo);
}

}  // namespace gl_arith
