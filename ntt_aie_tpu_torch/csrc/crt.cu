// CRT combine kernel for NVIDIA Hopper (sm_90a): the residues of an RNS
// product to the uint32 limbs of the integer they stand for.
//
// Replaces ntt_aie_tpu/ops/crt.py::make_crt_combine's combine, which the
// reference runs under XLA (it has no Pallas kernel): a helper kernel, as
// gl_colpass.cu's pointwise product is, because torch has no uint32
// arithmetic with carries on the card and its int64 ops would make each
// of the chain's ~100 steps a pass over the whole array.
//
// What it computes, per coefficient i of `count`: from k residues r_a[i]
// (canonical, [0, p_a), given in the chain's ascending-prime order) the
// Garner digits
//   v_0 = r_0,
//   v_a = (..((r_a - v_0) * inv(p_0) - v_1) * inv(p_1) .. - v_{a-1})
//         * inv(p_{a-1})  (mod p_a),
// each subtract a conditional one (v_j < p_j < p_a) and each multiply a
// Montgomery constant multiply (REDC with R = 2^32 as the high word of
// t + m*p: hi + __umulhi(m, p) + (lo != 0), one conditional subtract)
// against inv(p_j) * R mod p_a; then x = sum_a v_a * P_a with P_a the
// product of the primes before a, accumulated in nwords uint32 limbs with
// carries; with `centered`, x > M/2 becomes x - M, a multi-word subtract
// whose wrap is the two's-complement encoding of the negative value. It
// writes the nwords limbs of coefficient i, least significant first, at
// out[i * nwords ..]. Every step is the plain version's
// (ops/crt.py crt_combine_plain), so the limbs are equal bit for bit.
//
// What bounds it on an H100: bytes. A coefficient reads k residues and
// writes nwords limbs, (k + nwords) * 4 bytes (24 for the three default
// RNS primes, M ~ 2^91, nwords = 3: 0.12 ms at 3.35 TB/s for 16 products
// of n = 2^20), against some 100 integer instructions (k(k-1)/2 Garner
// steps of ~10, k * nwords limb steps of ~6), which the SMs issue in about
// half that time. The design: one thread a coefficient, the whole chain in
// registers (one kernel for each k and nwords, nwords <= k <= kMaxFields,
// so every loop unrolls and every index is a constant), the constants
// kernel parameters (read through the constant cache, the same for every
// thread), the limbs stored through shared memory as contiguous runs, a
// block-stride loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFields = 8;
constexpr int kMaxWords = 8;

struct CrtParams {
  const uint32_t* res[kMaxFields];  // residues in the chain's order
  uint32_t* out;                    // (count, nwords) limbs
  unsigned long long count;
  int k, nwords, centered;
  uint32_t p[kMaxFields];
  uint32_t neg_pinv[kMaxFields];           // -p^-1 mod 2^32
  uint32_t inv[kMaxFields][kMaxFields];    // inv(p_j) * R mod p_a, j < a
  uint32_t weight[kMaxFields][kMaxWords];  // P_a's limbs
  uint32_t m[kMaxWords];                   // M's limbs
  uint32_t half[kMaxWords];                // floor(M / 2)'s limbs
};

// (a - b) mod p for a, b in [0, p)
__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b,
                                            uint32_t p) {
  const uint32_t d = a + (p - b);
  return d >= p ? d - p : d;
}

// a * b * R^-1 mod p for a, b in [0, p), R = 2^32
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b,
                                             uint32_t p, uint32_t neg_pinv) {
  const uint32_t lo = a * b, hi = __umulhi(a, b);
  const uint32_t m = lo * neg_pinv;
  const uint32_t t = hi + __umulhi(m, p) + (lo != 0 ? 1u : 0u);
  return t >= p ? t - p : t;
}

// One block takes kThreads consecutive coefficients at a time: each
// thread runs the chain of one, writes its NW limbs to shared memory, and
// the block stores the kThreads * NW limbs as one contiguous run (each
// warp's store instruction a 128-byte line), where a store of limb w
// straight from each thread would touch NW times as many lines.
template <int K, int NW>
__global__ void __launch_bounds__(kThreads) crt_kernel(const CrtParams P) {
  __shared__ uint32_t stage[kThreads * NW];
  for (size_t base = (size_t)blockIdx.x * kThreads; base < P.count;
       base += (size_t)gridDim.x * kThreads) {
    const size_t i = base + threadIdx.x;
    if (i < P.count) {
      uint32_t v[K];
      uint32_t acc[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) acc[w] = 0;
#pragma unroll
      for (int a = 0; a < K; ++a) {
        uint32_t t = __ldg(P.res[a] + i);
#pragma unroll
        for (int j = 0; j < a; ++j) {
          t = sub_mod(t, v[j], P.p[a]);
          t = mont_mul(t, P.inv[a][j], P.p[a], P.neg_pinv[a]);
        }
        v[a] = t;
        // acc += v_a * P_a; t < 2^31, so each partial sum is < 2^64
        uint64_t carry = 0;
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          const uint64_t s = (uint64_t)t * P.weight[a][w] + acc[w] + carry;
          acc[w] = (uint32_t)s;
          carry = s >> 32;
        }
      }
      if (P.centered) {
        bool gt = false, eq = true;
#pragma unroll
        for (int w = NW - 1; w >= 0; --w) {
          gt = gt || (eq && acc[w] > P.half[w]);
          eq = eq && acc[w] == P.half[w];
        }
        if (gt) {
          uint32_t borrow = 0;
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            const uint32_t d0 = acc[w] - P.m[w];
            const uint32_t b0 = acc[w] < P.m[w] ? 1u : 0u;
            const uint32_t d1 = d0 - borrow;
            const uint32_t b1 = d0 < borrow ? 1u : 0u;
            acc[w] = d1;
            borrow = b0 + b1;
          }
        }
      }
#pragma unroll
      for (int w = 0; w < NW; ++w) stage[threadIdx.x * NW + w] = acc[w];
    }
    __syncthreads();
    const size_t left = P.count - base;
    const int words = (int)(left < kThreads ? left : kThreads) * NW;
    uint32_t* o = P.out + base * NW;
    for (int j = threadIdx.x; j < words; j += kThreads) o[j] = stage[j];
    __syncthreads();
  }
}

using KernelFn = void (*)(CrtParams);

// The kernel of k primes and nwords limbs, nwords <= k (a product of k
// primes below 2^31 has at most 31k bits), or null.
template <int K = 1, int NW = 1>
KernelFn pick_kernel(int k, int nwords) {
  if constexpr (K > kMaxFields) {
    return nullptr;
  } else if constexpr (NW > K) {
    return pick_kernel<K + 1, 1>(k, nwords);
  } else {
    if (k == K && nwords == NW) return crt_kernel<K, NW>;
    return pick_kernel<K, NW + 1>(k, nwords);
  }
}

}  // namespace

extern "C" {

int ntt_crt_max_fields() { return kMaxFields; }
int ntt_crt_max_words() { return kMaxWords; }

const char* ntt_crt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the combine over `count` coefficients on `stream`. residues: k
// device pointers to uint32 residues, in the chain's ascending-prime
// order; out: (count, nwords) uint32. primes, neg_pinv: k each; inv_const:
// k x k row-major (row a, column j < a: inv(p_j) * 2^32 mod p_a); weights:
// k x nwords (row a: the limbs of the product of the primes before a);
// m_limbs, half_limbs: nwords each. Returns cudaGetLastError() after the
// launch (0 = launched), or cudaErrorInvalidValue for a count, k or nwords
// it does not take (k above kMaxFields, nwords above k).
int ntt_crt_combine(const void* const* residues, void* out, long long count,
                    int k, int nwords, const unsigned int* primes,
                    const unsigned int* neg_pinv,
                    const unsigned int* inv_const,
                    const unsigned int* weights, const unsigned int* m_limbs,
                    const unsigned int* half_limbs, int centered,
                    void* stream) {
  const KernelFn kernel = pick_kernel(k, nwords);
  if (count < 1 || !kernel) return static_cast<int>(cudaErrorInvalidValue);
  CrtParams P = {};
  for (int a = 0; a < k; ++a) {
    P.res[a] = static_cast<const uint32_t*>(residues[a]);
    P.p[a] = primes[a];
    P.neg_pinv[a] = neg_pinv[a];
    for (int j = 0; j < a; ++j) P.inv[a][j] = inv_const[a * k + j];
    for (int w = 0; w < nwords; ++w) P.weight[a][w] = weights[a * nwords + w];
  }
  for (int w = 0; w < nwords; ++w) {
    P.m[w] = m_limbs[w];
    P.half[w] = half_limbs[w];
  }
  P.out = static_cast<uint32_t*>(out);
  P.count = static_cast<unsigned long long>(count);
  P.k = k;
  P.nwords = nwords;
  P.centered = centered;
  const long long blocks_needed = (count + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(
      blocks_needed < 132 * 32 ? blocks_needed : 132 * 32);
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
