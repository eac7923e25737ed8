// The exact 32-bit pointwise product for NVIDIA Hopper (sm_90a): the
// spectral product every 32-bit ring product runs between its transforms.
//
// Replaces no TPU kernel: the reference computes this product under XLA,
// its jitted _pointwise (ntt_aie_tpu/plan.py:175-187), which XLA fuses
// into one elementwise kernel. It is a helper kernel, as gl_colpass.cu's
// Goldilocks product is, because the plain PyTorch version is a chain of
// some ten int64 passes over the whole array, three of them 64-bit `%`.
//
// What it computes, per value i of a of n values:
//   o[i] = (a[i] mod p) * (b[j] mod p) mod p,  j = i mod nb,
// with a, b and o uint32 and 2 <= p < 2^31 (every prime a 32-bit reduction
// of the port accepts, from Kyber's 3329 to 2013265921); b has nb values,
// nb = n or a divisor of n (b broadcast over a's leading axes). The result
// is the canonical product, the same under every reduction, so it equals
// the plain version's bits for any uint32 inputs.
//
// Method: (a mod p)(b mod p) = a*b (mod p), so the kernel reduces the
// full 64-bit product t = a*b once, by Barrett with m = floor((2^64-1)/p):
// q = umulhi64(t, m) satisfies t/p - 2 < q <= t/p (the error of m is
// below 1 and t < 2^64), so r = t - q*p lies in [0, 2p) and, as 2p < 2^32,
// is exact in the low 32 bits: one conditional subtract makes it
// canonical. The compiler's 64-bit `%` would be a long division routine.
//
// What bounds it on an H100: bytes. A value reads 8 bytes and writes 4
// (12 bytes; 0.96 ms for 2^28 values at 3.35 TB/s), against one 32x32
// wide multiply, the 64x64 high product (a few 32-bit multiply-adds) and
// four more integer instructions, which the SMs issue in a small share of
// that time. The design: a grid-stride loop with 64-bit indices, 16-byte
// vector loads and stores (four values a thread an iteration) where n, nb
// and the pointers allow, one thread a value otherwise; a power-of-two nb
// (every transform's) indexes b by a mask, any other nb by `%`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocksPerSm = 8;
constexpr int kSms = 132;  // an H100 SXM; more blocks only wait

enum Broadcast { kSame = 0, kMask = 1, kModulo = 2 };

__device__ __forceinline__ uint32_t mulmod(uint32_t a, uint32_t b,
                                           uint32_t p, uint64_t m) {
  const uint64_t t = static_cast<uint64_t>(a) * b;
  const uint64_t q = __umul64hi(t, m);
  const uint32_t r = static_cast<uint32_t>(t) - static_cast<uint32_t>(q) * p;
  return r >= p ? r - p : r;
}

template <int kB>
__device__ __forceinline__ size_t index_b(size_t i, size_t nb) {
  if constexpr (kB == kMask) return i & (nb - 1);
  if constexpr (kB == kModulo) return i % nb;
  return i;
}

// Four values a thread an iteration: i = 4 * v, and nb % 4 == 0 keeps the
// four b values of one vector contiguous and 16-byte aligned.
template <int kB>
__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSm)
    mul32_vec_kernel(const uint4* __restrict__ a, const uint32_t* __restrict__ b,
                     uint4* __restrict__ o, size_t nvec, size_t nb,
                     uint32_t p, uint64_t m) {
  for (size_t v = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
       v < nvec; v += static_cast<size_t>(gridDim.x) * kThreads) {
    const uint4 x = a[v];
    const uint4 y = *reinterpret_cast<const uint4*>(b + index_b<kB>(4 * v, nb));
    o[v] = make_uint4(mulmod(x.x, y.x, p, m), mulmod(x.y, y.y, p, m),
                      mulmod(x.z, y.z, p, m), mulmod(x.w, y.w, p, m));
  }
}

template <int kB>
__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSm)
    mul32_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                 uint32_t* __restrict__ o, size_t n, size_t nb, uint32_t p,
                 uint64_t m) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * kThreads)
    o[i] = mulmod(a[i], b[index_b<kB>(i, nb)], p, m);
}

template <int kB>
cudaError_t launch(const void* a, const void* b, void* o, size_t n,
                   size_t nb, uint32_t p, bool vec, cudaStream_t stream) {
  const uint64_t m = ~0ull / p;
  const size_t items = vec ? n / 4 : n;
  const size_t need = (items + kThreads - 1) / kThreads;
  const size_t cap = static_cast<size_t>(kSms) * kMaxBlocksPerSm;
  const unsigned blocks = static_cast<unsigned>(need < cap ? need : cap);
  if (vec)
    mul32_vec_kernel<kB><<<blocks, kThreads, 0, stream>>>(
        static_cast<const uint4*>(a), static_cast<const uint32_t*>(b),
        static_cast<uint4*>(o), items, nb, p, m);
  else
    mul32_kernel<kB><<<blocks, kThreads, 0, stream>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<uint32_t*>(o), n, nb, p, m);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

extern "C" {

const char* ntt_pointwise_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch form ntt_mul32 takes for these sizes and pointers: 1 for the
// 16-byte vector loop, 0 for one value a thread.
int ntt_mul32_vectorized(const void* a, const void* b, const void* out,
                         long long n, long long nb) {
  return n % 4 == 0 && nb % 4 == 0 && aligned16(a) && aligned16(b) &&
         aligned16(out);
}

// Launches o = a * b mod p over n uint32 values on `stream`; b has nb
// values, nb = n or a divisor of n (b[i mod nb]). Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for sizes or a modulus it does not take (n < 1,
// nb not dividing n, p outside [2, 2^31)).
int ntt_mul32(const void* a, const void* b, void* out, long long n,
              long long nb, unsigned int p, void* stream) {
  if (n < 1 || nb < 1 || n % nb != 0 || p < 2 || p >= (1u << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = ntt_mul32_vectorized(a, b, out, n, nb) != 0;
  const size_t un = static_cast<size_t>(n), unb = static_cast<size_t>(nb);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (unb == un)
    err = launch<kSame>(a, b, out, un, unb, p, vec, s);
  else if ((unb & (unb - 1)) == 0)
    err = launch<kMask>(a, b, out, un, unb, p, vec, s);
  else
    err = launch<kModulo>(a, b, out, un, unb, p, vec, s);
  return static_cast<int>(err);
}

}  // extern "C"
