// The FIPS 203/204 layered transforms for NVIDIA Hopper (sm_90a): the
// ML-KEM NTT and inverse over q = 3329 (7 layers, FIPS 203 Algorithms
// 9-10) and the ML-DSA NTT and inverse over q = 8380417 (8 layers, FIPS
// 204 Algorithms 41-42), on polynomials of 256 coefficients.
//
// Replaces ntt_aie_tpu/ring_layers.py::layered_fwd and ::layered_inv
// (with the inverse's final scale of ntt_aie_tpu/kyber.py::kyber_intt and
// ntt_aie_tpu/dilithium.py::dilithium_intt), which the reference runs
// under XLA (it has no Pallas kernel there): a helper kernel, as crt.cu
// is. As torch ops one transform is 7 or 8 layers of some eight int64
// elementwise ops each, some 60 launches with int64 temporaries that each
// pass over the whole batch; here it is one launch.
//
// What it computes, per row of 256 values (canonical, [0, q)): forward,
// for layer L = 0 .. kLayers-1 with len = 128 >> L, block b = 0 .. 2^L-1
// and j < len, the CT butterfly on (u, v) = (a[2b len + j], a[2b len + j
// + len]) with z = zetas[2^L + b]: (u + z v, u - z v); inverse, for L =
// kLayers-1 .. 0, the GS butterfly (u + v, z (u - v)) with z = izetas[2^L
// + b], then every value times `scale`. zetas[2^L + b] is the reference's
// layer_zeta_tables(...)[L][b], laid out by the standards' index k = 2^L
// + b (entry 0 unused). The multiply of ML-KEM is (a z) mod q with a, z
// < q (a z < 2^24; q a compile-time constant, so the compiler's
// multiply-shift); ML-DSA's is Montgomery REDC with R = 2^32 against the
// tables' Montgomery form z R mod q (hi + umulhi(m, q) + (lo != 0), one
// conditional subtract), which returns a z mod q, as the reference's
// mont_mul does. Every result is canonical, so the output equals the plain
// version's (ring_layers.layered_fwd/layered_inv) bit for bit.
//
// What bounds it on an H100: bytes, about even with the operations. A
// polynomial reads and writes 1 KiB once (B = 8,192: 16.8 MB, 5.0 us at
// 3.35 TB/s) and does 128 butterflies a layer (B = 8,192: 7.3 M for
// ML-KEM, 8.4 M for ML-DSA, 3.5 and 5.1 us at the card's measured
// barrett and montgomery butterfly rates). The design: kPolys polynomials
// a block of 128 x kPolys threads; each polynomial's 256 values and the
// scheme's zeta table (512 or 1,024 bytes, read once a block, so the
// deep layers' 32 distinct zetas a warp are shared-memory reads and not
// a serialized constant-cache walk) live in shared memory; each thread
// does one butterfly a layer, with __syncthreads() between layers; the
// first and last layers load from and store to device memory as two
// coalesced runs a polynomial. Simple and right first: no register
// layers, no TMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 256;
constexpr int kHalf = kN / 2;  // butterflies a layer = threads a polynomial
constexpr int kPolys = 2;      // polynomials a block

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  const uint32_t s = a + b;
  return s >= q ? s - q : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  const uint32_t d = a + (q - b);
  return d >= q ? d - q : d;
}

// ML-KEM: q = 3329, zetas in standard form
struct MlKem {
  static constexpr uint32_t kQ = 3329;
  static constexpr int kLayers = 7;
  static constexpr uint32_t kNegPinv = 0;
  __device__ static __forceinline__ uint32_t mul(uint32_t a, uint32_t z) {
    return (a * z) % kQ;
  }
};

// ML-DSA: q = 8380417, zetas in Montgomery form (R = 2^32)
struct MlDsa {
  static constexpr uint32_t kQ = 8380417;
  static constexpr int kLayers = 8;
  static constexpr uint32_t kNegPinv = 4236238847u;  // -q^-1 mod 2^32
  __device__ static __forceinline__ uint32_t mul(uint32_t a, uint32_t zr) {
    const uint32_t lo = a * zr, hi = __umulhi(a, zr);
    const uint32_t m = lo * kNegPinv;
    const uint32_t t = hi + __umulhi(m, kQ) + (lo != 0 ? 1u : 0u);
    return t >= kQ ? t - kQ : t;
  }
};

template <class S, bool kInverse>
__global__ void __launch_bounds__(kHalf * kPolys)
    ring_layers_kernel(const uint32_t* __restrict__ x,
                       uint32_t* __restrict__ out, long long rows,
                       const uint32_t* __restrict__ zetas, uint32_t scale) {
  constexpr int kTable = 1 << S::kLayers;
  __shared__ uint32_t tile[kPolys][kN];
  __shared__ uint32_t ztab[kTable];
  const int t = threadIdx.x;
  for (int i = threadIdx.y * kHalf + t; i < kTable; i += kHalf * kPolys)
    ztab[i] = __ldg(zetas + i);
  const long long row = (long long)blockIdx.x * kPolys + threadIdx.y;
  const bool live = row < rows;
  uint32_t* a = tile[threadIdx.y];
  if (live) {
    const uint32_t* src = x + row * kN;
    a[t] = __ldg(src + t);
    a[t + kHalf] = __ldg(src + t + kHalf);
  } else {
    a[t] = 0;
    a[t + kHalf] = 0;
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < S::kLayers; ++s) {
    const int L = kInverse ? S::kLayers - 1 - s : s;
    const int log_len = 7 - L;
    const int b = t >> log_len, j = t & ((1 << log_len) - 1);
    const int i0 = (b << (log_len + 1)) + j, i1 = i0 + (1 << log_len);
    const uint32_t z = ztab[(1 << L) + b];
    const uint32_t u = a[i0], v = a[i1];
    if (kInverse) {
      a[i0] = add_mod(u, v, S::kQ);
      a[i1] = S::mul(sub_mod(u, v, S::kQ), z);
    } else {
      const uint32_t zv = S::mul(v, z);
      a[i0] = add_mod(u, zv, S::kQ);
      a[i1] = sub_mod(u, zv, S::kQ);
    }
    __syncthreads();
  }
  if (live) {
    uint32_t v0 = a[t], v1 = a[t + kHalf];
    if (kInverse) {
      v0 = S::mul(v0, scale);
      v1 = S::mul(v1, scale);
    }
    uint32_t* dst = out + row * kN;
    dst[t] = v0;
    dst[t + kHalf] = v1;
  }
}

using KernelFn = void (*)(const uint32_t*, uint32_t*, long long,
                          const uint32_t*, uint32_t);

// scheme 0: ML-KEM, 1: ML-DSA
KernelFn pick_kernel(int scheme, int inverse) {
  if (scheme == 0)
    return inverse ? ring_layers_kernel<MlKem, true>
                   : ring_layers_kernel<MlKem, false>;
  if (scheme == 1)
    return inverse ? ring_layers_kernel<MlDsa, true>
                   : ring_layers_kernel<MlDsa, false>;
  return nullptr;
}

}  // namespace

extern "C" {

const char* ntt_ring_layers_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The constants a scheme's kernels are compiled with, for the wrapper to
// check against its own: q, the layer count, -q^-1 mod 2^32 (0 where the
// multiply is not Montgomery's). Returns 0, or -1 for an unknown scheme.
int ntt_ring_layers_info(int scheme, unsigned int* q, int* layers,
                         unsigned int* neg_pinv) {
  if (scheme == 0) {
    *q = MlKem::kQ;
    *layers = MlKem::kLayers;
    *neg_pinv = MlKem::kNegPinv;
    return 0;
  }
  if (scheme == 1) {
    *q = MlDsa::kQ;
    *layers = MlDsa::kLayers;
    *neg_pinv = MlDsa::kNegPinv;
    return 0;
  }
  return -1;
}

// Launches the transform of `rows` polynomials (x, out: (rows, 256)
// uint32, canonical, not overlapping) on `stream`. zetas: 2^layers uint32
// on the device, entry 2^L + b the zeta of layer L's block b (the
// inverse's table for inverse = 1); scale: the inverse's final
// multiplier in the table's form. Returns cudaGetLastError() after the
// launch (0 = launched), or cudaErrorInvalidValue for a scheme, row count
// or grid it does not take.
int ntt_ring_layers(int scheme, int inverse, const void* x, void* out,
                    long long rows, const void* zetas, unsigned int scale,
                    void* stream) {
  const KernelFn kernel = pick_kernel(scheme, inverse);
  const long long blocks = (rows + kPolys - 1) / kPolys;
  if (!kernel || rows < 1 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned int>(blocks), dim3(kHalf, kPolys), 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), rows,
      static_cast<const uint32_t*>(zetas), scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
