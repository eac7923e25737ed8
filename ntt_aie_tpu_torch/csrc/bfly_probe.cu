// Butterfly-rate probe for NVIDIA Hopper (sm_90a): the measured ideal
// butterfly rate that ntt_aie_tpu_torch/profiling/roofline.py
// measure_vpu_peak divides by.
//
// Replaces the probe chain of ntt_aie_tpu/profiling/roofline.py
// measure_vpu_peak (:128-290), which runs under XLA on the TPU: per
// element pair (u, w), r chained butterflies
//   u, w <- add(u, w), mul_const(sub_for_mul(u, w), tw)
// with no network around them: no shared memory, no barrier, no stage
// table. In PyTorch ops each step would stream the buffer through device
// memory and measure bandwidth, so this kernel holds u and w in registers
// for all r steps. Variants:
//   harvey4, harvey, montgomery, barrett: reductions.cuh's arithmetic (the
//     column and fused kernels' policies), values in the policy's domain,
//     tw as its (w, w2) pair, the butterfly the row-major column_tile's
//     (conditional subtracts as selects);
//   goldilocks: gl_arith.cuh's canonical uint64 arithmetic on (hi, lo)
//     limb planes, joined on load and split on store.
// Layout (the reference's): u and w are (8, m) planes, one twiddle per
// row, tw[e / m] for element e; the wrapper passes the planes back to back
// in one buffer. The twiddle and the initial values are read from device
// memory and both outputs are stored, so the compiler can neither fold the
// chain nor drop it; the final values are a legal value stream, which the
// plain version (profiling/roofline.py probe_chain_plain) reproduces bit
// for bit.
//
// What bounds it: integer issue. Each thread runs one serial chain of r
// butterflies on two registers (a harvey4 butterfly is some 15 integer
// instructions, a Goldilocks one 40 SASS instructions, gl_arith.cuh
// counts them); at r = 64 a harvey4 thread does
// some 1 000 integer instructions per 16 bytes it moves, far above the
// card's bytes-to-operations ridge. One thread per element pair, so the
// serial chains' latency is hidden by the warps resident per SM. Loading
// and storing the buffer is a fixed cost per launch, not overlapped with
// the chain (a thread loads, runs r steps, then stores); measure_vpu_peak
// subtracts the same launches at half the depth to remove it.

#include "gl_arith.cuh"
#include "reductions.cuh"

namespace {

constexpr int kThreads = 256;

// The chain of one 32-bit reduction R on the planes u, w of x.
template <class Red>
__device__ __forceinline__ void probe_chain(const uint32_t* __restrict__ x,
                                            uint32_t* __restrict__ out,
                                            const uint32_t* __restrict__ tw_w,
                                            const uint32_t* __restrict__ tw_s,
                                            long long m, int r,
                                            Red R) {
  const long long half = 8 * m;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < half; e += (long long)gridDim.x * blockDim.x) {
    const int row = static_cast<int>(e / m);
    const uint32_t w = tw_w[row], ws = tw_s[row];
    uint32_t a = x[e], b = x[half + e];
    for (int k = 0; k < r; ++k) {
      const uint32_t s = R.template add<false>(a, b);
      b = R.mulc(R.sub_for_mul(a, b), w, ws);
      a = s;
    }
    out[e] = a;
    out[half + e] = b;
  }
}

// One kernel a reduction, each under its own name (scripts/sass_count.py
// compares kernels by name across checkouts).
#define PROBE_KERNEL(name, Policy)                                         \
  __global__ void __launch_bounds__(kThreads)                              \
      name(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,     \
           const uint32_t* __restrict__ tw_w,                              \
           const uint32_t* __restrict__ tw_s, long long m, int r,          \
           uint32_t p, uint32_t c1, uint32_t c2) {                         \
    probe_chain(x, out, tw_w, tw_s, m, r, Policy::make(p, c1, c2));        \
  }
PROBE_KERNEL(probe_harvey4, reductions::Harvey4)
PROBE_KERNEL(probe_harvey, reductions::Harvey)
PROBE_KERNEL(probe_montgomery, reductions::Montgomery)
PROBE_KERNEL(probe_barrett, reductions::Barrett)
#undef PROBE_KERNEL

__global__ void __launch_bounds__(kThreads)
    probe_goldilocks(const uint32_t* __restrict__ x,
                     uint32_t* __restrict__ out,
                     const uint32_t* __restrict__ tw_hi,
                     const uint32_t* __restrict__ tw_lo, long long m, int r) {
  // x: four (8, m) planes uh, ul, wh, wl back to back
  const long long q = 8 * m;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < q; e += (long long)gridDim.x * blockDim.x) {
    const int row = static_cast<int>(e / m);
    const uint64_t w = ((uint64_t)tw_hi[row] << 32) | tw_lo[row];
    uint64_t a = ((uint64_t)x[e] << 32) | x[q + e];
    uint64_t b = ((uint64_t)x[2 * q + e] << 32) | x[3 * q + e];
    for (int k = 0; k < r; ++k) {
      const uint64_t s = gl_arith::gl_add(a, b);
      b = gl_arith::gl_mul(gl_arith::gl_sub(a, b), w);
      a = s;
    }
    out[e] = (uint32_t)(a >> 32);
    out[q + e] = (uint32_t)a;
    out[2 * q + e] = (uint32_t)(b >> 32);
    out[3 * q + e] = (uint32_t)b;
  }
}

int grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 132 * 256 ? blocks : 132 * 256);
}

}  // namespace

extern "C" {

const char* ntt_probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the probe on `stream`: r butterflies per element pair of the
// (8, m) planes in x, into out (x's layout). kind: 0 harvey4, 2 harvey,
// 3 montgomery, 4 barrett: x is u, w (2 * 8m uint32), tw_a / tw_b the (8,)
// pair tables, p, c1, c2 the prime and the reduction's constants; kind 1,
// goldilocks: x is uh, ul, wh, wl (4 * 8m), tw_a / tw_b the (8,) hi and lo
// limbs. Returns cudaGetLastError() (0 = launched).
int ntt_bfly_probe(const void* x, void* out, const void* tw_a,
                   const void* tw_b, long long m, int r, int kind,
                   unsigned int p, unsigned int c1, unsigned int c2,
                   void* stream) {
  if (m < 1 || r < 0 || 8 * m > (1ll << 40) || kind < 0 || kind > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xi = static_cast<const uint32_t*>(x);
  auto* o = static_cast<uint32_t*>(out);
  const auto* ta = static_cast<const uint32_t*>(tw_a);
  const auto* tb = static_cast<const uint32_t*>(tw_b);
  const int grid = grid_for(8 * m);
  switch (kind) {
    case 0:
      probe_harvey4<<<grid, kThreads, 0, s>>>(xi, o, ta, tb, m, r, p, c1, c2);
      break;
    case 1:
      probe_goldilocks<<<grid, kThreads, 0, s>>>(xi, o, ta, tb, m, r);
      break;
    case 2:
      probe_harvey<<<grid, kThreads, 0, s>>>(xi, o, ta, tb, m, r, p, c1, c2);
      break;
    case 3:
      probe_montgomery<<<grid, kThreads, 0, s>>>(xi, o, ta, tb, m, r, p, c1,
                                                 c2);
      break;
    default:
      probe_barrett<<<grid, kThreads, 0, s>>>(xi, o, ta, tb, m, r, p, c1, c2);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
