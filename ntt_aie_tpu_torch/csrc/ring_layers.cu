// The FIPS 203/204 ring kernels for NVIDIA Hopper (sm_90a): the ML-KEM NTT
// and inverse over q = 3329 (7 layers, FIPS 203 Algorithms 9-10), the ML-DSA
// NTT and inverse over q = 8380417 (8 layers, FIPS 204 Algorithms 41-42), on
// polynomials of 256 coefficients, and the fused ring product
// out[i] = intt( sum_j A[i, j] o ntt(x[j]) ) with each stage switchable:
// polymul, basemul/pointwise, matvec and both serving steps, one launch each.
//
// Replaces ntt_aie_tpu/ring_layers.py::layered_fwd and ::layered_inv (with
// the inverse's final scale of ntt_aie_tpu/kyber.py::kyber_intt and
// ntt_aie_tpu/dilithium.py::dilithium_intt), and the products and matvec
// around them (kyber_basemul, dilithium_pointwise, ring_layers.matvec_terms),
// which the reference compiles into one XLA program a pipeline callable
// (ring_layers.jit_pipeline); it has no Pallas kernel there: helper kernels,
// as crt.cu is.
//
// What the transforms compute, per row of 256 canonical values: forward, for
// layer L = 0 .. kLayers-1 with len = 128 >> L, block b and j < len, the CT
// butterfly on (u, v) = (a[2b len + j], a[2b len + j + len]) with
// z = zetas[2^L + b]: (u + z v, u - z v); inverse, for L = kLayers-1 .. 0,
// the GS butterfly (u + v, z (u - v)) with z = izetas[2^L + b], then every
// value times `scale`. zetas[2^L + b] is the reference's
// layer_zeta_tables(...)[L][b], laid out by the standards' index k = 2^L + b
// (entry 0 unused). ML-KEM multiplies as (a z) mod q (q a compile-time
// constant; a z < 2^32); ML-DSA by Montgomery REDC with R = 2^32 against
// Montgomery-form tables z R mod q, which returns a z mod q. Inside a
// transform the values stay lazy (bfly, forward_bound, inverse_bound:
// below a multiple of q that the layers done bound, static_asserted
// against 2^32 and the multiply's range; ML-DSA's layer multiply is the
// REDC hi - umulhi(lo q^-1, q) + q in (0, 2q), five instructions with no
// compare), and each transform reduces once at its end: the forward mod
// q, the inverse by its final multiply. Every output is canonical, so it
// equals the plain version's bit for bit.
//
// The layout. One warp a polynomial, 8 values a lane in registers. Write a
// coefficient index i as 8 bits; a layout says which bit of i each of the 3
// bits of the register index and each of the 5 bits of the lane holds. The
// transforms load in the stride layout (lane t, register j: i = t + 32 j;
// each load instruction one coalesced 128-byte run), so the layers at
// len = 128, 64, 32 (bits 7, 6, 5) pair registers of one lane. A layer on a
// bit that a lane holds is reached by a swap: 4 __shfl_xor_sync a lane
// exchange register bit kSwapReg[s] with lane bit kSwapLane[s] (each lane
// keeps half of its register pairs and takes its partner's other half). The
// forward runs each layer as soon as its bit is in a register, swapping
// (kSwapReg, kSwapLane in order) until it is: five swaps bring bits 4, 3, 2,
// 1, 0 in, and leave the final layout, lane t holding coefficients 8t ..
// 8t + 7 (kFinalLayout; ML-KEM takes the last swap too, for that layout).
// The inverse starts from the final layout and undoes the swaps in reverse
// as its layers need. No shared-memory transposition and no barrier between
// layers: a layer is 4 butterflies a lane in registers. The forward stores
// (and the inverse loads) 16-byte vectors from the final layout; the inverse
// stores in the stride layout. In every layer the register bits above the
// layer's bit are the bits just above it, so a lane's zetas are one aligned
// run of 1, 2 or 4 consecutive table entries (lane_part, run_offset): one
// shared-memory load of 4, 8 or 16 bytes a lane, a quarter- or half-warp of
// consecutive words a wavefront, free of bank conflicts. ML-KEM's basemul
// pairs (2i, 2i + 1) differ in bit 0, which the final layout keeps in a
// register, so a lane holds both halves of its pairs and their gammas are
// again one run of 4.
//
// The ring product (ring_product_kernel): 8 warps a block, the zeta tables
// (both directions, and ML-KEM's gammas) read into shared memory once a
// block, and with a matrix shared by the batch that matrix too (k l KiB,
// 64-byte chunks XOR-swizzled so that a lane's two 16-byte reads take one
// wavefront a quarter-warp). k = l = 1 (polymul, basemul/pointwise): one
// warp a batch row, the polynomial in registers through ntt -> product ->
// intt. Otherwise a block serves `group` rows at a time (group k <= 8
// warps): the warps transform the group's l vectors into shared memory
// (the same swizzle), one barrier, then warp (g, i) accumulates row i over
// j and runs the inverse in registers. The grid is the resident blocks of
// the card at most, each block looping over the groups, so a shared matrix
// is read once a block. Sums are reduced once, at the end (RowSums): ML-KEM
// keeps a pair's sum a0 x0, sum a1 x1 and sum (a0 x1 + a1 x0) raw in 32
// bits (a pair's gamma is the same in every term, so it multiplies once);
// ML-DSA keeps sum a x in 64 bits and takes one Montgomery REDC, whose R^-1
// the final scale takes back (n^-1 R^2 in Montgomery form), or, with no
// inverse, one multiply by R^2 mod q.
//
// What bounds it on an H100: for the transforms, bytes and operations about
// even: a polynomial reads and writes 1 KiB once (B = 8,192: 16.8 MB, 5.0 us
// at 3.35 TB/s) and does 128 butterflies a layer (7.3 M for ML-KEM, 8.4 M
// for ML-DSA at B = 8,192: 3.5 and 5.1 us at the card's measured barrett and
// montgomery butterfly rates). A fused product moves its operands and result
// once and does its transforms' butterflies and its products, so the
// operations bound polymul and the serving steps.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kN = 256;
constexpr int kRegs = 8;   // values a lane holds
constexpr int kWarps = 8;  // warps a block: polynomials a block of the
                           // transforms, rows of a group of the product
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxRank = 8;  // the largest k and l of a product

// A layout: bits 3p .. 3p+2 the coefficient-index bit that register-index
// bit p holds (p < 3), bits 9 + 3q .. 11 + 3q the one lane bit q holds.
__host__ __device__ constexpr int layout_of(int r0, int r1, int r2, int q0,
                                            int q1, int q2, int q3, int q4) {
  return r0 | r1 << 3 | r2 << 6 | q0 << 9 | q1 << 12 | q2 << 15 | q3 << 18 |
         q4 << 21;
}
__host__ __device__ constexpr int reg_bit(int lay, int p) {
  return (lay >> (3 * p)) & 7;
}
__host__ __device__ constexpr int lane_bit(int lay, int q) {
  return (lay >> (9 + 3 * q)) & 7;
}

// The stride layout: lane t, register j holds coefficient t + 32 j.
constexpr int kStrideLayout = layout_of(5, 6, 7, 0, 1, 2, 3, 4);
// The swaps, in order: swap s exchanges register bit kSwapReg[s] with lane
// bit kSwapLane[s].
constexpr int kSwaps = 5;
constexpr int kSwapReg[kSwaps] = {2, 1, 0, 2, 1};
constexpr int kSwapLane[kSwaps] = {4, 3, 2, 1, 0};
// Shared-memory polynomials (a shared matrix, the transformed vectors):
// 64 chunks of 16 bytes, chunk c stored at c ^ ((c >> kSwizzleShift) & 1).
constexpr int kSwizzleShift = 3;

__host__ __device__ constexpr int swap_reg(int s) { return kSwapReg[s]; }
__host__ __device__ constexpr int swap_lane(int s) { return kSwapLane[s]; }

__host__ __device__ constexpr int swap_bits(int lay, int p, int q) {
  const int rb = reg_bit(lay, p), lb = lane_bit(lay, q);
  lay &= ~(7 << (3 * p));
  lay &= ~(7 << (9 + 3 * q));
  return lay | lb << (3 * p) | rb << (9 + 3 * q);
}

// the layout after the first s swaps
__host__ __device__ constexpr int layout_after(int s) {
  int lay = kStrideLayout;
  for (int i = 0; i < s; ++i) lay = swap_bits(lay, swap_reg(i), swap_lane(i));
  return lay;
}

constexpr int kFinalLayout = layout_after(kSwaps);

// the register-index bit that holds coefficient bit y, or -1
__host__ __device__ constexpr int reg_pos(int lay, int y) {
  for (int p = 0; p < 3; ++p)
    if (reg_bit(lay, p) == y) return p;
  return -1;
}

// log2 of a lane's zetas in the layer on bit y: its register bits above y
__host__ __device__ constexpr int run_log(int lay, int y) {
  int m = 0;
  for (int p = 0; p < 3; ++p) m += reg_bit(lay, p) > y;
  return m;
}

// the register bits above y are bits y + 1 .. y + run_log: a lane's zetas
// are consecutive entries
__host__ __device__ constexpr bool run_is_contiguous(int lay, int y) {
  for (int p = 0; p < 3; ++p) {
    const int b = reg_bit(lay, p);
    if (b > y + run_log(lay, y)) return false;
  }
  return true;
}

// register j's entry in its lane's run of zetas (the layer on bit y)
__host__ __device__ constexpr int run_offset(int lay, int y, int j) {
  int o = 0;
  for (int p = 0; p < 3; ++p) {
    const int b = reg_bit(lay, p);
    if (b > y) o |= ((j >> p) & 1) << (b - y - 1);
  }
  return o;
}

// the coefficient-index bits that register j holds
__host__ __device__ constexpr int reg_coeff(int lay, int j) {
  int c = 0;
  for (int p = 0; p < 3; ++p) c |= ((j >> p) & 1) << reg_bit(lay, p);
  return c;
}

__host__ __device__ constexpr bool is_final_consecutive(int lay) {
  for (int q = 0; q < 5; ++q)
    if (lane_bit(lay, q) != q + 3) return false;
  return true;
}

static_assert(is_final_consecutive(kFinalLayout),
              "the swaps must leave lane t holding coefficients 8t .. 8t+7");

__host__ __device__ constexpr int swizzle_chunk(int c) {
  return c ^ ((c >> kSwizzleShift) & 1);
}

// The lane's part of its run's first index in the layer on bit y: the block
// index i >> (y + 1) of its lane bits.
template <int kLay, int kY>
__device__ __forceinline__ int lane_part(int lane) {
  int b = 0;
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    const int bit = lane_bit(kLay, q);
    if (bit > kY) {
      const int sh = bit - kY - 1 - q;
      const int v = lane & (1 << q);
      b |= sh >= 0 ? v << sh : v >> -sh;
    }
  }
  return b;
}

template <int kM>
__device__ __forceinline__ void load_run(const uint32_t* p,
                                         uint32_t (&w)[4]) {
  if constexpr (kM == 0) {
    w[0] = w[1] = w[2] = w[3] = *p;
  } else if constexpr (kM == 1) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = w[2] = v.x;
    w[1] = w[3] = v.y;
  } else {
    static_assert(kM == 2, "a run is 1, 2 or 4 zetas");
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
}

// ML-KEM: q = 3329, zetas in standard form, basemul products
struct MlKem {
  static constexpr uint32_t kQ = 3329;
  static constexpr int kLayers = 7;
  static constexpr uint32_t kNegPinv = 0;
  static constexpr bool kBasemul = true;
  // the largest a that lazy_mul takes (a z < 2^32), and its result's
  // bound in multiples of q
  static constexpr uint32_t kMulMax = 0xffffffffu / (kQ - 1);
  static constexpr uint32_t kLazy = 1;
  // a z mod q (a z < 2^32), canonical
  __device__ static __forceinline__ uint32_t mul(uint32_t a, uint32_t z) {
    return (a * z) % kQ;
  }
  __device__ static __forceinline__ uint32_t lazy_mul(uint32_t a,
                                                      uint32_t z) {
    return mul(a, z);
  }
};

// ML-DSA: q = 8380417, zetas in Montgomery form (R = 2^32), coefficient
// products
struct MlDsa {
  static constexpr uint32_t kQ = 8380417;
  static constexpr int kLayers = 8;
  static constexpr uint32_t kNegPinv = 4236238847u;  // -q^-1 mod 2^32
  static constexpr uint32_t kQInv = 58728449u;       // q^-1 mod 2^32
  static constexpr bool kBasemul = false;
  static constexpr uint32_t kMulMax = 0xffffffffu;
  static constexpr uint32_t kLazy = 2;
  // a zr R^-1 mod q for any a < 2^32 and zr < q (canonical)
  __device__ static __forceinline__ uint32_t mul(uint32_t a, uint32_t zr) {
    const uint32_t lo = a * zr, hi = __umulhi(a, zr);
    const uint32_t m = lo * kNegPinv;
    const uint32_t t = hi + __umulhi(m, kQ) + (lo != 0 ? 1u : 0u);
    return t >= kQ ? t - kQ : t;
  }
  // a zr R^-1 mod q in (0, 2q) for any a < 2^32 and zr < q: with
  // m = lo q^-1, m q and a zr share their low word, so
  // (a zr - m q) / 2^32 = hi - umulhi(m, q), in (-q, q)
  __device__ static __forceinline__ uint32_t lazy_mul(uint32_t a,
                                                      uint32_t zr) {
    const uint32_t lo = a * zr, hi = __umulhi(a, zr);
    return hi + kQ - __umulhi(lo * kQInv, kQ);
  }
};

// The butterflies keep values lazy, below a multiple of q that the layers
// done so far bound, and the transforms reduce once at the end. Forward,
// after d layers: below (1 + kLazy d) q; a layer (u + t, u + kLazy q - t)
// with t = lazy_mul(v, z) < kLazy q. Inverse, after d layers: below 2^d q;
// a layer (u + v, lazy_mul(u + 2^d q - v, z)).
template <class S>
__host__ __device__ constexpr unsigned long long forward_bound(int done) {
  return (1ull + S::kLazy * done) * S::kQ;
}
template <class S>
__host__ __device__ constexpr unsigned long long inverse_bound(int done) {
  return (1ull << done) * S::kQ;
}

template <class S, bool kInv, int kDone>
__device__ __forceinline__ void bfly(uint32_t& u, uint32_t& v, uint32_t z) {
  if constexpr (kInv) {
    static_assert(inverse_bound<S>(kDone + 1) <= S::kMulMax + 1ull,
                  "the inverse's lazy values stay in the multiply's range");
    constexpr uint32_t kK = static_cast<uint32_t>(inverse_bound<S>(kDone));
    const uint32_t s = u + v;
    v = S::lazy_mul(u + kK - v, z);
    u = s;
  } else {
    static_assert(forward_bound<S>(kDone) <= S::kMulMax + 1ull &&
                      forward_bound<S>(kDone + 1) <= 0xffffffffull,
                  "the forward's lazy values stay in the multiply's range");
    const uint32_t t = S::lazy_mul(v, z);
    v = u + S::kLazy * S::kQ - t;
    u = u + t;
  }
}

// The layer on coefficient bit kY (len = 2^kY, L = 7 - kY) in layout kLay:
// 4 butterflies a lane on the register pairs that differ in that bit.
template <class S, bool kInv, int kLay, int kY>
__device__ __forceinline__ void layer(uint32_t (&r)[kRegs],
                                      const uint32_t* __restrict__ z,
                                      int lane) {
  constexpr int kP = reg_pos(kLay, kY);
  constexpr int kM = run_log(kLay, kY);
  static_assert(kP >= 0, "a layer pairs registers of one lane");
  static_assert(run_is_contiguous(kLay, kY) &&
                    ((1 << (7 - kY)) & ((1 << kM) - 1)) == 0,
                "a lane's zetas are one aligned run");
  uint32_t w[4];
  load_run<kM>(z + (1 << (7 - kY)) + lane_part<kLay, kY>(lane), w);
  constexpr int kDone = kInv ? kY - (8 - S::kLayers) : 7 - kY;
#pragma unroll
  for (int j = 0; j < kRegs; ++j)
    if (!(j & (1 << kP)))
      bfly<S, kInv, kDone>(r[j], r[j | (1 << kP)],
                           w[run_offset(kLay, kY, j)]);
}

// Swap s: register bit kSwapReg[s] with lane bit kSwapLane[s]. Of each
// register pair (j, j | step) the lane whose swapped lane bit is 0 keeps j
// and takes its partner's j; the other keeps j | step and takes its
// partner's j | step.
template <int kS>
__device__ __forceinline__ void swap_step(uint32_t (&r)[kRegs], int lane) {
  constexpr int kStep = 1 << swap_reg(kS), kMask = 1 << swap_lane(kS);
  const bool hi = lane & kMask;
#pragma unroll
  for (int j = 0; j < kRegs; ++j) {
    if (j & kStep) continue;
    const uint32_t send = hi ? r[j] : r[j | kStep];
    const uint32_t recv = __shfl_xor_sync(kFullMask, send, kMask);
    r[j] = hi ? recv : r[j];
    r[j | kStep] = hi ? r[j | kStep] : recv;
  }
}

// The forward from layout_after(kStep), next layer on bit kY: run each layer
// once its bit is in a register, swap until it is; past the last layer,
// the remaining swaps, to the final layout.
template <class S, int kStep, int kY>
__device__ __forceinline__ void forward_from(uint32_t (&r)[kRegs],
                                             const uint32_t* z, int lane) {
  constexpr int kLay = layout_after(kStep);
  if constexpr (kY < 8 - S::kLayers) {
    if constexpr (kStep < kSwaps) {
      swap_step<kStep>(r, lane);
      forward_from<S, kStep + 1, kY>(r, z, lane);
    }
  } else if constexpr (reg_pos(kLay, kY) >= 0) {
    layer<S, false, kLay, kY>(r, z, lane);
    forward_from<S, kStep, kY - 1>(r, z, lane);
  } else {
    static_assert(kStep < kSwaps, "the swaps bring every bit in");
    swap_step<kStep>(r, lane);
    forward_from<S, kStep + 1, kY>(r, z, lane);
  }
}

// The inverse from layout_after(kStep), next layer on bit kY: the swaps
// undone in reverse as the layers need, and past the last layer (bit 7)
// all of them, to the stride layout.
template <class S, int kStep, int kY>
__device__ __forceinline__ void inverse_from(uint32_t (&r)[kRegs],
                                             const uint32_t* z, int lane) {
  constexpr int kLay = layout_after(kStep);
  if constexpr (kY > 7) {
    if constexpr (kStep > 0) {
      swap_step<kStep - 1>(r, lane);
      inverse_from<S, kStep - 1, kY>(r, z, lane);
    }
  } else if constexpr (reg_pos(kLay, kY) >= 0) {
    layer<S, true, kLay, kY>(r, z, lane);
    inverse_from<S, kStep, kY + 1>(r, z, lane);
  } else {
    static_assert(kStep > 0, "the swaps bring every bit in");
    swap_step<kStep - 1>(r, lane);
    inverse_from<S, kStep - 1, kY>(r, z, lane);
  }
}

// stride layout in (the transform's input in natural order), the final
// layout out, reduced to canonical values
template <class S>
__device__ __forceinline__ void forward(uint32_t (&r)[kRegs],
                                        const uint32_t* z, int lane) {
  forward_from<S, 0, 7>(r, z, lane);
#pragma unroll
  for (int j = 0; j < kRegs; ++j) r[j] %= S::kQ;
}

// final layout in, stride layout out, lazy: the caller's final multiply
// (S::mul, canonical) reduces it
template <class S>
__device__ __forceinline__ void inverse(uint32_t (&r)[kRegs],
                                       const uint32_t* z, int lane) {
  static_assert(inverse_bound<S>(S::kLayers) <= S::kMulMax + 1ull,
                "the final multiply takes the inverse's lazy values");
  inverse_from<S, kSwaps, 8 - S::kLayers>(r, z, lane);
}

__device__ __forceinline__ void load_stride(const uint32_t* __restrict__ src,
                                            uint32_t (&r)[kRegs], int lane) {
#pragma unroll
  for (int j = 0; j < kRegs; ++j) r[j] = __ldg(src + lane + 32 * j);
}

__device__ __forceinline__ void store_stride(uint32_t* __restrict__ dst,
                                             const uint32_t (&r)[kRegs],
                                             int lane) {
#pragma unroll
  for (int j = 0; j < kRegs; ++j) dst[lane + 32 * j] = r[j];
}

// the final layout's registers from coefficients 8t .. 8t + 7 (c[m]: 8t + m)
__device__ __forceinline__ void from_coeffs(const uint4 v0, const uint4 v1,
                                            uint32_t (&r)[kRegs]) {
  const uint32_t c[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
  for (int j = 0; j < kRegs; ++j) r[j] = c[reg_coeff(kFinalLayout, j)];
}

__device__ __forceinline__ void to_coeffs(const uint32_t (&r)[kRegs],
                                          uint4& v0, uint4& v1) {
  uint32_t c[8];
#pragma unroll
  for (int j = 0; j < kRegs; ++j) c[reg_coeff(kFinalLayout, j)] = r[j];
  v0 = make_uint4(c[0], c[1], c[2], c[3]);
  v1 = make_uint4(c[4], c[5], c[6], c[7]);
}

__device__ __forceinline__ void load_final(const uint32_t* __restrict__ src,
                                           uint32_t (&r)[kRegs], int lane) {
  const uint4* s = reinterpret_cast<const uint4*>(src) + 2 * lane;
  from_coeffs(__ldg(s), __ldg(s + 1), r);
}

__device__ __forceinline__ void store_final(uint32_t* __restrict__ dst,
                                            const uint32_t (&r)[kRegs],
                                            int lane) {
  uint4 v0, v1;
  to_coeffs(r, v0, v1);
  uint4* d = reinterpret_cast<uint4*>(dst) + 2 * lane;
  d[0] = v0;
  d[1] = v1;
}

// a polynomial in shared memory (64 swizzled chunks), final layout
__device__ __forceinline__ void load_final_smem(const uint32_t* poly,
                                                uint32_t (&r)[kRegs],
                                                int lane) {
  const uint4* s = reinterpret_cast<const uint4*>(poly);
  from_coeffs(s[swizzle_chunk(2 * lane)], s[swizzle_chunk(2 * lane + 1)], r);
}

__device__ __forceinline__ void store_final_smem(uint32_t* poly,
                                                 const uint32_t (&r)[kRegs],
                                                 int lane) {
  uint4 v0, v1;
  to_coeffs(r, v0, v1);
  uint4* d = reinterpret_cast<uint4*>(poly);
  d[swizzle_chunk(2 * lane)] = v0;
  d[swizzle_chunk(2 * lane + 1)] = v1;
}

// One polynomial a warp; the row's loads are in flight while the block
// reads the table.
template <class S, bool kInverse>
__global__ void __launch_bounds__(kThreads)
    ring_layers_kernel(const uint32_t* __restrict__ x,
                       uint32_t* __restrict__ out, long long rows,
                       const uint32_t* __restrict__ zetas, uint32_t scale) {
  constexpr int kTable = 1 << S::kLayers;
  __shared__ __align__(16) uint32_t ztab[kTable];
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool live = row < rows;
  uint32_t r[kRegs];
  if (live) {
    if constexpr (kInverse)
      load_final(x + row * kN, r, lane);
    else
      load_stride(x + row * kN, r, lane);
  }
  for (int i = threadIdx.x; i < kTable; i += kThreads)
    ztab[i] = __ldg(zetas + i);
  __syncthreads();
  if (!live) return;
  if constexpr (kInverse) {
    inverse<S>(r, ztab, lane);
#pragma unroll
    for (int j = 0; j < kRegs; ++j) r[j] = S::mul(r[j], scale);
    store_stride(out + row * kN, r, lane);
  } else {
    forward<S>(r, ztab, lane);
    store_final(out + row * kN, r, lane);
  }
}

// The product's table: the forward zetas, the inverse's, and ML-KEM's
// gammas (entry 2^kLayers * 2 + i: zeta^(2 BitRev7(i) + 1)).
template <class S>
__host__ __device__ constexpr int product_table_words() {
  return 2 * (1 << S::kLayers) + (S::kBasemul ? 128 : 0);
}

// The sums of a row's terms, in the final layout, reduced once at the end.
// ML-KEM: for each register pair (j, h) that differs in bit 0 (a basemul
// pair), sum a_j x_j, sum a_h x_h and sum (a_j x_h + a_h x_j), raw (below
// 2 kMaxRank q^2 < 2^28); its gamma is the same in every term, so
// c_j = (sum a_j x_j + (sum a_h x_h mod q) gamma) mod q and
// c_h = sum (a_j x_h + a_h x_j) mod q. ML-DSA: sum a_j x_j in 64 bits
// (below kMaxRank q^2 < 2^32 q), one Montgomery REDC at the end: the sum
// times R^-1 mod q, canonical.
template <class S>
struct RowSums;

template <>
struct RowSums<MlKem> {
  static constexpr int kP = reg_pos(kFinalLayout, 0);
  static_assert(kP >= 0 && run_log(kFinalLayout, 0) == 2 &&
                    run_is_contiguous(kFinalLayout, 0),
                "a lane holds both halves of its pairs and 4 gammas");
  uint32_t lo[kRegs], hi[kRegs], cross[kRegs];  // at a pair's lower j

  template <bool kFirst>
  __device__ __forceinline__ void add(const uint32_t (&a)[kRegs],
                                      const uint32_t (&x)[kRegs]) {
#pragma unroll
    for (int j = 0; j < kRegs; ++j) {
      if (j & (1 << kP)) continue;
      const int h = j | (1 << kP);
      lo[j] = (kFirst ? 0u : lo[j]) + a[j] * x[j];
      hi[j] = (kFirst ? 0u : hi[j]) + a[h] * x[h];
      cross[j] = (kFirst ? 0u : cross[j]) + a[j] * x[h] + a[h] * x[j];
    }
  }

  __device__ __forceinline__ void reduce(uint32_t (&r)[kRegs],
                                         const uint32_t* gam, int lane) {
    uint32_t g[4];
    load_run<2>(gam + lane_part<kFinalLayout, 0>(lane), g);
#pragma unroll
    for (int j = 0; j < kRegs; ++j) {
      if (j & (1 << kP)) continue;
      const int h = j | (1 << kP);
      r[j] = (lo[j] + (hi[j] % MlKem::kQ) * g[run_offset(kFinalLayout, 0, j)]) %
             MlKem::kQ;
      r[h] = cross[j] % MlKem::kQ;
    }
  }
};

template <>
struct RowSums<MlDsa> {
  uint64_t sum[kRegs];

  template <bool kFirst>
  __device__ __forceinline__ void add(const uint32_t (&a)[kRegs],
                                      const uint32_t (&x)[kRegs]) {
#pragma unroll
    for (int j = 0; j < kRegs; ++j)
      sum[j] = (kFirst ? 0ull : sum[j]) + (uint64_t)a[j] * x[j];
  }

  __device__ __forceinline__ void reduce(uint32_t (&r)[kRegs], const uint32_t*,
                                         int) {
#pragma unroll
    for (int j = 0; j < kRegs; ++j) {
      const uint32_t m = (uint32_t)sum[j] * MlDsa::kNegPinv;
      const uint32_t t =
          (uint32_t)((sum[j] + (uint64_t)m * MlDsa::kQ) >> 32);
      r[j] = t >= MlDsa::kQ ? t - MlDsa::kQ : t;
    }
  }
};

// The product's row from its reduced sums: the inverse (the layers and
// `scale`, stride layout out) or, with none, the final layout out (ML-DSA
// first times `scale` = R^2 mod q, taking back the REDC's R^-1).
template <class S, bool kInv>
__device__ __forceinline__ void finish_row(uint32_t (&r)[kRegs],
                                           uint32_t* __restrict__ dst,
                                           const uint32_t* zi,
                                           uint32_t scale, int lane) {
  if constexpr (kInv) {
    inverse<S>(r, zi, lane);
#pragma unroll
    for (int j = 0; j < kRegs; ++j) r[j] = S::mul(r[j], scale);
    store_stride(dst, r, lane);
  } else {
    if constexpr (!S::kBasemul) {
#pragma unroll
      for (int j = 0; j < kRegs; ++j) r[j] = S::mul(r[j], scale);
    }
    store_final(dst, r, lane);
  }
}

// out (batch, k, 256) = [intt] sum_j A[i, j] o [ntt] x[j], x (batch, l, 256);
// A (k, l, 256) shared by the batch (kSharedA) or (batch, k, l, 256);
// kFwdA transforms a batched A. tables: product_table_words<S>() words.
// Dynamic shared memory: the tables, the shared matrix, and with kFwdX and
// (k, l) != (1, 1) the group's transformed vectors.
template <class S, bool kFwdX, bool kFwdA, bool kInv, bool kSharedA>
__global__ void __launch_bounds__(kThreads)
    ring_product_kernel(const uint32_t* __restrict__ x,
                        const uint32_t* __restrict__ a,
                        uint32_t* __restrict__ out, long long batch, int k,
                        int l, int group,
                        const uint32_t* __restrict__ tables,
                        uint32_t scale) {
  static_assert(!(kFwdA && kSharedA), "a shared matrix comes transformed");
  constexpr int kTable = 1 << S::kLayers;
  constexpr int kTabWords = product_table_words<S>();
  extern __shared__ __align__(16) uint32_t smem[];
  const uint32_t* zf = smem;
  const uint32_t* zi = smem + kTable;
  const uint32_t* gam = smem + 2 * kTable;
  uint32_t* atab = smem + kTabWords;
  uint32_t* xhat = atab + (kSharedA ? k * l * kN : 0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, warps = nthreads >> 5;
  for (int i = tid; i < kTabWords; i += nthreads) smem[i] = __ldg(tables + i);
  if constexpr (kSharedA) {
    const uint4* src = reinterpret_cast<const uint4*>(a);
    uint4* dst = reinterpret_cast<uint4*>(atab);
    for (int c = tid; c < k * l * (kN / 4); c += nthreads)
      dst[(c & ~63) | swizzle_chunk(c & 63)] = __ldg(src + c);
  }
  __syncthreads();
  const long long groups = (batch + group - 1) / group;
  const int kl = k * l;

  // the product's operands of row (g, i), term j, in the final layout
  auto load_a = [&](uint32_t (&r)[kRegs], long long g, int i, int j) {
    if constexpr (kSharedA) {
      load_final_smem(atab + (i * l + j) * kN, r, lane);
    } else {
      const uint32_t* src = a + ((g * k + i) * l + j) * kN;
      if constexpr (kFwdA) {
        load_stride(src, r, lane);
        forward<S>(r, zf, lane);
      } else {
        load_final(src, r, lane);
      }
    }
  };
  auto load_x = [&](uint32_t (&r)[kRegs], long long g, int j) {
    const uint32_t* src = x + (g * l + j) * kN;
    if constexpr (kFwdX) {
      load_stride(src, r, lane);
      forward<S>(r, zf, lane);
    } else {
      load_final(src, r, lane);
    }
  };

  if (kl == 1) {  // one warp a row, in registers throughout
    for (long long grp = blockIdx.x; grp < groups; grp += gridDim.x) {
      const long long g = grp * group + warp;
      if (g >= batch) continue;
      uint32_t xr[kRegs], ar[kRegs];
      RowSums<S> sums;
      load_x(xr, g, 0);
      load_a(ar, g, 0, 0);
      sums.template add<true>(ar, xr);
      sums.reduce(xr, gam, lane);
      finish_row<S, kInv>(xr, out + g * kN, zi, scale, lane);
    }
    return;
  }
  for (long long grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const long long g0 = grp * group;
    if constexpr (kFwdX) {  // the group's vectors, transformed once
      for (int task = warp; task < group * l; task += warps) {
        const long long g = g0 + task / l;
        if (g >= batch) continue;
        uint32_t r[kRegs];
        load_x(r, g, task % l);
        store_final_smem(xhat + task * kN, r, lane);
      }
      __syncthreads();
    }
    for (int task = warp; task < group * k; task += warps) {
      const long long g = g0 + task / k;
      const int i = task % k;
      if (g >= batch) continue;
      RowSums<S> sums;
      uint32_t xr[kRegs], ar[kRegs];
      for (int j = 0; j < l; ++j) {
        if constexpr (kFwdX)
          load_final_smem(xhat + ((task / k) * l + j) * kN, xr, lane);
        else
          load_x(xr, g, j);
        load_a(ar, g, i, j);
        if (j == 0)
          sums.template add<true>(ar, xr);
        else
          sums.template add<false>(ar, xr);
      }
      sums.reduce(xr, gam, lane);
      finish_row<S, kInv>(xr, out + (g * k + i) * kN, zi, scale, lane);
    }
    if constexpr (kFwdX) __syncthreads();  // before the next group's vectors
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

using ProductFn = void (*)(const uint32_t*, const uint32_t*, uint32_t*,
                           long long, int, int, int, const uint32_t*,
                           uint32_t);

// The product's modes (the wrapper's instantiations): bit 0 transform x,
// bit 1 transform A, bit 2 the inverse, bit 3 A shared by the batch.
constexpr int kModeFwdX = 1, kModeFwdA = 2, kModeInv = 4, kModeShared = 8;

template <class S>
ProductFn pick_product_of(int mode) {
  switch (mode) {
    case kModeFwdX | kModeFwdA | kModeInv:  // polymul; serving step, fresh A
      return ring_product_kernel<S, true, true, true, false>;
    case 0:  // basemul / pointwise; matvec, batched A
      return ring_product_kernel<S, false, false, false, false>;
    case kModeShared:  // matvec, shared A
      return ring_product_kernel<S, false, false, false, true>;
    case kModeFwdX | kModeInv:  // serving step, batched NTT-domain A
      return ring_product_kernel<S, true, false, true, false>;
    case kModeFwdX | kModeInv | kModeShared:  // serving step, shared A
      return ring_product_kernel<S, true, false, true, true>;
    default:
      return nullptr;
  }
}

ProductFn pick_product(int scheme, int mode) {
  if (scheme == 0) return pick_product_of<MlKem>(mode);
  if (scheme == 1) return pick_product_of<MlDsa>(mode);
  return nullptr;
}

int table_words(int scheme) {
  return scheme == 0 ? product_table_words<MlKem>()
                     : product_table_words<MlDsa>();
}

// the largest dynamic shared memory of a product: the tables, a shared
// 8 x 8 matrix and 8 groups' worth of 8 transformed vectors
constexpr int kMaxSmemBytes =
    (product_table_words<MlDsa>() + 2 * kMaxRank * kMaxRank * kN) * 4;

// Blocks of `fn` resident on the current card at once (the product's grid
// at most); 0 if it does not fit. Cached by kernel, shape and device.
int resident_blocks(const void* fn, int threads, int smem) {
  struct Entry {
    const void* fn;
    int device, threads, smem, blocks;
  };
  static std::mutex mu;
  static Entry cache[128];
  static int used = 0;
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 0;
  std::lock_guard<std::mutex> guard(mu);
  for (int i = 0; i < used; ++i)
    if (cache[i].fn == fn && cache[i].device == device &&
        cache[i].threads == threads && cache[i].smem == smem)
      return cache[i].blocks;
  int per_sm = 0, sms = 0;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmemBytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                    smem) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return 0;
  const int blocks = per_sm * sms;
  if (used < 128) cache[used++] = {fn, device, threads, smem, blocks};
  return blocks;
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
// uint32, canonical, not overlapping, 16-byte aligned) on `stream`. zetas:
// 2^layers uint32 on the device, entry 2^L + b the zeta of layer L's block
// b (the inverse's table for inverse = 1); scale: the inverse's final
// multiplier in the table's form. Returns cudaGetLastError() after the
// launch (0 = launched), or cudaErrorInvalidValue for a scheme, row count
// or grid it does not take.
int ntt_ring_layers(int scheme, int inverse, const void* x, void* out,
                    long long rows, const void* zetas, unsigned int scale,
                    void* stream) {
  const KernelFn kernel = pick_kernel(scheme, inverse);
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (!kernel || rows < 1 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), rows,
      static_cast<const uint32_t*>(zetas), scale);
  return static_cast<int>(cudaGetLastError());
}

// The words of a scheme's product table (the forward zetas, the inverse's,
// ML-KEM's gammas), or -1 for an unknown scheme.
int ntt_ring_product_table_words(int scheme) {
  return scheme == 0 || scheme == 1 ? table_words(scheme) : -1;
}

// Launches the fused ring product on `stream`: out (batch, k, 256) =
// [intt] sum_j A[i, j] o [ntt] x[j] with x (batch, l, 256), A (k, l, 256)
// (mode bit 3) or (batch, k, l, 256), all uint32, canonical, contiguous,
// 16-byte aligned, out not overlapping the others. mode: bit 0 transform
// x, bit 1 transform A, bit 2 inverse-transform the sums, bit 3 A shared.
// tables: ntt_ring_product_table_words(scheme) uint32 on the device; scale:
// with the inverse its final multiplier (ML-DSA: n^-1 R^2 in Montgomery
// form, taking back the products' R^-1), without it ML-DSA's R^2 mod q
// (ML-KEM: unused). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a scheme, mode, k, l or batch it does not take.
int ntt_ring_product(int scheme, int mode, const void* x, const void* a,
                     void* out, long long batch, int k, int l,
                     const void* tables, unsigned int scale, void* stream) {
  const ProductFn kernel = pick_product(scheme, mode);
  if (!kernel || batch < 1 || k < 1 || k > kMaxRank || l < 1 ||
      l > kMaxRank)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool single = k == 1 && l == 1;
  const int group = single ? kWarps : (kWarps / k > 0 ? kWarps / k : 1);
  const int threads = 32 * (single ? kWarps : group * k);
  const int smem =
      4 * (table_words(scheme) + ((mode & kModeShared) ? k * l * kN : 0) +
           ((mode & kModeFwdX) && !single ? group * l * kN : 0));
  const int resident = resident_blocks(reinterpret_cast<const void*>(kernel),
                                       threads, smem);
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long groups = (batch + group - 1) / group;
  const long long blocks = groups < resident ? groups : resident;
  kernel<<<static_cast<unsigned int>(blocks), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(a),
      static_cast<uint32_t*>(out), batch, k, l, group,
      static_cast<const uint32_t*>(tables), scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
