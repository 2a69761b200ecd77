// K5: the complete G1 / G2 group law, p + q and 2 p, one launch a call, over
// projective points (X : Y : Z) in Montgomery limbs, canonical in [0, p):
//   G1 (..., 3, 12, n)        G2 (..., 3, 2, 12, n)
//
// No Pallas kernel computes these: the JAX package writes the
// Renes-Costello-Batina complete formulas for a = 0 as stacked field
// operations (lighthouse_tpu/ops/bm/curves.py:100 add, :122 double) and XLA
// fuses them into each stage's program. The port ran each formula as torch
// code around its field kernels, 14-28 CUDA kernels a call (G1 add 25,
// double 14, G2 add 28, double 17): 2-3 K1 or K2 products, 6-11 K4 additive
// launches (fp_add.cu) and torch.stack's copies between them. Here a call
// is one launch, and K4's work runs inside it, in registers.
//
// What bounds it. The function needs 3,024 (G1 add), 2,028 (G1 double),
// 7,776 (G2 add) and 5,184 (G2 double) 32-bit multiply-adds a point (its
// schedule's products and reductions, chip_smoke.py WORK) against 432, 288,
// 864 and 576 bytes: bound by operations, 0.0005-0.0019 ms at 4096 points.
// The paths give it 16-4096 points (KZG's ladders 16 and 512, h2g2, the
// pairing and the signature sum 64-65, the ladders and the key tree 4096):
// 1-128 blocks of 32 points, so a launch is its floor plus one block's
// critical path, and the design shortens that path. A block owns 32
// points, lane = point, so every limb row is one 128-byte line, and each
// level of the formula runs its independent Fp products on parallel warps:
//
//   load     warp f < inputs loads input Fp f of its 32 points (strided or
//            broadcast in place, as K4), every thread its share of the
//            schedule; all loads are issued before the first shared store;
//   level 0  products: warp k forms product k's two operands, each a signed
//            combination of slots with small coefficients (combine), and
//            its 24-limb product (lh::mul_wide) into shared memory;
//            reductions: warp k sums its output's products with their signs
//            and o p^2 column by column, then one REDC (lh::redc_imm,
//            canonical) into a slot;
//   level 1  the same on level 0's values, the reductions into the output.
// One barrier after each step, five in all; one copy of each step's code
// (a loop over the two levels), so the kernel is about 2,400 instructions.
// G1 add's 12 products and 9 reductions run on 6 warps, G1 double's 8 and
// 7 on 4, G2 add's 36 Fp products (Karatsuba) and 18 reductions on 18
// warps, G2 double's 22 and 14 on 12.
//
// The schedule is not written here: ops/fused.py (k5_schedule) writes each
// operation's formula once, level by level, and ops/_build.py writes its
// words into the generated header curve_plan.h (one struct of counts per
// operation). tests/test_torch_curve_op.py replays those words in Python
// integers in this file's order against the oracle, asserting each bound:
//   an operand is canonical (< p), so a product W < p^2;
//   a reduction T = o p^2 + sum_i d_i W_i, o the sum of the subtracted
//   |d_i|, has 0 <= T <= (sum |d_i|) p^2 <= 9 p^2 < p 2^384 (2^384 / p >
//   9.8): its column sums stay below 2^38 in magnitude, its final carry is 0,
//   and REDC returns u < T / 2^384 + p < 2p, one subtraction to canonical;
//   every output is canonical, so it equals the plain version's bit for bit.
//
// Measured (graph-replay us at n = 1 / 4096, NVIDIA H100 80GB HBM3, 700 W,
// each step timed against the one before in one call, in turns; clock64
// stamps per step; PERF.md), G1 add, G1 double, G2 add, G2 double:
//   every operand by K4's chains (mul_small by doubling), the whole
//   formula unrolled per level        13.9/14.4  12.4/13.6  23.7/24.1  18.9/19.3
//   small multiples in one pass (column sums, a quotient estimate and one
//   subtraction); column sums split from the carry chain
//                                     11.8/13.0  10.2/12.3  21.6/22.1  15.4/15.9
//   one copy of each step's code      10.4/10.8   8.3/8.5   21.4/21.9  13.8/14.1
//   p^2 as immediates, loads before stores, the quotient in double
//   precision (no 64-bit division)    10.7/11.1   8.1/8.4   22.6/23.1  13.6/13.9
//   +-1 combinations by K4's chains, column sums adding +-1 products
//   without a multiply: kept           9.5/9.8    7.4/7.7   17.7/18.3  13.6/13.9
// A lone warp runs these dependent chains at about 2.5-3 cycles an
// instruction (stamps: a product's 144-step operand scanning about 1,170
// cycles, REDC about 1,350), and G2 add's 18 warps share four schedulers,
// so the time follows the instruction count of the critical path (per
// level a combination or two, a product, a column sum, a REDC).
//
// Resources (ptxas, sm_90a, nvcc 12.9): 72-96 registers; G1 add spills 12
// bytes (three words stored near its start and loaded for its final store,
// once per thread). Shared memory per block, dynamic: the schedule, the
// slots (max(inputs, level 0's reductions) x 12 limbs x 32 lanes) and the
// products (the larger level's x 24 limbs x 32 lanes): G1 add 28 KB, G1
// double 19 KB, G2 add 74 KB, G2 double 49 KB. Above 48 KB a function must
// be allowed it (cudaFuncSetAttribute), which the launcher does once per
// device at its first call, before the graphs that capture it (they run
// each stage once eagerly first).
#include <atomic>

#include "fp.cuh"
#include "curve_plan.h"

namespace {

constexpr int kLanes = 32;   // points per block
constexpr int kMulWords = 2 * LH_K5_LIN;
constexpr int kRedWords = 1 + LH_K5_RED;
constexpr uint32_t kHas = 1u << 31;
constexpr int kFpWords = lh::NL * kLanes;     // one Fp slot of the block
constexpr int kWideWords = lh::NW * kLanes;   // one unreduced product

// Element strides of one operand over the output's (r1, r0) rows, its
// coordinate, component (G2), limb and column axes; a broadcast axis has
// stride 0.
struct Geom {
  long long s1, s0, sc, sk, sl, sn;
};

struct Grid {
  uint32_t total, n, r0;
};

// Limb j of p^2 as an immediate (the reductions' offsets o p^2).
__host__ __device__ constexpr uint32_t p2_limb(int j) {
  constexpr uint32_t kLimbs[lh::NW] = {
      0x1c718e39u, 0x26aa0000u, 0x76382eabu, 0x7ced6b1du, 0x62113cfdu, 0x162c3383u,
      0x3e71b743u, 0x66bf91edu, 0x7091a049u, 0x292e85a8u, 0x86185c7bu, 0x1d68619cu,
      0x0978ef01u, 0xf5314933u, 0x16ddca6eu, 0x50a62cfdu, 0x349e8bd0u, 0x66e59e49u,
      0x0e7046b4u, 0xe2dc90e5u, 0xa22f25e9u, 0x4bd278eau, 0xb8c35fc7u, 0x02a437a4u};
  return kLimbs[j];
}

// acc = sum_k c_k slot[s_k] mod p, canonical. slots points at this lane's
// column of slot 0. Most operands are single slots or sums and differences
// of slots (every |c_k| = 1): the first term loaded (negated if need be),
// the others by K4's chains (lh::add_mod, sub_mod), a lone +x a plain load.
// Otherwise (small multiples, 3 to 72) in one pass: the terms' signed column
// sums plus m p (m the subtracted |c_k|), one carry pass into v in
// [0, (sum |c_k|) p), 13 limbs; then v - q p with q = v_hi * LH_K5_INV_HI in
// double precision, truncated (v_hi = floor(v / 2^352) < 2^47, exact in a
// double; the constant is 2^352 / p rounded down past the product's
// rounding), which is floor(v / p) or one less; then one conditional
// subtraction.
__device__ __forceinline__ void load_slot(const uint32_t* slots, uint32_t w, uint32_t* x) {
  const uint32_t* src = slots + (w & 0xffu) * kFpWords;
#pragma unroll
  for (int l = 0; l < lh::NL; ++l) x[l] = src[l * kLanes];
}

__device__ __forceinline__ void combine(const uint32_t* words, const uint32_t* slots,
                                        uint32_t* acc) {
  bool unit = true;
#pragma unroll
  for (int i = 0; i < LH_K5_LIN; ++i) {
    const uint32_t w = words[i];
    unit = unit && (!(w & kHas) || ((w >> 8) & 0xffffu) == 1u);
  }
  if (unit) {
    uint32_t x[lh::NL];
    load_slot(slots, words[0], acc);
    if (words[0] & (1u << 24)) {
      lh::neg_mod(acc, x);
#pragma unroll
      for (int l = 0; l < lh::NL; ++l) acc[l] = x[l];
    }
#pragma unroll 1
    for (int i = 1; i < LH_K5_LIN; ++i) {
      const uint32_t w = words[i];
      if (!(w & kHas)) break;
      load_slot(slots, w, x);
      if (w & (1u << 24)) {
        lh::sub_mod(acc, x, acc);
      } else {
        lh::add_mod(acc, x, acc);
      }
    }
    return;
  }
  long long col[lh::NL];
#pragma unroll
  for (int l = 0; l < lh::NL; ++l) col[l] = 0;
  long long m = 0;
#pragma unroll 1
  for (int i = 0; i < LH_K5_LIN; ++i) {
    const uint32_t w = words[i];
    if (!(w & kHas)) break;
    const uint32_t* src = slots + (w & 0xffu) * kFpWords;
    const long long k = (w >> 8) & 0xffffu;
    const long long c = (w & (1u << 24)) ? -k : k;
    m += (w & (1u << 24)) ? k : 0;
#pragma unroll
    for (int l = 0; l < lh::NL; ++l) col[l] += c * src[l * kLanes];   // |c x| < 2^48
  }
  uint32_t v[lh::NL];
  long long carry = 0;   // arithmetic shift: v >= 0, so it ends non-negative
#pragma unroll
  for (int l = 0; l < lh::NL; ++l) {
    carry += col[l] + m * lh::p_limb(l);
    v[l] = (uint32_t)carry;
    carry >>= 32;
  }
  const uint64_t hi = ((uint64_t)carry << 32) | v[lh::NL - 1];
  const long long q = (long long)((double)hi * LH_K5_INV_HI);
  long long br = 0;
#pragma unroll
  for (int l = 0; l < lh::NL; ++l) {
    br += (long long)v[l] - q * lh::p_limb(l);
    v[l] = (uint32_t)br;
    br >>= 32;
  }
  // v - q p is in [0, 2p): its carry out is -carry; keep it or v - q p - p.
  uint32_t d[lh::NL];
  br = 0;
#pragma unroll
  for (int l = 0; l < lh::NL; ++l) {
    br += (long long)v[l] - lh::p_limb(l);
    d[l] = (uint32_t)br;
    br >>= 32;
  }
#pragma unroll
  for (int l = 0; l < lh::NL; ++l) acc[l] = br < 0 ? v[l] : d[l];
}

// One product of the schedule: its two operands, each staged in this warp's
// product slot (one copy of combine's code), then A * B into that slot.
__device__ __forceinline__ void product(const uint32_t* rec, const uint32_t* slots,
                                        uint32_t* wide) {
  uint32_t x[lh::NL], y[lh::NL], t[lh::NW];
#pragma unroll 1
  for (int k = 0; k < 2; ++k) {
    combine(rec + k * LH_K5_LIN, slots, x);
#pragma unroll
    for (int l = 0; l < lh::NL; ++l) wide[(k * lh::NL + l) * kLanes] = x[l];
  }
#pragma unroll
  for (int l = 0; l < lh::NL; ++l) {
    x[l] = wide[l * kLanes];
    y[l] = wide[(lh::NL + l) * kLanes];
  }
  lh::mul_wide(x, y, t);
#pragma unroll
  for (int c = 0; c < lh::NW; ++c) wide[c * kLanes] = t[c];
}

// One reduction of the schedule: out = REDC(o p^2 + sum_i d_i W_i),
// canonical: the terms' signed column sums (|sum| < 2^37), one carry pass,
// one REDC. wide points at this lane's column of product 0.
__device__ __forceinline__ void reduce(const uint32_t* rec, const uint32_t* wide,
                                       uint32_t* out) {
  const uint32_t head = rec[0];
  long long s[lh::NW];
#pragma unroll
  for (int col = 0; col < lh::NW; ++col) s[col] = (long long)(head & 0xffu) * p2_limb(col);
  const int terms = (head >> 16) & 0xff;
#pragma unroll 1
  for (int i = 0; i < terms; ++i) {
    const uint32_t w = rec[1 + i];
    const uint32_t k = (w >> 8) & 0xffu;
    const uint32_t* src = wide + (w & 0xffu) * kWideWords;
    if ((w >> 16) & 1u) {
#pragma unroll
      for (int col = 0; col < lh::NW; ++col) s[col] -= (long long)k * src[col * kLanes];
    } else if (k == 1) {
#pragma unroll
      for (int col = 0; col < lh::NW; ++col) s[col] += src[col * kLanes];
    } else {
#pragma unroll
      for (int col = 0; col < lh::NW; ++col) s[col] += (long long)k * src[col * kLanes];
    }
  }
  uint32_t t[lh::NW];
  long long c = 0;   // arithmetic shift
#pragma unroll
  for (int col = 0; col < lh::NW; ++col) {
    c += s[col];
    t[col] = (uint32_t)c;
    c >>= 32;
  }
  lh::redc_imm(t, out);
}

template <class K>
__global__ void __launch_bounds__(K::warps * kLanes)
curve_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ a,
             const uint32_t* __restrict__ b, Geom ga, Geom gb, Grid g) {
  extern __shared__ uint32_t smem[];
  constexpr int kPlanWords = (K::words + 3) / 4 * 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* plan = smem;
  uint32_t* slots = smem + kPlanWords + lane;
  uint32_t* wide = smem + kPlanWords + K::slots * kFpWords + lane;

  // Load: warp f < inputs loads input Fp f, of operand f / (3 comps),
  // coordinate (f / comps) % 3, component f % comps; every thread loads its
  // share of the schedule. All loads are issued before the first shared
  // store (a warp issues in order: a store waiting on its load would hold
  // back the loads after it). A lane past the end computes on zeros and
  // stores nothing.
  static_assert(K::inputs <= K::warps, "one input Fp per warp");
  constexpr int kThreads = K::warps * kLanes;
  constexpr int kPer = (K::words + kThreads - 1) / kThreads;
  const uint32_t e = blockIdx.x * kLanes + lane;
  const bool live = e < g.total;
  const uint32_t row = live ? e / g.n : 0, j = live ? e - row * g.n : 0;
  const uint32_t r1 = row / g.r0, r0 = row - r1 * g.r0;
  uint32_t x[lh::NL], pw[kPer];
  if (warp < K::inputs) {
    const bool second = warp >= 3 * K::comps;
    const Geom gm = second ? gb : ga;
    const int q = second ? warp - 3 * K::comps : warp;
    const uint32_t* src = (second ? b : a) + r1 * gm.s1 + r0 * gm.s0 + (q / K::comps) * gm.sc +
                          (q % K::comps) * gm.sk + j * gm.sn;
#pragma unroll
    for (int l = 0; l < lh::NL; ++l) x[l] = live ? src[l * gm.sl] : 0u;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    pw[k] = i < K::words ? K::plan()[i] : 0u;
  }
  if (warp < K::inputs) {
#pragma unroll
    for (int l = 0; l < lh::NL; ++l) slots[warp * kFpWords + l * kLanes] = x[l];
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < K::words) plan[i] = pw[k];
  }
  __syncthreads();

  // Two levels, one copy of their code: products, then reductions, level
  // 0's into the slots (every product has read the inputs by the barrier
  // between), level 1's into the output (rows, 3, comps, 12, n), Fp index
  // coordinate * comps + component.
  const uint32_t* rec = plan;
  const long long fp = lh::NL * (long long)g.n;
#pragma unroll 1
  for (int level = 0; level < 2; ++level) {
    const int np = level ? K::np1 : K::np0, nr = level ? K::nr1 : K::nr0;
    if (warp < np) product(rec + warp * kMulWords, slots, wide + warp * kWideWords);
    rec += np * kMulWords;
    __syncthreads();
    if (warp < nr && (live || level == 0)) {
      const uint32_t* r = rec + warp * kRedWords;
      uint32_t v[lh::NL];
      reduce(r, wide, v);
      const uint32_t dest = (r[0] >> 8) & 0xffu;
      uint32_t* dst = level ? out + row * (3 * K::comps * fp) + dest * fp + j
                            : slots + dest * kFpWords;
      const long long stride = level ? (long long)g.n : kLanes;
#pragma unroll
      for (int l = 0; l < lh::NL; ++l) dst[l * stride] = v[l];
    }
    rec += nr * kRedWords;
    __syncthreads();
  }
}

__global__ void empty_kernel() {}

template <class K>
constexpr int smem_bytes() {
  return 4 * ((K::words + 3) / 4 * 4 + K::slots * kFpWords + K::wide * kWideWords);
}

// Allows the kernel its dynamic shared memory on the current device, once.
template <class K>
int allow_smem() {
  static std::atomic<unsigned long long> done{0};   // a bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return 0;
  e = cudaFuncSetAttribute(curve_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes<K>());
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_acq_rel);
  return (int)e;
}

unsigned blocks(long long rows, long long n) {
  return (unsigned)((rows * n + kLanes - 1) / kLanes);
}

// geom: null for dense operands (each of the output's shape and contiguous),
// else r0 and then each operand's six element strides s1, s0 (the two row
// levels), sc (coordinate), sk (component), sl (limb) and sn (column).
template <class K>
int launch(void* out, const void* a, const void* b, long long rows, long long n,
           const long long* geom, void* stream) {
  constexpr bool kTwo = K::inputs == 6 * K::comps;
  const long long fp = lh::NL * n;
  const long long r0 = geom ? geom[0] : rows;
  const Geom dense{0, 3 * K::comps * fp, K::comps * fp, fp, n, 1};
  const Geom ga = geom ? Geom{geom[1], geom[2], geom[3], geom[4], geom[5], geom[6]} : dense;
  const Geom gb = geom && kTwo ? Geom{geom[7], geom[8], geom[9], geom[10], geom[11], geom[12]}
                               : ga;
  if (rows * n >= (1ll << 31) || r0 < 1 || rows % r0 != 0) return (int)cudaErrorInvalidValue;
  const int e = allow_smem<K>();
  if (e != 0) return e;
  curve_kernel<K><<<blocks(rows, n), K::warps * kLanes, smem_bytes<K>(), (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, ga, gb,
      Grid{(uint32_t)(rows * n), (uint32_t)n, (uint32_t)r0});
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lh_g1_add(void* out, const void* a, const void* b, long long rows, long long n,
                         const long long* geom, void* stream) {
  return launch<K5G1Add>(out, a, b, rows, n, geom, stream);
}

extern "C" int lh_g1_dbl(void* out, const void* a, long long rows, long long n,
                         const long long* geom, void* stream) {
  return launch<K5G1Double>(out, a, a, rows, n, geom, stream);
}

extern "C" int lh_g2_add(void* out, const void* a, const void* b, long long rows, long long n,
                         const long long* geom, void* stream) {
  return launch<K5G2Add>(out, a, b, rows, n, geom, stream);
}

extern "C" int lh_g2_dbl(void* out, const void* a, long long rows, long long n,
                         const long long* geom, void* stream) {
  return launch<K5G2Double>(out, a, a, rows, n, geom, stream);
}

// An empty kernel on G1 add's grid for (rows, n) (blocks of 32 points, 6
// warps): the launch floor K5 is timed against (chip_smoke.py floor_ms).
// Not a kernel of the port.
extern "C" int lh_curve_empty(void* out, long long rows, long long n, void* stream) {
  (void)out;
  empty_kernel<<<blocks(rows, n), K5G1Add::warps * kLanes, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
