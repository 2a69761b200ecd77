// K1: Fp product a * b * 2^-384 mod p, and square a^2 * 2^-384 mod p, over
// (..., 12, n) Montgomery limbs.
//
// Replaces the Pallas pair squeeze_fwd + inv_out(with_offset=False)
// (lighthouse_tpu/ops/fused.py:279 _fwd_call and :319 _inv_call), which
// evaluate the product through a small-prime NTT/CRT on the MXU.
//
// Design: one thread per element, a block of 32 elements (lane = element),
// so every limb row is one 128-byte line and (k, 12, 4096) operands spread
// over all 132 SMs (256-thread blocks left 36-100 of them idle). Work per
// element:
//   product  T = a b by operand scanning (lh::mul_wide), 144 multiply-adds;
//   square   the 66 products a_i a_j, j > i, once, by operand scanning (the
//            off-diagonal triangle O), then T = 2 O + sum a_i^2 2^(64 i) in
//            one carry pass with the 12 diagonal squares: 78 multiply-adds;
//   then     Montgomery REDC (12 rows of 12 multiply-adds, the quotient of
//            row i being t_i (-p^-1) mod 2^32), and u - p by a signed borrow
//            chain beside u, the canonical value chosen by its sign.
// p's limbs are immediates in the instructions (lh::p_limb, lh::redc_imm in
// fp.cuh, shared with K4 and K5): a __constant__
// array goes through the constant cache, which misses on a launch's first
// use. The element's row r = g / n is a multiply-high by a magic number
// (PyTorch's IntDivider, exact for g, n < 2^31), and limb l's offset l n is
// 32-bit (12 n < 2^32), so no load waits on another's address.
//
// Bounds (tests/test_torch_k1_plan.py replays the arithmetic and asserts
// each): every multiply-add x y + t + carry <= (2^32 - 1)^2 + 2 (2^32 - 1)
// < 2^64; the square's doubling pass adds 2 t + a 32-bit half of a_i^2 +
// its carry, below 2^34; a, b < p gives T < p^2 < p 2^384, so REDC's
// quotient stays below 2^384, its final carry is 0 and
// u = (T + m p) / 2^384 < p^2 / 2^384 + p < 1.11 p < 2p: one subtraction.
//
// Bound on an H100: 288 multiply-adds (square 222) per 144 bytes (square 96)
// against the card's 5 per byte: the bytes, 0.000176 ms at 4096 elements.
// At the main path's sizes a launch is its floor (an empty kernel on this
// grid, lh_fp_empty, about 1.1 us), the loads' latency and one thread's
// chain: at n = 1 about 850-900 of the 3,470 cycles a thread runs are its
// loads, 1,100 the product and 1,350 the reduction (clock64 stamps).
//
// Resources (ptxas, sm_90a, nvcc 12.9), no shared memory, 0 bytes of spills:
// product 82 registers, square 64.
//
// Measured (graph-replay us, NVIDIA H100 80GB HBM3, 700 W, every design
// built and timed in one call, each beside its own empty kernel; PERF.md),
// fp_mul at (12, 1) / (3, 2, 12, 65) / (4, 12, 4096) / (6, 12, 4096), then
// fp_sqr at (12, 1):
//   the kernel this replaces, 256 a block   2.83 / 3.89 / 4.07 / 4.28   2.98
//   blocks of 32                            2.96 / 3.00 / 3.34 / 4.14   2.99
//   + the 78-multiply-add square            2.96 / 3.00 / 3.36 / 4.13   2.69
//   + multiply-high row, 32-bit offsets     2.85 / 2.92 / 3.26 / 4.08   2.65
//   + p as immediates, u - p chosen: kept   2.65 / 2.77 / 3.13 / 3.91   2.53
//   four warps per element: a band of three rows each, a full-width
//   quotient m = T (-p^-1) mod 2^384, three barriers
//                                           2.61 / 3.17 / 4.38 / 5.19   2.55
// Four warps run level at n = 1 and 1.1-1.4x slower at every other shape
// (2.2x the instructions), so one design serves every size.
#include "fp.cuh"

namespace {

constexpr int kLanes = 32;   // elements per block

// t = a^2 (24 limbs): the triangle O = sum_{i < j} a_i a_j 2^(32 (i + j))
// by operand scanning, then T = 2 O + sum a_i^2 2^(64 i) in one pass.
__device__ __forceinline__ void sqr_wide(const uint32_t* a, uint32_t* t) {
#pragma unroll
  for (int c = 0; c < lh::NW; ++c) t[c] = 0;
#pragma unroll
  for (int i = 0; i < lh::NL - 1; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = i + 1; j < lh::NL; ++j) {
      c += (uint64_t)a[i] * a[j] + t[i + j];
      t[i + j] = (uint32_t)c;
      c >>= 32;
    }
    t[i + lh::NL] = (uint32_t)c;
  }
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < lh::NL; ++i) {
    const uint64_t d = (uint64_t)a[i] * a[i];
    c += ((uint64_t)t[2 * i] << 1) + (uint32_t)d;
    t[2 * i] = (uint32_t)c;
    c >>= 32;
    c += ((uint64_t)t[2 * i + 1] << 1) + (d >> 32);
    t[2 * i + 1] = (uint32_t)c;
    c >>= 32;
  }
}

// g / n as (multiply-high(g, magic) + g) >> shift: PyTorch's IntDivider,
// exact for g, n < 2^31.
struct Div {
  uint32_t magic, shift;
};

Div divider(long long n) {
  uint32_t shift = 0;
  while ((1ull << shift) < (unsigned long long)n) ++shift;
  const uint64_t magic = ((1ull << 32) * ((1ull << shift) - (uint64_t)n)) / (uint64_t)n + 1;
  return {(uint32_t)magic, shift};
}

__device__ __forceinline__ void load(uint32_t* x, const uint32_t* src, uint32_t n) {
#pragma unroll
  for (int l = 0; l < lh::NL; ++l) x[l] = src[(uint32_t)l * n];
}

__device__ __forceinline__ void store(uint32_t* dst, const uint32_t* x, uint32_t n) {
#pragma unroll
  for (int l = 0; l < lh::NL; ++l) dst[(uint32_t)l * n] = x[l];
}

template <bool SQR>
__global__ void __launch_bounds__(kLanes)
fp_mul_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ a,
              const uint32_t* __restrict__ b, uint32_t total, uint32_t n, Div d) {
  const uint32_t g = blockIdx.x * kLanes + threadIdx.x;
  if (g >= total) return;
  const uint32_t r = (__umulhi(g, d.magic) + g) >> d.shift;
  const long long base = (long long)r * (lh::NL * n) + (g - r * n);
  uint32_t x[lh::NL], y[lh::NL], t[lh::NW];
  load(x, a + base, n);
  if (SQR) {
    sqr_wide(x, t);
  } else {
    load(y, b + base, n);
    lh::mul_wide(x, y, t);
  }
  lh::redc_imm(t, x);
  store(out + base, x, n);
}

__global__ void empty_kernel() {}

unsigned blocks(long long rows, long long n) {
  return (unsigned)((rows * n + kLanes - 1) / kLanes);
}

template <bool SQR>
int launch(void* out, const void* a, const void* b, long long rows, long long n, void* stream) {
  if (rows * n >= (1ll << 31) || lh::NL * n >= (1ll << 32)) return (int)cudaErrorInvalidValue;
  fp_mul_kernel<SQR><<<blocks(rows, n), kLanes, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, (uint32_t)(rows * n), (uint32_t)n,
      divider(n));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lh_fp_mul(void* out, const void* a, const void* b, long long rows, long long n,
                         void* stream) {
  return launch<false>(out, a, b, rows, n, stream);
}

extern "C" int lh_fp_sqr(void* out, const void* a, long long rows, long long n, void* stream) {
  return launch<true>(out, a, a, rows, n, stream);
}

// An empty kernel on lh_fp_mul's grid for (rows, n): the launch floor K1
// is timed against (chip_smoke.py floor_ms). Not a kernel of the port.
extern "C" int lh_fp_empty(void* out, long long rows, long long n, void* stream) {
  (void)out;
  empty_kernel<<<blocks(rows, n), kLanes, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
