// K3: one whole Fp12 square, product, or product with a sparse Miller line,
// per element, over (..., 2, 3, 2, 12, n) Montgomery limbs.
//
// Replaces the Pallas whole-op kernels fp12_op("sqr" | "mul" | "line")
// (lighthouse_tpu/ops/fused.py:578 _k3_fp12_call; sqr_kernel :586,
// mul_kernel :598, line_kernel :610).
//
// Fp12 = Fp6[w]/(w^2 - v), Fp6 = Fp2[v]/(v^3 - xi): coordinate (h, k) of the
// (2, 3) Fp2 grid is the coefficient of w^(2k + h), and w^6 = xi. The
// product is the schoolbook of ops/bm/tower.py (two Fp6 halves, each an Fp6
// schoolbook, the v-shift folding t1 into c0) written in that w basis:
//   c_e = sum_{i + j = e} a_i b_j + xi * sum_{i + j = e + 6} a_i b_j,
// 36 Fp2 products for sqr and mul. The line l0 + l1 w^3 + l2 w^5 is b with
// only b_0 = l0, b_3 = l1, b_5 = l2: the 18 products of fused.py:610-635.
//
// Lazy reduction: each of the 12 output Fp coordinates is one 24-limb
// accumulator T = 16 p^2 + (added products) - (subtracted products), reduced
// once. Per accumulator at most 17 products are added and 16 subtracted
// (counted and asserted by the plain version, ops/fused.py), so with
// canonical inputs 0 <= T < 33 p^2 < 2^767 and REDC returns u < 4.36 p:
// four conditional subtractions.
//
// Register pressure: one thread per element, operands are NOT held in
// registers (one Fp12 is 144 words). Each Fp2 term loads its two operand
// coordinates from global memory (L1/L2-resident after the first touch) and
// only the two accumulators, one product and the four operand Fp values
// live in registers (about 120 words).
#include "fp.cuh"

namespace {

constexpr int SQR = 0, MUL = 1, LINE = 2;

// Offset of w-coefficient e's Fp2 in the (2, 3, 2, 12, n) layout.
__device__ __forceinline__ long long coord(int e, long long n) {
  const int h = e & 1, k = e >> 1;
  return (long long)(h * 3 + k) * 2 * lh::NL * n;
}

template <int KIND>
__global__ void fp12_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ a,
                            const uint32_t* __restrict__ b, long long rows, long long n) {
  const long long idx = lh::thread_index();
  if (idx >= rows * n) return;
  const long long r = idx / n;
  const long long lane = idx - r * n;
  const long long base = r * 12 * lh::NL * n + lane;
  const long long lbase = r * 6 * lh::NL * n + lane;   // line (3, 2, 12, n)
  const long long c1 = lh::NL * n;
  const uint32_t* b_ = KIND == SQR ? a : b;
#pragma unroll 1
  for (int e = 0; e < 6; ++e) {
    uint32_t t0[lh::NW], t1[lh::NW];
    lh::set_wide(t0, lh::kP2x16);
    lh::set_wide(t1, lh::kP2x16);
#pragma unroll 1
    for (int i = 0; i < 6; ++i) {
      int j = e - i;
      const bool xi = j < 0;
      if (xi) j += 6;
      const uint32_t* yp;
      if (KIND == LINE) {
        if (j != 0 && j != 3 && j != 5) continue;
        yp = b_ + lbase + (long long)(j == 0 ? 0 : (j == 3 ? 1 : 2)) * 2 * c1;
      } else {
        yp = b_ + base + coord(j, n);
      }
      const uint32_t* xp = a + base + coord(i, n);
      uint32_t x0[lh::NL], x1[lh::NL], y0[lh::NL], y1[lh::NL];
      lh::load(x0, xp, n);
      lh::load(x1, xp + c1, n);
      lh::load(y0, yp, n);
      lh::load(y1, yp + c1, n);
      lh::fp2_acc(t0, t1, x0, x1, y0, y1, xi);
    }
    uint32_t o[lh::NL];
    lh::redc<4>(t0, o);
    lh::store(out + base + coord(e, n), o, n);
    lh::redc<4>(t1, o);
    lh::store(out + base + coord(e, n) + c1, o, n);
  }
}

template <int KIND>
int launch(void* out, const void* a, const void* b, long long rows, long long n, void* stream) {
  const long long total = rows * n;
  const int threads = 128;
  const long long blocks = (total + threads - 1) / threads;
  fp12_kernel<KIND><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, rows, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lh_fp12_sqr(void* out, const void* a, long long rows, long long n, void* stream) {
  return launch<SQR>(out, a, a, rows, n, stream);
}

extern "C" int lh_fp12_mul(void* out, const void* a, const void* b, long long rows, long long n,
                           void* stream) {
  return launch<MUL>(out, a, b, rows, n, stream);
}

extern "C" int lh_fp12_line(void* out, const void* a, const void* line, long long rows,
                            long long n, void* stream) {
  return launch<LINE>(out, a, line, rows, n, stream);
}
