// K2: Fp2 product and square over (..., 2, 12, n) Montgomery limbs.
//
// Replaces the Pallas pair squeeze_fwd + inv_out(with_offset=True)
// (lighthouse_tpu/ops/fused.py:279 _fwd_call and :319 _inv_call), which
// reduce a signed sum of NTT-domain products once per output
// (ops/bm/tower.py fp2_mul / fp2_sqr through ops/limbs.py).
//
// The work the function needs (Karatsuba), inputs canonical in [0, p):
//   product  T0 = p^2 + a0 b0 - a1 b1                 in (0, 2 p^2)
//            T1 = (a0 + a1)(b0 + b1) - a0 b0 - a1 b1  in [0, 2 p^2)
//            three Fp products; the offset p^2 (a multiple of p) keeps T0
//            non-negative, and T1 = a0 b1 + a1 b0 exactly;
//   square   T0 = (a0 + a1)(a0 - a1 + p)              in [0, 4 p^2)
//            T1 = 2 a0 a1                             in [0, 2 p^2)
//            two Fp products; a0 - a1 + p >= 1 (least at a0 = 0,
//            a1 = p - 1), and every sum is below 2p < 2^382: 12 limbs.
// Then one Montgomery REDC per output: T < 4 p^2 < p 2^384 gives
// U = (T + m p) / 2^384 < 4 p^2 / 2^384 + p < 1.41 p, one conditional
// subtraction (lh::redc<1>). The outputs are canonical, so they equal
// the plain versions' bit for bit, though the plain table (ops/fused.py
// _K2_TABLE) sums the four schoolbook products.
//
// Design: one thread per Fp product, then one thread per output. A block
// owns 32 elements, lane = element, so every load and store of a limb row
// is one 128-byte line. Warp k (k < 3; square k < 2) loads its operands
// straight from global memory, forms the sums it needs (one 12-limb
// carry chain) and runs one 12 x 12 product (lh::mul_wide) into shared
// memory. After one barrier, warps 0 and 1 sum output 0's and output 1's
// columns in one signed carry pass, reduce (lh::redc<1>) and store. The
// thread-per-element design this replaces ran four products and both
// reductions on one thread, 864 multiply-adds in series; here the path is
// one product (144), one carry pass and one reduction (144), and the
// products and the two reductions of an element run on different warps.
// It does the 720 multiply-adds the product needs (square 576), where
// that design did 864, and uses 56 registers where it used 120-152, so
// 24,576 elements fill each SM with about 17 warps instead of 6.
//
// A warp per element was tried first (lane c summing column c of each
// Karatsuba product, the carries and a full-width Montgomery reduction
// resolved across the lanes by shuffles and ballots): slower at every
// size, 0.0035-0.0041 ms at n = 64 and 0.037-0.046 ms at 24,576 elements,
// where most lanes of each column product idle and each carry resolution
// costs tens of instructions per element (PERF.md, Findings).
//
// Bound on an H100 (chip_smoke.py WORK): 720 multiply-adds per 288 bytes
// (square 576 per 192), under the card's 5 per byte: the bytes. At the
// main path's 64-1024 elements a launch is bound by its critical path and
// the launch itself (chip_smoke.py floor_ms).
//
// Resources (ptxas, sm_90a, nvcc 12.9), 0 bytes of spills in both:
//   product  56 registers, 9,216 B static shared (3 x 24 limbs x 32 lanes)
//   square   56 registers, 6,144 B static shared
#include "fp.cuh"

namespace {

constexpr int kLanes = 32;   // elements per block

template <bool SQR>
__global__ void __launch_bounds__(96)
fp2_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ a,
           const uint32_t* __restrict__ b, long long total, long long n) {
  constexpr int NP = SQR ? 2 : 3;   // Fp products, one warp each
  __shared__ uint32_t prod[NP][lh::NW][kLanes];
  const int k = threadIdx.x >> 5, e = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * kLanes + e;
  const bool live = g < total;
  long long base = 0;
  if (live) {
    const long long r = g / n;
    base = r * 2 * lh::NL * n + (g - r * n);
  }
  const long long c1 = lh::NL * n;
  uint32_t x[lh::NL], y[lh::NL], t[lh::NW];
  if (live) {
    // Product k multiplies (a0, b0), (a1, b1), (a0 + a1, b0 + b1); the
    // square's (a0 + a1, a0 - a1 + p), (a0, a1).
    const bool sums = SQR ? k == 0 : k == 2;
    lh::load(x, a + base + (!SQR && k == 1 ? c1 : 0), n);
    lh::load(y, (SQR ? a : b) + base + (SQR || k == 1 ? c1 : 0), n);
    if (sums) {
      uint32_t x1[lh::NL], y1[lh::NL];
      if (!SQR) {
        lh::load(x1, a + base + c1, n);
        lh::load(y1, b + base + c1, n);
      }
      long long cx = 0, cy = 0;   // signed carries, arithmetic shifts
#pragma unroll
      for (int l = 0; l < lh::NL; ++l) {
        cx += (long long)x[l] + (SQR ? y[l] : x1[l]);
        cy += SQR ? (long long)x[l] - y[l] + lh::kP[l] : (long long)y[l] + y1[l];
        x[l] = (uint32_t)cx;
        y[l] = (uint32_t)cy;
        cx >>= 32;
        cy >>= 32;
      }
    }
    lh::mul_wide(x, y, t);
  } else {
#pragma unroll
    for (int c = 0; c < lh::NW; ++c) t[c] = 0;
  }
#pragma unroll
  for (int c = 0; c < lh::NW; ++c) prod[k][c][e] = t[c];
  __syncthreads();
  if (k >= 2 || !live) return;

  // Output k: the product's T0 = p^2 + P0 - P1, T1 = P2 - P0 - P1; the
  // square's T0 = X0, T1 = 2 X1. |column| < 2^34; the carry is the floor.
  long long c = 0;
#pragma unroll
  for (int col = 0; col < lh::NW; ++col) {
    long long v;
    if (SQR) {
      v = k == 0 ? (long long)prod[0][col][e] : 2 * (long long)prod[1][col][e];
    } else {
      const long long p0 = prod[0][col][e], p1 = prod[1][col][e];
      v = k == 0 ? (long long)lh::kP2[col] + p0 - p1 : (long long)prod[2][col][e] - p0 - p1;
    }
    c += v;
    t[col] = (uint32_t)c;
    c >>= 32;
  }
  lh::redc<1>(t, x);
  lh::store(out + base + k * c1, x, n);
}

__global__ void empty_kernel() {}

unsigned blocks(long long rows, long long n) {
  return (unsigned)((rows * n + kLanes - 1) / kLanes);
}

template <bool SQR>
int launch(void* out, const void* a, const void* b, long long rows, long long n, void* stream) {
  fp2_kernel<SQR><<<blocks(rows, n), SQR ? 64 : 96, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, rows * n, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lh_fp2_mul(void* out, const void* a, const void* b, long long rows, long long n,
                          void* stream) {
  return launch<false>(out, a, b, rows, n, stream);
}

extern "C" int lh_fp2_sqr(void* out, const void* a, long long rows, long long n, void* stream) {
  return launch<true>(out, a, a, rows, n, stream);
}

// An empty kernel on lh_fp2_mul's grid for (rows, n): the launch floor K2
// is timed against (chip_smoke.py floor_ms). Not a kernel of the port.
extern "C" int lh_fp2_empty(void* out, long long rows, long long n, void* stream) {
  (void)out;
  empty_kernel<<<blocks(rows, n), 96, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
