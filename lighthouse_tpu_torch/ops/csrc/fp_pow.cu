// K7: a public-exponent power a^e, one launch a call, over Montgomery limbs
// canonical in [0, p), in two modes:
//   fp_pow   Fp  (..., 12, n)      limbs.pow_fixed, and so limbs.inv (e = p - 2)
//   fp2_pow  Fp2 (..., 2, 12, n)   tower.fp2_pow_fixed (fp2_sqrt_ratio's
//                                  e = (p^2 - 9) / 16, 758 bits)
//
// No Pallas kernel computes these: the JAX package runs each power as one
// lax.scan whose body (four squares and a table product) XLA fuses
// (lighthouse_tpu/ops/bm/limbs.py:433 pow_fixed, scan at :462;
// ops/bm/tower.py:165 fp2_pow_fixed, scan at :193). The port ran them as a
// Python loop of one K1 or K2 launch a square and a product: 485 launches
// for the Fp inverse, 946 for the Fp2 power.
//
// What one call computes, per element, a 4-bit fixed window as ops/fused.py
// pow_loop (the plain version): the table a^0 ... a^15 (14 products, a^2
// as a product), then from the most significant digit d_0, acc = a^d_0 and
// per further digit four squares and, where d != 0, one product by a^d.
// Fp2 first splits the exponent at p: e = A p + B with B < p, and since
// a^p = conj(a) for every a in Fp2 (the Frobenius map), a^e = conj(a)^A a^B,
// one chain of squares for both (Straus): a window squares four times and
// multiplies by a^dB and by conj(a^dA), the table's entry conjugated. For
// (p^2 - 9) / 16 that is 96 windows, 380 squares and 194 products (14 of
// them the table's), where the plain 758-bit chain runs 757 squares and
// 189 products. The digits come from a device buffer
// the wrapper builds once per exponent and device (ops/fused.py
// pow_digits, fp2_pow_digits: a byte a window, B's digit in the low
// nibble, A's in the high one; a captured graph reads the buffer at
// replay); the digits are the same for every element, so every branch on
// them is uniform. An exponent below 16 takes the same table (the plain
// loop's shorter chain gives the same canonical value), and below p the
// same chain as the plain loop's.
//
// Design: the value's chain is latency (485 and 574 dependent products a
// call at the paths' 1-256 elements), so each element's chain runs on one
// lane (Fp) or one pair of lanes (Fp2), the accumulator in registers and
// the table in shared memory, each product as K5's one-lane product (the
// PTX carry chains of fp.cuh: lh::rows, then lh::redc_lane). A block is one
// warp: 32 Fp elements or 16 Fp2 elements.
//   Fp     square and product are one 12 x 12 product and one REDC.
//   Fp2    lane r of a pair computes component r: the square as K2's,
//          lane 0 (a0 + a1)(a0 + (p - a1)), lane 1 (a0 + a0) a1, one
//          product each; the product by b schoolbook, lane 0
//          a0 b0 + (p - a1) b1, lane 1 a0 b1 + a1 b0 (by a conjugate
//          a0 b0 + a1 b1 and (p - a0) b1 + a1 b0), two products each
//          summed into one 24-limb T; then one REDC each, and the pair
//          swaps its components by 12 shuffles. Each lane forms its
//          operands by selects on r, so neither lane waits on the other's
//          branch. A pair's two lanes read the two components of a table
//          entry at once: a pad limb per component puts them on different
//          banks.
// Bounds: every operand sum is below 2p < 2^382 (12 limbs) and every T is
// below 4 p^2 < p 2^384 (2^384 / p > 9.8): the square's lane 0 below
// 2p 2p, every other T below 2 p^2. So REDC's quotient stays below 2^384,
// its final carry is 0, and u = (T + m p) / 2^384 < 2p: one subtraction to
// canonical (lh::canonical). Every output is canonical, so it equals the
// plain version's bit for bit. tests/test_torch_fp_pow.py replays this
// arithmetic in Python integers and asserts each bound.
//
// Bound on an H100 (chip_smoke.py pow_work): the exponent's products and
// squares, 288 and 222 multiply-adds each in Fp (Fp2 three and two Fp
// products and two reductions), against 96 (Fp2 192) bytes an element:
// bound by operations, far below a microsecond at the paths' sizes, where a
// call is one chain: about 485 Fp products in series for the inverse.
//
// Resources (ptxas, sm_90a, nvcc 12.9), 0 bytes of spills: Fp 66
// registers and 24,576 B of static shared memory (the table, 32
// elements), Fp2 110 registers and 26,624 B (16 elements, padded).
//
// Measured (graph-replay ms, NVIDIA H100 80GB HBM3, 700 W, both designs
// in one call; PERF.md): fp_pow at (12, 1), e = p - 2: 0.577
// (1.19 us a product in series); fp2_pow at (2, 2, 12, 64), e =
// (p^2 - 9) / 16: the plain 758-bit chain 1.764, split at p 1.190, and
// 1.185-1.208 at every path shape (m = 1 to 256, and 4096 elements): a
// call is one chain, so its width does not show until the card is full.
#include "fp.cuh"

namespace {

constexpr int kEntries = 16;                 // the 4-bit window's table
constexpr int kFpElems = 32;                 // Fp: a lane an element, a warp a block
constexpr int kFp2Elems = 16;                // Fp2: a pair of lanes an element
constexpr int kFp2Comp = 13 * kFp2Elems;     // words from component 0 to 1 (a pad limb)
constexpr int kFp2Entry = 2 * kFp2Comp;      // words an Fp2 table entry

// Limb j of R = 2^384 mod p, the Montgomery form of 1.
__host__ __device__ constexpr uint32_t one_limb(int j) {
  return j == 0 ? 0x0002fffdu
       : j == 1 ? 0x76090000u
       : j == 2 ? 0xc40c0002u
       : j == 3 ? 0xebf4000bu
       : j == 4 ? 0x53c758bau
       : j == 5 ? 0x5f489857u
       : j == 6 ? 0x70525745u
       : j == 7 ? 0x77ce5853u
       : j == 8 ? 0xa256ec6du
       : j == 9 ? 0x5c071a97u
       : j == 10 ? 0xfa80e493u
       : 0x15f65ec3u;
}

// out = a b 2^-384 mod p, canonical, for a b < p 2^384; out may alias a or b.
__device__ __forceinline__ void mont_mul(const uint32_t* a, const uint32_t* b, uint32_t* out) {
  uint32_t t[lh::NW + 1];
  lh::rows<lh::NL>(a, b, t);
  lh::redc_lane(t, out);
}

// --- Fp: a lane an element ---------------------------------------------------

__global__ void __launch_bounds__(kFpElems)
fp_pow_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ a,
              const uint8_t* __restrict__ digits, int n_digits, long long total, long long n) {
  __shared__ uint32_t table[kEntries][lh::NL][kFpElems];
  const int e = threadIdx.x;
  const long long g = (long long)blockIdx.x * kFpElems + e;
  if (g >= total) return;
  const long long r = g / n;
  const long long base = r * lh::NL * n + (g - r * n);
  uint32_t x[lh::NL], acc[lh::NL];
  lh::load(x, a + base, n);
#pragma unroll
  for (int l = 0; l < lh::NL; ++l) {
    table[0][l][e] = one_limb(l);
    table[1][l][e] = acc[l] = x[l];
  }
#pragma unroll 1
  for (int k = 2; k < kEntries; ++k) {
    mont_mul(acc, x, acc);
#pragma unroll
    for (int l = 0; l < lh::NL; ++l) table[k][l][e] = acc[l];
  }
  const int d0 = __ldg(digits);
#pragma unroll
  for (int l = 0; l < lh::NL; ++l) acc[l] = table[d0][l][e];
#pragma unroll 1
  for (int w = 1; w < n_digits; ++w) {
    const int d = __ldg(digits + w);
    // Steps 0-3 square, step 4 multiplies by a^d (none for d = 0).
#pragma unroll 1
    for (int s = 0; s < 5; ++s) {
      uint32_t b[lh::NL];
      if (s == 4 && d == 0) break;
#pragma unroll
      for (int l = 0; l < lh::NL; ++l) b[l] = s < 4 ? acc[l] : table[d][l][e];
      mont_mul(acc, b, acc);
    }
  }
  lh::store(out + base, acc, n);
}

// --- Fp2: a pair of lanes an element -------------------------------------------

// The pair's components after lane r computed c = component r.
__device__ __forceinline__ void swap_in(const uint32_t* c, int r, uint32_t* a0, uint32_t* a1) {
#pragma unroll
  for (int l = 0; l < lh::NL; ++l) {
    const uint32_t o = __shfl_xor_sync(0xffffffffu, c[l], 1);
    a0[l] = r ? o : c[l];
    a1[l] = r ? c[l] : o;
  }
}

// out = p - a for a <= p.
__device__ __forceinline__ void p_minus(const uint32_t* a, uint32_t* out) {
  long long br = 0;
#pragma unroll
  for (int j = 0; j < lh::NL; ++j) {
    br += (long long)lh::p_limb(j) - a[j];
    out[j] = (uint32_t)br;
    br >>= 32;
  }
}

// out = a + b, unreduced (a + b < 2^384).
__device__ __forceinline__ void add_raw(const uint32_t* a, const uint32_t* b, uint32_t* out) {
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < lh::NL; ++j) {
    c += (uint64_t)a[j] + b[j];
    out[j] = (uint32_t)c;
    c >>= 32;
  }
}

// (a0, a1) = (a0, a1)^2: lane 0 T = (a0 + a1)(a0 + (p - a1)) < 4 p^2,
// lane 1 T = (a0 + a0) a1 < 2 p^2.
__device__ __forceinline__ void fp2_sqr_pair(uint32_t* a0, uint32_t* a1, int r) {
  uint32_t x[lh::NL], y[lh::NL], c[lh::NL];
  p_minus(a1, y);
  add_raw(a0, y, y);
#pragma unroll
  for (int l = 0; l < lh::NL; ++l) {
    c[l] = r ? a0[l] : a1[l];
    y[l] = r ? a1[l] : y[l];
  }
  add_raw(a0, c, x);
  mont_mul(x, y, c);
  swap_in(c, r, a0, a1);
}

// (a0, a1) = (a0, a1) b, b = (b0, b1) or, with conj, its conjugate
// (b0, -b1); b's component r at own, the other at other (limb stride
// kFp2Elems). T = x1 own + x2 other, each below 2 p^2:
//            lane 0                     lane 1
//   b        a0 b0 + (p - a1) b1        a0 b1 + a1 b0
//   conj b   a0 b0 + a1 b1              (p - a0) b1 + a1 b0
__device__ __forceinline__ void fp2_mul_pair(uint32_t* a0, uint32_t* a1, const uint32_t* own,
                                             const uint32_t* other, int r, bool conj) {
  uint32_t x[lh::NL], y[lh::NL], z[lh::NL], t[lh::NW + 1], u[lh::NW + 1];
#pragma unroll
  for (int l = 0; l < lh::NL; ++l) {
    z[l] = r ? a0[l] : a1[l];
    y[l] = own[l * kFp2Elems];
  }
  p_minus(z, z);
#pragma unroll
  for (int l = 0; l < lh::NL; ++l) x[l] = conj && r ? z[l] : a0[l];
  lh::rows<lh::NL>(x, y, t);
#pragma unroll
  for (int l = 0; l < lh::NL; ++l) {
    x[l] = r || conj ? a1[l] : z[l];
    y[l] = other[l * kFp2Elems];
  }
  lh::rows<lh::NL>(x, y, u);
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < lh::NW; ++j) {
    c += (uint64_t)t[j] + u[j];
    t[j] = (uint32_t)c;
    c >>= 32;
  }
  lh::redc_lane(t, x);
  swap_in(x, r, a0, a1);
}

__global__ void __launch_bounds__(2 * kFp2Elems)
fp2_pow_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ a,
               const uint8_t* __restrict__ digits, int n_digits, long long total, long long n) {
  __shared__ uint32_t table[kEntries * kFp2Entry];
  const int e = threadIdx.x >> 1, r = threadIdx.x & 1;
  const long long g0 = (long long)blockIdx.x * kFp2Elems + e;
  // A lane past the end runs the last element's chain and stores nothing:
  // the pair's shuffles need every lane of the warp.
  const long long g = g0 < total ? g0 : total - 1;
  const long long row = g / n;
  const long long base = row * 2 * lh::NL * n + (g - row * n);
  uint32_t* own = table + r * kFp2Comp + e;
  const uint32_t* other = table + (1 - r) * kFp2Comp + e;
  uint32_t a0[lh::NL], a1[lh::NL];
  lh::load(a0, a + base, n);
  lh::load(a1, a + base + lh::NL * n, n);
#pragma unroll
  for (int l = 0; l < lh::NL; ++l) {
    own[l * kFp2Elems] = r ? 0u : one_limb(l);
    own[kFp2Entry + l * kFp2Elems] = r ? a1[l] : a0[l];
  }
  __syncwarp();
#pragma unroll 1
  for (int k = 2; k < kEntries; ++k) {
    fp2_mul_pair(a0, a1, own + kFp2Entry, other + kFp2Entry, r, false);
#pragma unroll
    for (int l = 0; l < lh::NL; ++l) own[k * kFp2Entry + l * kFp2Elems] = r ? a1[l] : a0[l];
  }
  __syncwarp();
  // Window w's byte holds B's digit (low nibble) and A's (high): acc =
  // acc^16 a^dB conj(a)^dA, conj(a)^k = conj(a^k) being table entry k
  // conjugated. The first window loads a^dB.
  const int b0 = __ldg(digits) & 15;
#pragma unroll
  for (int l = 0; l < lh::NL; ++l) {
    a0[l] = table[b0 * kFp2Entry + l * kFp2Elems + e];
    a1[l] = table[b0 * kFp2Entry + kFp2Comp + l * kFp2Elems + e];
  }
#pragma unroll 1
  for (int w = 0; w < n_digits; ++w) {
    const int d = __ldg(digits + w);
    if (w > 0) {
#pragma unroll 1
      for (int s = 0; s < 4; ++s) fp2_sqr_pair(a0, a1, r);
    }
#pragma unroll 1
    for (int h = w > 0 ? 0 : 1; h < 2; ++h) {
      const int k = h ? d >> 4 : d & 15;
      if (k != 0) fp2_mul_pair(a0, a1, own + k * kFp2Entry, other + k * kFp2Entry, r, h);
    }
  }
  if (g0 < total) {
    uint32_t c[lh::NL];
#pragma unroll
    for (int l = 0; l < lh::NL; ++l) c[l] = r ? a1[l] : a0[l];
    lh::store(out + base + r * lh::NL * n, c, n);
  }
}

__global__ void empty_kernel() {}

unsigned blocks(long long rows, long long n, int per_block) {
  return (unsigned)((rows * n + per_block - 1) / per_block);
}

template <bool FP2>
int launch(void* out, const void* a, const void* digits, long long n_digits, long long rows,
           long long n, void* stream) {
  if (n_digits < 1 || n_digits > (1 << 20) || rows < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const int per_block = FP2 ? kFp2Elems : kFpElems;
  auto kernel = FP2 ? fp2_pow_kernel : fp_pow_kernel;
  kernel<<<blocks(rows, n, per_block), FP2 ? 2 * kFp2Elems : kFpElems, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)a, (const uint8_t*)digits, (int)n_digits, rows * n, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lh_fp_pow(void* out, const void* a, const void* digits, long long n_digits,
                         long long rows, long long n, void* stream) {
  return launch<false>(out, a, digits, n_digits, rows, n, stream);
}

extern "C" int lh_fp2_pow(void* out, const void* a, const void* digits, long long n_digits,
                          long long rows, long long n, void* stream) {
  return launch<true>(out, a, digits, n_digits, rows, n, stream);
}

// Empty kernels on lh_fp_pow's and lh_fp2_pow's grids for (rows, n): the
// launch floors K7 is timed against (chip_smoke.py floor_ms). Not kernels
// of the port.
extern "C" int lh_fp_pow_empty(void* out, long long rows, long long n, void* stream) {
  (void)out;
  empty_kernel<<<blocks(rows, n, kFpElems), kFpElems, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" int lh_fp2_pow_empty(void* out, long long rows, long long n, void* stream) {
  (void)out;
  empty_kernel<<<blocks(rows, n, kFp2Elems), 2 * kFp2Elems, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
