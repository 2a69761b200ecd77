// K4: the Fp additive layer over (..., 12, n) Montgomery limbs, canonical in
// [0, p) in and out: a + b, a - b, -a and k a (1 <= k < 2^16) mod p.
//
// No Pallas kernel computes these: the JAX package adds loose digits
// (lighthouse_tpu/ops/bm/limbs.py:343-353 add / sub / neg) and XLA fuses
// the additions into each stage's program. The port keeps its limbs
// canonical, so each of these is a 384-bit carry chain; as torch ops it
// was about 47 kernels a call (a carry lookahead on packed bit vectors),
// here it is one.
//
// Design: one thread per element, a block of kBlock elements along the
// flat (row, column) index, so a warp's loads of one limb coalesce along
// the minor axis. Work per element, in 32-bit limbs with 64-bit carries:
//   add        s = a + b (below 2p < 2^382: no carry out of limb 11), then
//              s - p by a signed borrow chain beside s, and s kept iff
//              that chain borrowed;
//   sub        d = a - b by a signed borrow chain, then d + (p & borrow
//              mask) with the carry out of limb 11 dropped: a - b + p when
//              a < b;
//   neg        (p & nonzero mask) - a;
//   mul_small  left-to-right double-and-add over k's bits, each step an
//              add above, so every intermediate value stays in [0, p).
// p's limbs are immediates, as in K1; the chains are lh::add_mod, sub_mod
// and neg_mod (fp.cuh), which K5 (csrc/curve_op.cu) shares.
//
// Operands may be strided views and may broadcast: each input carries its
// element strides (Geom) over the output's rows, which the wrapper
// (ops/fused.py _geometry) folds into two levels r1 * r0; a broadcast axis
// has stride 0. Dense operands (most calls) pass no geometry at all: each
// argument a ctypes call converts costs the host about half a microsecond.
// The output is a fresh contiguous (rows, 12, n) tensor.
//
// Bound on an H100: add and sub move 96 + 48 bytes an element, neg and
// mul_small 48 + 48, and need no multiplies: bound by bytes, far below the
// launch floor (an empty kernel on this grid, lh_fp_add_empty) at every
// main-path shape. tests/test_torch_fp_add.py replays this file's limb
// algorithm in Python integers.
#include "fp.cuh"

namespace {

constexpr int kBlock = 128;   // elements per block

enum Op { kAdd, kSub, kNeg, kMulSmall };

// out = k a mod p for 1 <= k < 2^16, left to right over k's bits; out must
// not alias a.
__device__ __forceinline__ void mul_small_mod(const uint32_t* a, uint32_t k, uint32_t* out) {
#pragma unroll
  for (int j = 0; j < lh::NL; ++j) out[j] = a[j];
  for (int bit = 30 - __clz(k); bit >= 0; --bit) {
    lh::add_mod(out, out, out);
    if ((k >> bit) & 1u) lh::add_mod(out, a, out);
  }
}

// Element strides of one input over the output's (r1, r0, limb, column).
struct Geom {
  long long s1, s0, sl, sn;
};

struct Grid {
  uint32_t total, n, r0;
};

__device__ __forceinline__ const uint32_t* at(const uint32_t* base, const Geom& g, uint32_t r1,
                                              uint32_t r0, uint32_t j) {
  return base + r1 * g.s1 + r0 * g.s0 + j * g.sn;
}

template <int OP>
__global__ void __launch_bounds__(kBlock)
fp_add_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ a,
              const uint32_t* __restrict__ b, Geom ga, Geom gb, Grid g, uint32_t k) {
  const uint32_t e = blockIdx.x * kBlock + threadIdx.x;
  if (e >= g.total) return;
  const uint32_t row = e / g.n, j = e - row * g.n;
  const uint32_t r1 = row / g.r0, r0 = row - r1 * g.r0;
  uint32_t x[lh::NL], y[lh::NL], z[lh::NL];
  const uint32_t* pa = at(a, ga, r1, r0, j);
#pragma unroll
  for (int l = 0; l < lh::NL; ++l) x[l] = pa[l * ga.sl];
  if (OP == kAdd || OP == kSub) {
    const uint32_t* pb = at(b, gb, r1, r0, j);
#pragma unroll
    for (int l = 0; l < lh::NL; ++l) y[l] = pb[l * gb.sl];
  }
  if (OP == kAdd) lh::add_mod(x, y, z);
  if (OP == kSub) lh::sub_mod(x, y, z);
  if (OP == kNeg) lh::neg_mod(x, z);
  if (OP == kMulSmall) mul_small_mod(x, k, z);
  uint32_t* po = out + (long long)row * (lh::NL * (long long)g.n) + j;
#pragma unroll
  for (int l = 0; l < lh::NL; ++l) po[(long long)l * g.n] = z[l];
}

__global__ void empty_kernel() {}

unsigned blocks(long long rows, long long n) {
  return (unsigned)((rows * n + kBlock - 1) / kBlock);
}

// geom: null for dense operands (every input of the output's shape and
// contiguous), else r0 and then each input's four element strides s1, s0
// (the two row levels), sl (limb) and sn (column).
template <int OP>
int launch(void* out, const void* a, const void* b, long long rows, long long n,
           const long long* geom, long long k, void* stream) {
  const long long r0 = geom ? geom[0] : rows;
  const Geom dense{0, lh::NL * n, n, 1};
  const Geom ga = geom ? Geom{geom[1], geom[2], geom[3], geom[4]} : dense;
  const Geom gb = geom && (OP == kAdd || OP == kSub) ? Geom{geom[5], geom[6], geom[7], geom[8]}
                                                     : ga;
  if (rows * n >= (1ll << 31) || r0 < 1 || rows % r0 != 0) return (int)cudaErrorInvalidValue;
  if (OP == kMulSmall && (k < 1 || k >= (1 << 16))) return (int)cudaErrorInvalidValue;
  fp_add_kernel<OP><<<blocks(rows, n), kBlock, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, ga, gb,
      Grid{(uint32_t)(rows * n), (uint32_t)n, (uint32_t)r0}, (uint32_t)k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lh_fp_add(void* out, const void* a, const void* b, long long rows, long long n,
                         const long long* geom, void* stream) {
  return launch<kAdd>(out, a, b, rows, n, geom, 0, stream);
}

extern "C" int lh_fp_sub(void* out, const void* a, const void* b, long long rows, long long n,
                         const long long* geom, void* stream) {
  return launch<kSub>(out, a, b, rows, n, geom, 0, stream);
}

extern "C" int lh_fp_neg(void* out, const void* a, long long rows, long long n,
                         const long long* geom, void* stream) {
  return launch<kNeg>(out, a, a, rows, n, geom, 0, stream);
}

extern "C" int lh_fp_mul_small(void* out, const void* a, long long rows, long long n, long long k,
                               const long long* geom, void* stream) {
  return launch<kMulSmall>(out, a, a, rows, n, geom, k, stream);
}

// An empty kernel on K4's grid for (rows, n): the launch floor K4 is timed
// against (chip_smoke.py floor_ms). Not a kernel of the port.
extern "C" int lh_fp_add_empty(void* out, long long rows, long long n, void* stream) {
  (void)out;
  empty_kernel<<<blocks(rows, n), kBlock, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
