// K2: Fp2 product and square with lazy reduction over (..., 2, 12, n).
//
// Replaces the Pallas pair squeeze_fwd + inv_out(with_offset=True)
// (lighthouse_tpu/ops/fused.py:279 _fwd_call and :319 _inv_call), which
// reduce a signed sum of NTT-domain products once per output. Here:
//   T0 = p^2 + a0 b0 - a1 b1,   T1 = p^2 + a0 b1 + a1 b0
// as 24-limb integers, then one Montgomery REDC per output.
// Bound: inputs canonical in [0, p) (every port operation returns canonical
// values). Each accumulator holds the offset p^2 plus at most two products
// and minus at most one, so 0 <= T < 3 p^2 < 2^763 and REDC returns
// u < 3 p^2 / 2^384 + p < 1.31 p: one conditional subtraction. The offset
// p^2 is a multiple of p and covers the one subtracted product (< p^2).
// Work per element: 4 x 144 product + 2 x 144 reduction multiply-adds
// against 288 bytes (192 for a square): bound by the bytes on an H100.
#include "fp.cuh"

namespace {

template <bool SQR>
__global__ void fp2_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ a,
                           const uint32_t* __restrict__ b, long long rows, long long n) {
  const long long idx = lh::thread_index();
  if (idx >= rows * n) return;
  const long long r = idx / n;
  const long long base = r * 2 * lh::NL * n + (idx - r * n);
  const long long c1 = lh::NL * n;
  uint32_t x0[lh::NL], x1[lh::NL], y0[lh::NL], y1[lh::NL];
  lh::load(x0, a + base, n);
  lh::load(x1, a + base + c1, n);
  const uint32_t* b_ = SQR ? a : b;
  lh::load(y0, b_ + base, n);
  lh::load(y1, b_ + base + c1, n);
  uint32_t t0[lh::NW], t1[lh::NW];
  lh::set_wide(t0, lh::kP2);
  lh::set_wide(t1, lh::kP2);
  lh::fp2_acc(t0, t1, x0, x1, y0, y1, false);
  lh::redc<1>(t0, x0);
  lh::redc<1>(t1, x1);
  lh::store(out + base, x0, n);
  lh::store(out + base + c1, x1, n);
}

template <bool SQR>
int launch(void* out, const void* a, const void* b, long long rows, long long n, void* stream) {
  const long long total = rows * n;
  const int threads = 128;
  const long long blocks = (total + threads - 1) / threads;
  fp2_kernel<SQR><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, rows, n);
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
