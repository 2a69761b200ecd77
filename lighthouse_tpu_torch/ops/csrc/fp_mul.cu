// K1: Fp product a * b * 2^-384 mod p over (..., 12, n) Montgomery limbs.
//
// Replaces the Pallas pair squeeze_fwd + inv_out(with_offset=False)
// (lighthouse_tpu/ops/fused.py:279 _fwd_call and :319 _inv_call), which
// evaluate the product through a small-prime NTT/CRT on the MXU. Here one
// thread owns one element: a 12x12 schoolbook into 24 limbs and one
// Montgomery REDC. Bound: a, b < p gives T = a b < p^2, so REDC returns
// u < p^2 / 2^384 + p < 1.11 p and one conditional subtraction makes it
// canonical. Work per element: 288 32-bit multiply-adds (144 product, 144
// reduction) against 144 bytes read and written (96 for a square), so on an
// H100 (5 multiply-adds per byte at peak) the bound is the bytes.
#include "fp.cuh"

namespace {

template <bool SQR>
__global__ void fp_mul_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ a,
                              const uint32_t* __restrict__ b, long long rows, long long n) {
  const long long idx = lh::thread_index();
  if (idx >= rows * n) return;
  const long long r = idx / n;
  const long long base = r * lh::NL * n + (idx - r * n);
  uint32_t x[lh::NL], y[lh::NL], t[lh::NW];
  lh::load(x, a + base, n);
  if (SQR) {
    lh::mul_wide(x, x, t);
  } else {
    lh::load(y, b + base, n);
    lh::mul_wide(x, y, t);
  }
  lh::redc<1>(t, x);
  lh::store(out + base, x, n);
}

template <bool SQR>
int launch(void* out, const void* a, const void* b, long long rows, long long n, void* stream) {
  const long long total = rows * n;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  fp_mul_kernel<SQR><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, rows, n);
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
