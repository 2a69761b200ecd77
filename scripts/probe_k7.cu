// Microbenchmarks of K7's steps (run by scripts/probe_k7.py; not built by
// the port), each a loop of one dependent step timed with clock64 on block
// 0's lane 0, in a grid of h2g2's 2 x 64 Fp2 elements (m = 64), so that each
// warp runs alone on its SM:
//   lanes4_* the Fp2 power's step as ops/csrc/fp_pow.cu runs it (four lanes
//            an element): the square, the product, the product's part sum (12
//            shuffles and an add mod p) and the square's operands (12
//            shuffles, PTX sums, selects);
//   fp_mul   one lane's Fp Montgomery product (lh::rows + lh::redc_lane);
//   gcd_*    the inverse's parts: a batch of 30 divsteps, update_fg,
//            update_de, and the whole inverse (inv_lane).
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "fp_pow.cu"

namespace {

enum Op {
  LANES4_SQR, LANES4_MUL, LANES4_PART_SUM, LANES4_SQR_OPERANDS,
  FP_MUL, GCD_DIVSTEPS, GCD_UPDATE_FG, GCD_UPDATE_DE, GCD_INV, N_OPS
};
const char* kNames[N_OPS] = {
    "lanes4_sqr", "lanes4_mul", "lanes4_part_sum", "lanes4_sqr_operands",
    "fp_mul", "gcd_divsteps_batch", "gcd_update_fg", "gcd_update_de", "gcd_inverse"};

// x, y: canonical operands from `data` (limb l of lane t at l * n + t).
template <int OP>
__global__ void __launch_bounds__(32) probe(uint32_t* data, int iters, long long* cyc) {
  __shared__ uint32_t table[kEntries * kFp2Entry];
  const int lane = threadIdx.x, t = blockIdx.x * 32 + lane, n = gridDim.x * 32;
  uint32_t x[lh::NL], y[lh::NL];
#pragma unroll
  for (int l = 0; l < lh::NL; ++l) {
    x[l] = data[l * n + t];
    y[l] = data[(lh::NL + l) * n + t];
  }
  for (int w = lane; w < kEntries * kFp2Entry; w += 32) table[w] = data[(w % 24) * n + t] >> 3;
  __syncwarp();
  const int k = lane & 3;
  int32_t f[kL30], g[kL30];
#pragma unroll
  for (int i = 0; i < kL30; ++i) {
    f[i] = i < lh::NL ? (int32_t)(x[i] & kM30) : 0;
    g[i] = i < lh::NL ? (int32_t)(y[i] & kM30) : 0;
  }
  Trans tr = {1 << 30, 0, 0, 1 << 30};   // (f, g) and (d, e) stay as they are
  int delta = 1, layout = 0;
  long long c0 = clock64();
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    if (OP == LANES4_SQR) {
      fp2_sqr_lanes(x, k, layout);
    } else if (OP == LANES4_MUL) {
      fp2_mul_lanes(x, table + kFp2Entry + lane / kFp2Lanes, k, layout, false);
    } else if (OP == LANES4_PART_SUM) {
      uint32_t o[lh::NL], d[lh::NL];
#pragma unroll
      for (int l = 0; l < lh::NL; ++l) o[l] = __shfl_xor_sync(0xffffffffu, x[l], layout ? 1 : 3);
      add_to(x, o);
      const uint32_t lt = sub_p(x, d);
#pragma unroll
      for (int l = 0; l < lh::NL; ++l) x[l] = lt ? x[l] : d[l];
      layout ^= 1;
    } else if (OP == LANES4_SQR_OPERANDS) {
      const int h = held(k, layout);
      uint32_t o[lh::NL], u[lh::NL];
#pragma unroll
      for (int l = 0; l < lh::NL; ++l) {
        o[l] = __shfl_xor_sync(0xffffffffu, x[l], 2);
        u[l] = h ? x[l] : o[l];
        y[l] = ~o[l];
      }
      add_to(u, x);
      add_p1_to(y);
      add_to(y, x);
#pragma unroll
      for (int l = 0; l < lh::NL; ++l) x[l] = (h ? o[l] : y[l]) ^ u[l];
    } else if (OP == FP_MUL) {
      mont_mul(x, y, x);
    } else if (OP == GCD_DIVSTEPS) {
      Trans s;
      delta = divsteps(delta, (uint32_t)f[0], (uint32_t)g[0], s);
      f[0] ^= s.u;
      g[0] ^= s.v | 1;
    } else if (OP == GCD_UPDATE_FG) {
      update_fg(f, g, tr);
    } else if (OP == GCD_UPDATE_DE) {
      update_de(f, g, tr);
    } else if (OP == GCD_INV) {
      inv_lane(x);
    }
  }
  long long c1 = clock64();
#pragma unroll
  for (int l = 0; l < lh::NL; ++l) data[(2 * lh::NL + l) * n + t] = x[l] ^ y[l] ^ f[l] ^ g[l] ^ delta;
  if (lane == 0) cyc[blockIdx.x] = c1 - c0;
}

template <int OP>
double run(uint32_t* d, long long* cyc, int blocks, int iters) {
  probe<OP><<<blocks, 32>>>(d, 2, cyc);                  // warm-up
  probe<OP><<<blocks, 32>>>(d, iters, cyc);
  if (cudaDeviceSynchronize() != cudaSuccess) { printf("{\"error\": \"%s\"}\n", kNames[OP]); exit(1); }
  long long c;
  cudaMemcpy(&c, cyc, 8, cudaMemcpyDeviceToHost);
  return (double)c / iters;
}

}  // namespace

int main() {
  const int blocks = 2 * 64 / kFp2Elems;                 // h2g2's 2 x 64 elements, four lanes each
  const int n = blocks * 32;
  uint32_t* d;
  long long* cyc;
  cudaMalloc(&d, 36ull * n * 4);
  cudaMalloc(&cyc, 8ull * blocks);
  std::vector<uint32_t> h(36ull * n);
  uint64_t s = 88172645463325252ull;
  for (auto& w : h) { s ^= s << 13; s ^= s >> 7; s ^= s << 17; w = (uint32_t)s; }
  for (int t = 0; t < n; ++t) { h[11 * n + t] %= 0x1a0111eau; h[23 * n + t] %= 0x1a0111eau; }
  cudaMemcpy(d, h.data(), 36ull * n * 4, cudaMemcpyHostToDevice);
  const int iters = 256;
  double c[N_OPS];
  c[LANES4_SQR] = run<LANES4_SQR>(d, cyc, blocks, iters);
  c[LANES4_MUL] = run<LANES4_MUL>(d, cyc, blocks, iters);
  c[LANES4_PART_SUM] = run<LANES4_PART_SUM>(d, cyc, blocks, iters);
  c[LANES4_SQR_OPERANDS] = run<LANES4_SQR_OPERANDS>(d, cyc, blocks, iters);
  c[FP_MUL] = run<FP_MUL>(d, cyc, blocks, iters);
  c[GCD_DIVSTEPS] = run<GCD_DIVSTEPS>(d, cyc, blocks, iters);
  c[GCD_UPDATE_FG] = run<GCD_UPDATE_FG>(d, cyc, blocks, iters);
  c[GCD_UPDATE_DE] = run<GCD_UPDATE_DE>(d, cyc, blocks, iters);
  c[GCD_INV] = run<GCD_INV>(d, cyc, blocks, 16);
  int clock_khz = 0;
  cudaDeviceGetAttribute(&clock_khz, cudaDevAttrClockRate, 0);
  for (int op = 0; op < N_OPS; ++op)
    printf("{\"probe\": \"k7_step\", \"step\": \"%s\", \"cycles\": %.1f, \"us_at_max_clock\": %.4f}\n",
           kNames[op], c[op], c[op] / (clock_khz * 1e-3));
  return 0;
}
