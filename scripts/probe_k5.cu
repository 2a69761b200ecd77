// Microbenchmarks of the card's costs behind K5's design (run by
// scripts/probe_k5.py micro; not built by the port): one Fp Montgomery
// product, x <- x y mod p repeated in every lane, as C carry chains
// (lh::mul_wide + lh::redc_imm: IMAD.WIDE and two IADD3 a multiply-add) and
// as fp.cuh's PTX carry chains (lh::row_even / row_odd / redc_even /
// redc_odd, mad.lo.cc / madc.hi.cc pairs), at 1 to 16 warps an SM (the
// first latency, the last throughput); and a shuffle's latency.
#include <cstdio>
#include <cstdint>
#include <cstdlib>
#include <vector>
#include "fp.cuh"

using u32 = uint32_t;

__device__ __forceinline__ void mul_wide_cc(const u32* a, const u32* b, u32* t) {
#pragma unroll
  for (int c = 0; c < 25; ++c) t[c] = 0;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    lh::row_even(t + i, a[i], b);
    lh::row_odd(t + i + 1, a[i], b);
  }
}

__device__ __forceinline__ void redc_cc(u32* t, u32* out) {
  u32 ec = 0;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    const u32 m = t[i] * lh::kN0;
    const u32 k = lh::redc_even(t + i, m, ec);
    ec = k + lh::redc_odd(t + i + 1, m);
  }
  u32 s[12];
  long long br = 0;
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    br += (long long)t[12 + j] - lh::p_limb(j);
    s[j] = (u32)br;
    br >>= 32;
  }
#pragma unroll
  for (int j = 0; j < 12; ++j) out[j] = br < 0 ? t[12 + j] : s[j];
}


__device__ __forceinline__ void mul_old(const u32* a, const u32* b, u32* out) {
  u32 t[24];
  lh::mul_wide(a, b, t);
  lh::redc_imm(t, out);
}

// x <- x y mod p, `iters` times a lane; MODE 0 C chains, 1 PTX chains.
template <int MODE>
__global__ void kmul(u32* data, int iters, long long* cyc) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = gridDim.x * blockDim.x;
  u32 x[12], y[12];
#pragma unroll
  for (int l = 0; l < 12; ++l) { x[l] = data[l * n + t]; y[l] = data[(12 + l) * n + t]; }
  long long c0 = clock64();
  for (int it = 0; it < iters; ++it) {
    u32 z[12];
    if (MODE == 0) {
      mul_old(x, y, z);
    } else {
      u32 w[25];
      mul_wide_cc(x, y, w);
      redc_cc(w, z);
    }
#pragma unroll
    for (int l = 0; l < 12; ++l) x[l] = z[l];
  }
  long long c1 = clock64();
#pragma unroll
  for (int l = 0; l < 12; ++l) data[(24 + l) * n + t] = x[l];
  if (threadIdx.x == 0) cyc[blockIdx.x] = c1 - c0;
}

// A shuffle's latency: one dependent chain within groups of four lanes.
__global__ void kshfl(u32* data, int iters, long long* cyc) {
  u32 r = data[threadIdx.x];
  long long c0 = clock64();
  for (int it = 0; it < iters; ++it) r = __shfl_sync(0xffffffffu, r, (threadIdx.x & ~3) | ((r + 1) & 3));
  long long c1 = clock64();
  data[threadIdx.x] = r;
  if (threadIdx.x == 0) cyc[blockIdx.x] = c1 - c0;
}

static void check(cudaError_t e, const char* what) {
  if (e != cudaSuccess) { printf("CUDA error %s: %s\n", what, cudaGetErrorString(e)); exit(1); }
}

int main() {
  cudaDeviceProp prop;
  check(cudaGetDeviceProperties(&prop, 0), "properties");
  const int sms = prop.multiProcessorCount;
  const int iters = 64;
  const size_t maxn = (size_t)sms * 512;
  u32* d;
  long long* cyc;
  check(cudaMalloc(&d, 36 * maxn * 4), "malloc");
  check(cudaMalloc(&cyc, 8 * (size_t)sms * 16), "malloc");
  std::vector<u32> h(36 * maxn);
  uint64_t s = 88172645463325252ull;
  for (auto& w : h) { s ^= s << 13; s ^= s >> 7; s ^= s << 17; w = (u32)s; }
  for (int warps : {1, 4, 8, 16}) {
    const int threads = 32 * warps, blocks = sms, n = blocks * threads;
    for (int t = 0; t < n; ++t) { h[11 * n + t] %= 0x1a0111eau; h[23 * n + t] %= 0x1a0111eau; }
    double cycles[2];
    std::vector<u32> out[2];
    for (int mode = 0; mode < 2; ++mode) {
      check(cudaMemcpy(d, h.data(), 36ull * n * 4, cudaMemcpyHostToDevice), "copy");
      if (mode == 0) kmul<0><<<blocks, threads>>>(d, iters, cyc); else kmul<1><<<blocks, threads>>>(d, iters, cyc);
      check(cudaDeviceSynchronize(), "run");
      std::vector<long long> hc(blocks);
      check(cudaMemcpy(hc.data(), cyc, 8ull * blocks, cudaMemcpyDeviceToHost), "copy");
      double avg = 0;
      for (auto c : hc) avg += c;
      cycles[mode] = avg / blocks / iters;
      out[mode].resize(12ull * n);
      check(cudaMemcpy(out[mode].data(), d + 24ull * n, 48ull * n, cudaMemcpyDeviceToHost), "copy");
    }
    int differ = 0;
    for (size_t i = 0; i < out[0].size(); ++i) differ += out[0][i] != out[1][i];
    printf("{\"probe\": \"fp_product\", \"warps_per_sm\": %d, \"cycles_a_product_c_chains\": %.1f, "
           "\"cycles_a_product_ptx_chains\": %.1f, \"limbs_differ\": %d}\n",
           warps, cycles[0], cycles[1], differ);
  }
  kshfl<<<1, 32>>>(d, 4096, cyc);
  check(cudaDeviceSynchronize(), "shuffle");
  long long c;
  check(cudaMemcpy(&c, cyc, 8, cudaMemcpyDeviceToHost), "copy");
  printf("{\"probe\": \"shuffle\", \"cycles\": %.2f}\n", c / 4096.0);
  return 0;
}
