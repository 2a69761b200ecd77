// K3: one whole Fp12 square, product, or product with a sparse Miller line,
// per element, over (..., 2, 3, 2, 12, n) Montgomery limbs.
//
// Replaces the Pallas whole-op kernels fp12_op("sqr" | "mul" | "line")
// (lighthouse_tpu/ops/fused.py:578 _k3_fp12_call; sqr_kernel :586,
// mul_kernel :598, line_kernel :610).
//
// Fp12 = Fp6[w]/(w^2 - v), Fp6 = Fp2[v]/(v^3 - xi): coordinate (h, k) of the
// (2, 3) Fp2 grid is the coefficient of w^(2k + h), and w^6 = xi. The
// product is the schoolbook of ops/bm/tower.py written in that w basis:
//   c_e = sum_{i + j = e} a_i b_j + xi * sum_{i + j = e + 6} a_i b_j,
// 36 Fp2 products of 4 Fp products. The line l0 + l1 w^3 + l2 w^5 is b with
// only b_0 = l0, b_3 = l1, b_5 = l2: 18 Fp2 products. The square merges the
// mirrored products a_x a_y and a_y a_x of the 144 into one of multiplicity
// 2: 78 distinct Fp products.
//
// Lazy reduction: each of the 12 output Fp coordinates is one accumulator
// T = 16 p^2 + (added products) - (subtracted products), reduced once. Per
// accumulator at most 17 products are added and 16 subtracted, a merged
// product counted twice (the tables of ops/fused.py, checked there and by
// tests/test_torch_k3_plan.py), so with canonical inputs 0 <= T < 33 p^2 <
// 2^767 and REDC returns u < 4.36 p: four conditional subtractions.
//
// Layout. The plan (which Fp products, into which accumulators, with which
// signed multiplicity) is not written here: ops/fused.py (k3_plan_words)
// makes it from its K3 tables, and ops/_build.py writes it into the
// generated header k3_plan.h. It cuts each kind into groups of at most 32
// products feeding at most 4 accumulators (sqr 3 groups of 28/26/24
// products, mul 6 of 24, line 3 of 24). A block owns E elements of one row
// (E = 1 for small batches, so that every element gets a block; E = 8 when
// rows * n >= kWideBatch, so that a limb row of the group is one 32-byte
// sector) and runs in three phases:
//   1. stage: the block copies the group's operands (144 words of a, and
//      144 of b or 72 of the line, per element) into shared memory with
//      sector-wide loads, each element at an odd stride (no bank conflicts);
//   2. products: one warp per (element, plan group). Lane k computes the
//      group's product k (12 x 12 -> 24 limbs, lh::mul_wide, operands from
//      shared memory) into the warp's scratch; then lane c < 24 sums column
//      c of each accumulator as a signed 64-bit sum of the products' limbs
//      times their multiplicities (|sum| < 33 * 2^32 < 2^38: no carries).
//      The column sums read the plan at compile time, so they unroll into
//      one shared load per product and an add or subtraction per term;
//   3. reduce: one thread per (element, output coordinate) adds the 16 p^2
//      offset column by column, makes one carry pass (T in 24 limbs),
//      lh::redc<4>, and stores 12 limbs, E neighbouring lanes per sector.
// The critical path is one Fp product, one column sum of at most 28 terms,
// one carry pass and one REDC, not the 144 products in series of a thread
// per element.
//
// Bounds on an H100. At the main path's n = 1 (the final exponentiation's
// chain) and n = 65 (the Miller loop's pairs) K3 is bound by latency: that
// critical path plus the launch, on one block per element. At n >= 4096 it
// is bound by 32-bit integer multiply-adds (chip_smoke.py WORK) and, in
// practice, by instruction issue: the kernel does 78 (sqr) / 144 (mul) /
// 72 (line) Fp products and 12 REDCs where the function needs 36 / 54 / 42
// and 12, and each 32 x 32 multiply-add of lh::mul_wide costs about five
// instructions.
//
// Resources (ptxas, sm_90a, nvcc 12.9), 0 bytes of spills in all six:
//   sqr   E = 1: 48 registers, 11,380 B shared;  E = 8: 64 registers, 46,240 B
//   mul   E = 1: 52 registers, 17,960 B shared;  E = 8: 64 registers, 47,680 B
//   line  E = 1: 48 registers, 10,472 B shared;  E = 8: 56 registers, 45,376 B
// Shared memory is static (cols E * 12 * 25 int64, scratch warps * products
// * 25 words, operands E * (145 + 145 or 73) words), under 48 KB: at E = 8
// four blocks of 256 threads fit an SM.
#include <utility>

#include "fp.cuh"
#include "k3_plan.h"

namespace {

constexpr int SQR = 0, MUL = 1, LINE = 2;
constexpr int FP12W = 12 * lh::NL;    // words of one Fp12 element
constexpr int LINEW = 6 * lh::NL;     // words of one sparse line
constexpr int PS = lh::NW + 1;        // shared stride of a product and of an accumulator
constexpr uint32_t HAS = 1u << 31;    // plan word: the lane has a product
constexpr int WORDS = 33;             // plan words per group: head, then one per lane
constexpr long long kWideBatch = 2048;

// The plan twice: in device memory for the product lanes (indexed by
// lane), and as a compile-time table for the column sums, which the
// compiler unrolls into adds and subtractions of the right products.
__device__ const uint32_t kPlanSqr[LH_K3_GROUPS_SQR][WORDS] = LH_K3_PLAN_SQR;
__device__ const uint32_t kPlanMul[LH_K3_GROUPS_MUL][WORDS] = LH_K3_PLAN_MUL;
__device__ const uint32_t kPlanLine[LH_K3_GROUPS_LINE][WORDS] = LH_K3_PLAN_LINE;

template <int KIND>
struct Kind;
template <>
struct Kind<SQR> {
  static constexpr int groups = LH_K3_GROUPS_SQR, products = LH_K3_PRODUCTS_SQR;
  static constexpr int ywords = FP12W;
  static constexpr uint32_t plan[groups][WORDS] = LH_K3_PLAN_SQR;
  __device__ static const uint32_t* lanes(int g) { return kPlanSqr[g] + 1; }
};
template <>
struct Kind<MUL> {
  static constexpr int groups = LH_K3_GROUPS_MUL, products = LH_K3_PRODUCTS_MUL;
  static constexpr int ywords = FP12W;
  static constexpr uint32_t plan[groups][WORDS] = LH_K3_PLAN_MUL;
  __device__ static const uint32_t* lanes(int g) { return kPlanMul[g] + 1; }
};
template <>
struct Kind<LINE> {
  static constexpr int groups = LH_K3_GROUPS_LINE, products = LH_K3_PRODUCTS_LINE;
  static constexpr int ywords = LINEW;
  static constexpr uint32_t plan[groups][WORDS] = LH_K3_PLAN_LINE;
  __device__ static const uint32_t* lanes(int g) { return kPlanLine[g] + 1; }
};

template <int KIND>
__host__ __device__ constexpr uint32_t plan_word(int g, int i) {
  return Kind<KIND>::plan[g][i];
}

// Signed 4-bit multiplicity of accumulator j in a product word (bits 8 + 4j).
__host__ __device__ constexpr int mult(uint32_t word, int j) {
  return (int)(word << (20 - 4 * j)) >> 28;
}

// Warps per block: one per plan group for one element, eight for eight.
template <int KIND, int E>
struct Block {
  static constexpr int warps = E == 1 ? Kind<KIND>::groups : 8;
};

// Column `col` of group G's accumulators: s[j] += m_jk * product_k[col].
template <int KIND, int G, int K>
__device__ __forceinline__ void column_term(const uint32_t* pw, int col, long long (&s)[4]) {
  constexpr uint32_t w = plan_word<KIND>(G, 1 + K);
  if constexpr ((w & HAS) != 0) {
    const long long v = pw[K * PS + col];
    if constexpr (mult(w, 0) != 0) s[0] += mult(w, 0) * v;
    if constexpr (mult(w, 1) != 0) s[1] += mult(w, 1) * v;
    if constexpr (mult(w, 2) != 0) s[2] += mult(w, 2) * v;
    if constexpr (mult(w, 3) != 0) s[3] += mult(w, 3) * v;
  }
}

template <int KIND, int G, int... Ks>
__device__ __forceinline__ void column_sums(const uint32_t* pw, int col, long long (&s)[4],
                                            std::integer_sequence<int, Ks...>) {
  (column_term<KIND, G, Ks>(pw, col, s), ...);
}

// Group g's column sums (g known only at run time: one branch per group)
// into its accumulators' columns `out + acc * PS`.
template <int KIND, int G = 0>
__device__ __forceinline__ void group_sums(int g, const uint32_t* pw, int col, long long* out) {
  if constexpr (G < Kind<KIND>::groups) {
    if (g != G) return group_sums<KIND, G + 1>(g, pw, col, out);
    long long s[4] = {0, 0, 0, 0};
    column_sums<KIND, G>(pw, col, s, std::make_integer_sequence<int, Kind<KIND>::products>{});
    constexpr uint32_t head = plan_word<KIND>(G, 0);
    out[((head >> 4) & 15) * PS] = s[0];
    out[((head >> 8) & 15) * PS] = s[1];
    if constexpr ((head & 15) > 2) {
      out[((head >> 12) & 15) * PS] = s[2];
      out[((head >> 16) & 15) * PS] = s[3];
    }
  }
}

template <int KIND, int E>
__global__ void __launch_bounds__((32 * Block<KIND, E>::warps))
fp12_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ a,
            const uint32_t* __restrict__ b, long long n) {
  using K = Kind<KIND>;
  constexpr int WARPS = Block<KIND, E>::warps;
  constexpr int XS = FP12W + 1, YS = K::ywords + 1;
  __shared__ long long cols[E * 12 * PS];
  __shared__ uint32_t scratch[WARPS][K::products * PS];
  __shared__ uint32_t xs[E * XS];
  __shared__ uint32_t ys_own[KIND == SQR ? 1 : E * YS];
  const uint32_t* ys = KIND == SQR ? xs : ys_own;

  const long long per_row = (n + E - 1) / E;
  const long long r = blockIdx.x / per_row;
  const long long lane0 = (blockIdx.x - r * per_row) * E;
  const int live = (int)min((long long)E, n - lane0);

  // 1. Stage the operands.
  const uint32_t* ga = a + r * FP12W * n + lane0;
  for (int t = threadIdx.x; t < FP12W * E; t += blockDim.x) {
    const int w = t / E, e = t - w * E;
    xs[e * XS + w] = e < live ? ga[w * n + e] : 0u;
  }
  if (KIND != SQR) {
    const uint32_t* gb = b + r * K::ywords * n + lane0;
    for (int t = threadIdx.x; t < K::ywords * E; t += blockDim.x) {
      const int w = t / E, e = t - w * E;
      ys_own[e * YS + w] = e < live ? gb[w * n + e] : 0u;
    }
  }
  __syncthreads();

  // 2. Products, and their column sums per accumulator.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* pw = scratch[warp];
  for (int task = warp; task < E * K::groups; task += WARPS) {
    const int g = task / E, e = task - g * E;
    const uint32_t word = lane < K::products ? K::lanes(g)[lane] : 0u;
    if (word & HAS) {
      const uint32_t* xp = xs + e * XS + (word & 15) * lh::NL;
      const uint32_t* yp = ys + e * YS + ((word >> 4) & 15) * lh::NL;
      uint32_t x[lh::NL], y[lh::NL], t[lh::NW];
#pragma unroll
      for (int l = 0; l < lh::NL; ++l) {
        x[l] = xp[l];
        y[l] = yp[l];
      }
      lh::mul_wide(x, y, t);
#pragma unroll
      for (int c = 0; c < lh::NW; ++c) pw[lane * PS + c] = t[c];
    }
    __syncwarp();
    if (lane < lh::NW) group_sums<KIND>(g, pw, lane, cols + e * 12 * PS + lane);
    __syncwarp();
  }
  __syncthreads();

  // 3. Offset, carry pass, REDC and store, one thread per output coordinate.
  for (int t = threadIdx.x; t < 12 * E; t += blockDim.x) {
    const int o = t / E, e = t - o * E;
    if (e >= live) continue;
    const long long* cp = cols + (e * 12 + o) * PS;
    uint32_t w[lh::NW];
    long long c = 0;
#pragma unroll
    for (int k = 0; k < lh::NW; ++k) {
      c += cp[k] + (long long)lh::kP2x16[k];
      w[k] = (uint32_t)c;
      c >>= 32;   // arithmetic: the floor, for negative sums too
    }
    uint32_t res[lh::NL];
    lh::redc<4>(w, res);
    lh::store(out + r * FP12W * n + (long long)o * lh::NL * n + lane0 + e, res, n);
  }
}

template <int KIND, int E>
int launch_e(void* out, const void* a, const void* b, long long rows, long long n,
             void* stream) {
  const long long blocks = rows * ((n + E - 1) / E);
  constexpr int threads = 32 * Block<KIND, E>::warps;
  fp12_kernel<KIND, E><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, n);
  return (int)cudaGetLastError();
}

template <int KIND>
int launch(void* out, const void* a, const void* b, long long rows, long long n, void* stream) {
  return rows * n >= kWideBatch ? launch_e<KIND, 8>(out, a, b, rows, n, stream)
                                : launch_e<KIND, 1>(out, a, b, rows, n, stream);
}

__global__ void empty_kernel() {}

template <int E>
int launch_empty(long long rows, long long n, void* stream) {
  empty_kernel<<<(unsigned)(rows * ((n + E - 1) / E)), 32 * Block<SQR, E>::warps, 0,
                 (cudaStream_t)stream>>>();
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

// An empty kernel on lh_fp12_sqr's grid for (rows, n) (the square: most of
// K3's launches; the product's E = 1 blocks have twice its warps): the
// launch floor K3 is timed against (chip_smoke.py floor_ms). Not a kernel
// of the port.
extern "C" int lh_fp12_empty(void* out, long long rows, long long n, void* stream) {
  (void)out;
  return rows * n >= kWideBatch ? launch_empty<8>(rows, n, stream)
                                : launch_empty<1>(rows, n, stream);
}
