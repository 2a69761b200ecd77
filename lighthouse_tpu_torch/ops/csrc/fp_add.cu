// K4: the Fp additive layer over (..., 12, n) Montgomery limbs, canonical in
// [0, p) in and out. One launch evaluates a plan of signed linear
// combinations,
//     out[r] = sum_j C[r][j] x[j] mod p,   r < R,
// the terms x[j] being the Fp values on axis -3 of up to kMaxOps operand
// tensors (..., J_o, 12, n) in order, and the output a fresh contiguous
// (..., R, 12, n): a whole step's additions, subtractions, negations and
// small multiples (an Fp6 product's six sums of eighteen products with xi
// folded in, a conjugation, a point's negation) in one launch. fused.fp_add,
// fp_sub, fp_neg and fp_mul_small are one-row plans of it.
//
// No Pallas kernel computes these: the JAX package adds loose digits
// (lighthouse_tpu/ops/bm/limbs.py:343-353 add / sub / neg) and XLA fuses
// the additions into each stage's program.
//
// Arithmetic, one output Fp per thread (lh::sum_mod, fp.cuh, which K5's
// operands share): the terms' signed 64-bit column sums c x[l], then plus
// m p (m the row's subtracted |c|), one carry pass into v in [0, S p), S =
// sum_j |C[r][j]|; a quotient estimate q = trunc(v_hi kInvHi) in double
// precision, floor(v / p) or one less for v_hi = floor(v / 2^352) < 2^47;
// v - q p in [0, 2p) and one conditional subtraction.
//
// Bounds (the launcher refuses a plan past them, as the wrapper does):
//   R <= kMaxRows, J_o <= kMaxTerms, at most kMaxWords nonzero coefficients,
//   0 < |C[r][j]| <= kMaxCoeff = 2^16 - 1 (fp_mul_small's k),
//   S <= kMaxSum = 2^18 - 1.
// With terms below p < 2^381, v < 2^18 p < 2^399, so v_hi < 2^47: the
// estimate is exact enough (tests/test_torch_curve_op.py
// test_quotient_constant). A column's partial sum is below 2 S 2^32 < 2^51 in
// magnitude and the carry below 2^20: no int64 overflow.
//
// Design: one thread per (lead row, output Fp, column), the output's own
// order, so a warp's loads and stores of one limb coalesce along n. A row's
// terms are read kBatch at a time, all their limbs' loads issued before any
// is summed: one memory round trip a batch, where a load, sum, load loop
// waited a round trip a term (a step's rows have 1 to 5 terms; batches of
// 1, 4, 6 and 8 timed by scripts/probe_k4.py, PERF.md). The
// plan is a by-value kernel parameter (__grid_constant__): a CUDA graph
// records it at capture, with no device buffer and no host sync; it
// changes per call site, so it cannot live in __constant__ memory. A row's
// words are (term | operand << 6 | signed coefficient << 8); zero
// coefficients are not stored. Operands may be strided views and may
// broadcast: each carries its element strides over the output's lead rows,
// folded into two levels r1 * r0 (ops/fused.py _geometry), and its term,
// limb and column strides; a broadcast axis has stride 0.
//
// Bound on an H100: bytes, each input Fp read once and each output written
// once, (J + R) 48 bytes a column; the multiplies are by small integers. At
// the main path's shapes (n = 1 to 4096) that is far below the launch floor
// (an empty kernel on this grid, lh_fp_add_empty). Tensor cores and TMA
// have nothing to do here. tests/test_torch_fp_lincomb.py replays this
// file's arithmetic in Python integers and the launch arguments' addressing.
#include "fp.cuh"

namespace {

constexpr int kBlock = 128;              // output Fp columns per block
constexpr int kBatch = 4;                // terms whose loads are issued together
constexpr int kMaxOps = 4;               // operand tensors
constexpr int kMaxTerms = 64;            // terms per operand (6 bits of a word)
constexpr int kMaxRows = 32;             // outputs R
constexpr int kMaxWords = 128;           // nonzero coefficients of a plan
constexpr long long kMaxCoeff = (1 << 16) - 1;
constexpr long long kMaxSum = (1 << 18) - 1;

// One operand: its data and its element strides over the output's (r1, r0)
// and its own term, limb and column axes.
struct Operand {
  const uint32_t* ptr;
  long long s1, s0, sj, sl, sn;
};

struct Operands {
  Operand op[kMaxOps];
};

// Row r's words are word[start[r] .. start[r + 1]).
struct Plan {
  uint32_t rows;
  uint8_t start[kMaxRows + 1];
  uint32_t word[kMaxWords];
};

struct Grid {
  uint32_t total, n, r0;
};

__global__ void __launch_bounds__(kBlock)
lincomb_kernel(uint32_t* __restrict__ out, const __grid_constant__ Operands ops,
               const __grid_constant__ Plan plan, const Grid g) {
  const uint32_t e = blockIdx.x * kBlock + threadIdx.x;
  if (e >= g.total) return;
  const uint32_t t = e / g.n, j = e - t * g.n;          // t: (lead row, output)
  const uint32_t row = t / plan.rows, r = t - row * plan.rows;
  const uint32_t r1 = row / g.r0, r0 = row - r1 * g.r0;
  long long col[lh::NL];
#pragma unroll
  for (int l = 0; l < lh::NL; ++l) col[l] = 0;
  long long m = 0;
  const uint32_t w0 = plan.start[r], w1 = plan.start[r + 1];
  for (uint32_t i = w0; i < w1; i += kBatch) {
    uint32_t x[kBatch][lh::NL];
    long long c[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      c[k] = 0;
#pragma unroll
      for (int l = 0; l < lh::NL; ++l) x[k][l] = 0;
      if (i + k < w1) {
        const uint32_t w = plan.word[i + k];
        const Operand& o = ops.op[(w >> 6) & 3u];
        c[k] = (int)w >> 8;
        const uint32_t* src = o.ptr + r1 * o.s1 + r0 * o.s0 + (w & 63u) * o.sj + j * o.sn;
#pragma unroll
        for (int l = 0; l < lh::NL; ++l) x[k][l] = __ldg(src + l * o.sl);
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
#pragma unroll
      for (int l = 0; l < lh::NL; ++l) col[l] += c[k] * x[k][l];
      m += c[k] < 0 ? -c[k] : 0;
    }
  }
  uint32_t z[lh::NL];
  lh::sum_mod(col, 0, m, z);
  uint32_t* po = out + (long long)t * (lh::NL * (long long)g.n) + j;
#pragma unroll
  for (int l = 0; l < lh::NL; ++l) po[(long long)l * g.n] = z[l];
}

__global__ void empty_kernel() {}

unsigned blocks(long long rows, long long n) {
  return (unsigned)((rows * n + kBlock - 1) / kBlock);
}

}  // namespace

// xs: nops operand pointers. rows: the output's lead rows (r1 * r0). plan:
// R, start[0 .. R], then start[R] words. geom: r0, then per operand its term
// count J_o and strides s1, s0, sj, sl, sn. Returns cudaErrorInvalidValue
// for a plan or geometry past the bounds above.
extern "C" int lh_fp_lincomb(void* out, const void* const* xs, long long nops, long long rows,
                             long long n, const uint32_t* plan, const long long* geom,
                             void* stream) {
  const long long R = plan[0];
  const long long r0 = geom[0];
  if (nops < 1 || nops > kMaxOps || R < 1 || R > kMaxRows || r0 < 1 || rows % r0 != 0 ||
      rows * R * n >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  Operands ops{};
  long long terms[kMaxOps] = {};
  for (int o = 0; o < nops; ++o) {
    const long long* gs = geom + 1 + 6 * o;
    terms[o] = gs[0];
    if (terms[o] < 1 || terms[o] > kMaxTerms) return (int)cudaErrorInvalidValue;
    ops.op[o] = Operand{(const uint32_t*)xs[o], gs[1], gs[2], gs[3], gs[4], gs[5]};
  }
  Plan p{};
  p.rows = (uint32_t)R;
  const uint32_t* start = plan + 1;
  const uint32_t* words = plan + 2 + R;
  if (start[0] != 0 || start[R] > (uint32_t)kMaxWords) return (int)cudaErrorInvalidValue;
  for (int r = 0; r <= R; ++r) {
    if (r < R && start[r + 1] < start[r]) return (int)cudaErrorInvalidValue;
    p.start[r] = (uint8_t)start[r];
  }
  for (int r = 0; r < R; ++r) {
    long long sum = 0;
    for (uint32_t i = start[r]; i < start[r + 1]; ++i) {
      const uint32_t w = words[i];
      const long long c = (int)w >> 8;
      const int o = (w >> 6) & 3;
      if (o >= nops || (long long)(w & 63u) >= terms[o] || c == 0 || c > kMaxCoeff ||
          -c > kMaxCoeff)
        return (int)cudaErrorInvalidValue;
      sum += c < 0 ? -c : c;
      p.word[i] = w;
    }
    if (sum > kMaxSum) return (int)cudaErrorInvalidValue;
  }
  lincomb_kernel<<<blocks(rows * R, n), kBlock, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, ops, p, Grid{(uint32_t)(rows * R * n), (uint32_t)n, (uint32_t)r0});
  return (int)cudaGetLastError();
}

// An empty kernel on K4's grid for (rows, n), rows counting every output Fp
// (lead rows times R): the launch floor K4 is timed against (chip_smoke.py
// floor_ms). Not a kernel of the port.
extern "C" int lh_fp_add_empty(void* out, long long rows, long long n, void* stream) {
  (void)out;
  empty_kernel<<<blocks(rows, n), kBlock, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
