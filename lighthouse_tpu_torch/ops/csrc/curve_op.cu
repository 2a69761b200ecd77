// K5: the complete G1 / G2 group law, p + q and 2 p, one launch a call, over
// projective points (X : Y : Z) in Montgomery limbs, canonical in [0, p):
//   G1 (..., 3, 12, n)        G2 (..., 3, 2, 12, n)
// K6 (below K5, the same engine): the Miller loop's doubling and addition
// steps, one launch a step.
//
// No Pallas kernel computes these: the JAX package writes the
// Renes-Costello-Batina complete formulas for a = 0 as stacked field
// operations (lighthouse_tpu/ops/bm/curves.py:100 add, :122 double) and XLA
// fuses them into each stage's program. Here a call is one launch.
//
// What bounds it. The function needs 3,024 (G1 add), 2,028 (G1 double),
// 7,776 (G2 add) and 5,184 (G2 double) 32-bit multiply-adds a point (its
// schedule's products and reductions, chip_smoke.py WORK) against 432, 288,
// 864 and 576 bytes: bound by operations, 0.0005-0.0019 ms at 4096 points.
// The paths give it 16-16384 points (KZG's ladders 16 and 512, h2g2, the
// pairing and the signature sum 64-65, the ladders and the key tree 4096,
// the wide path 16384). Below a few thousand points a call is latency: a
// launch floor plus one warp's path through two levels, each a step of Fp
// products (two operands, a 24-limb product) and a step of reductions
// (signed column sums, one REDC). A lone warp on that path waits about 4
// cycles a multiply-add in a carry chain (a product's rows and a REDC take
// as long warm as cold), a shuffle 41 cycles, and straight-line code past
// about 32 KB is fetched at 2.25-2.37 cycles an instruction (4.75 past
// 128 KB, 1.08 looped; scripts/probe_k5.py micro). The design shortens
// that path and spreads a call over the card:
//
//   layouts   picked per call from its point count: up to 1024 points a
//             pair of lanes a unit and 4 points a block, from 1025 one lane
//             a unit and 32 points a block. A warp holds 32 / (P L) units
//             (products or reductions of a step) of its P points, so a G2
//             add (18 units a level) at n = 64 runs 16 blocks of 5 warps
//             instead of 2 blocks of 18, and each SM's four schedulers share
//             a few warps.
//   load      unit f < inputs loads input Fp f (strided or broadcast in
//             place, as K4), every thread its share of the schedule; all
//             loads are issued before the first shared store;
//   products  one lane: both operands (combine) and the 24-limb product,
//             twelve rows of two PTX carry chains (fp.cuh lh::row_even /
//             row_odd: mad.lo.cc / madc.hi.cc, a limb a multiply-add). A pair: sub-lane r forms operand r,
//             the two meet in shared memory (__syncwarp of the pair), each
//             takes six rows, sub-lane 0 adds sub-lane 1's 18-limb partial
//             at limb 6;
//   reductions  one lane: the terms' signed column sums, a carry pass, the
//             PTX REDC (lh::redc_even / redc_odd). A pair: each sums 12 of the 24 columns; both carry
//             them into T's limbs and form the twelve quotient words with
//             the 78 products below column 12; the 66 products at or above
//             it split by rows (36 a lane); the partials meet, and one
//             subtraction makes u canonical;
//   level 1   where a warp's lanes hold different units or operands (the
//             pairs), level 1's operands take the one-pass small-multiple
//             form and the column sums one signed multiply-add form: no
//             lane waits on another branch.
// One barrier after each step, one copy of each step's code (a loop over
// the two levels).
//
// The schedule is not written here: ops/fused.py (k5_schedule) writes each
// operation's formula once, level by level, and ops/_build.py writes its
// words into the generated header curve_plan.h (one struct of counts per
// operation). tests/test_torch_curve_op.py replays those words in Python
// integers in this file's order for both layouts against the oracle,
// asserting each bound:
//   an operand is canonical (< p), so a product W < p^2, and a pair's row
//   partial is exact (six rows of A times B, below 2^576);
//   a reduction T = o p^2 + sum_i d_i W_i, o the sum of the subtracted
//   |d_i|, has 0 <= T <= (sum |d_i|) p^2 <= 9 p^2 < p 2^384 (2^384 / p >
//   9.8): its column sums stay below 2^38 in magnitude (the signed limb's
//   bias d 2^31 added back), its final carry is 0, the pair's carries into
//   column 12 sum below 2^36, and REDC returns u < T / 2^384 + p < 2p, one
//   subtraction to canonical;
//   every output is canonical, so it equals the plain version's bit for bit.
//
// Designs tried (graph-replay us, G2 add / G2 double at n = 64 and 4096,
// NVIDIA H100 80GB HBM3, 700 W, every design in one call, bit for bit
// first; the rejected designs' sources and their harness are not kept, the
// first design is `git show 0c87fa7:lighthouse_tpu_torch/ops/csrc/curve_op.cu`):
//   a lane a point, a warp a unit, 32 points a block, C carry chains
//   (the first one-launch design)          17.7/18.2    13.7/13.9
//   1. each product and its REDC split over G lanes (32 / G points a block;
//   each lane formed both operands, took 12 / G rows, and ran a window of
//   REDC columns, the quotient word and the window's low column passed by
//   shuffles, 24 a REDC on the critical path)
//                      G = 1 (PTX chains)  16.6/17.1    11.9/12.2
//                      G = 2               30.3/86.9    21.2/56.4
//                      G = 4               35.4/206     25.8/150
//   2. one lane a unit, 32 / P units a warp, P points a block
//                      P = 32              16.6/17.0    11.7/12.0
//                      P = 16              16.7/22.4     9.5/12.5
//                      P = 4               10.5/26.1    11.8/21.6
//   3. this one: pairs at 4 points a block up to 1024 points, one lane at
//   32 above                                  9.0/16.6     7.6/11.6
// and at 16384 points 62.5 (G2 add) and 34.5 (G2 double, two blocks an SM)
// against 68.8 and 51.5. Split over G lanes, each lane still ran both
// operands, the column sums and the carry pass, the shuffles sat on the
// critical path, and the code grew to 3,400-4,000 instructions; a pair
// splits those too and exchanges through shared memory once a step. The
// aim of 7 us (G2 double) and 9 us (G2 add) at n = 64 and 4096 is met for
// G2 add at 64 only: at 64 a G2 double is still two levels of rows and REDC
// chains near 850 and 1,390 cycles a level; at 4096 the card is full
// (128-512 blocks) and the time is the instructions a G2 point costs.
//
// Critical path (clock64 stamps of block 0's first warp, LH_K5_STAMP, cycles
// at 1.98 GHz, n = 64, pairs; scripts/probe_k5.py stamps): G2 double 13,493
// = loads 1,088, then per level operands 1,105 / 1,374, six rows 856,
// partial sum 559, column sums 1,007 / 2,020, carry pass 455, REDC and the
// partials' sum 1,386; G2 add 16,469, G1 add 12,007, G1 double 11,254. A
// one-lane product's rows take 1,105-1,556 and its REDC 1,421-2,194 (G1,
// n = 4096).
//
// Resources (ptxas, sm_90a, nvcc 12.9; no spills, where the first design's
// G1 add spilled 12 bytes): 84-96 registers a thread; __launch_bounds__
// asks for two 384-thread blocks an SM for the one-lane G2 double (80
// registers), which lets the 16384-point grid overlap two blocks' chains.
// Shared memory per block, dynamic: the schedule, the slots (13 P words
// each), the products (25 P words, or 43 P for a pair's operands, product
// and partial) and a pair's exchange (73 P words a reduction unit): at
// (P, L) = (4, 2) / (32, 1) G1 add 12.8 / 29.2 KB, G1 double 8.6 / 19.5,
// G2 add 36.9 / 77.6, G2 double 24.6 / 51.7. Above 48 KB a function must
// be allowed it (cudaFuncSetAttribute), which the launcher does once per
// device and layout at its first call, before the graphs that capture it
// (they run each stage once eagerly first).
//
// K6: the Miller loop's doubling step (2T and the tangent line at T) and
// addition step (T + Q and the line through T and Q), each line evaluated at
// P and homogenized by its Z, for n pairs: T, Q (..., 3, 2, 12, n), px, py,
// pz (..., 12, n), read in place as p_proj.select(-3, i) gives them. No
// Pallas kernel computes these either: lighthouse_tpu/ops/bm/pairing.py:24
// _dbl_step and :63 _add_step are array code that XLA fuses into the
// lax.scan body at :107 / :112. Here they were 30 and 18 kernels a step
// (K1, K2, K4, K5 and the torch.stack copies of their operands, 48.6 and
// 37.2 us on the card at 65 pairs); K6 is one launch, which writes the
// point and the line (l0, l1, l2) (..., 3, 2, 12, n) as K3's fp12_mul_line
// reads it. Its schedule (ops/fused.py k5_schedule) has three levels:
//   doubling  level 0 Y^2, YZ, Z^2, XY, X^2 (12 Fp products, 10
//             reductions); level 1 K5's doubling products and X^2 X,
//             YZ Z, Y^2 Z, X^2 Z (24, 14: the point, flagged to the output,
//             and 2 xi YZ^2, 3 X^2 Z, X^3, Y^2 Z into slots); level 2
//             l0 = 2 xi YZ^2 py, l1 = (3 X^3 - 2 Y^2 Z) pz, l2 = -3 X^2 Z
//             px (6 Fp products by P's coordinates, 6 reductions);
//   addition  level 0 K5's g2_add products and yq Z1, xq Z1, Y1 zq, X1 zq
//             (30, 16: n and d folded into the reductions); level 1 K5's
//             and d Z1, n X1, n Z1, d Y1 (30, 12); level 2 l0 = xi d Z1 py,
//             l1 = (n X1 - d Y1) pz, l2 = -n Z1 px (6, 6).
// Every linear piece ([3b], the small multiples, xi, the sums and the
// line's negation) is an operand's combination or a reduction's signed
// coefficients, within K5's bounds; a reduction's slot is the lowest that
// no later level reads. It needs 10,368 (doubling) and 14,400 (addition)
// multiply-adds a pair against 1,008 and 1,296 bytes: bound by operations.
// K6 keeps K5's layouts; one lane a unit takes 16 points a block, where 32
// would take 768 and 960 threads (24 and 30 units a point). On the card
// (graph-replay us, NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py): the
// doubling step 11.0-11.1 at 2-65 pairs, 22.7 at 4097, 84-85 at 16385; the
// addition step 12.4-12.6, 35.4-35.8, 137-139; ptxas (nvcc 12.9) 78-93
// registers a thread, no spills. Sharing the engine (operands by index,
// three levels, the output flag) costs K5 up to 0.4 us a call: G1 double
// 6.5-6.8 -> 6.9-7.1 at n = 1-64, G2 double 7.5-7.7 -> 7.7-7.9, G1 add
// 8.7-8.8 -> 9.0-9.2 at 4096, G2 add within 0.2 (the same card, the two
// sources in turns). Tried and dropped, each within 0.1 us of this source:
// operands selected over static indices (no indexed parameter), with
// __ldg or plain loads; K5's output test and address resolved at compile
// time.
#include <atomic>

#include "fp.cuh"
#include "curve_plan.h"

namespace {

constexpr int kMulWords = 2 * LH_K5_LIN;
constexpr int kRedWords = 1 + LH_K5_RED;
constexpr uint32_t kHas = 1u << 31;
constexpr uint32_t kOut = 1u << 24;   // a reduction's head: to the output

// Element strides of one operand over the output's (r1, r0) rows, its
// coordinate, component (G2), limb and column axes; a broadcast axis has
// stride 0.
struct Geom {
  long long s1, s0, sc, sk, sl, sn;
};

struct Grid {
  uint32_t total, n, r0;
};

// A launch's operands, in the order of the schedule's inputs: the points
// (K5: p, then q for an add; K6: T, then Q for an addition step), then
// P's coordinates px, py, pz (K6), each an Fp read with stride 0 on the
// coordinate and component axes.
constexpr int kMaxOps = 5;
struct Operands {
  const uint32_t* ptr[kMaxOps];
  Geom geom[kMaxOps];
};

// clock64 stamps of block 0's thread 0 at the steps of its path, read by
// scripts/probe_k5.py stamps, which builds this file with -DLH_K5_STAMPS;
// otherwise they compile to nothing. Level -1 is the loads (0 start, 1
// stored); a level's steps are 0 operands, 1 rows, 2 product stored, 3
// barrier, 4 column sums, 5 carry pass, 6 REDC's main part, 7 reduction
// done, 8 barrier.
#ifdef LH_K5_STAMPS
__device__ long long g_k5_stamp[3][9];
#define LH_K5_STAMP(level, step)                                                  \
  do {                                                                            \
    if (blockIdx.x == 0 && threadIdx.x == 0 && (level) < 2)                       \
      g_k5_stamp[(level) + 1][step] = clock64();                                  \
  } while (0)
#else
#define LH_K5_STAMP(level, step) \
  do {                           \
  } while (0)
#endif

// Limb j of p^2 as an immediate (the reductions' offsets o p^2).
__host__ __device__ constexpr uint32_t p2_limb(int j) {
  constexpr uint32_t kLimbs[lh::NW] = {
      0x1c718e39u, 0x26aa0000u, 0x76382eabu, 0x7ced6b1du, 0x62113cfdu, 0x162c3383u,
      0x3e71b743u, 0x66bf91edu, 0x7091a049u, 0x292e85a8u, 0x86185c7bu, 0x1d68619cu,
      0x0978ef01u, 0xf5314933u, 0x16ddca6eu, 0x50a62cfdu, 0x349e8bd0u, 0x66e59e49u,
      0x0e7046b4u, 0xe2dc90e5u, 0xa22f25e9u, 0x4bd278eau, 0xb8c35fc7u, 0x02a437a4u};
  return kLimbs[j];
}

// t = a's R rows times b: t[0 .. R + 12) exact (R + 12 limbs and a zero).
template <int R>
__device__ __forceinline__ void rows(const uint32_t* a, const uint32_t* b, uint32_t* t) {
#pragma unroll
  for (int c = 0; c < R + 13; ++c) t[c] = 0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    lh::row_even(t + i, a[i], b);
    lh::row_odd(t + i + 1, a[i], b);
  }
}

// A limb x as the signed x - 2^31, so that a small signed multiple d x is
// one signed multiply-add and a bias d 2^31 the caller adds once.
__device__ __forceinline__ int signed_limb(uint32_t x) { return (int)(x ^ 0x80000000u); }

// out = u - p if u >= p, else u.
__device__ __forceinline__ void canonical(const uint32_t* u, uint32_t* out) {
  uint32_t d[lh::NL];
  long long br = 0;   // signed borrow, arithmetic shift: -1 at the end iff u < p
#pragma unroll
  for (int j = 0; j < lh::NL; ++j) {
    br += (long long)u[j] - lh::p_limb(j);
    d[j] = (uint32_t)br;
    br >>= 32;
  }
#pragma unroll
  for (int j = 0; j < lh::NL; ++j) out[j] = br < 0 ? u[j] : d[j];
}

// out = t 2^-384 mod p, canonical, for 0 <= t < p 2^384 (t is clobbered),
// on one lane: twelve steps of two chains each (redc_even, redc_odd), the
// carry out of column i + 12 deferred to the next step as ec.
__device__ __forceinline__ void redc_lane(uint32_t* t, uint32_t* out) {
  uint32_t ec = 0;
#pragma unroll
  for (int i = 0; i < lh::NL; ++i) {
    const uint32_t m = t[i] * lh::kN0;
    const uint32_t k = lh::redc_even(t + i, m, ec);
    ec = k + lh::redc_odd(t + i + 1, m);
  }
  canonical(t + lh::NL, out);
}

// The block's layout for P points a block and L lanes a unit: a warp's 32
// lanes are V = 32 / (P L) units (a product or a reduction of the step)
// times its P points times L, lane = (unit * P + point) * L + r; every array
// point-minor (limb l of point q at l * P + q). 32-bit words:
//   plan      the schedule;
//   slots     K::slots Fp values of 12 limbs, 13 P words each;
//   prod      K::wide products: 24 limbs (L = 1: 25 P words each), or the
//             operands staged, then the product, and sub-lane 1's partial
//             (L = 2: 43 P words);
//   scratch   (L = 2) a reduction unit's exchange, 73 P words: 24 64-bit
//             column sums, then the two lanes' 12-limb REDC partials.
// The pad limb puts the V units of a warp, which read and write the same
// limb of V different arrays, on different banks.
template <class K, int P, int L>
struct Shape {
  static constexpr int V = 32 / (P * L);
  static constexpr int warps = (K::warps + V - 1) / V;
  static constexpr int fp = 13 * P;
  static constexpr int wide = (L == 1 ? 25 : 43) * P;
  static constexpr int rs = L == 1 ? 0 : 73 * P;
  static constexpr int plan = (K::words + 3) / 4 * 4;
  static constexpr int words = plan + K::slots * fp + K::wide * wide + K::warps * rs;
  // Blocks an SM must hold at once (ptxas's register cap): two where a
  // one-lane block is up to 384 threads, so that full grids overlap two
  // blocks' chains; else one, which leaves the registers uncapped.
  static constexpr int min_blocks = L == 1 && warps * 32 <= 384 ? 2 : 1;
};

// acc = sum_k c_k slot[s_k] mod p, canonical; slots points at this point's
// column of slot 0 (limb stride P, slot stride SF). The words (LH_K5_LIN) are
// read into registers first. Where `chains` allows it and every |c_k| = 1
// (single slots, sums and differences of slots): the first term loaded
// (negated if need be), the others by K4's chains (lh::add_mod, sub_mod).
// Otherwise (small multiples, 3 to 72, or any operand where the caller
// wants one form) in one pass: the terms' signed column sums plus m p (m the
// subtracted |c_k|), one carry pass into v in [0, (sum |c_k|) p), 13 limbs;
// then v - q p with q = v_hi * LH_K5_INV_HI in double precision, truncated
// (v_hi = floor(v / 2^352) < 2^47, exact in a double; the constant is
// 2^352 / p rounded down past the product's rounding), which is floor(v / p)
// or one less; then one conditional subtraction.
template <int P, int SF>
__device__ __forceinline__ void load_slot(const uint32_t* slots, uint32_t w, uint32_t* x) {
  const uint32_t* src = slots + (w & 0xffu) * SF;
#pragma unroll
  for (int l = 0; l < lh::NL; ++l) x[l] = src[l * P];
}

template <int P, int SF>
__device__ __forceinline__ void combine(const uint32_t* words, const uint32_t* slots,
                                        bool chains, uint32_t* acc) {
  uint32_t wd[LH_K5_LIN];
#pragma unroll
  for (int i = 0; i < LH_K5_LIN; ++i) wd[i] = words[i];
  bool unit = chains;
#pragma unroll
  for (int i = 0; i < LH_K5_LIN; ++i)
    unit = unit && (!(wd[i] & kHas) || ((wd[i] >> 8) & 0xffffu) == 1u);
  if (unit) {
    uint32_t x[lh::NL];
    load_slot<P, SF>(slots, wd[0], acc);
    if (wd[0] & (1u << 24)) {
      lh::neg_mod(acc, x);
#pragma unroll
      for (int l = 0; l < lh::NL; ++l) acc[l] = x[l];
    }
#pragma unroll
    for (int i = 1; i < LH_K5_LIN; ++i) {
      if (wd[i] & kHas) {
        load_slot<P, SF>(slots, wd[i], x);
        if (wd[i] & (1u << 24)) {
          lh::sub_mod(acc, x, acc);
        } else {
          lh::add_mod(acc, x, acc);
        }
      }
    }
    return;
  }
  long long col[lh::NL];
#pragma unroll
  for (int l = 0; l < lh::NL; ++l) col[l] = 0;
  long long m = 0, bias = 0;
#pragma unroll
  for (int i = 0; i < LH_K5_LIN; ++i) {
    const uint32_t w = wd[i];
    if (w & kHas) {
      const uint32_t* src = slots + (w & 0xffu) * SF;
      const long long k = (w >> 8) & 0xffffu;
      const long long c = (w & (1u << 24)) ? -k : k;
      m += (w & (1u << 24)) ? k : 0;
      if constexpr (P < 32) {   // lanes of a warp differ: a signed multiply-add
        bias += c << 31;
#pragma unroll
        for (int l = 0; l < lh::NL; ++l) col[l] += c * signed_limb(src[l * P]);
      } else {
#pragma unroll
        for (int l = 0; l < lh::NL; ++l) col[l] += c * src[l * P];   // |c x| < 2^48
      }
    }
  }
  uint32_t v[lh::NL];
  long long carry = 0;   // arithmetic shift: v >= 0, so it ends non-negative
#pragma unroll
  for (int l = 0; l < lh::NL; ++l) {
    carry += col[l] + bias + m * lh::p_limb(l);
    v[l] = (uint32_t)carry;
    carry >>= 32;
  }
  const uint64_t hi = ((uint64_t)carry << 32) | v[lh::NL - 1];
  const long long q = (long long)((double)hi * LH_K5_INV_HI);
  long long br = 0;
#pragma unroll
  for (int l = 0; l < lh::NL; ++l) {
    br += (long long)v[l] - q * lh::p_limb(l);
    v[l] = (uint32_t)br;
    br >>= 32;
  }
  canonical(v, acc);   // v - q p is in [0, 2p)
}

// One product of the schedule, W = A B, 24 exact limbs into its column
// (`wide`, limb stride P). L = 1: the lane forms both operands (combine,
// one copy of its code), stages them in the column and runs all twelve rows
// (two carry chains a row). L = 2: sub-lane r forms operand r and stages
// it; each takes six rows of A times B (r 6 .. r 6 + 6), an exact partial
// of 18 limbs; sub-lane 1 leaves its partial beside the column, sub-lane 0
// adds it in at limb 6 (one carry chain) and stores the product.
template <int P, int SF, int L>
__device__ __forceinline__ void product(const uint32_t* rec, const uint32_t* slots,
                                        uint32_t* wide, int level, int r, unsigned pair) {
  // Level 0's operands are all sums and differences of slots, level 1's
  // mostly small multiples: where units or a pair's lanes share a warp,
  // level 1 takes the one-pass form for every operand, so no lane waits on
  // another path.
  const bool chains = level == 0 || (L == 1 && P == 32);
  if constexpr (L == 1) {
    uint32_t x[lh::NL], y[lh::NL], t[lh::NW + 1];
#pragma unroll 1
    for (int k = 0; k < 2; ++k) {
      combine<P, SF>(rec + k * LH_K5_LIN, slots, chains, x);
#pragma unroll
      for (int l = 0; l < lh::NL; ++l) wide[(k * lh::NL + l) * P] = x[l];
    }
#pragma unroll
    for (int l = 0; l < lh::NL; ++l) {
      x[l] = wide[l * P];
      y[l] = wide[(lh::NL + l) * P];
    }
    LH_K5_STAMP(level, 0);
    rows<lh::NL>(x, y, t);
    LH_K5_STAMP(level, 1);
#pragma unroll
    for (int c = 0; c < lh::NW; ++c) wide[c * P] = t[c];
  } else {
    constexpr int H = lh::NL / 2;
    uint32_t x[lh::NL], y[lh::NL], t[H + 13];
    combine<P, SF>(rec + r * LH_K5_LIN, slots, chains, x);
    LH_K5_STAMP(level, 0);
#pragma unroll
    for (int l = 0; l < lh::NL; ++l) wide[(r * lh::NL + l) * P] = x[l];
    __syncwarp(pair);
#pragma unroll
    for (int i = 0; i < H; ++i) x[i] = wide[(r * H + i) * P];
#pragma unroll
    for (int l = 0; l < lh::NL; ++l) y[l] = wide[(lh::NL + l) * P];
    rows<H>(x, y, t);
    LH_K5_STAMP(level, 1);
    uint32_t* part = wide + lh::NW * P;
    if (r) {
#pragma unroll
      for (int c = 0; c < H + 12; ++c) part[c * P] = t[c];
    }
    __syncwarp(pair);
    if (!r) {
      uint64_t c = 0;
#pragma unroll
      for (int col = 0; col < lh::NW; ++col) {
        c += (col < H + 13 ? (uint64_t)t[col] : 0) + (col >= H ? part[(col - H) * P] : 0u);
        wide[col * P] = (uint32_t)c;
        c >>= 32;
      }
    }
  }
}

// One reduction of the schedule: out = REDC(o p^2 + sum_i d_i W_i),
// canonical, in every lane of the unit. prod points at this point's column
// of product 0; `level` only names the stamps.
//   L = 1: the terms' signed column sums over all 24 columns (|sum| <
//   2^38), one carry pass, one REDC (redc_lane).
//   L = 2: sub-lane r sums columns [12 r, 12 r + 12); the sums meet in the
//   scratch and both lanes carry them into T's 24 limbs. REDC in two parts:
//   both lanes compute the quotient words m_i = t_i n0 with the products
//   that land below column 12 (78 multiply-adds, the carries into column 12
//   summed in ch); then the products m_i p_j that land at column 12 or above
//   (66) split by rows, sub-lane r taking m_{2k + r} times p's top 2k + r
//   limbs (sub-lane 0 padded with a zero limb, so both run 36), each into an
//   exact 12-limb partial H_r from column 12 up. The partials meet in the
//   scratch: u = T_hi + ch + H_0 + H_1 < 2 p, one subtraction.
template <int P, int SW, int L>
__device__ __forceinline__ void reduce(const uint32_t* rec, const uint32_t* prod,
                                       uint32_t* scratch, int q, int r, unsigned pair,
                                       int level, uint32_t* out) {
  constexpr int C = lh::NW / L;
  const uint32_t head = rec[0];
  long long s[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if constexpr (L == 1) {
      s[c] = (long long)(head & 0xffu) * p2_limb(c);
    } else {
      s[c] = (long long)(head & 0xffu) * (r ? p2_limb(C + c) : p2_limb(c));
    }
  }
  const int terms = (head >> 16) & 0xff;
  long long bias = 0;
#pragma unroll 1
  for (int i = 0; i < terms; ++i) {
    const uint32_t w = rec[1 + i];
    const uint32_t k = (w >> 8) & 0xffu;
    const uint32_t* src = prod + (w & 0xffu) * SW + r * C * P;
    if constexpr (P < 32) {   // lanes of a warp differ: one branch-free form
      const int d = ((w >> 16) & 1u) ? -(int)k : (int)k;
      bias += (long long)d << 31;
#pragma unroll
      for (int c = 0; c < C; ++c) s[c] += (long long)d * signed_limb(src[c * P]);
    } else if ((w >> 16) & 1u) {
#pragma unroll
      for (int c = 0; c < C; ++c) s[c] -= (long long)k * src[c * P];
    } else if (k == 1) {
#pragma unroll
      for (int c = 0; c < C; ++c) s[c] += src[c * P];
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) s[c] += (long long)k * src[c * P];
    }
  }
  LH_K5_STAMP(level, 4);
  uint32_t t[lh::NW];
  long long c = 0;   // arithmetic shift
  if constexpr (L == 1) {
#pragma unroll
    for (int col = 0; col < lh::NW; ++col) {
      c += s[col] + bias;
      t[col] = (uint32_t)c;
      c >>= 32;
    }
    LH_K5_STAMP(level, 5);
    redc_lane(t, out);
    LH_K5_STAMP(level, 6);
  } else {
    long long* sums = reinterpret_cast<long long*>(scratch) + q;
#pragma unroll
    for (int v = 0; v < C; ++v) sums[(r * C + v) * P] = s[v] + bias;
    __syncwarp(pair);
#pragma unroll
    for (int col = 0; col < lh::NW; ++col) {
      c += sums[col * P];
      t[col] = (uint32_t)c;
      c >>= 32;
    }
    LH_K5_STAMP(level, 5);
    // The quotient words, with the products below column 12.
    uint32_t m[lh::NL];
    uint64_t ch = 0;
#pragma unroll
    for (int i = 0; i < lh::NL; ++i) {
      m[i] = t[i] * lh::kN0;
      uint64_t cc = 0;
#pragma unroll
      for (int j = 0; i + j < lh::NL; ++j) {
        cc += (uint64_t)m[i] * lh::p_limb(j) + t[i + j];
        t[i + j] = (uint32_t)cc;
        cc >>= 32;
      }
      ch += cc;
    }
    // This lane's rows of the products at column 12 and above.
    uint32_t h[lh::NL];
#pragma unroll
    for (int v = 0; v < lh::NL; ++v) h[v] = 0;
#pragma unroll
    for (int k = 0; k < lh::NL / 2; ++k) {
      const uint32_t mi = r ? m[2 * k + 1] : m[2 * k];
      uint64_t cc = 0;
#pragma unroll
      for (int v = 0; v <= 2 * k; ++v) {
        const uint32_t pj = r ? lh::p_limb(11 - 2 * k + v) : v < 2 * k ? lh::p_limb(12 - 2 * k + v) : 0u;
        cc += (uint64_t)mi * pj + h[v];
        h[v] = (uint32_t)cc;
        cc >>= 32;
      }
      h[2 * k + 1] = (uint32_t)cc;
    }
    LH_K5_STAMP(level, 6);
    uint32_t* hs = scratch + 2 * lh::NW * P + q;
#pragma unroll
    for (int v = 0; v < lh::NL; ++v) hs[(r * lh::NL + v) * P] = h[v];
    __syncwarp(pair);
    uint32_t u[lh::NL];
    uint64_t cu = 0;
#pragma unroll
    for (int l = 0; l < lh::NL; ++l) {
      cu += (uint64_t)t[lh::NL + l] + hs[l * P] + hs[(lh::NL + l) * P];
      if (l == 0) cu += (uint32_t)ch;
      if (l == 1) cu += (uint32_t)(ch >> 32);
      u[l] = (uint32_t)cu;
      cu >>= 32;
    }
    canonical(u, out);
  }
}

template <class K, int P, int L>
__global__ void __launch_bounds__(Shape<K, P, L>::warps * 32, Shape<K, P, L>::min_blocks)
curve_kernel(uint32_t* __restrict__ out, uint32_t* __restrict__ line, const Operands ops,
             Grid g) {
  using S = Shape<K, P, L>;
  extern __shared__ __align__(16) uint32_t smem[];
  const int r = threadIdx.x % L, up = threadIdx.x / L;
  const int u = up / P, q = up % P;   // unit, point
  const unsigned pair = L == 1 ? 1u << (threadIdx.x & 31) : 3u << (threadIdx.x & 30);
  uint32_t* plan = smem;
  uint32_t* slots = smem + S::plan + q;
  uint32_t* prod = smem + S::plan + K::slots * S::fp + q;
  uint32_t* scratch = smem + S::plan + K::slots * S::fp + K::wide * S::wide + u * S::rs;

  // Load: unit f < inputs loads input Fp f of its point: below the points'
  // 3 comps Fp values each, of point operand f / (3 comps), coordinate
  // (f / comps) % 3, component f % comps; past them, P's coordinate
  // operand; sub-lane r its limbs r + L i. Every thread loads its share of
  // the schedule. All loads are issued before the first shared store (a
  // warp issues in order: a store waiting on its load would hold back the
  // loads after it). A point past the end computes on zeros and stores
  // nothing.
  static_assert(K::inputs <= K::warps, "one input Fp per unit");
  constexpr int kThreads = S::warps * 32;
  constexpr int kPer = (K::words + kThreads - 1) / kThreads;
  LH_K5_STAMP(-1, 0);
  const uint32_t e = blockIdx.x * P + q;
  const bool live = e < g.total;
  const uint32_t row = live ? e / g.n : 0, j = live ? e - row * g.n : 0;
  const uint32_t r1 = row / g.r0, r0 = row - r1 * g.r0;
  uint32_t x[lh::NL / L], pw[kPer];
  constexpr int kPt = 3 * K::comps;             // Fp values a point
  constexpr int kPts = K::inputs - K::fps;        // the points' Fp values
  if (u < K::inputs) {
    const int o = u < kPts ? u / kPt : kPts / kPt + (u - kPts);
    const int f = u < kPts ? u % kPt : 0;
    const Geom gm = ops.geom[o];
    const uint32_t* src = ops.ptr[o] + r1 * gm.s1 + r0 * gm.s0 + (f / K::comps) * gm.sc +
                          (f % K::comps) * gm.sk + j * gm.sn;
#pragma unroll
    for (int i = 0; i < lh::NL / L; ++i) x[i] = live ? __ldg(src + (r + L * i) * gm.sl) : 0u;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    pw[k] = i < K::words ? K::plan()[i] : 0u;
  }
  if (u < K::inputs) {
#pragma unroll
    for (int i = 0; i < lh::NL / L; ++i) slots[u * S::fp + (r + L * i) * P] = x[i];
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < K::words) plan[i] = pw[k];
  }
  LH_K5_STAMP(-1, 1);
  __syncthreads();

  // The levels (two for K5, three for K6), one copy of their code:
  // products, then reductions, each into its slot (every product of the
  // level has read the slots by the barrier between) or, the last level's
  // and those flagged kOut, into the output (rows, 3, comps, 12, n), Fp
  // index coordinate * comps + component, the indices past the point's
  // into the line (K6, the same layout); both lanes of a unit hold the
  // value and store all its limbs.
  const uint32_t* rec = plan;
  const long long fp = lh::NL * (long long)g.n;
#pragma unroll 1
  for (int level = 0; level < K::levels; ++level) {
    const int np = level == 0 ? K::np0 : level == 1 ? K::np1 : K::np2;
    const int nr = level == 0 ? K::nr0 : level == 1 ? K::nr1 : K::nr2;
    if (u < np) product<P, S::fp, L>(rec + u * kMulWords, slots, prod + u * S::wide, level, r, pair);
    LH_K5_STAMP(level, 2);
    rec += np * kMulWords;
    __syncthreads();
    LH_K5_STAMP(level, 3);
    if (u < nr) {
      const uint32_t* rr = rec + u * kRedWords;
      uint32_t v[lh::NL];
      reduce<P, S::wide, L>(rr, prod, scratch, q, r, pair, level, v);
      LH_K5_STAMP(level, 7);
      const uint32_t dest = (rr[0] >> 8) & 0xffu;
      if (level == K::levels - 1 || (rr[0] & kOut)) {
        if (live) {
          uint32_t* dst = (dest < kPt ? out : line) + row * (kPt * fp) + (dest % kPt) * fp + j;
#pragma unroll
          for (int l = 0; l < lh::NL; ++l) dst[l * (long long)g.n] = v[l];
        }
      } else {
#pragma unroll
        for (int l = 0; l < lh::NL; ++l) slots[dest * S::fp + l * P] = v[l];
      }
    }
    rec += nr * kRedWords;
    __syncthreads();
    LH_K5_STAMP(level, 8);
  }
}

__global__ void empty_kernel() {}

// Allows the kernel its dynamic shared memory on the current device, once.
template <class K, int P, int L>
int allow_smem() {
  static std::atomic<unsigned long long> done{0};   // a bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return 0;
  e = cudaFuncSetAttribute(curve_kernel<K, P, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           4 * Shape<K, P, L>::words);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_acq_rel);
  return (int)e;
}

// The layout for a call of `points` points: up to 1024, where one lane a
// point (32 points a block) would leave most of the card idle, pairs of
// lanes a unit and 4 points a block, which spread the call over more SMs
// and halve each lane's chains; from 1025, where the grid fills the card,
// one lane a unit at kLaneP points a block: 32 (no divergence, no
// exchanges) where the block stays within 576 threads, else 16 (K6's 24 and
// 30 units a point: 384 and 480 threads, where 32 points would hold 768
// and 960 threads of at most 85 and 68 registers).
constexpr long long kPairsUpTo = 1024;
constexpr int kLaneThreads = 576;
template <class K>
constexpr int kLaneP = K::warps * 32 <= kLaneThreads ? 32 : 16;

template <class K, int P, int L>
int run(void* out, void* line, const Operands& ops, Grid g, void* stream) {
  const int e = allow_smem<K, P, L>();
  if (e != 0) return e;
  curve_kernel<K, P, L><<<(g.total + P - 1) / P, Shape<K, P, L>::warps * 32,
                          4 * Shape<K, P, L>::words, (cudaStream_t)stream>>>(
      (uint32_t*)out, (uint32_t*)line, ops, g);
  return (int)cudaGetLastError();
}

// ops: the operands' pointers in the schedule's order (the points, then
// P's coordinates). geom: null for dense points (each of the output's
// shape and contiguous; K6 always passes one), else r0 and then each
// operand's six element strides s1, s0 (the two row levels), sc
// (coordinate), sk (component), sl (limb) and sn (column).
template <class K>
int launch(void* out, void* line, const void* const* ops, long long rows, long long n,
           const long long* geom, void* stream) {
  constexpr int kOps = (K::inputs - K::fps) / (3 * K::comps) + K::fps;
  static_assert(kOps <= kMaxOps, "operands");
  const long long fp = lh::NL * n;
  const long long r0 = geom ? geom[0] : rows;
  if (rows * n >= (1ll << 31) || r0 < 1 || rows % r0 != 0 || (K::fps && !geom))
    return (int)cudaErrorInvalidValue;
  Operands o{};
  for (int k = 0; k < kOps; ++k) {
    const long long* s = geom ? geom + 1 + 6 * k : nullptr;
    o.ptr[k] = (const uint32_t*)ops[k];
    o.geom[k] = s ? Geom{s[0], s[1], s[2], s[3], s[4], s[5]}
                  : Geom{0, 3 * K::comps * fp, K::comps * fp, fp, n, 1};
  }
  const Grid g{(uint32_t)(rows * n), (uint32_t)n, (uint32_t)r0};
  return rows * n <= kPairsUpTo ? run<K, 4, 2>(out, line, o, g, stream)
                                : run<K, kLaneP<K>, 1>(out, line, o, g, stream);
}

// An empty kernel on K's grid for (rows, n) (the layout the launcher picks:
// its blocks and warps): the launch floor a kernel is timed against
// (chip_smoke.py floor_ms). Not a kernel of the port.
template <class K>
int empty_launch(long long rows, long long n, void* stream) {
  const long long points = rows * n;
  const bool pairs = points <= kPairsUpTo;
  const int p = pairs ? 4 : kLaneP<K>;
  const int warps = pairs ? Shape<K, 4, 2>::warps : Shape<K, kLaneP<K>, 1>::warps;
  empty_kernel<<<(unsigned)((points + p - 1) / p), warps * 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lh_g1_add(void* out, const void* a, const void* b, long long rows, long long n,
                         const long long* geom, void* stream) {
  const void* ops[] = {a, b};
  return launch<K5G1Add>(out, nullptr, ops, rows, n, geom, stream);
}

extern "C" int lh_g1_dbl(void* out, const void* a, long long rows, long long n,
                         const long long* geom, void* stream) {
  return launch<K5G1Double>(out, nullptr, &a, rows, n, geom, stream);
}

extern "C" int lh_g2_add(void* out, const void* a, const void* b, long long rows, long long n,
                         const long long* geom, void* stream) {
  const void* ops[] = {a, b};
  return launch<K5G2Add>(out, nullptr, ops, rows, n, geom, stream);
}

extern "C" int lh_g2_dbl(void* out, const void* a, long long rows, long long n,
                         const long long* geom, void* stream) {
  return launch<K5G2Double>(out, nullptr, &a, rows, n, geom, stream);
}

// K6: 2T (into out) and the tangent line at T evaluated at P (into line),
// T (rows, 3, 2, 12, n), px, py, pz (rows, 12, n), as the geometry says.
extern "C" int lh_miller_dbl(void* out, void* line, const void* t, const void* px,
                             const void* py, const void* pz, long long rows, long long n,
                             const long long* geom, void* stream) {
  const void* ops[] = {t, px, py, pz};
  return launch<K6MillerDbl>(out, line, ops, rows, n, geom, stream);
}

// K6: T + Q and the line through T and Q evaluated at P.
extern "C" int lh_miller_add(void* out, void* line, const void* t, const void* q,
                             const void* px, const void* py, const void* pz, long long rows,
                             long long n, const long long* geom, void* stream) {
  const void* ops[] = {t, q, px, py, pz};
  return launch<K6MillerAdd>(out, line, ops, rows, n, geom, stream);
}

// The floors: an empty kernel on G1 add's grid (K5) and on the doubling
// step's (K6).
extern "C" int lh_curve_empty(void* out, long long rows, long long n, void* stream) {
  (void)out;
  return empty_launch<K5G1Add>(rows, n, stream);
}

extern "C" int lh_miller_empty(void* out, long long rows, long long n, void* stream) {
  (void)out;
  return empty_launch<K6MillerDbl>(rows, n, stream);
}

#ifdef LH_K5_STAMPS
// The last call's stamps, 3 x 9 cycle counts (0: not reached), into `host`.
extern "C" int lh_k5_stamps(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_k5_stamp, sizeof(g_k5_stamp));
}
#endif
