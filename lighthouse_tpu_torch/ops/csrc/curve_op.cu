// K5: the complete G1 / G2 group law, p + q and 2 p, one launch a call, over
// projective points (X : Y : Z) in Montgomery limbs, canonical in [0, p):
//   G1 (..., 3, 12, n)        G2 (..., 3, 2, 12, n)
// K6 (below K5, the same engine): a Miller loop's whole T chain (its
// doubling and addition steps and their lines), one launch a loop.
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
// K6: a Miller loop's T chain for n pairs: from T, with Q (..., 3, 2, 12,
// n) and P's px, py, pz (..., 12, n), read in place as p_proj.select(-3, i)
// gives them, the steps of fused.MILLER_STEPS (63 doublings, 2T and the
// tangent line at T, and 5 additions, T + Q and the line through T and Q,
// each line evaluated at P and homogenized by its Z), one launch. No Pallas
// kernel computes these either: lighthouse_tpu/ops/bm/pairing.py:24
// _dbl_step and :63 _add_step are array code that XLA fuses into the
// lax.scan bodies at :107 / :112. The port ran them as 30 and 18 kernels a
// step, then as one launch a step on this engine at three levels (0.011-
// 0.012 ms a step at 2-65 pairs, 10-12x the launch floor, 0.758 ms a
// loop). Now a block loads T, Q and P once into slots 0-14 and
// walks the steps (a bit each in the launch's arguments), each step two
// levels of the same engine:
//   doubling  level 0 Y^2, YZ, Z^2, XY, X^2 and Z py, Z px, X pz, Z pz (20
//             Fp products, 18 reductions); level 1 K5's doubling products
//             and the line from level 0's values, l0 = 2 xi (YZ)(Z py), l1
//             = (3 X^2)(X pz) - (2 Y^2)(Z pz), l2 = -(3 X^2)(Z px) (24, 12);
//   addition  level 0 K5's g2_add products, yq Z1, xq Z1, Y1 zq, X1 zq and
//             Z1 py, Z1 px, X1 pz, Y1 pz (38, 24: n and d folded into the
//             reductions); level 1 K5's and l0 = xi d (Z1 py), l1 = n (X1
//             pz) - d (Y1 pz), l2 = -n (Z1 px) (30, 12).
// Level 1 reads no input, so level 0's values may take T's slots, never
// Q's or P's (fused.K6_KEPT); level 1's six point reductions go back into
// T's slots (the output's Fp index is the slot) and, at the last step, to
// the output T, its six line reductions to lines[step] (steps, ..., 3, 2,
// 12, n), the layout K3's fp12_mul_line reads. A small multiple that would
// take a reduction past 9 p^2 (3 X^2, 2 Y^2) is an operand's. The steps
// need 10,656 and 14,976 multiply-adds a pair (the three-level schedules'
// 10,368 and 14,400: two more Fp products a step for folding the line into
// level 1) against 19,584 bytes of lines a pair a loop: bound by
// operations. The one-step calls (fused.miller_dbl / miller_add) are this
// kernel on a chain of one step.
// Layouts: up to 1024 pairs, pairs of lanes at LH_K6_PAIR_P pairs a block
// with 38 units a pair (the addition's level 0: every level in one round);
// from 1025, one lane a unit at 16 pairs a block with the doubling's 24
// units (384 threads, two blocks an SM; an addition's levels take two
// rounds of 24).
// On the card (graph-replay ms a Miller loop, NVIDIA H100 80GB HBM3, 700 W,
// chip_smoke.py, parent and this source in one call): 68 launches of the
// three-level steps 0.758 / 0.758 / 1.604 / 6.006 at 2 / 65 / 4097 / 16385
// pairs, the chain 0.418-0.421 / 0.422-0.425 / 1.335 / 5.098-5.099, about
// 6.2 us a step at 2-65 pairs (5.6x the launch floor a step where the
// three-level steps ran 10-12x); bound 4.3e-5 / 0.0028 / 0.177 / 0.709
// (operations). Pairs a block in the pairs layout (scripts/probe_k6.py,
// the three builds in turns, ms at 2 / 65 pairs): 1: 0.426 / 0.429, 2:
// 0.422 / 0.425 (kept), 4: 0.479 / 0.480: at 4 pairs ten warps share an
// SM's four schedulers on one block's path, at 1 three. The one-step calls
// (a chain of one) run 0.0082-0.0085 (doubling) and 0.0091-0.0096
// (addition) at 2-65 pairs, where the three-level steps ran 0.0110 and
// 0.0122-0.0124. Resources (ptxas, sm_90a, nvcc 12.9, no spills): 92
// registers a thread in the pairs layout at 2 pairs a block (94 at 1, 92
// at 4), 79 in the one-lane layout; shared memory, dynamic, per block:
// the two schedules (1,556 words), 33 slots, 38 product columns and, in
// pairs, 40 units' exchange: 46.1 KB at 2 pairs a block (allowed above 48
// KB as K5's), 94.5 KB at 16 pairs one lane.
#include <atomic>

#include "fp.cuh"
#include "curve_plan.h"

// Pairs a block in K6's pairs layout (1, 2 or 4: scripts/probe_k6.py builds
// each and times the chain at 2 and 65 pairs; 2 was the fastest).
#ifndef LH_K6_PAIR_P
#define LH_K6_PAIR_P 2
#endif

namespace {

constexpr int kMulWords = 2 * LH_K5_LIN;
constexpr int kRedWords = 1 + LH_K5_RED;
constexpr uint32_t kHas = 1u << 31;

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
// (K5: p, then q for an add; K6: T, then Q), then P's coordinates px, py,
// pz (K6), each an Fp read with stride 0 on the coordinate and component
// axes.
constexpr int kMaxOps = 5;
struct Operands {
  const uint32_t* ptr[kMaxOps];
  Geom geom[kMaxOps];
};

// K6's steps: their count and a bit a step, set for an addition.
constexpr int kMaxSteps = 128;
struct Steps {
  uint32_t count;
  uint32_t adds[kMaxSteps / 32];
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

// A limb x as the signed x - 2^31, so that a small signed multiple d x is
// one signed multiply-add and a bias d 2^31 the caller adds once.
__device__ __forceinline__ int signed_limb(uint32_t x) { return (int)(x ^ 0x80000000u); }

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
// (negated if need be), the others by fp.cuh's chains (lh::add_mod, sub_mod).
// Otherwise (small multiples, 3 to 72, or any operand where the caller
// wants one form) in one pass: the terms' signed column sums, then
// lh::sum_mod (fp.cuh, K4's arithmetic too): plus m p (m the subtracted
// |c_k|), one carry pass into v in [0, (sum |c_k|) p), a quotient estimate
// floor(v / p) or one less, one conditional subtraction.
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
  lh::sum_mod(col, bias, m, acc);
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
    lh::rows<lh::NL>(x, y, t);
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
    lh::rows<H>(x, y, t);
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
    lh::redc_lane(t, out);
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
    lh::canonical(u, out);
  }
}

// Input Fp f of a point (row r1, r0, column j), sub-lane r's limbs r + L i
// into x (zeros for a point past the end): below the points' 3 comps Fp
// values each, of point operand f / (3 comps), coordinate (f / comps) % 3,
// component f % comps; past them, P's coordinate operand.
template <int L, int kInputs, int kFps, int kComps>
__device__ __forceinline__ void fetch(const Operands& ops, int f, int r, bool live, uint32_t r1,
                                      uint32_t r0, uint32_t j, uint32_t* x) {
  constexpr int kPt = 3 * kComps;               // Fp values a point
  constexpr int kPts = kInputs - kFps;          // the points' Fp values
  const int o = f < kPts ? f / kPt : kPts / kPt + (f - kPts);
  const int c = f < kPts ? f % kPt : 0;
  const Geom gm = ops.geom[o];
  const uint32_t* src =
      ops.ptr[o] + r1 * gm.s1 + r0 * gm.s0 + (c / kComps) * gm.sc + (c % kComps) * gm.sk + j * gm.sn;
#pragma unroll
  for (int i = 0; i < lh::NL / L; ++i) x[i] = live ? __ldg(src + (r + L * i) * gm.sl) : 0u;
}

template <class K, int P, int L>
__global__ void __launch_bounds__(Shape<K, P, L>::warps * 32, Shape<K, P, L>::min_blocks)
curve_kernel(uint32_t* __restrict__ out, const Operands ops, Grid g) {
  using S = Shape<K, P, L>;
  extern __shared__ __align__(16) uint32_t smem[];
  const int r = threadIdx.x % L, up = threadIdx.x / L;
  const int u = up / P, q = up % P;   // unit, point
  const unsigned pair = L == 1 ? 1u << (threadIdx.x & 31) : 3u << (threadIdx.x & 30);
  uint32_t* plan = smem;
  uint32_t* slots = smem + S::plan + q;
  uint32_t* prod = smem + S::plan + K::slots * S::fp + q;
  uint32_t* scratch = smem + S::plan + K::slots * S::fp + K::wide * S::wide + u * S::rs;

  // Load: unit f < inputs loads input Fp f of its point (fetch), every
  // thread its share of the schedule. All loads are issued before the
  // first shared store (a warp issues in order: a store waiting on its load
  // would hold back the loads after it). A point past the end computes on
  // zeros and stores nothing.
  static_assert(K::inputs <= K::warps, "one input Fp per unit");
  constexpr int kThreads = S::warps * 32;
  constexpr int kPer = (K::words + kThreads - 1) / kThreads;
  LH_K5_STAMP(-1, 0);
  const uint32_t e = blockIdx.x * P + q;
  const bool live = e < g.total;
  const uint32_t row = live ? e / g.n : 0, j = live ? e - row * g.n : 0;
  const uint32_t r1 = row / g.r0, r0 = row - r1 * g.r0;
  uint32_t x[lh::NL / L], pw[kPer];
  if (u < K::inputs) fetch<L, K::inputs, K::fps, K::comps>(ops, u, r, live, r1, r0, j, x);
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

  // The two levels, one copy of their code: products, then reductions,
  // level 0's each into its slot (every product of the level has read the
  // slots by the barrier between), level 1's into the output (rows, 3,
  // comps, 12, n), Fp index coordinate * comps + component; both lanes of
  // a unit hold the value and store all its limbs.
  const uint32_t* rec = plan;
  const long long fp = lh::NL * (long long)g.n;
#pragma unroll 1
  for (int level = 0; level < 2; ++level) {
    const int np = level == 0 ? K::np0 : K::np1;
    const int nr = level == 0 ? K::nr0 : K::nr1;
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
      if (level == 1) {
        if (live) {
          uint32_t* dst = out + row * (3 * K::comps * fp) + dest * fp + j;
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

// K6's block: P pairs, L lanes a unit, at least kUnits units a pair (whole
// warps: `units`); a level's products and reductions run in rounds of
// `units`. Shared memory as K5's (Shape), for both steps: their schedules
// (the doubling's words, then the addition's), the larger slot count and
// product count, a pair's exchange per unit, its 64-bit sums 8-byte
// aligned for an odd P too (`scratch`, and rs rounded up to even).
template <int P, int L, int kUnits>
struct ChainShape {
  using D = K6MillerDbl;
  using A = K6MillerAdd;
  static constexpr int V = 32 / (P * L);
  static constexpr int warps = (kUnits + V - 1) / V;
  static constexpr int units = warps * V;
  static constexpr int fp = 13 * P;
  static constexpr int wide = (L == 1 ? 25 : 43) * P;
  static constexpr int rs = L == 1 ? 0 : (73 * P + 1) / 2 * 2;
  static constexpr int plan = (D::words + A::words + 3) / 4 * 4;
  static constexpr int slots = D::slots > A::slots ? D::slots : A::slots;
  static constexpr int products = D::wide > A::wide ? D::wide : A::wide;
  static constexpr int scratch = (plan + slots * fp + products * wide + 1) / 2 * 2;
  static constexpr int words = scratch + units * rs;
  static constexpr int min_blocks = L == 1 && warps * 32 <= 384 ? 2 : 1;
};

// K6: a Miller loop's T chain for one pair a point of the grid. T, Q and
// P load once into slots 0-14; each step runs the doubling's or the
// addition's schedule (two levels); level 1's reductions write the new T
// into T's slots 0-5 (the output's Fp index is its slot) and, at the last
// step, to t_out, and the line (Fp indices 6-11) to lines[step] (steps,
// rows, 3, 2, 12, n). No step's level-0 reduction takes Q's or P's slots
// (fused.K6_KEPT), and level 1 reads no input, so T's slots are free to
// take level 0's values.
template <int P, int L, int kUnits>
__global__ void __launch_bounds__(ChainShape<P, L, kUnits>::warps * 32,
                                  ChainShape<P, L, kUnits>::min_blocks)
chain_kernel(uint32_t* __restrict__ t_out, uint32_t* __restrict__ lines, const Operands ops,
             Grid g, const Steps steps) {
  using S = ChainShape<P, L, kUnits>;
  using D = K6MillerDbl;
  using A = K6MillerAdd;
  static_assert(D::inputs == A::inputs && D::fps == 3 && A::fps == 3 && D::comps == 2 &&
                    A::comps == 2 && D::inputs <= S::units,
                "K6's steps share their inputs, one input Fp per unit");
  extern __shared__ __align__(16) uint32_t smem[];
  const int r = threadIdx.x % L, up = threadIdx.x / L;
  const int u = up / P, q = up % P;   // unit, pair
  const unsigned pair = L == 1 ? 1u << (threadIdx.x & 31) : 3u << (threadIdx.x & 30);
  uint32_t* plan = smem;
  uint32_t* slots = smem + S::plan + q;
  uint32_t* prod = smem + S::plan + S::slots * S::fp + q;
  uint32_t* scratch = smem + S::scratch + u * S::rs;

  // Load, as K5's.
  constexpr int kThreads = S::warps * 32;
  constexpr int kWords = D::words + A::words;
  constexpr int kPer = (kWords + kThreads - 1) / kThreads;
  const uint32_t e = blockIdx.x * P + q;
  const bool live = e < g.total;
  const uint32_t row = live ? e / g.n : 0, j = live ? e - row * g.n : 0;
  const uint32_t r1 = row / g.r0, r0 = row - r1 * g.r0;
  uint32_t x[lh::NL / L], pw[kPer];
  if (u < D::inputs) fetch<L, D::inputs, D::fps, D::comps>(ops, u, r, live, r1, r0, j, x);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    pw[k] = i < D::words ? D::plan()[i] : i < kWords ? A::plan()[i - D::words] : 0u;
  }
  if (u < D::inputs) {
#pragma unroll
    for (int i = 0; i < lh::NL / L; ++i) slots[u * S::fp + (r + L * i) * P] = x[i];
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < kWords) plan[i] = pw[k];
  }
  __syncthreads();

  const long long fp = lh::NL * (long long)g.n;
  const long long at = row * (6 * fp) + j;                  // this pair's limb 0 of Fp 0
  const long long per_line = (long long)g.total * 6 * lh::NL;
#pragma unroll 1
  for (uint32_t s = 0; s < steps.count; ++s) {
    const bool add = (steps.adds[s >> 5] >> (s & 31)) & 1u;
    const bool last = s + 1 == steps.count;
    const uint32_t* rec = plan + (add ? D::words : 0);
#pragma unroll 1
    for (int level = 0; level < 2; ++level) {
      const int np = level == 0 ? (add ? A::np0 : D::np0) : (add ? A::np1 : D::np1);
      const int nr = level == 0 ? (add ? A::nr0 : D::nr0) : (add ? A::nr1 : D::nr1);
#pragma unroll 1
      for (int k = u; k < np; k += S::units)
        product<P, S::fp, L>(rec + k * kMulWords, slots, prod + k * S::wide, level, r, pair);
      rec += np * kMulWords;
      __syncthreads();
#pragma unroll 1
      for (int k = u; k < nr; k += S::units) {
        const uint32_t* rr = rec + k * kRedWords;
        uint32_t v[lh::NL];
        reduce<P, S::wide, L>(rr, prod, scratch, q, r, pair, level, v);
        const uint32_t dest = (rr[0] >> 8) & 0xffu;
        if (level == 0 || dest < 6) {
#pragma unroll
          for (int l = 0; l < lh::NL; ++l) slots[dest * S::fp + l * P] = v[l];
        }
        if (level == 1 && live && (dest >= 6 || last)) {
          uint32_t* dst = (dest < 6 ? t_out + dest * fp : lines + s * per_line + (dest - 6) * fp) + at;
#pragma unroll
          for (int l = 0; l < lh::NL; ++l) dst[l * (long long)g.n] = v[l];
        }
      }
      rec += nr * kRedWords;
      __syncthreads();
    }
  }
}

__global__ void empty_kernel() {}

// Allows `kernel` `bytes` of dynamic shared memory on the current device,
// once per device (`done`, a bit each).
template <class F>
int allow_smem(F* kernel, int bytes, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_acq_rel);
  return (int)e;
}

// The layout for a call of `points` points: up to 1024, where one lane a
// point (32 points a block) would leave most of the card idle, pairs of
// lanes a unit and 4 points a block, which spread the call over more SMs
// and halve each lane's chains; from 1025, where the grid fills the card,
// one lane a unit at kLaneP points a block: 32 (no divergence, no
// exchanges) where the block stays within kLaneThreads threads (every K5
// operation), else 16.
constexpr long long kPairsUpTo = 1024;
constexpr int kLaneThreads = 576;
template <class K>
constexpr int kLaneP = K::warps * 32 <= kLaneThreads ? 32 : 16;

template <class K, int P, int L>
int run(void* out, const Operands& ops, Grid g, void* stream) {
  static std::atomic<unsigned long long> done{0};
  const int e = allow_smem(curve_kernel<K, P, L>, 4 * Shape<K, P, L>::words, done);
  if (e != 0) return e;
  curve_kernel<K, P, L><<<(g.total + P - 1) / P, Shape<K, P, L>::warps * 32,
                          4 * Shape<K, P, L>::words, (cudaStream_t)stream>>>((uint32_t*)out, ops, g);
  return (int)cudaGetLastError();
}

// ops: the operands' pointers in the schedule's order (the points, then
// P's coordinates). geom: null for dense operands (each of the output's
// shape and contiguous), else r0 and then each operand's six element
// strides s1, s0 (the two row levels), sc (coordinate), sk (component), sl
// (limb) and sn (column). -> 0, or cudaErrorInvalidValue for a grid past
// 2^31 points or rows that fold into no (r1, r0).
int operands(const void* const* ops, int count, int comps, long long rows, long long n,
             const long long* geom, Operands* o, Grid* g) {
  const long long fp = lh::NL * n;
  const long long r0 = geom ? geom[0] : rows;
  if (rows * n >= (1ll << 31) || r0 < 1 || rows % r0 != 0) return (int)cudaErrorInvalidValue;
  *o = Operands{};
  for (int k = 0; k < count; ++k) {
    const long long* s = geom ? geom + 1 + 6 * k : nullptr;
    o->ptr[k] = (const uint32_t*)ops[k];
    o->geom[k] = s ? Geom{s[0], s[1], s[2], s[3], s[4], s[5]}
                   : Geom{0, 3 * comps * fp, comps * fp, fp, n, 1};
  }
  *g = Grid{(uint32_t)(rows * n), (uint32_t)n, (uint32_t)r0};
  return 0;
}

template <class K>
int launch(void* out, const void* const* ops, long long rows, long long n, const long long* geom,
           void* stream) {
  constexpr int kOps = K::inputs / (3 * K::comps);
  static_assert(kOps <= kMaxOps && K::fps == 0, "operands");
  Operands o;
  Grid g;
  const int e = operands(ops, kOps, K::comps, rows, n, geom, &o, &g);
  if (e != 0) return e;
  return rows * n <= kPairsUpTo ? run<K, 4, 2>(out, o, g, stream)
                                : run<K, kLaneP<K>, 1>(out, o, g, stream);
}

// K6's layouts: up to kPairsUpTo pairs, pairs of lanes at LH_K6_PAIR_P
// pairs a block with every unit either step's level needs (one round);
// from 1025, where the grid fills the card, one lane a unit at 16 pairs a
// block with the doubling's units (an addition's levels take two rounds):
// 384 threads, two blocks an SM.
constexpr int kChainPairP = LH_K6_PAIR_P;
constexpr int kChainUnits =
    K6MillerAdd::warps > K6MillerDbl::warps ? K6MillerAdd::warps : K6MillerDbl::warps;
constexpr int kChainLaneP = 16;
constexpr int kChainLaneUnits = K6MillerDbl::warps;
static_assert(kChainPairP == 1 || kChainPairP == 2 || kChainPairP == 4, "LH_K6_PAIR_P");

template <int P, int L, int U>
int run_chain(void* t_out, void* lines, const Operands& ops, Grid g, const Steps& steps,
              void* stream) {
  using S = ChainShape<P, L, U>;
  static std::atomic<unsigned long long> done{0};
  const int e = allow_smem(chain_kernel<P, L, U>, 4 * S::words, done);
  if (e != 0) return e;
  chain_kernel<P, L, U><<<(g.total + P - 1) / P, S::warps * 32, 4 * S::words,
                          (cudaStream_t)stream>>>((uint32_t*)t_out, (uint32_t*)lines, ops, g,
                                                  steps);
  return (int)cudaGetLastError();
}

// An empty kernel on a launch's grid for (rows, n) (the layout the
// launcher picks: its blocks and warps): the launch floor a kernel is
// timed against (chip_smoke.py floor_ms). Not a kernel of the port.
int empty_launch(long long points, int p, int warps, void* stream) {
  empty_kernel<<<(unsigned)((points + p - 1) / p), warps * 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lh_g1_add(void* out, const void* a, const void* b, long long rows, long long n,
                         const long long* geom, void* stream) {
  const void* ops[] = {a, b};
  return launch<K5G1Add>(out, ops, rows, n, geom, stream);
}

extern "C" int lh_g1_dbl(void* out, const void* a, long long rows, long long n,
                         const long long* geom, void* stream) {
  return launch<K5G1Double>(out, &a, rows, n, geom, stream);
}

extern "C" int lh_g2_add(void* out, const void* a, const void* b, long long rows, long long n,
                         const long long* geom, void* stream) {
  const void* ops[] = {a, b};
  return launch<K5G2Add>(out, ops, rows, n, geom, stream);
}

extern "C" int lh_g2_dbl(void* out, const void* a, long long rows, long long n,
                         const long long* geom, void* stream) {
  return launch<K5G2Double>(out, &a, rows, n, geom, stream);
}

// K6: `count` Miller steps from T (rows, 3, 2, 12, n) with Q and P's
// coordinates px, py, pz (rows, 12, n), as the geometry says (always
// given); kinds[s] is 0 for a doubling, 1 for an addition. The last T
// goes to t_out (rows, 3, 2, 12, n), step s's line to lines + s (rows, 3,
// 2, 12, n) elements.
extern "C" int lh_miller_chain(void* t_out, void* lines, const void* t, const void* q,
                               const void* px, const void* py, const void* pz, long long rows,
                               long long n, const unsigned char* kinds, long long count,
                               const long long* geom, void* stream) {
  if (count < 1 || count > kMaxSteps || !geom) return (int)cudaErrorInvalidValue;
  Steps steps{};
  steps.count = (uint32_t)count;
  for (int s = 0; s < count; ++s)
    if (kinds[s]) steps.adds[s >> 5] |= 1u << (s & 31);
  const void* ops[] = {t, q, px, py, pz};
  Operands o;
  Grid g;
  const int e = operands(ops, kMaxOps, 2, rows, n, geom, &o, &g);
  if (e != 0) return e;
  return rows * n <= kPairsUpTo
             ? run_chain<kChainPairP, 2, kChainUnits>(t_out, lines, o, g, steps, stream)
             : run_chain<kChainLaneP, 1, kChainLaneUnits>(t_out, lines, o, g, steps, stream);
}

// The floors: an empty kernel on G1 add's grid (K5) and on the chain's
// (K6).
extern "C" int lh_curve_empty(void* out, long long rows, long long n, void* stream) {
  (void)out;
  const long long points = rows * n;
  return points <= kPairsUpTo
             ? empty_launch(points, 4, Shape<K5G1Add, 4, 2>::warps, stream)
             : empty_launch(points, kLaneP<K5G1Add>,
                            Shape<K5G1Add, kLaneP<K5G1Add>, 1>::warps, stream);
}

extern "C" int lh_miller_empty(void* out, long long rows, long long n, void* stream) {
  (void)out;
  const long long points = rows * n;
  return points <= kPairsUpTo
             ? empty_launch(points, kChainPairP, ChainShape<kChainPairP, 2, kChainUnits>::warps,
                            stream)
             : empty_launch(points, kChainLaneP,
                            ChainShape<kChainLaneP, 1, kChainLaneUnits>::warps, stream);
}

#ifdef LH_K5_STAMPS
// The last call's stamps, 3 x 9 cycle counts (0: not reached), into `host`.
extern "C" int lh_k5_stamps(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_k5_stamp, sizeof(g_k5_stamp));
}
#endif
