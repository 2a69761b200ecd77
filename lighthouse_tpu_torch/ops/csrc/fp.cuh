// BLS12-381 base-field arithmetic for one element per thread (sm_90a).
//
// An Fp value is 12 little-endian 32-bit limbs in Montgomery form
// (x * 2^384 mod p), canonical in [0, p). Tensors are batch-minor: limb l
// of element (row r, lane i) lives at r * stride + l * n + i, so a warp's
// 32 threads read 32 neighbouring words for every limb.
//
// Products are double-width (24 limbs) and accumulate lazily: a signed sum
// of products plus a non-negativity offset (a multiple of p) is reduced
// ONCE by Montgomery REDC. redc<NSUB>(T) returns T * 2^-384 mod p for any
// 0 <= T < 2^768 with T / 2^384 + p < (NSUB + 1) p, i.e. T < NSUB * p * 2^384;
// each caller states its bound.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lh {

constexpr int NL = 12;   // limbs per Fp
constexpr int NW = 24;   // limbs per double-width product

__constant__ uint32_t kP[NL] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};

// p^2 and 16 p^2: the offsets of the Fp2 (K2) and Fp12 (K3) accumulators.
__constant__ uint32_t kP2[NW] = {
    0x1c718e39u, 0x26aa0000u, 0x76382eabu, 0x7ced6b1du, 0x62113cfdu, 0x162c3383u,
    0x3e71b743u, 0x66bf91edu, 0x7091a049u, 0x292e85a8u, 0x86185c7bu, 0x1d68619cu,
    0x0978ef01u, 0xf5314933u, 0x16ddca6eu, 0x50a62cfdu, 0x349e8bd0u, 0x66e59e49u,
    0x0e7046b4u, 0xe2dc90e5u, 0xa22f25e9u, 0x4bd278eau, 0xb8c35fc7u, 0x02a437a4u};
__constant__ uint32_t kP2x16[NW] = {
    0xc718e390u, 0x6aa00001u, 0x6382eab2u, 0xced6b1d7u, 0x2113cfd7u, 0x62c33836u,
    0xe71b7431u, 0x6bf91ed3u, 0x091a0496u, 0x92e85a87u, 0x6185c7b2u, 0xd68619c8u,
    0x978ef011u, 0x53149330u, 0x6ddca6efu, 0x0a62cfd1u, 0x49e8bd05u, 0x6e59e493u,
    0xe7046b46u, 0x2dc90e50u, 0x22f25e9eu, 0xbd278eaau, 0x8c35fc74u, 0x2a437a4bu};

constexpr uint32_t kN0 = 0xfffcfffdu;   // -p^-1 mod 2^32

__device__ __forceinline__ void load(uint32_t* x, const uint32_t* src, long long n) {
#pragma unroll
  for (int l = 0; l < NL; ++l) x[l] = src[l * n];
}

__device__ __forceinline__ void store(uint32_t* dst, const uint32_t* x, long long n) {
#pragma unroll
  for (int l = 0; l < NL; ++l) dst[l * n] = x[l];
}

// t = a * b (24 limbs), operand scanning: row i adds a[i] * b into
// t[i .. i + 12] with a 64-bit carry (a[i] b[j] + t[i + j] + carry < 2^64),
// each step one 32 x 32 + 64 multiply-add.
__device__ __forceinline__ void mul_wide(const uint32_t* a, const uint32_t* b, uint32_t* t) {
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    c += (uint64_t)a[0] * b[j];
    t[j] = (uint32_t)c;
    c >>= 32;
  }
  t[NL] = (uint32_t)c;
#pragma unroll
  for (int i = 1; i < NL; ++i) {
    c = 0;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      c += (uint64_t)a[i] * b[j] + t[i + j];
      t[i + j] = (uint32_t)c;
      c >>= 32;
    }
    t[i + NL] = (uint32_t)c;
  }
}

// x -= p when x >= p.
__device__ __forceinline__ void cond_sub_p(uint32_t* x) {
  uint32_t d[NL];
  uint64_t br = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    const uint64_t v = (uint64_t)x[j] - kP[j] - br;
    d[j] = (uint32_t)v;
    br = v >> 63;
  }
#pragma unroll
  for (int j = 0; j < NL; ++j) x[j] = br ? x[j] : d[j];
}

// out = t * 2^-384 mod p (t is clobbered). Separated operand scanning: row i
// adds m_i * p * 2^(32 i), which clears limb i; the row's carry lands on limb
// i + 12 and that limb's own overflow (0 or 1) rides `ec` into the next row.
template <int NSUB>
__device__ __forceinline__ void redc(uint32_t* t, uint32_t* out) {
  uint32_t ec = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const uint32_t m = t[i] * kN0;
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      c += (uint64_t)m * kP[j] + t[i + j];
      t[i + j] = (uint32_t)c;
      c >>= 32;
    }
    const uint64_t s = (uint64_t)t[i + NL] + c + ec;
    t[i + NL] = (uint32_t)s;
    ec = (uint32_t)(s >> 32);
  }
  // Under every caller's bound the quotient is below 2^384, so ec == 0.
#pragma unroll
  for (int j = 0; j < NL; ++j) out[j] = t[NL + j];
#pragma unroll
  for (int s = 0; s < NSUB; ++s) cond_sub_p(out);
}

// --- p as immediates: K1's reduction and the modular chains K5's operands
// take (csrc/curve_op.cu)

// Limb j of p as an immediate: a __constant__ array goes through the
// constant cache, which misses on a launch's first use.
__host__ __device__ constexpr uint32_t p_limb(int j) {
  return j == 0 ? 0xffffaaabu
       : j == 1 ? 0xb9feffffu
       : j == 2 ? 0xb153ffffu
       : j == 3 ? 0x1eabfffeu
       : j == 4 ? 0xf6b0f624u
       : j == 5 ? 0x6730d2a0u
       : j == 6 ? 0xf38512bfu
       : j == 7 ? 0x64774b84u
       : j == 8 ? 0x434bacd7u
       : j == 9 ? 0x4b1ba7b6u
       : j == 10 ? 0x397fe69au
       : 0x1a0111eau;
}

// out = t 2^-384 mod p, canonical, for 0 <= t < p 2^384 (t is clobbered):
// redc's rows with p's limbs as immediates, then u - p beside u and the
// choice by its sign (u < t / 2^384 + p < 2p).
__device__ __forceinline__ void redc_imm(uint32_t* t, uint32_t* out) {
  uint32_t ec = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const uint32_t m = t[i] * kN0;
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      c += (uint64_t)m * p_limb(j) + t[i + j];
      t[i + j] = (uint32_t)c;
      c >>= 32;
    }
    const uint64_t s = (uint64_t)t[i + NL] + c + ec;
    t[i + NL] = (uint32_t)s;
    ec = (uint32_t)(s >> 32);
  }
  uint32_t d[NL];
  long long br = 0;   // signed borrow, arithmetic shift: -1 at the end iff u < p
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    br += (long long)t[NL + j] - p_limb(j);
    d[j] = (uint32_t)br;
    br >>= 32;
  }
#pragma unroll
  for (int j = 0; j < NL; ++j) out[j] = br < 0 ? t[NL + j] : d[j];
}

// --- Carry chains (PTX: one multiply-add a limb, the carry in the flag), K5's
// products and REDC (csrc/curve_op.cu). A lone warp's Fp product, twelve rows
// of these and twelve REDC steps, takes about 2,300 cycles on an H100 against
// about 2,850 for mul_wide + redc_imm (scripts/probe_k5.py micro).
//
// row_even: t[0..11] += x (y0, y2, ..., y10) as (lo, hi) pairs, the carry
//   into t[12] and t[13]; row_odd: t[0..11] += x (y1, y3, ..., y11), t[0]
//   y1's column, the carry into t[12]. Two rows add x y at column 0.
// redc_even / redc_odd: the same with p's limbs as immediates; redc_even
//   adds ec and the chain's carry into t[12] and returns that limb's carry,
//   redc_odd returns its chain's carry.
// The C versions below compute the same for a host compiler (the source
// can then be run on a CPU against the plain versions).
#if defined(__CUDA_ARCH__)
__device__ __forceinline__ void row_even(uint32_t* t, uint32_t x, const uint32_t* y) {
  asm("mad.lo.cc.u32 %0, %14, %15, %0;"
      "madc.hi.cc.u32 %1, %14, %15, %1;"
      "madc.lo.cc.u32 %2, %14, %16, %2;"
      "madc.hi.cc.u32 %3, %14, %16, %3;"
      "madc.lo.cc.u32 %4, %14, %17, %4;"
      "madc.hi.cc.u32 %5, %14, %17, %5;"
      "madc.lo.cc.u32 %6, %14, %18, %6;"
      "madc.hi.cc.u32 %7, %14, %18, %7;"
      "madc.lo.cc.u32 %8, %14, %19, %8;"
      "madc.hi.cc.u32 %9, %14, %19, %9;"
      "madc.lo.cc.u32 %10, %14, %20, %10;"
      "madc.hi.cc.u32 %11, %14, %20, %11;"
      "addc.cc.u32 %12, %12, 0;"
      "addc.u32 %13, %13, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "+r"(t[13])
      : "r"(x), "r"(y[0]), "r"(y[2]), "r"(y[4]), "r"(y[6]), "r"(y[8]), "r"(y[10]));
}

__device__ __forceinline__ void row_odd(uint32_t* t, uint32_t x, const uint32_t* y) {
  asm("mad.lo.cc.u32 %0, %13, %14, %0;"
      "madc.hi.cc.u32 %1, %13, %14, %1;"
      "madc.lo.cc.u32 %2, %13, %15, %2;"
      "madc.hi.cc.u32 %3, %13, %15, %3;"
      "madc.lo.cc.u32 %4, %13, %16, %4;"
      "madc.hi.cc.u32 %5, %13, %16, %5;"
      "madc.lo.cc.u32 %6, %13, %17, %6;"
      "madc.hi.cc.u32 %7, %13, %17, %7;"
      "madc.lo.cc.u32 %8, %13, %18, %8;"
      "madc.hi.cc.u32 %9, %13, %18, %9;"
      "madc.lo.cc.u32 %10, %13, %19, %10;"
      "madc.hi.cc.u32 %11, %13, %19, %11;"
      "addc.u32 %12, %12, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12])
      : "r"(x), "r"(y[1]), "r"(y[3]), "r"(y[5]), "r"(y[7]), "r"(y[9]), "r"(y[11]));
}

__device__ __forceinline__ uint32_t redc_even(uint32_t* t, uint32_t m, uint32_t ec) {
  uint32_t k;
  asm("mad.lo.cc.u32 %0, %14, 0xffffaaabU, %0;"
      "madc.hi.cc.u32 %1, %14, 0xffffaaabU, %1;"
      "madc.lo.cc.u32 %2, %14, 0xb153ffffU, %2;"
      "madc.hi.cc.u32 %3, %14, 0xb153ffffU, %3;"
      "madc.lo.cc.u32 %4, %14, 0xf6b0f624U, %4;"
      "madc.hi.cc.u32 %5, %14, 0xf6b0f624U, %5;"
      "madc.lo.cc.u32 %6, %14, 0xf38512bfU, %6;"
      "madc.hi.cc.u32 %7, %14, 0xf38512bfU, %7;"
      "madc.lo.cc.u32 %8, %14, 0x434bacd7U, %8;"
      "madc.hi.cc.u32 %9, %14, 0x434bacd7U, %9;"
      "madc.lo.cc.u32 %10, %14, 0x397fe69aU, %10;"
      "madc.hi.cc.u32 %11, %14, 0x397fe69aU, %11;"
      "addc.cc.u32 %12, %12, %15;"
      "addc.u32 %13, 0, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "=r"(k)
      : "r"(m), "r"(ec));
  return k;
}

__device__ __forceinline__ uint32_t redc_odd(uint32_t* t, uint32_t m) {
  uint32_t k;
  asm("mad.lo.cc.u32 %0, %13, 0xb9feffffU, %0;"
      "madc.hi.cc.u32 %1, %13, 0xb9feffffU, %1;"
      "madc.lo.cc.u32 %2, %13, 0x1eabfffeU, %2;"
      "madc.hi.cc.u32 %3, %13, 0x1eabfffeU, %3;"
      "madc.lo.cc.u32 %4, %13, 0x6730d2a0U, %4;"
      "madc.hi.cc.u32 %5, %13, 0x6730d2a0U, %5;"
      "madc.lo.cc.u32 %6, %13, 0x64774b84U, %6;"
      "madc.hi.cc.u32 %7, %13, 0x64774b84U, %7;"
      "madc.lo.cc.u32 %8, %13, 0x4b1ba7b6U, %8;"
      "madc.hi.cc.u32 %9, %13, 0x4b1ba7b6U, %9;"
      "madc.lo.cc.u32 %10, %13, 0x1a0111eaU, %10;"
      "madc.hi.cc.u32 %11, %13, 0x1a0111eaU, %11;"
      "addc.u32 %12, 0, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "=r"(k)
      : "r"(m));
  return k;
}
#else
__device__ __forceinline__ void row_even(uint32_t* t, uint32_t x, const uint32_t* y) {
  uint64_t c = 0;
  for (int k = 0; k < 6; ++k) {
    const uint64_t p = (uint64_t)x * y[2 * k];
    c += (uint64_t)t[2 * k] + (uint32_t)p;
    t[2 * k] = (uint32_t)c;
    c = (c >> 32) + t[2 * k + 1] + (p >> 32);
    t[2 * k + 1] = (uint32_t)c;
    c >>= 32;
  }
  c += t[12];
  t[12] = (uint32_t)c;
  t[13] += (uint32_t)(c >> 32);
}

__device__ __forceinline__ void row_odd(uint32_t* t, uint32_t x, const uint32_t* y) {
  uint64_t c = 0;
  for (int k = 0; k < 6; ++k) {
    const uint64_t p = (uint64_t)x * y[2 * k + 1];
    c += (uint64_t)t[2 * k] + (uint32_t)p;
    t[2 * k] = (uint32_t)c;
    c = (c >> 32) + t[2 * k + 1] + (p >> 32);
    t[2 * k + 1] = (uint32_t)c;
    c >>= 32;
  }
  t[12] += (uint32_t)c;
}

__device__ __forceinline__ uint32_t redc_even(uint32_t* t, uint32_t m, uint32_t ec) {
  uint32_t y[12];
  for (int j = 0; j < 12; ++j) y[j] = p_limb(j);
  uint64_t c = 0;
  for (int k = 0; k < 6; ++k) {
    const uint64_t p = (uint64_t)m * y[2 * k];
    c += (uint64_t)t[2 * k] + (uint32_t)p;
    t[2 * k] = (uint32_t)c;
    c = (c >> 32) + t[2 * k + 1] + (p >> 32);
    t[2 * k + 1] = (uint32_t)c;
    c >>= 32;
  }
  c += (uint64_t)t[12] + ec;
  t[12] = (uint32_t)c;
  return (uint32_t)(c >> 32);
}

__device__ __forceinline__ uint32_t redc_odd(uint32_t* t, uint32_t m) {
  uint32_t y[12];
  for (int j = 0; j < 12; ++j) y[j] = p_limb(j);
  uint64_t c = 0;
  for (int k = 0; k < 6; ++k) {
    const uint64_t p = (uint64_t)m * y[2 * k + 1];
    c += (uint64_t)t[2 * k] + (uint32_t)p;
    t[2 * k] = (uint32_t)c;
    c = (c >> 32) + t[2 * k + 1] + (p >> 32);
    t[2 * k + 1] = (uint32_t)c;
    c >>= 32;
  }
  return (uint32_t)c;
}
#endif

// --- One lane's product and REDC on the chains above: K5's and K6's (csrc/
// curve_op.cu) and K7's (csrc/fp_pow.cu).

// t = a's R rows times b: t[0 .. R + 12) exact (R + 12 limbs and a zero).
template <int R>
__device__ __forceinline__ void rows(const uint32_t* a, const uint32_t* b, uint32_t* t) {
#pragma unroll
  for (int c = 0; c < R + 13; ++c) t[c] = 0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    row_even(t + i, a[i], b);
    row_odd(t + i + 1, a[i], b);
  }
}

// out = u - p if u >= p, else u.
__device__ __forceinline__ void canonical(const uint32_t* u, uint32_t* out) {
  uint32_t d[NL];
  long long br = 0;   // signed borrow, arithmetic shift: -1 at the end iff u < p
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    br += (long long)u[j] - p_limb(j);
    d[j] = (uint32_t)br;
    br >>= 32;
  }
#pragma unroll
  for (int j = 0; j < NL; ++j) out[j] = br < 0 ? u[j] : d[j];
}

// --- Small signed sums of Fp values: K4's linear combinations (csrc/fp_add.cu)
// and K5's operands (csrc/curve_op.cu combine).

// 2^352 / p (1 - 2^-51), rounded down to a double (ops/fused.py K5_INV_HI).
constexpr double kInvHi = 0x1.3b06ba5e7993ap-29;

// out = v mod p, canonical, for v = sum_l (col[l] + bias) 2^(32 l) + m p with
// 0 <= v < 2^18 p: one carry pass into 13 limbs (the carry an arithmetic
// shift: the columns may be negative, v is not); then v - q p with q =
// trunc(v_hi kInvHi) in double precision, v_hi = floor(v / 2^352) < 2^47
// exact in a double, which is floor(v / p) or one less, so v - q p is in
// [0, 2p); then one conditional subtraction. The columns' partial sums stay
// below 2^52 in magnitude for any such v whose terms are below 2^32 a limb.
__device__ __forceinline__ void sum_mod(const long long* col, long long bias, long long m,
                                        uint32_t* out) {
  uint32_t v[NL];
  long long carry = 0;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    carry += col[l] + bias + m * p_limb(l);
    v[l] = (uint32_t)carry;
    carry >>= 32;
  }
  const uint64_t hi = ((uint64_t)carry << 32) | v[NL - 1];
  const long long q = (long long)((double)hi * kInvHi);
  long long br = 0;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    br += (long long)v[l] - q * p_limb(l);
    v[l] = (uint32_t)br;
    br >>= 32;
  }
  canonical(v, out);   // v - q p is in [0, 2p)
}

// out = t 2^-384 mod p, canonical, for 0 <= t < p 2^384 (t is clobbered),
// on one lane: twelve steps of two chains each (redc_even, redc_odd), the
// carry out of column i + 12 deferred to the next step as ec.
__device__ __forceinline__ void redc_lane(uint32_t* t, uint32_t* out) {
  uint32_t ec = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const uint32_t m = t[i] * kN0;
    const uint32_t k = redc_even(t + i, m, ec);
    ec = k + redc_odd(t + i + 1, m);
  }
  canonical(t + NL, out);
}

// out = a + b mod p for canonical a, b; out may alias a or b.
__device__ __forceinline__ void add_mod(const uint32_t* a, const uint32_t* b, uint32_t* out) {
  uint32_t s[NL], d[NL];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    c += (uint64_t)a[j] + b[j];
    s[j] = (uint32_t)c;
    c >>= 32;
  }
  long long br = 0;   // signed borrow, arithmetic shift: -1 at the end iff s < p
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    br += (long long)s[j] - p_limb(j);
    d[j] = (uint32_t)br;
    br >>= 32;
  }
#pragma unroll
  for (int j = 0; j < NL; ++j) out[j] = br < 0 ? s[j] : d[j];
}

// out = a - b mod p; out may alias a or b.
__device__ __forceinline__ void sub_mod(const uint32_t* a, const uint32_t* b, uint32_t* out) {
  uint32_t d[NL];
  long long br = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    br += (long long)a[j] - b[j];
    d[j] = (uint32_t)br;
    br >>= 32;
  }
  const uint32_t mask = (uint32_t)br;   // all ones iff a < b
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    c += (uint64_t)d[j] + (p_limb(j) & mask);
    out[j] = (uint32_t)c;
    c >>= 32;
  }
}

// out = -a mod p: p - a, or 0 for 0.
__device__ __forceinline__ void neg_mod(const uint32_t* a, uint32_t* out) {
  uint32_t any = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) any |= a[j];
  const uint32_t mask = any ? 0xffffffffu : 0u;
  long long br = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    br += (long long)(p_limb(j) & mask) - a[j];
    out[j] = (uint32_t)br;
    br >>= 32;
  }
}

}  // namespace lh
