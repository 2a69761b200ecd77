"""K7's Fp inverse (csrc/fp_pow.cu fp_inv_kernel, fused.fp_inv, which
limbs.inv is) replayed in Python integers on the CPU, where it cannot run,
as one lane of the kernel runs it on one element: the Montgomery limbs cut
into 13 signed 30-bit limbs, 37 batches of 30 divsteps on one 32-bit word
each (the 2 x 2 matrix of a batch), the matrix applied to (f, g) exactly
and to (d, e) mod p with int64 accumulators, then d + 2p packed into 12
words and one Montgomery product by +-R^3 mod p. Every word is held to the
width the kernel gives it (uint32 divstep words, int32 limbs and matrix
entries, int64 accumulators), g is 0 after the fixed step count, and the
result is a^-1 R mod p, for 0, 1, p - 1, R mod p, 2 and 200 seeded values.
Also: the step count against Bernstein and Yang's bound and the source's
constants against their values here.
"""

import re
from pathlib import Path

import numpy as np

from lighthouse_tpu_torch.crypto.bls.constants import P
from lighthouse_tpu_torch.ops import fused

SRC = Path(fused.__file__).parent / "csrc" / "fp_pow.cu"
R = 1 << 384
M30 = (1 << 30) - 1
W32 = (1 << 32) - 1
L30 = 13
BATCH, BATCHES = 30, 37
PINV30 = pow(P, -1, 1 << 30)
R3 = pow(R, 3, P)
NEG_PINV = -pow(P, -1, R) % R        # REDC's quotient factor, -p^-1 mod 2^384


def _to30(x):
    """The kernel's cut of 12 words into 13 limbs: limb i is bits 30 i ..."""
    return [(x >> (30 * i)) & M30 for i in range(L30 - 1)] + [x >> (30 * (L30 - 1))]


P30 = _to30(P)

# The replay runs every value at once: a limb is a numpy column over the
# values (int64 holding the kernel's int32 limbs, uint32 its divstep words),
# and each bound is asserted for the whole column.


def _fits(x, bits):
    assert ((x >= -(1 << (bits - 1))) & (x < 1 << (bits - 1))).all()
    return x


def _mac(acc, terms):
    """acc + sum of a * b (int64 columns), asserted to fit the kernel's
    int64 accumulator: a float64 shadow below 2^62 rules out a wrap."""
    shadow = acc.astype(np.float64) + sum(a.astype(np.float64) * b for a, b in terms)
    assert (np.abs(shadow) < 2.0 ** 62).all()
    return acc + sum(a * b for a, b in terms)


def _sign(limbs, scale=1, plus_p=0):
    """sign(scale x + plus_p p) of 13-limb columns, exactly: the limbs'
    carries propagated, then the top limb's sign or any lower limb."""
    c, low = 0, np.zeros_like(limbs[0])
    for i in range(L30):
        c = c + scale * limbs[i] + plus_p * P30[i]
        if i + 1 < L30:
            low |= c & M30
            c = c >> 30
    return np.where(c != 0, np.sign(c), (low != 0).astype(np.int64))


def _divsteps(delta, f, g):
    """divsteps(): kBatch divsteps on the low words (uint32), each by
    selects between g + f and g - f (q +- u, r +- v) -> delta and the
    matrix (u, v, q, r) as int32 values in int64 columns."""
    one = np.ones_like(f)
    u, v, q, r = one, 0 * one, 0 * one, one
    for _ in range(BATCH):
        odd, pos = (g & np.uint32(1)) == 1, delta > 0
        swap = odd & pos
        gn, qn, rn = (np.where(odd, np.where(pos, a - b, a + b), a)
                      for a, b in ((g, f), (q, u), (r, v)))
        f = np.where(swap, g, f)
        u, v = np.where(swap, q, u) << np.uint32(1), np.where(swap, r, v) << np.uint32(1)
        delta = _fits(np.where(swap, 1 - delta, 1 + delta), 32)
        g, q, r = gn >> np.uint32(1), qn, rn
    t = [w.view(np.int32).astype(np.int64) for w in (u, v, q, r)]
    assert (np.abs(t[0]) + np.abs(t[1]) <= 1 << BATCH).all()
    assert (np.abs(t[2]) + np.abs(t[3]) <= 1 << BATCH).all()
    return delta, t


def _apply(x, y, a, b, c, d, madd=None):
    """One limb loop of update_fg (madd None) or update_de: the rows
    (a x + b y [+ p md]) / 2^30 and (c x + d y [+ p me]) / 2^30."""
    zero = np.zeros_like(x[0])
    cx, cy = _mac(zero, [(a, x[0]), (b, y[0])]), _mac(zero, [(c, x[0]), (d, y[0])])
    if madd is not None:
        md, me = madd
        md = _fits(md - ((PINV30 * (cx & W32) + (md & W32)) & M30), 32)
        me = _fits(me - ((PINV30 * (cy & W32) + (me & W32)) & M30), 32)
        cx, cy = _mac(cx, [(md, P30[0])]), _mac(cy, [(me, P30[0])])
    assert not (cx & M30).any() and not (cy & M30).any()      # exact division
    cx, cy = cx >> 30, cy >> 30
    nx, ny = [None] * L30, [None] * L30
    for i in range(1, L30):
        tx, ty = [(a, x[i]), (b, y[i])], [(c, x[i]), (d, y[i])]
        if madd is not None:
            tx, ty = tx + [(md, P30[i])], ty + [(me, P30[i])]
        cx, cy = _mac(cx, tx), _mac(cy, ty)
        nx[i - 1], ny[i - 1] = cx & M30, cy & M30
        cx, cy = cx >> 30, cy >> 30
    nx[-1], ny[-1] = _fits(cx, 32), _fits(cy, 32)
    return nx, ny


def gcd_replay(xs):
    """fp_inv_kernel, one lane each: xs = aR mod p (canonical) -> a^-1 R
    mod p, with every bound of the kernel asserted on the way."""
    assert all(0 <= x < P for x in xs)
    cols = lambda vals: [np.array(v, dtype=np.int64) for v in zip(*vals)]   # noqa: E731
    g = cols([_to30(x) for x in xs])
    f = cols([P30] * len(xs))
    d, e = cols([[0] * L30] * len(xs)), cols([[1] + [0] * (L30 - 1)] * len(xs))
    delta = np.ones(len(xs), dtype=np.int64)
    for _ in range(BATCHES):
        delta, (u, v, q, r) = _divsteps(delta, f[0].astype(np.uint32), g[0].astype(np.uint32))
        f, g = _apply(f, g, u, v, q, r)
        sd, se = -(d[-1] < 0).astype(np.int64), -(e[-1] < 0).astype(np.int64)
        d, e = _apply(d, e, u, v, q, r, ((u & sd) + (v & se), (q & sd) + (r & se)))
        for limbs in (f, g, d, e):
            assert all(((w >= 0) & (w <= M30)).all() for w in limbs[:-1])
        for limbs in (f, g):                                  # |f|, |g| <= p
            assert (_sign(limbs, 1, 1) >= 0).all() and (_sign(limbs, -1, 1) >= 0).all()
        for limbs in (d, e):                                  # -2p < d, e < p
            assert (_sign(limbs, 1, 2) > 0).all() and (_sign(limbs, -1, 1) > 0).all()
    out = []
    for i, x in enumerate(xs):
        fv, gv, dl = (sum(int(w[i]) << (30 * j) for j, w in enumerate(limbs))
                      for limbs in (f, g, d))
        # The fixed step count reaches g = 0; f = +-1, or p for x = 0.
        assert gv == 0 and (fv in (1, -1) if x else fv == P)
        # d + 2p in (0, 3p), 12 words; times +-R^3 by one Montgomery product.
        c, dd = 0, []
        for j in range(L30):
            c += int(d[j][i]) + 2 * P30[j]
            dd.append(c & M30 if j + 1 < L30 else c)
            c >>= 30
        assert -(1 << 31) <= dd[-1] < 1 << 31
        words = [((dd[j] >> (2 * j)) | (dd[j + 1] << (30 - 2 * j))) & W32 for j in range(12)]
        dv = sum(w << (32 * j) for j, w in enumerate(words))
        assert dv == dl + 2 * P and 0 < dv < 3 * P
        t = dv * (P - R3 if fv < 0 else R3)
        assert t < P * R                                      # lh::redc_lane's bound
        m = t * NEG_PINV % R
        u = (t + m * P) // R
        assert u < 2 * P
        out.append(u - P if u >= P else u)
    return out


def _gcd_values():
    rng = np.random.default_rng(61)
    rand = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(200)]
    return [0, 1, P - 1, R % P, 2] + rand


def test_gcd_replay_inverts():
    """Each value as the kernel's input aR: the replay gives a^-1 R (0 for
    0), the plain version's a^(p-2) R."""
    vals = _gcd_values()
    assert gcd_replay([a * R % P for a in vals]) == [pow(a, P - 2, P) * R % P for a in vals]


def test_gcd_step_count_is_the_proven_bound():
    """Bernstein-Yang (Theorem 11.2): for f odd and f^2 + 4 g^2 <= 5 2^(2d),
    floor((49 d + 57) / 17) divsteps (d >= 46) reach g = 0. f = p, 0 <= g <
    p and p < 2^381 give d = 381 and 1,101 divsteps: the kernel runs 1,110."""
    d = P.bit_length()
    assert d == 381 and P * P + 4 * (P - 1) ** 2 <= 5 * 2 ** (2 * d)
    assert BATCH * BATCHES >= (49 * d + 57) // 17 == 1101
    assert BATCH * (BATCHES - 1) < 1101                       # no spare batch


def test_gcd_source_constants():
    src = SRC.read_text()

    def consts(fn, width):
        body = src[src.index(f"constexpr {width} {fn}("):]
        return [int(h, 16) for h in re.findall(r"0x([0-9a-f]{8})u?", body[:body.index("}")])]

    assert consts("p30", "int32_t") == P30
    assert consts("r3_limb", "uint32_t") == [(R3 >> (32 * j)) & W32 for j in range(12)]
    assert consts("neg_r3_limb", "uint32_t") == [((P - R3) >> (32 * j)) & W32 for j in range(12)]
    assert int(re.search(r"kPInv30 = 0x([0-9a-f]+)u;", src).group(1), 16) == PINV30
    assert int(re.search(r"kBatch = (\d+);", src).group(1)) == BATCH
    assert int(re.search(r"kBatches = (\d+);", src).group(1)) == BATCHES
    assert int(re.search(r"kL30 = (\d+);", src).group(1)) == L30
    assert 'extern "C" int lh_fp_inv(' in src and 'extern "C" int lh_fp_inv_empty(' in src
