"""Batch signature-set verification on the card: the port's backend "gpu".

Counterparts: ``lighthouse_tpu/ops/bm/backend.py`` (the three stages,
``_segment_combine``, ``_dual_var_ladder``) and ``lighthouse_tpu/ops/backend.py``
(:55-60 ``_next_pow2``, :267-300 the host early-outs, :393-487
``M_BUCKET_SHIFTS``, ``_m_bucket_for``, ``stage_bm``). It evaluates blst's
random-scalar batch equation

    prod_i e([r_i] agg_pk_i, H(m_i)) * e(-g1, sum_i [r_i] sig_i) == 1

grouped by message (bilinearity: sets that share a message share one
Miller-loop pair), with r_i nonzero 64-bit scalars from the host CSPRNG:

    h2g2     hash the m distinct messages to G2          (ops/h2c.py)
    prepare  aggregate pubkeys, check signatures in G2, weight both by r_i
             in one dual ladder, sum the signatures, combine same-message
             pubkeys                                      (ops/curves.py)
    pairing  one multi-Miller loop over m + 1 pairs and one final
             exponentiation                               (ops/pairing.py)

Staging pads sets to power-of-two buckets (infinity pubkeys and masked
sets) and quantizes the distinct-message count to M_BUCKET_SHIFTS, as the
JAX backend does. It has a host half (``stage_host``: hashing, points to
limbs, masks and scalars, all numpy) and a device half (``to_device``:
pinned copies that do not block), so that staging the next batch never
waits for the device. Every batch runs on the device it is given: the
choice of the native CPU route belongs to the serving router
(``serving/router.py``, its ``small`` rule).

Each stage is a CUDA graph per bucket (``ops/graphs.py``), as each is a
jit per bucket in JAX (``ops/bm/backend.py:234-335``): stage 1 and stage 3
per m bucket, shared by every (n, k), and stage 2 per (n, k, m,
all_checked). ``graph_core`` chains them; ``core`` is the eager function
they capture. Both time their stages through ``observability/stages.py``
(engine ``gpu``) while stage timing is on.

``verify_signature_sets_gpu_async`` (JAX ``ops/backend.py:244-253``)
returns a ``PendingVerdict`` without waiting for the device, so that the
host stages batch i + 1 while the card runs batch i;
``verify_signature_sets_gpu`` is its ``bool``.

Wide buckets (JAX ``ops/bm/backend.py:122-217``): the prepare stage's
ladder block (key aggregation, subgroup check, dual ladder, mask) may run
in chunks of ``prep_chunk_width(n_bucket)`` sets, rejoined along the batch
axis before the full-width tail (signature sum, segment combine): every
output is bit for bit the monolithic one. Buckets go up to
``max_n_bucket()``, 16384.

Several devices (JAX ``_jitted_core(sharded=True)``, ``_verify_bm_impl``):
over a mesh (``parallel/mesh.py``) of d devices, staging floors n_bucket at
d and m_bucket at the next power of two >= d, and shard i runs stage 1 on
its m/d message columns and a partial stage 2 on its n/d sets (its
signature sum, and its same-message combine into all m rows, rows without
a member at infinity). The lead device, the mesh's first, sums the
partials, ANDs the validity bits, joins the h2g2 columns and runs stage 3
over the m + 1 pairs, as JAX leaves stage 3 unsharded.
"""

import contextlib
import os
import secrets
from functools import lru_cache, partial

import numpy as np
import torch

from ..crypto.bls import api as _api
from ..crypto.bls import curves as _oc
from ..crypto.bls.constants import P as _P
from ..crypto.bls.constants import RAND_BITS as _RAND_BITS
from ..observability import stages
from . import curves as cv
from . import graphs
from . import h2c
from . import limbs as lb
from . import pairing as pr
from ..parallel import mesh as pm

# The distinct-message bucket menu, as shifts off n_bucket (m = n >> s).
M_BUCKET_SHIFTS = (8, 6, 4, 2, 0)


# The prepare stage's chunk width for wide buckets, per device (JAX
# ops/bm/backend.py:128): 0 keeps every bucket monolithic.
# LIGHTHOUSE_TPU_PREP_CHUNK overrides it (0 turns chunking off; junk is
# ignored). JAX chunks at 4096 because its monolithic graphs spilled past
# 4096 sets on the TPU. The card needs no chunking: on an H100 80GB HBM3
# at 700 W, a replayed 16384-set prepare stage took 10.0 ms monolithic
# against 13.0 ms in chunks of 4096, in 771 graph nodes against 2741, and
# a 16384 x 4 verify peaked at 122 MB of device memory.
DEFAULT_PREP_CHUNK = 0


def prep_chunk_width(n_bucket: int, n_devices: int = 1) -> int:
    """The prepare stage's chunk width for an n bucket: 0 = monolithic,
    else a width below n_bucket that divides it. The configured width is
    per device, so over a mesh the batch's chunk is d times wider (each
    shard then chunks its n/d sets at the configured width)."""
    try:
        base = int(os.environ.get("LIGHTHOUSE_TPU_PREP_CHUNK", "") or DEFAULT_PREP_CHUNK)
    except ValueError:
        base = DEFAULT_PREP_CHUNK
    if base <= 0:
        return 0
    width = base * max(1, int(n_devices))
    if width >= n_bucket or n_bucket % width:
        return 0
    return width


def max_n_bucket() -> int:
    """The largest n bucket the port serves and warms: 16384, as the JAX
    engine's (ops/backend.py:396-404), which ties it to its chunked prepare
    stage; the port's holds at any chunk width (DEFAULT_PREP_CHUNK)."""
    return 16384


def _next_pow2(n: int, floor: int = 1) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def _m_bucket_for(n_bucket: int, n_uniq: int) -> int:
    """Quantize the distinct-message bucket to the M_BUCKET_SHIFTS menu."""
    if n_uniq > n_bucket:
        raise ValueError((n_uniq, n_bucket))
    for shift in M_BUCKET_SHIFTS:
        m = max(1, n_bucket >> shift)
        if n_uniq <= m:
            return m
    raise AssertionError("menu ends at n_bucket >= n_uniq")


def draw_scalars(n: int, n_bucket: int) -> np.ndarray:
    """Nonzero 64-bit batch scalars from the host CSPRNG (padding gets 1),
    as int64 bit patterns."""
    scalars = np.ones((n_bucket,), dtype=np.uint64)
    for i in range(n):
        r = 0
        while r == 0:
            r = secrets.randbits(_RAND_BITS)
        scalars[i] = r
    return scalars.view(np.int64)


def stage_host(sets, scalars=None, n_floor: int = 1, m_floor: int = 1):
    """The host half of staging: a batch -> (the eight staged arrays in
    numpy, m_bucket, all_sigs_checked). `scalars` (n_bucket,) overrides the
    CSPRNG draw for deterministic callers. `n_floor` and `m_floor` bound
    the n and m buckets from below (a mesh of d devices: d and the next
    power of two >= d, so that every shard has sets and messages)."""
    n = len(sets)
    n_bucket = _next_pow2(n, floor=max(1, n_floor))
    k_bucket = _next_pow2(max(len(s.signing_keys) for s in sets))

    uniq: dict = {}
    inv_idx = np.zeros((n_bucket,), dtype=np.int64)
    for i, s in enumerate(sets):
        inv_idx[i] = uniq.setdefault(bytes(s.message), len(uniq))
    m_bucket = max(_m_bucket_for(n_bucket, len(uniq)), _next_pow2(max(1, m_floor)))
    u = np.zeros((2, 2, lb.L, m_bucket), dtype=np.int32)
    u[..., :len(uniq)] = h2c.hash_to_field_limbs_np(list(uniq))
    row_mask = np.zeros((m_bucket,), dtype=bool)
    row_mask[:len(uniq)] = True

    pk_pts = []
    for s in sets:
        pts = [pk.point for pk in s.signing_keys]
        pk_pts.extend(pts + [None] * (k_bucket - len(pts)))
    pk_pts += [None] * ((n_bucket - n) * k_bucket)
    # Flat order is (set, slot), slot fastest: split the minor axis and
    # move the slot axis to the front -> (K, 3, 12, n).
    pk_proj = np.ascontiguousarray(np.moveaxis(
        cv.g1_from_affine_np(pk_pts).reshape(3, lb.L, n_bucket, k_bucket), -1, 0))

    sig_pts = [s.signature.point for s in sets] + [None] * (n_bucket - n)
    sig_proj = cv.g2_from_affine_np(sig_pts)

    sig_checked = np.ones((n_bucket,), dtype=bool)
    sig_checked[:n] = [s.signature.subgroup_checked for s in sets]
    set_mask = np.zeros((n_bucket,), dtype=bool)
    set_mask[:n] = True
    if scalars is None:
        scalars = draw_scalars(n, n_bucket)
    scalars = np.ascontiguousarray(np.asarray(scalars).view(np.int64))
    host = (u, inv_idx, row_mask, pk_proj, sig_proj, sig_checked, set_mask, scalars)
    return host, m_bucket, bool(sig_checked.all())


def to_device(host, device) -> tuple:
    """The device half of staging: numpy arrays -> tensors on `device`. On
    the card each array is pinned and copied without blocking, queued on
    the current stream, so that the host goes on while the card still
    runs the batch before (a pageable copy would wait for it)."""
    device = torch.device(device)
    if device.type != "cuda":
        return tuple(torch.from_numpy(x).to(device) for x in host)
    return tuple(torch.from_numpy(x).pin_memory().to(device, non_blocking=True) for x in host)


def stage(sets, device, scalars=None):
    """Stage a batch into batch-minor device tensors: stage_host, then
    to_device. Returns (args, m_bucket, all_sigs_checked)."""
    host, m_bucket, all_checked = stage_host(sets, scalars)
    return to_device(host, device), m_bucket, all_checked


@lru_cache(maxsize=None)
def _neg_g1(device):
    return cv.g1_from_affine([(_oc.G1_GEN[0], _P - _oc.G1_GEN[1])], device)


def _h2g2(u):
    """Stage 1: (2, 2, 12, m) field elements -> (3, 2, 12, m) G2 points."""
    return h2c.hash_to_g2_device(u)


def _segment_combine(pts, inv_idx, m_bucket: int, empty_at_infinity: bool = False):
    """Sum weighted G1 points by message id: (3, 12, n) x (n,) ->
    (3, 12, m_bucket), out[j] = sum_{i: inv_idx[i] = j} pts[i]. Sort by id,
    then an inclusive segmented scan (value, first-of-segment flag) in
    log2(n) complete adds, then each segment's last position. Rows with no
    members gather garbage, which the pairing masks (row_mask), unless
    `empty_at_infinity`: a shard's rows go into a cross-shard sum, where a
    message whose sets all sit in other shards must add nothing."""
    n = pts.shape[-1]
    order = torch.argsort(inv_idx, stable=True)
    ids = inv_idx[order]
    v = pts[..., order]
    f = torch.cat([torch.ones((1,), dtype=torch.bool, device=ids.device),
                   ids[1:] != ids[:-1]])
    d = 1
    while d < n:
        vb, fb = v[..., d:], f[d:]
        comb = cv.G1.select(fb, vb, cv.G1.add(v[..., :-d], vb))
        v = torch.cat([v[..., :d], comb], dim=-1)
        f = torch.cat([f[:d], f[:-d] | fb])
        d *= 2
    targets = torch.arange(m_bucket, dtype=ids.dtype, device=ids.device)
    last = (torch.searchsorted(ids, targets, right=True) - 1).clamp(0, n - 1)
    out = v[..., last]
    if empty_at_infinity:
        out = cv.G1.select(ids[last] == targets, out,
                           cv.G1.infinity(out.device).expand_as(out))
    return out


def _dual_var_ladder(p1, p2, k, nbits: int = 64):
    """[k]P1 (G1) and [k]P2 (G2) with the same per-element scalars, one
    2-bit window step for both groups at a time."""
    g1, g2 = cv.G1, cv.G2
    p1_2 = g1.double(p1)
    p1_3 = g1.add(p1_2, p1)
    p2_2 = g2.double(p2)
    p2_3 = g2.add(p2_2, p2)
    inf1 = g1.infinity(p1.device).expand_as(p1)
    inf2 = g2.infinity(p2.device).expand_as(p2)
    a1, a2 = inf1, inf2
    for pos in range(nbits - 2, -1, -2):
        a1 = g1.double(g1.double(a1))
        a2 = g2.double(g2.double(a2))
        digit = (k >> pos) & 3
        e1 = g1.select(digit == 1, p1, g1.select(
            digit == 2, p1_2, g1.select(digit == 3, p1_3, inf1)))
        e2 = g2.select(digit == 1, p2, g2.select(
            digit == 2, p2_2, g2.select(digit == 3, p2_3, inf2)))
        a1, a2 = g1.add(a1, e1), g2.add(a2, e2)
    return a1, a2


def _ladder_block(pk_proj, sig_proj, sig_checked, set_mask, scalars, all_checked: bool = False):
    """Stage 2's part per set (JAX ops/bm/backend.py:166-176): aggregate
    each set's keys, check its signature in G2, weight both by its scalar
    in the dual ladder, mask padding -> (a_masked (3, 12, c), rsig
    (3, 2, 12, c), ok (c,)). `all_checked` skips the device subgroup check
    when the host knows every signature passed it (its result would be
    ignored). Elementwise along the batch axis."""
    g1 = cv.G1
    agg = lb.tree_reduce(pk_proj, g1.add, g1.infinity(pk_proj.device), pk_proj.shape[0])
    agg_inf = g1.is_infinity(agg)
    if all_checked:
        sig_ok = sig_checked
    else:
        sig_ok = torch.logical_or(sig_checked, cv.g2_in_subgroup(sig_proj))
    a_proj, rsig = _dual_var_ladder(agg, sig_proj, scalars)
    a_masked = g1.select(set_mask, a_proj, g1.infinity(agg.device).expand_as(a_proj))
    ok = torch.where(set_mask, torch.logical_and(sig_ok, ~agg_inf),
                     torch.ones_like(set_mask))
    return a_masked, rsig, ok


def _ladder(pk_proj, sig_proj, sig_checked, set_mask, scalars, all_checked: bool = False,
            chunk: int = 0):
    """The ladder block over the batch: at once, or, with 0 < chunk < n, on
    the slices [..., i c:(i + 1) c] one after another, rejoined along the
    batch axis (JAX ops/bm/backend.py:184-209). The block is elementwise
    along that axis, so the result is bit for bit the monolithic one."""
    n = sig_proj.shape[-1]
    args = (pk_proj, sig_proj, sig_checked, set_mask, scalars)
    if not chunk or chunk >= n:
        return _ladder_block(*args, all_checked)
    assert n % chunk == 0, (n, chunk)
    parts = [_ladder_block(*(x[..., i:i + chunk].contiguous() for x in args), all_checked)
             for i in range(0, n, chunk)]
    return tuple(torch.cat(xs, dim=-1) for xs in zip(*parts))


def _prepare(pk_proj, sig_proj, sig_checked, set_mask, scalars, inv_idx,
             m_bucket: int, all_checked: bool = False, chunk: int = 0):
    """Stage 2: -> (p_proj (3, 12, m + 1), s_proj (3, 2, 12, 1), sets_valid).
    The ladder block (chunked at `chunk`), then the full-width tail: the
    signature sum and the same-message combine (JAX :211-215)."""
    n = sig_proj.shape[-1]
    a_masked, rsig, ok = _ladder(pk_proj, sig_proj, sig_checked, set_mask, scalars,
                                 all_checked, chunk)
    s_proj = cv.G2.msm_reduce_minor(rsig, n)
    a_comb = _segment_combine(a_masked, inv_idx, m_bucket)
    p_proj = torch.cat([a_comb, _neg_g1(a_comb.device)], dim=-1)
    return p_proj, s_proj, torch.all(ok)


def _partial_prepare(pk_proj, sig_proj, sig_checked, set_mask, scalars, inv_idx,
                     m_bucket: int, all_checked: bool = False, chunk: int = 0):
    """Stage 2 on one shard's sets -> (its same-message combine into all m
    rows (3, 12, m), rows without a set of the shard at infinity; its
    signature sum (3, 2, 12, 1); the AND of its sets' validity ())."""
    n = sig_proj.shape[-1]
    a_masked, rsig, ok = _ladder(pk_proj, sig_proj, sig_checked, set_mask, scalars,
                                 all_checked, chunk)
    return (_segment_combine(a_masked, inv_idx, m_bucket, empty_at_infinity=True),
            cv.G2.msm_reduce_minor(rsig, n), torch.all(ok))


def _join_shards(parts):
    """On the lead device: each shard's (h2g2 columns, combine, signature
    sum, validity), all on the lead, -> stage 3's (p_proj (3, 12, m + 1),
    h_unique (3, 2, 12, m), s_proj (3, 2, 12, 1), sets_valid): the G1 sum
    of the combines, the G2 sum of the signature sums, the AND, and the
    columns joined in shard order."""
    h, a, s, ok = zip(*parts)
    a_sum, s_sum = a[0], s[0]
    for a_i, s_i in zip(a[1:], s[1:]):
        a_sum, s_sum = cv.G1.add(a_sum, a_i), cv.G2.add(s_sum, s_i)
    p_proj = torch.cat([a_sum, _neg_g1(a_sum.device)], dim=-1)
    return p_proj, torch.cat(h, dim=-1), s_sum, torch.stack(ok).all()


def _pairing_check(p_proj, h_unique, s_proj, row_mask, sets_valid):
    """Stage 3: product of pairings over the m distinct messages and the
    signature pair, one final exponentiation."""
    q_proj = torch.cat([h_unique, s_proj], dim=-1)
    mask = torch.cat([row_mask, torch.ones((1,), dtype=torch.bool, device=row_mask.device)])
    return torch.logical_and(pr.multi_pairing_check(p_proj, q_proj, mask), sets_valid)


def core(u, inv_idx, row_mask, pk_proj, sig_proj, sig_checked, set_mask, scalars,
         m_bucket: int, all_checked: bool = False, chunk=None):
    """The three stages on staged tensors -> () bool tensor, each stage
    timed while stage timing is on. `chunk` None is prep_chunk_width(n)."""
    n = sig_proj.shape[-1]
    chunk = prep_chunk_width(n) if chunk is None else chunk
    shape = dict(n=n, k=pk_proj.shape[0], m=m_bucket, all_checked=all_checked, chunk=chunk)
    prepare = partial(_prepare, m_bucket=m_bucket, all_checked=all_checked, chunk=chunk)
    h_unique = stages.traced("gpu", "h2g2", _h2g2, **shape)(u)
    p_proj, s_proj, sets_valid = stages.traced("gpu", "prepare", prepare, **shape)(
        pk_proj, sig_proj, sig_checked, set_mask, scalars, inv_idx)
    return stages.traced("gpu", "pairing", _pairing_check, **shape)(
        p_proj, h_unique, s_proj, row_mask, sets_valid)


def shard_staged(host, mesh):
    """Staged numpy arrays (``stage_host`` with the mesh's floors) -> (for
    each shard, its (u, inv_idx, pk_proj, sig_proj, sig_checked, set_mask,
    scalars) on its device: u's m/d message columns and the rest on its
    n/d sets; row_mask on the lead)."""
    u, inv_idx, row_mask, pk, sig, sig_checked, set_mask, scalars = (
        torch.from_numpy(x) for x in host)
    per = [pm.shard_minor(x, mesh) for x in (u, inv_idx, pk, sig, sig_checked, set_mask,
                                                scalars)]
    return list(zip(*per)), pm.replicated(row_mask, mesh[:1])[0]


def core_sharded(shards, row_mask, m_bucket: int, all_checked: bool = False, chunk=None):
    """The sharded stages, eager: each shard's stage 1 and partial stage 2
    on its device (``shard_staged``'s layout), the join and stage 3 on the
    lead, row_mask's device -> () bool tensor. `chunk` None is the chunk
    width of a shard (prep_chunk_width(n, d) / d)."""
    d = len(shards)
    n = shards[0][3].shape[-1]
    if chunk is None:
        chunk = prep_chunk_width(n * d, d) // d
    lead = row_mask.device
    parts = []
    for u, inv_idx, pk, sig, sig_checked, set_mask, scalars in shards:
        with _on(u.device):
            h = _h2g2(u)
            a, s, ok = _partial_prepare(pk, sig, sig_checked, set_mask, scalars, inv_idx,
                                        m_bucket, all_checked, chunk)
            parts.append(tuple(_to_lead(x, lead) for x in (h, a, s, ok)))
    p_proj, h_unique, s_proj, sets_valid = _join_shards(parts)
    return _pairing_check(p_proj, h_unique, s_proj, row_mask, sets_valid)


def _on(device):
    """The device's context, for a shard's launches (a no-op off the card)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _to_lead(x, lead):
    """A copy of `x` on the lead device: a shard's outputs outlive the next
    replay of its graph, which another shard on the same device may run.
    A copy between two cards is ordered by torch against both devices'
    current streams."""
    return x.clone() if x.device == lead else x.to(lead, non_blocking=True)


# --- CUDA-graph stages per bucket --------------------------------------------
#
# One lock per (m, device) covers the three graphs of every chain with that
# m: a chain passes stage 1's static outputs to stage 3 after stage 2 has
# run, and stage 1 and 3 are shared by every (n, k) with that m. Stage 1
# and 3 of one m share a memory pool, and the stage-2 graphs of one m
# another: under the lock none of them runs while another does, and a
# chain reads a graph's outputs before the next graph of its pool replays.


def _stage_lock(m_bucket: int, device):
    return graphs.key_lock(("bls", m_bucket, device))


@graphs.cached
def _stage1_graph(m_bucket: int, device):
    return graphs.StaticGraph(_h2g2, [((2, 2, lb.L, m_bucket), lb.DTYPE)], device,
                              f"h2g2 m={m_bucket}", _stage_lock(m_bucket, device),
                              graphs.pool("bls_h2g2_pairing", m_bucket, device))


@graphs.cached
def _stage3_graph(m_bucket: int, device):
    specs = [((3, lb.L, m_bucket + 1), lb.DTYPE), ((3, 2, lb.L, m_bucket), lb.DTYPE),
             ((3, 2, lb.L, 1), lb.DTYPE), ((m_bucket,), torch.bool), ((), torch.bool)]
    return graphs.StaticGraph(_pairing_check, specs, device, f"pairing m={m_bucket}",
                              _stage_lock(m_bucket, device),
                              graphs.pool("bls_h2g2_pairing", m_bucket, device))


def _stage2_graph(fn, kind: str, n: int, k_bucket: int, m_bucket: int, all_checked: bool,
                  chunk: int, device):
    specs = [((k_bucket, 3, lb.L, n), lb.DTYPE), ((3, 2, lb.L, n), lb.DTYPE),
             ((n,), torch.bool), ((n,), torch.bool), ((n,), torch.int64), ((n,), torch.int64)]
    return graphs.StaticGraph(
        partial(fn, m_bucket=m_bucket, all_checked=all_checked, chunk=chunk), specs, device,
        f"{kind} n={n} k={k_bucket} m={m_bucket} checked={all_checked} chunk={chunk}",
        _stage_lock(m_bucket, device), graphs.pool("bls_prepare", m_bucket, device))


@graphs.cached
def _prepare_graph(n_bucket: int, k_bucket: int, m_bucket: int, all_checked: bool, chunk: int,
                   device):
    return _stage2_graph(_prepare, "prepare", n_bucket, k_bucket, m_bucket, all_checked, chunk,
                         device)


@graphs.cached
def _partial_prepare_graph(n_shard: int, k_bucket: int, m_bucket: int, all_checked: bool,
                           chunk: int, device):
    """A shard's stage 2 on its n/d sets (``_partial_prepare``): the graph
    kind the sharded path adds. Shards on one device share it."""
    return _stage2_graph(_partial_prepare, "partial_prepare", n_shard, k_bucket, m_bucket,
                         all_checked, chunk, device)


class PendingVerdict:
    """A batch's verdict on its way back from the card. Made under the
    bucket's lock right after the batch's last replay: it queues a copy of
    the static verdict into pinned host memory of its own (the next
    replay overwrites the static one) and records an event after it.
    ``bool()`` waits on that event and on nothing else, reads the copy,
    and observes the stage times recorded so far that have completed
    (``stages.settle``). On the CPU the verdict is there at once."""

    def __init__(self, verdict: torch.Tensor):
        if verdict.device.type != "cuda":
            self._value = bool(verdict)
            return
        self._value = None
        stream = torch.cuda.current_stream(verdict.device)
        self._host = torch.empty((), dtype=torch.bool, pin_memory=True)
        self._host.copy_(verdict, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record(stream)

    def __bool__(self) -> bool:
        if self._value is None:
            self._event.synchronize()
            self._value = bool(self._host)
            stages.settle()
        return self._value


class GraphCore:
    """The stage graphs of one (n, k, m, all_checked, chunk) bucket, chained
    as ``core`` chains the stages (``jitted_core``'s counterpart), every
    graph replayed on the caller's stream. A call returns the static
    verdict tensor: read it while holding ``lock``; ``dispatch`` returns a
    PendingVerdict instead, and lets go of the lock at once."""

    def __init__(self, n_bucket: int, k_bucket: int, m_bucket: int, all_checked: bool, device,
                 chunk: int = 0):
        self.h2g2 = _stage1_graph(m_bucket, device)
        self.prepare = _prepare_graph(n_bucket, k_bucket, m_bucket, all_checked, chunk, device)
        self.pairing = _stage3_graph(m_bucket, device)
        self.graphs = (self.h2g2, self.prepare, self.pairing)
        self.lock = self.h2g2.lock
        shape = dict(n=n_bucket, k=k_bucket, m=m_bucket, all_checked=all_checked, chunk=chunk)
        self._stages = tuple(stages.traced("gpu", stage, g, **shape) for stage, g in
                             zip(("h2g2", "prepare", "pairing"), self.graphs))

    def __call__(self, u, inv_idx, row_mask, pk_proj, sig_proj, sig_checked, set_mask, scalars):
        h2g2, prepare, pairing = self._stages
        with self.lock:
            h_unique = h2g2(u)
            p_proj, s_proj, sets_valid = prepare(pk_proj, sig_proj, sig_checked, set_mask,
                                                 scalars, inv_idx)
            return pairing(p_proj, h_unique, s_proj, row_mask, sets_valid)

    def dispatch(self, *args) -> PendingVerdict:
        """Replay the bucket on the staged `args` and return the pending
        verdict, without waiting for the device."""
        with self.lock:
            pending = PendingVerdict(self(*args))
            if self.h2g2.device.type == "cuda":
                # The verdict's copy reads a static output: the next holder
                # of the lock, on any stream, waits for it.
                self.lock.mark(torch.cuda.current_stream(self.h2g2.device))
            return pending


def graph_core(n_bucket: int, k_bucket: int, m_bucket: int, all_checked: bool, device,
               chunk=None):
    """The bucket's GraphCore, its graphs on `device`; `chunk` None is
    prep_chunk_width(n_bucket)."""
    chunk = prep_chunk_width(n_bucket) if chunk is None else chunk
    return _graph_core(n_bucket, k_bucket, m_bucket, all_checked, device, chunk)


@graphs.cached
def _graph_core(n_bucket, k_bucket, m_bucket, all_checked, device, chunk):
    return GraphCore(n_bucket, k_bucket, m_bucket, all_checked, torch.device(device), chunk)


def _mark(lock, device) -> None:
    """Record the end of the work queued so far under `lock` on the
    device's current stream (a no-op off the card)."""
    if device.type == "cuda":
        lock.mark(torch.cuda.current_stream(device))


class ShardedCore:
    """The stage graphs of one (n, k, m, all_checked, chunk) bucket over a
    mesh of d devices (``_jitted_core(sharded=True)``'s counterpart): for
    each shard, stage 1 at m/d and the partial prepare at n/d on its
    device; on the lead, stage 3 at m. A call takes ``shard_staged``'s
    layout and returns a PendingVerdict without waiting for the device.
    Shards on one device replay the same graphs: each shard's outputs are
    copied to the lead under the graph's lock, and the lock's tail marked
    after the copy, before the next shard replays it. The join on the lead
    (``_join_shards``, 2 (d - 1) K5 launches) runs eagerly."""

    def __init__(self, n_bucket: int, k_bucket: int, m_bucket: int, all_checked: bool, mesh,
                 chunk: int):
        d = len(mesh)
        self.mesh, self.lead = tuple(mesh), mesh[0]
        self.shards = [(_stage1_graph(m_bucket // d, dev),
                        _partial_prepare_graph(n_bucket // d, k_bucket, m_bucket, all_checked,
                                               chunk, dev)) for dev in self.mesh]
        self.pairing = _stage3_graph(m_bucket, self.lead)
        self.graphs = tuple(dict.fromkeys([g for pair in self.shards for g in pair]
                                          + [self.pairing]))
        shape = dict(n=n_bucket, k=k_bucket, m=m_bucket, all_checked=all_checked, chunk=chunk,
                     shards=d)
        self._stages = [tuple(stages.traced("gpu", stage, g, **shape) for stage, g in
                              zip(("h2g2", "prepare"), pair)) for pair in self.shards]
        self._pairing = stages.traced("gpu", "pairing", self.pairing, **shape)

    def __call__(self, shards, row_mask) -> PendingVerdict:
        if len(shards) != len(self.mesh):
            raise ValueError(f"{len(shards)} shards for a mesh of {len(self.mesh)}")
        lead = self.lead
        parts = []
        for (h2g2, prepare), (g1, g2), (u, inv_idx, pk, sig, sig_checked, set_mask, scalars) \
                in zip(self._stages, self.shards, shards):
            dev = g1.device
            with _on(dev):
                with g1.lock:
                    h = _to_lead(h2g2(u), lead)
                    _mark(g1.lock, dev)
                with g2.lock:
                    outs = prepare(pk, sig, sig_checked, set_mask, scalars, inv_idx)
                    a, s, ok = (_to_lead(x, lead) for x in outs)
                    _mark(g2.lock, dev)
            parts.append((h, a, s, ok))
        with _on(lead):
            p_proj, h_unique, s_proj, sets_valid = _join_shards(parts)
            with self.pairing.lock:
                pending = PendingVerdict(self._pairing(p_proj, h_unique, s_proj, row_mask,
                                                       sets_valid))
                _mark(self.pairing.lock, lead)
        return pending


def sharded_core(n_bucket: int, k_bucket: int, m_bucket: int, all_checked: bool, mesh,
                 chunk=None) -> ShardedCore:
    """The bucket's ShardedCore over `mesh`; `chunk` None is a shard's
    chunk width, prep_chunk_width(n_bucket, d) / d."""
    mesh = pm.get_mesh(devices=mesh)
    if chunk is None:
        chunk = prep_chunk_width(n_bucket, len(mesh)) // len(mesh)
    return _sharded_core(n_bucket, k_bucket, m_bucket, all_checked, mesh, chunk)


@graphs.cached
def _sharded_core(n_bucket, k_bucket, m_bucket, all_checked, mesh, chunk):
    return ShardedCore(n_bucket, k_bucket, m_bucket, all_checked, mesh, chunk)


def resolve_mesh(device=None, sharded=None, mesh=None):
    """The mesh a verify shards over, or None for one device. `sharded`
    None means sharded when a mesh is given, or when `device` is None and
    more than one CUDA device is visible (JAX ops/backend.py:295-296). A
    sharded verify without a mesh takes every visible CUDA device."""
    if sharded is None:
        sharded = mesh is not None or (device is None and torch.cuda.device_count() > 1)
    if not sharded:
        return None
    return pm.get_mesh(devices=mesh)


def verify_signature_sets_gpu_async(sets, device=None, sharded=None, mesh=None):
    """Dispatch a batch verify on `device` (default: the card), or over a
    mesh (``resolve_mesh``), WITHOUT waiting for it: stage the batch,
    replay its bucket's graphs, and return a PendingVerdict, whose bool()
    is the verdict. Host early-outs return a Python bool, as the oracle
    rejects: empty batch, a set without keys, an infinity signature. A
    caller stages its next batch while the card runs this one."""
    mesh = resolve_mesh(device, sharded, mesh)
    if mesh is None:
        device = lb.default_device(device)
    sets = list(sets)
    if not sets:
        return False
    for s in sets:
        if not s.signing_keys or s.signature.point is None:
            return False
    if mesh is None:
        args, m_bucket, all_checked = stage(sets, device)
        k_bucket, _, _, n_bucket = args[3].shape
        bucket = graph_core(n_bucket, k_bucket, m_bucket, all_checked, args[0].device)
        return bucket.dispatch(*args)
    d = len(mesh)
    host, m_bucket, all_checked = stage_host(sets, n_floor=d, m_floor=d)
    k_bucket, _, _, n_bucket = host[3].shape
    core = sharded_core(n_bucket, k_bucket, m_bucket, all_checked, mesh)
    return core(*shard_staged(host, mesh))


def verify_signature_sets_gpu(sets, device=None, sharded=None, mesh=None) -> bool:
    """Batch-verify SignatureSets on `device` (default: the card), or over
    a mesh, through the batch's bucket graphs: the async dispatch, waited
    on."""
    return bool(verify_signature_sets_gpu_async(sets, device, sharded, mesh))


# --- Single verifications ----------------------------------------------------


def single_m_bucket(k: int) -> int:
    """The m bucket of a k-pair product: the smallest m >= k that staging
    gives a batch (``_m_bucket_for``; every menu entry is a power of two),
    so that a warm node replays stage graphs the warmer has captured."""
    return _m_bucket_for(_next_pow2(k), k)


def stage_pairs(pk_points, messages, sig_point, m_bucket: int):
    """Host staging of prod_i e(pk_i, H(m_i)) * e(-g1, sig) for stage 1 and
    stage 3 of bucket m: (u (2, 2, 12, m), p_proj (3, 12, m + 1) without its
    last column, -g1, which the device adds, s_proj (3, 2, 12, 1),
    row_mask (m,)), numpy. Padding rows are infinity and masked, and so is
    a row whose key is infinity (the oracle skips such a pair)."""
    k = len(messages)
    u = np.zeros((2, 2, lb.L, m_bucket), dtype=np.int32)
    u[..., :k] = h2c.hash_to_field_limbs_np(list(messages))
    pts = list(pk_points) + [None] * (m_bucket - k)
    row_mask = np.array([p is not None for p in pts], dtype=bool)
    return u, cv.g1_from_affine_np(pts), cv.g2_from_affine_np([sig_point]), row_mask


def verify_pairs_gpu(pk_points, messages, sig_point, device=None) -> bool:
    """prod_i e(pk_i, H(m_i)) * e(-g1, sig) == 1 on `device` (default: the
    card), deterministic, with no batch scalar: the single verifications'
    product (``crypto/bls/api.py`` verify, aggregate_verify). Runs the batch
    path's stage graphs of bucket ``single_m_bucket(k)``, stage 1 on the
    messages' field elements and stage 3 on the keys, -g1 and the
    signature, under the bucket's lock from stage 1 until the verdict is
    read (stage 1's static outputs are stage 3's input)."""
    device = lb.default_device(device)
    m_bucket = single_m_bucket(len(messages))
    u, p_proj, s_proj, row_mask = stage_pairs(pk_points, messages, sig_point, m_bucket)
    u, p_proj, s_proj, row_mask = to_device((u, p_proj, s_proj, row_mask), device)
    device = u.device
    p_proj = torch.cat([p_proj, _neg_g1(device)], dim=-1)
    valid = torch.ones((), dtype=torch.bool, device=device)
    with _stage_lock(m_bucket, device):
        h_unique = _stage1_graph(m_bucket, device)(u)
        verdict = _stage3_graph(m_bucket, device)(p_proj, h_unique, s_proj, row_mask, valid)
        return bool(verdict.item())


_api.register_backend("gpu", verify_signature_sets_gpu)
