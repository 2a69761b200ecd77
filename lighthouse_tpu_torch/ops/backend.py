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
"""

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

# The distinct-message bucket menu, as shifts off n_bucket (m = n >> s).
M_BUCKET_SHIFTS = (8, 6, 4, 2, 0)


def max_n_bucket() -> int:
    """The largest n bucket the port serves and warms: 4096. Its prepare
    stage is monolithic at every n, and no verify above 4096 sets has run
    on the card; the JAX engine's 16384 rests on its chunked prep stage
    (ROADMAP A13)."""
    return 4096


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


def stage_host(sets, scalars=None):
    """The host half of staging: a batch -> (the eight staged arrays in
    numpy, m_bucket, all_sigs_checked). `scalars` (n_bucket,) overrides the
    CSPRNG draw for deterministic callers."""
    n = len(sets)
    n_bucket = _next_pow2(n)
    k_bucket = _next_pow2(max(len(s.signing_keys) for s in sets))

    uniq: dict = {}
    inv_idx = np.zeros((n_bucket,), dtype=np.int64)
    for i, s in enumerate(sets):
        inv_idx[i] = uniq.setdefault(bytes(s.message), len(uniq))
    m_bucket = _m_bucket_for(n_bucket, len(uniq))
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


def _segment_combine(pts, inv_idx, m_bucket: int):
    """Sum weighted G1 points by message id: (3, 12, n) x (n,) ->
    (3, 12, m_bucket), out[j] = sum_{i: inv_idx[i] = j} pts[i]. Sort by id,
    then an inclusive segmented scan (value, first-of-segment flag) in
    log2(n) complete adds, then each segment's last position. Rows with no
    members gather garbage; the pairing masks them (row_mask)."""
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
    last = torch.searchsorted(ids, targets, right=True) - 1
    return v[..., last.clamp(0, n - 1)]


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


def _prepare(pk_proj, sig_proj, sig_checked, set_mask, scalars, inv_idx,
             m_bucket: int, all_checked: bool = False):
    """Stage 2: -> (p_proj (3, 12, m + 1), s_proj (3, 2, 12, 1), sets_valid).
    `all_checked` skips the device subgroup check when the host knows every
    signature passed it (its result would be ignored)."""
    n = sig_proj.shape[-1]
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
    s_proj = cv.G2.msm_reduce_minor(rsig, n)
    a_comb = _segment_combine(a_masked, inv_idx, m_bucket)
    p_proj = torch.cat([a_comb, _neg_g1(a_comb.device)], dim=-1)
    return p_proj, s_proj, torch.all(ok)


def _pairing_check(p_proj, h_unique, s_proj, row_mask, sets_valid):
    """Stage 3: product of pairings over the m distinct messages and the
    signature pair, one final exponentiation."""
    q_proj = torch.cat([h_unique, s_proj], dim=-1)
    mask = torch.cat([row_mask, torch.ones((1,), dtype=torch.bool, device=row_mask.device)])
    return torch.logical_and(pr.multi_pairing_check(p_proj, q_proj, mask), sets_valid)


def core(u, inv_idx, row_mask, pk_proj, sig_proj, sig_checked, set_mask, scalars,
         m_bucket: int, all_checked: bool = False):
    """The three stages on staged tensors -> () bool tensor, each stage
    timed while stage timing is on."""
    shape = dict(n=sig_proj.shape[-1], k=pk_proj.shape[0], m=m_bucket, all_checked=all_checked)
    prepare = partial(_prepare, m_bucket=m_bucket, all_checked=all_checked)
    h_unique = stages.traced("gpu", "h2g2", _h2g2, **shape)(u)
    p_proj, s_proj, sets_valid = stages.traced("gpu", "prepare", prepare, **shape)(
        pk_proj, sig_proj, sig_checked, set_mask, scalars, inv_idx)
    return stages.traced("gpu", "pairing", _pairing_check, **shape)(
        p_proj, h_unique, s_proj, row_mask, sets_valid)


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


@graphs.cached
def _prepare_graph(n_bucket: int, k_bucket: int, m_bucket: int, all_checked: bool, device):
    n = n_bucket
    specs = [((k_bucket, 3, lb.L, n), lb.DTYPE), ((3, 2, lb.L, n), lb.DTYPE),
             ((n,), torch.bool), ((n,), torch.bool), ((n,), torch.int64), ((n,), torch.int64)]
    return graphs.StaticGraph(partial(_prepare, m_bucket=m_bucket, all_checked=all_checked),
                              specs, device,
                              f"prepare n={n} k={k_bucket} m={m_bucket} checked={all_checked}",
                              _stage_lock(m_bucket, device),
                              graphs.pool("bls_prepare", m_bucket, device))


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
    """The stage graphs of one (n, k, m, all_checked) bucket, chained as
    ``core`` chains the stages (``jitted_core``'s counterpart), every graph
    replayed on the caller's stream. A call returns the static verdict
    tensor: read it while holding ``lock``; ``dispatch`` returns a
    PendingVerdict instead, and lets go of the lock at once."""

    def __init__(self, n_bucket: int, k_bucket: int, m_bucket: int, all_checked: bool, device):
        self.h2g2 = _stage1_graph(m_bucket, device)
        self.prepare = _prepare_graph(n_bucket, k_bucket, m_bucket, all_checked, device)
        self.pairing = _stage3_graph(m_bucket, device)
        self.graphs = (self.h2g2, self.prepare, self.pairing)
        self.lock = self.h2g2.lock
        shape = dict(n=n_bucket, k=k_bucket, m=m_bucket, all_checked=all_checked)
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


@graphs.cached
def graph_core(n_bucket: int, k_bucket: int, m_bucket: int, all_checked: bool, device):
    """The bucket's GraphCore, its graphs on `device`."""
    return GraphCore(n_bucket, k_bucket, m_bucket, all_checked, torch.device(device))


def verify_signature_sets_gpu_async(sets, device=None):
    """Dispatch a batch verify on `device` (default: the card) WITHOUT
    waiting for it: stage the batch, replay its bucket's graphs, and return
    a PendingVerdict, whose bool() is the verdict. Host early-outs return
    a Python bool, as the oracle rejects: empty batch, a set without keys,
    an infinity signature. A caller stages its next batch while the card
    runs this one."""
    device = lb.default_device(device)
    sets = list(sets)
    if not sets:
        return False
    for s in sets:
        if not s.signing_keys or s.signature.point is None:
            return False
    args, m_bucket, all_checked = stage(sets, device)
    k_bucket, _, _, n_bucket = args[3].shape
    bucket = graph_core(n_bucket, k_bucket, m_bucket, all_checked, args[0].device)
    return bucket.dispatch(*args)


def verify_signature_sets_gpu(sets, device=None) -> bool:
    """Batch-verify SignatureSets on `device` (default: the card) through
    the batch's bucket graphs: the async dispatch, waited on."""
    return bool(verify_signature_sets_gpu_async(sets, device))


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
