"""Drive the port (lighthouse_tpu_torch) on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. env      the card, the toolchain, and the build of every CUDA kernel
            (one nvcc per source, started together).
2. kernels  every kernel variant against its plain PyTorch version on the
            card, bit for bit, at n = 1, 2, 65, 64, 4096 and 16384 elements
            from a seed (edge values p - 1 and 0 included; n = 1, 2 and 65
            are where the paths run K3: the final exponentiation's chain,
            KZG's two pairs and the Miller loop's m + 1 pairs), each with
            its time (one call replayed from a CUDA graph, and a
            back-to-back wrapper call with its dispatch), the plain
            version's time and its bound. K4's operands carry the edge
            pairs of _k4_edge_pairs() in their first columns, K5's the edge
            points of _k5_edge_points() (infinity, P + P, P + (-P), O + O,
            Z != 1), K6's (the Miller loop's T chain and its one-step
            calls) T and Q G2's edge points with P's coordinates
            p.select(-3, i) of one tensor, and K4 is held
            at every edge pair at once at (12, m) and (m, 12, 1), mul_small
            at each k of K4_EDGE_KS (k_edges). K4's linear combinations
            (fp_lincomb) are held at every plan the paths register
            (fused.LINCOMB_PLANS) at each n, the edge pairs in their terms'
            first columns, and at LINCOMB_WORST's bound rows with every term
            p - 1, 0 and edge pairs; timed per plan at LINCOMB_NS. K1-K4 are
            also timed at the paths' heavy operand shapes (K1_SHAPES with
            KZG's ladder shapes, K2_SHAPES, K3_SHAPES, K4_SHAPES, K5_SHAPES,
            K6_SHAPES: the chain and both one-step calls at n = 2, 65, 4097
            and 16385 pairs), each beside floor_ms,
            an empty kernel on its library's grid timed the same way (also
            at every n). K7 (the inverse and the powers) is held at
            K7_SHAPES instead of the n above, the powers at each exponent
            of _pow_exponents (their path's and 0, 1, 15, 16, 17), its
            first columns p - 1, 0, 1, 2 and R mod p (Fp2 (p - 1, p - 1),
            (0, 0), (1, 0) and (0, 1)), and timed (the powers at their
            path's exponent) beside an empty kernel on its own grid.
   wrapper  the host's cost of the parts of one K2 wrapper call (checks,
            output allocation, library lookup, device context, stream,
            the ctypes launch), of one K4 call (checks, launch
            arguments, function lookup, device, stream, the ctypes launch)
            and of one K5 call (launch arguments, function lookup, the
            ctypes launch; whole calls dense, strided and broadcast), each
            timed alone over many calls.
3. verify   the main path, batch signature-set verification: 4096 sets x 4
            keys over 64 distinct messages must verify True, first on the
            eager path (ops/backend.core, uncaptured: a watched run records
            each kernel's operand shapes and its launches per operand n and
            per operand shape, K4 also per k of mul_small; then one more
            run counts one verify's launches), then through the API, which
            replays the bucket's CUDA graphs: the launch counts are reset
            just before its first call (which runs each stage eagerly once
            and captures it) and read just after, and every kernel must have
            been launched (but OFF_PATH's, which no path launches since K6,
            its chain and K7's inverse),
            and none of OFF_PAIRING at the pairing's m + 1 = 65 pairs; a warm
            call must launch nothing from Python. K4's launches in the eager
            verify (k4_family, by entry point) must stay within K4_CEILING:
            32 a verify, 16 in h2g2 (n = m) and 16 in the final
            exponentiation (n = 1). Then
            the eager run split into its stages for their wall times, and
            through the API: the same batch with one poisoned set in a
            shared-message group False, 256 one-key sets with distinct
            messages True, and find_invalid_sets must name the one culprit
            among 32 sets.
4. main_path_shapes
            every kernel against its plain version again, bit for bit, at
            each operand shape the headline verify gave it (stacked rows of
            Fp2 products, K3 at n = m + 1 pairs and at n = 1; K4 and K5 at
            each operand layout, strides, broadcasts and k included; K7 at
            each shape and exponent); then
            the K1, K2, K4 and K5 entries timed at the three shapes with
            the most launches in that record (k1_shapes, k2_shapes,
            k4_shapes, k5_shapes), with floor_ms.
5. vectors  every verify / fast_aggregate_verify / batch_verify case under
            tests/vectors/general/phase0/bls/*/small must give its output.
6. kzg      the second path, Deneb's verify_blob_kzg_proof_batch
            (crypto/kzg.py, ops/kzg.py): a by_root batch of 6 blobs and a
            by_range batch of 192 (KZG_BATCHES), 4096 random field
            elements each from SEED, committed and proven from a known tau
            (C = [p(tau)]G1, W = [(p(tau) - y) / (tau - z)]G1), must verify
            True: as in verify, a watched eager run records each kernel's
            operand shapes and one more counts one verify's launches, then
            the API's first call (KZG_REQUIRED must be launched, none of
            OFF_PAIRING at the pairing's n = 2, at most 20 K4 launches in an
            eager verify) and a warm
            one (nothing launched from Python), and an eager run is split
            at its stages (host, staging, stage A, stage B with the sums,
            pairing). Then through the API: by_root with two proofs swapped
            False, with one field element changed False, with every blob
            zero (so every commitment and proof at infinity) True, and the three
            Deneb vectors under tests/vectors/general/deneb/kzg/
            verify_blob_kzg_proof_batch/small with the production setup at
            their outputs.
   kzg_shapes
            every kernel the KZG runs launched against its plain version,
            bit for bit, at each operand shape they gave it (K3 at n = 2
            and 1, K1 at 2 n_bucket lanes).
6b. single  the single verifications on the card. First verify,
            aggregate_verify at k = SINGLE_K distinct messages and
            verify_kzg_proof, each: a watched eager run (staging, then the
            stage functions the graphs capture) records its operand shapes
            and one more counts its launches; then the API's first call
            (wall s, launches, the graphs it captured: none where the
            verify phase had captured the bucket) and SINGLE_TIMED_CALLS
            warm ones (wall ms, nothing launched from Python). Then the 6
            verify, 3 fast_aggregate_verify and 2 aggregate_verify cases
            under tests/vectors/general/phase0/bls/*/small through those
            functions, the 3 deneb/kzg/verify_kzg_proof/small cases with
            the production setup (a proof that fails to decompress is
            False), verify_blob_kzg_proof on each by_root blob (True, each
            timed) and on one with a changed field element (False), and
            aggregate_verify at k = SINGLE_K with two messages swapped
            (False).
   single_shapes
            every kernel the single path launched against its plain
            version, bit for bit, at each operand shape it gave it.
6c. wide    batches past 4096 sets: the headline's 64 sets tiled to
            8192 and 16384 sets (WIDE_NS), each run with the prepare stage
            monolithic and chunked at 4096 (LIGHTHOUSE_TPU_PREP_CHUNK 0 and
            WIDE_CHUNK): on one staged batch with fixed scalars the chunked
            p_proj, s_proj and sets_valid torch.equal to the monolithic
            ones; stage_host's wall and its share in the Montgomery
            conversion; then per mode a watched eager verify (operand
            shapes), one more counting every kernel, the API's first call
            (which captures the prepare graph: its kernels must be counted)
            and a warm one (nothing launched from Python), the poisoned copy
            False, the prepare graph's capture costs, the peak of
            torch.cuda.max_memory_allocated, eager and replayed warm walls
            (GRAPH_TIMED_CALLS each, in turns), the eager stage split and
            the stage timers' device ms over 3 replayed verifies.
   wide_shapes
            every kernel against its plain version, bit for bit, at each
            operand shape the wide verifies gave it that the headline did
            not.
6d. multi   the sharded verify (parallel/mesh.py): meshes over every
            visible card and MULTI_SHARDS shards laid on the lead card (one
            card: the degenerate case, which shows the split and the join
            right and their cost, not scaling). For each: a watched eager
            sharded verify (staging with the mesh's floors, then
            backend.core_sharded) and one more counting every kernel; on
            one batch with fixed scalars the lead's joined stage-2 outputs
            affine-equal to the unsharded prepare's on the message rows and
            h2g2's columns torch.equal; the API's first call (True, the
            partial prepare's kernels counted) and a warm one (only the
            join's 2 (d - 1) K5 additions launched from Python); the
            headline, the poisoned copy and the 256 distinct sets with the
            unsharded verdicts (True, False, True); the stage timers'
            device ms over 3 replayed verifies (h2g2 and prepare summed
            over the shards); eager and replayed warm walls.
   multi_shapes
            likewise at each operand shape the sharded verifies gave.
7. warmer   the port's ShapeWarmer over WARMER_RUNGS with every m of each,
            one headline verify run while it warms (True); then one more
            key captured on the main thread, to compare; each graph the
            warmer captured and every graph of the run with its costs, and
            the default warm grid's cost extrapolated per kind (81 graphs:
            53 prepare, 14 h2g2, 14 pairing).
8. profile  torch.profiler over one call of each unit (fp_add, fp_sub,
            fp_neg and fp_mul_small on equal shapes, fp_add broadcast and
            strided, fp_lincomb at the isogeny's sums and an Fp6 product's,
            G1/G2 add and double, the Miller doubling and addition
            steps, a Miller loop's T chain, the Fp inverse and the Fp2
            sqrt-ratio power: one CUDA kernel each, or the phase fails),
            over each
            device stage of the headline and by_root verifies (a stage's
            kernels are the nodes a CUDA graph of it would hold), then over
            one warm eager headline verify and one warm by_root KZG verify:
            CUDA kernels, the port's among them (which must equal the
            wrappers' launches), device busy ms, the device's idle share of
            the wall, the ten kernels launched most often.

9. graphs   the bucket graphs (ops/graphs.py): for the headline key
            (4096, 4, 64, True) and the by_root and by_range KZG keys
            (n_bucket 8 and 256), each graph's capture costs (eager warm-up,
            capture and instantiation seconds, nodes, the wrappers'
            launches during the capture, host RSS and pool bytes added);
            on one staged batch with fixed scalars the replayed h_unique,
            p_proj, s_proj, sets_valid and verdict, and KZG's terms, sums
            and verdict, equal to the eager stages' (torch.equal); two
            replays with different scalars give different p_proj and both
            verify; eager and graph warm verifies, GRAPH_TIMED_CALLS each in
            turns (median, spread); torch.profiler over one replayed
            headline, 16384-set wide (the default chunk width) and by_root
            verify (nothing launched from Python, every captured port
            kernel in the trace, busy ms, idle share). The wide phase
            traces nothing: torch.profiler has dropped the port's kernels
            from a short trace taken after long ones, and the profile
            phase's short traces come first.

10. serving the serving path in front of the card. pipelined: the headline
            batch, warm, PIPELINED_BATCHES times with every fifth the
            poisoned copy, as a blocking loop (api.verify_signature_sets)
            and pipelined (every batch dispatched through
            verify_signature_sets_gpu_async, then every verdict read), in
            turns (blocking, pipelined, pipelined, blocking), every verdict
            as expected; sets/s of each, and torch.profiler over one more
            pipelined run (busy ms, the card's idle share). stages:
            engine_stage_seconds{engine="gpu"} of h2g2, prepare and pairing
            (CUDA events) over STAGE_TIMED_CALLS replayed and eager
            verifies, beside the eager run's synchronised stage walls.
            cpu_route: the native backend "cpu" (built on first use) at 1,
            4 and 16 sets of the headline and of the distinct sets, ms a
            set and the host CPU's model; a poisoned 16 False; every
            batch_verify vector at its output. scheduler: the ShapeWarmer
            over the default grid with the batch policy, then a
            ContinuousBatchScheduler over the real router (cpu and gpu)
            drains the headline's sets as gossip_aggregate, the poisoned
            set as gossip_attestation, the 256 distinct sets as
            gossip_sync_signature, and
            SINGLE_JOBS single sets submitted alone: every job's verdict as
            expected; batches by route and size, close causes, deadline
            hits and misses, the router's learned table.

11. control the serving control plane: an Autotuner over the serving
            phase's scheduler, router and batch policy, stepped after each
            of CONTROL_ROUNDS drains of the headline's sets (every verdict
            True): each SLO evaluation and decision, then current_policy(),
            saved to a temporary directory. Then two fresh processes
            (chip_smoke.py --restart default|tuned <dir> <launch time>)
            restart a node: import, load the kernel libraries and the native
            verifier from their caches, warm DEFAULT_SHAPE_GRID, or
            tuned_shape_grid(load_policy(dir)) after apply_policy, and verify
            the headline batch through the router. Each prints the seconds
            of each step, their sum (restart to the first verified batch),
            and compile_events.counts(): no kernel_build, a kernel_cache_hit
            a source, a graph_capture a graph of its grid, or it fails, and
            so does the phase.

Then the card's name and power limit, the kernel summary line (launches:
the main path's first headline verify through the API, which runs each
stage eagerly and captures it; launches_per_verify: one eager verify, what
a replay runs; launches_kzg and launches_kzg_per_verify likewise), and last
{"ok": true, "device": {...}}. Any failure raises: the exit code is then
not 0 and the last line is not printed. Without a card it exits 1 at once.

    python3 chip_smoke.py --kernels-only

runs phases 1 and 2 (and the wrapper phase) alone and prints the kernel
summary: the quick way to time two trees' kernels in one call on one card.
To time a kernel redesign against its parent, unpack the parent with
``git archive`` into a gitignored directory, copy this script beside it,
and run both trees' ``--kernels-only`` in one call, in turns (parent,
change, change, parent). A tree whose K1, K2, K3 or K4 library has no
empty entry point gets floor_ms null there.
"""

import collections
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 20261017
# Where the operands are made: the card. A rehearsal of the script's logic
# on a CPU sets "cpu" (the kernels then take their plain versions).
DEVICE = "cuda"
NS = (1, 2, 65, 64, 4096, 16384)
# K2's operand shapes with the most launches per headline verify (the
# verify phase's launches_by_shape: fp2_sqr 760 at (2, 2, 12, 64); fp2_mul
# 254 at (4, 2, 12, 64), 201 at (2, 2, 12, 64), 130 at (4, 2, 12, 4096)),
# and its largest, (6, 2, 12, 4096) (66 launches).
K2_SHAPES = ((2, 2, 12, 64), (4, 2, 12, 64), (4, 2, 12, 4096), (6, 2, 12, 4096))
# K1's operand shapes with the most launches per headline verify (the
# verify phase's launches_by_shape: fp_mul 130 at (4, 12, 4096), 104 at
# (12, 1), 68 at (3, 2, 12, 65), 66 at (6, 12, 4096); fp_sqr all 381 at
# (12, 1)).
# KZG's ladders run it at (4, 12, 2 n_bucket) and (6, 12, 2 n_bucket): 16
# lanes for by_root (n_bucket 8), 512 for by_range (256).
K1_SHAPES = ((12, 1), (3, 2, 12, 65), (4, 12, 4096), (6, 12, 4096),
             (4, 12, 16), (4, 12, 512), (6, 12, 512))
# K4's one-row entries' operand shapes (their most called before
# fp_lincomb took every path's additive steps; no path runs them now): the
# headline's n = 4096 and m = 64, m + 1 and its largest, (6, 12, 4096).
K4_SHAPES = ((2, 12, 64), (2, 12, 65), (12, 4096), (2, 12, 4096), (6, 12, 4096))
# fp_lincomb: every plan the paths register (fused.LINCOMB_PLANS) held at NS
# with K4's edge pairs in the first columns, and timed at the paths' n: the
# final exponentiation's 1, h2g2's m = 64, 4096 and the wide bucket's
# 16384; LINCOMB_MAIN is its summary's row (the Fp6 product's sums, the
# final exponentiation's most launched plan). LINCOMB_WORST: the kernel's worst accumulator rows, every
# |c| and their sum at the bounds, both signs (held with every term p - 1).
LINCOMB_NS = (1, 64, 4096, 16384)
LINCOMB_MAIN = ("fp6_mul", 1)
LINCOMB_WORST = (((1 << 16) - 1,) * 4 + (3,), (-((1 << 16) - 1),) * 4 + (-3,),
                 ((1 << 16) - 1, -((1 << 16) - 1), (1 << 16) - 1, -((1 << 16) - 1), 3))
# K3's operand shapes on the paths: the final exponentiation's n = 1, KZG's
# two pairs and the headline's m + 1 = 65.
K3_SHAPES = ((2, 3, 2, 12, 1), (2, 3, 2, 12, 2), (2, 3, 2, 12, 65))
# K5's operand shapes on the paths, per entry: G1 in the headline's ladder
# and key tree (n = 4096) and KZG's ladders (16 and 512 lanes); G2 in h2g2's
# cofactor clearing (m = 64), the pairing's addition steps (m + 1 = 65), the
# signature ladder (4096) and the wide path's ladder (16384, max_n_bucket).
# They span both of K5's layouts (pairs of lanes up to 1024 points, one lane
# a unit from 1025).
K5 = ("g1_add", "g1_double", "g2_add", "g2_double")
# K6: a Miller loop's T chain (the paths' only K6 call) and its one-step
# calls (K6_STEPS, on no path).
K6_STEPS = ("miller_dbl", "miller_add")
K6 = K6_STEPS + ("miller_chain",)
# K7: the inverse (fp_inv, no exponent) and the powers (K7_POW, a public
# exponent each call). The paths run fp_inv and fp2_pow (K7_PATH).
K7_POW = ("fp_pow", "fp2_pow")
K7 = ("fp_inv",) + K7_POW
K7_PATH = ("fp_inv", "fp2_pow")
K5_SHAPES = {"g1_add": ((3, 12, 16), (3, 12, 512), (3, 12, 4096), (2, 3, 12, 4096)),
             "g1_double": ((3, 12, 16), (3, 12, 512), (3, 12, 4096)),
             "g2_add": ((3, 2, 12, 64), (3, 2, 12, 65), (3, 2, 12, 4096), (3, 2, 12, 16384)),
             "g2_double": ((3, 2, 12, 64), (3, 2, 12, 4096), (3, 2, 12, 16384))}
# K6's T (and Q) shapes (P's coordinates at (12, n), strided as
# p_proj.select(-3, i) gives them): KZG's two pairs, the headline's m + 1 =
# 65, 4097 pairs (4096 distinct messages) in the one-lane layout (past 1024
# pairs), and max_n_bucket() + 1 = 16385.
K6_SHAPES = {name: ((3, 2, 12, 2), (3, 2, 12, 65), (3, 2, 12, 4097), (3, 2, 12, 16385))
             for name in K6}
# Libraries timed at main-path shapes beside an empty kernel on their grid:
# library -> (empty entry point, shapes (or shapes per entry), phase tag).
FLOORED = {"fp_mul": ("lh_fp_empty", K1_SHAPES, "k1"),
           "fp2_mul": ("lh_fp2_empty", K2_SHAPES, "k2"),
           "fp12_op": ("lh_fp12_empty", K3_SHAPES, "k3"),
           "fp_add": ("lh_fp_add_empty", K4_SHAPES, "k4"),
           "curve_op": ("lh_curve_empty", {**K5_SHAPES, **K6_SHAPES}, "k5")}
# Kernels timed against an empty kernel of their own grid, not their
# library's: K6 against one on its chain's grid.
FLOOR_ENTRY = {**{name: "lh_miller_empty" for name in K6}, "fp_inv": "lh_fp_inv_empty",
               "fp_pow": "lh_fp_pow_empty", "fp2_pow": "lh_fp2_pow_empty"}
# K7's shapes: the final exponentiation's inverse (12, 1), and the Fp
# power there (no path runs it); the sqrt-ratio power at the paths' m = 1
# (single verifications), 64 (the headline) and 256 (the distinct-message
# batch) messages, with h2g2's two rows; and 4096 elements. The powers'
# exponents: each path's first (timed), then the short ones. K7_MAIN is each
# mode's headline shape, its summary's row.
K7_SHAPES = {"fp_inv": ((12, 1), (12, 4096)), "fp_pow": ((12, 1), (12, 4096)),
             "fp2_pow": ((2, 2, 12, 1), (2, 2, 12, 64), (2, 2, 12, 256), (2, 12, 4096))}
K7_MAIN = {"fp_inv": (12, 1), "fp_pow": (12, 1), "fp2_pow": (2, 2, 12, 64)}
HEADLINE = dict(n_sets=4096, keys=4, distinct=64)
# KZG batches, one RPC response each: BlobsByRoot for one block
# (MAX_BLOBS_PER_BLOCK = 6) and BlobsByRange for one epoch of full blocks
# (32 slots x 6), as range sync asks for it (network/sync.py
# EPOCHS_PER_BATCH = 1). A blob is 4096 field elements.
KZG_BATCHES = {"by_root": 6, "by_range": 192}
KZG_ELEMENTS = 4096
# Kernels the KZG path cannot run without: the G1 ladders' group law and
# Fp products, the modular additions, the Miller loop's T chain (K6) and
# the final exponentiation's Fp2 and Fp12 products (no K5 on G2: the chain
# holds the G2 doubling and addition).
K4 = ("fp_add", "fp_sub", "fp_neg", "fp_mul_small")
# K4's launches on a path, by entry point, and their ceilings a verify
# (h2g2's at m, the final exponentiation's at n = 1).
K4_FAMILY = K4 + ("fp_lincomb",)
K4_CEILING = {"headline": 32, "h2g2": 16, "final_exp": 16, "kzg": 20}
# Kernels no path launches: fp_mul_small since K6 folded the Miller steps'
# small multiples into its schedule, fp_sqr since K7 took the Fp inverse's
# squares (its only path caller), fp_pow since the inverse became K7's
# binary GCD (fp_inv), K6's one-step calls since the Miller loop runs its
# steps as one chain, fp_add, fp_sub and fp_neg since every path's additive
# steps are fp_lincomb launches. Held against their plain versions in the
# kernels phase (every shape, n = 65 included), required on no path.
OFF_PATH = ("fp_mul_small", "fp_sqr", "fp_pow", "fp_add", "fp_sub", "fp_neg") + K6_STEPS
KZG_REQUIRED = ("fp_mul", "fp2_mul", "fp12_sqr", "fp12_mul", "fp12_line", "fp_lincomb",
                "g1_add", "g1_double", "miller_chain", "fp_inv")

# Kernels K6 took off the pairing's width (n = m + 1 pairs; KZG's 2): none
# of them may launch at that n.
OFF_PAIRING = ("fp_mul", "fp_sqr", "fp2_mul", "fp2_sqr") + K4_FAMILY + ("g2_add", "g2_double")
K4_EDGE_KS = (1, 3, 4, 8, 12, 65535)     # mul_small's k at the edge pairs
K4_TIMED_K = 12     # the main path's largest k: three doublings and an add

# H100 SXM peaks (NVIDIA H100 data sheet / Hopper white paper, 700 W):
# 3.35 TB/s of HBM3, and 33.5 TOPS of INT32 with a multiply-add counted
# as two operations, i.e. 16.75e12 32-bit multiply-adds per second.
HBM_BYTES_PER_S = 3.35e12
INT32_MAD_PER_S = 33.5e12 / 2

# Per element: the 32-bit multiply-adds the function needs, and the bytes it
# must move (each operand read once, the result written once; an Fp is 48
# bytes). A product of two 12-limb Fp values is 144 multiply-adds (a square
# 78) and a Montgomery reduction 144. An Fp2 product needs 3 Fp products
# (Karatsuba; a square 2), an Fp6 product 6 Fp2 products, an Fp12 product 3
# Fp6 products (18 Fp2) and an Fp12 square 2 (12 Fp2). The sparse line
# needs 14 Fp2 products: a0 * l0 (3), a1 * (l1 v + l2 v^2) (5) and
# (a0 + a1) * (l0 + l1 v + l2 v^2) (6). Lazy reduction reduces each Fp
# output once. The kernels do more (K3 runs 36 schoolbook Fp2 products of 4
# Fp products each); the bound counts what the function needs.
FP_PROD, FP_SQR, REDC = 144, 78, 144
WORK = {
    "fp_mul": (FP_PROD + REDC, 3 * 48), "fp_sqr": (FP_SQR + REDC, 2 * 48),
    "fp2_mul": (3 * FP_PROD + 2 * REDC, 3 * 96), "fp2_sqr": (2 * FP_PROD + 2 * REDC, 2 * 96),
    "fp12_sqr": (12 * 3 * FP_PROD + 12 * REDC, 2 * 576),
    "fp12_mul": (18 * 3 * FP_PROD + 12 * REDC, 3 * 576),
    "fp12_line": (14 * 3 * FP_PROD + 12 * REDC, 2 * 576 + 288),
    # K4 needs no multiplies: add and sub read two Fp and write one, neg
    # and mul_small read one.
    "fp_add": (0, 3 * 48), "fp_sub": (0, 3 * 48), "fp_neg": (0, 2 * 48),
    "fp_mul_small": (0, 2 * 48),
    # K5, per point, as its schedule (ops/fused.py k5_schedule) needs them:
    # G1 add 12 Fp products and 9 reductions, G1 double 8 products (two of
    # them squares) and 7, G2 add 36 (six Fp2 products of three, twice) and
    # 18, G2 double 22 (its Fp2 squares of two) and 14; a G1 point is 144
    # bytes, a G2 point 288, two read and one written (double one and one).
    "g1_add": (12 * FP_PROD + 9 * REDC, 3 * 144),
    "g1_double": (2 * FP_SQR + 6 * FP_PROD + 7 * REDC, 2 * 144),
    "g2_add": (36 * FP_PROD + 18 * REDC, 3 * 288),
    "g2_double": (22 * FP_PROD + 14 * REDC, 2 * 288),
    # K6, per pair: a step's work is the smaller of its two schedules'
    # (ops/fused.py k5_schedule), the three-level one's (the per-step
    # kernels' before the chain): the doubling step 42 Fp products and 30
    # reductions, the addition step 66 and 34; the two-level one runs 44
    # (20 and 24 a level) and 30 (18, 12), and 68 (38, 30) and 36 (24,
    # 12). A step reads T (and Q), 288
    # bytes each, and P's three coordinates, 144, and writes T' and the
    # line, 576; the chain reads T, Q and P once, writes T once and
    # MILLER_STEPS' 68 lines (63 doublings and 5 additions).
    "miller_dbl": (42 * FP_PROD + 30 * REDC, 288 + 144 + 576),
    "miller_add": (66 * FP_PROD + 34 * REDC, 2 * 288 + 144 + 576),
    "miller_chain": (63 * (42 * FP_PROD + 30 * REDC) + 5 * (66 * FP_PROD + 34 * REDC),
                     2 * 288 + 144 + 288 + 68 * 288),
    # K7's inverse, per element, as its binary GCD (csrc/fp_pow.cu) needs
    # them: 37 batches, each update_fg's 2 x 2 products of 13 signed 30-bit
    # limbs, update_de's 2 x 3 and its two quotient words, then one
    # Montgomery product by +-R^3. The divsteps are adds and selects, no
    # multiply. One Fp read and one written.
    "fp_inv": (37 * ((2 * 2 + 2 * 3) * 13 + 2) + FP_PROD + REDC, 2 * 48),
}


def pow_work(name, exponent):
    """K7's (multiply-adds, bytes) per element for one exponent, as its
    chain needs them: below 16 a square a further bit and a product a set
    one (the plain loop's); from 16 the table's a^2 (a square) and 13
    products, four squares a further window and a product a nonzero digit
    but the first window's low one (a table entry). Fp2 runs its exponent
    split at p (fused.fp2_pow_digits): a window's two digits share its
    squares. An Fp square is 78 + 144 multiply-adds, a product 144 + 144;
    an Fp2 square two Fp products and two reductions, a product three and
    two. One element read and one written (the digits, shared by every
    element, not counted)."""
    from lighthouse_tpu_torch.ops import fused

    if exponent == 0:
        sqrs = muls = 0
    elif exponent < 16:
        bits = bin(exponent)[3:]
        sqrs, muls = len(bits), bits.count("1")
    else:
        digits = (fused.pow_digits if name == "fp_pow" else fused.fp2_pow_digits)(exponent)
        nibbles = [d & 15 for d in digits[1:]] + [d >> 4 for d in digits]
        sqrs = 1 + 4 * (len(digits) - 1)
        muls = 13 + sum(1 for k in nibbles if k)
    if name == "fp_pow":
        return sqrs * (FP_SQR + REDC) + muls * (FP_PROD + REDC), 2 * 48
    return sqrs * (2 * FP_PROD + 2 * REDC) + muls * (3 * FP_PROD + 2 * REDC), 2 * 96


SOURCES = {
    "fp_mul": ("lighthouse_tpu_torch/ops/csrc/fp_mul.cu",
               "lighthouse_tpu/ops/fused.py:279 _fwd_call + :319 _inv_call"),
    "fp2_mul": ("lighthouse_tpu_torch/ops/csrc/fp2_mul.cu",
                "lighthouse_tpu/ops/fused.py:279 _fwd_call + :319 _inv_call (with_offset)"),
    "fp12_op": ("lighthouse_tpu_torch/ops/csrc/fp12_op.cu",
                "lighthouse_tpu/ops/fused.py:578 _k3_fp12_call"),
    "fp_add": ("lighthouse_tpu_torch/ops/csrc/fp_add.cu",
               "none (no pallas_call): lighthouse_tpu/ops/bm/limbs.py:343 add, :347 sub, "
               ":351 neg, fused by XLA"),
    "curve_op": ("lighthouse_tpu_torch/ops/csrc/curve_op.cu",
                 "none (no pallas_call): lighthouse_tpu/ops/bm/curves.py:100 add, :122 double, "
                 "fused by XLA"),
    # K6, in K5's source, per wrapper:
    "miller_dbl": ("lighthouse_tpu_torch/ops/csrc/curve_op.cu",
                   "none (no pallas_call): lighthouse_tpu/ops/bm/pairing.py:24 _dbl_step, "
                   "fused by XLA in the lax.scan at :107"),
    "miller_add": ("lighthouse_tpu_torch/ops/csrc/curve_op.cu",
                   "none (no pallas_call): lighthouse_tpu/ops/bm/pairing.py:63 _add_step, "
                   "fused by XLA"),
    "miller_chain": ("lighthouse_tpu_torch/ops/csrc/curve_op.cu",
                     "none (no pallas_call): lighthouse_tpu/ops/bm/pairing.py:88 "
                     "miller_loop_proj, its lax.scans at :107 (_dbl_step :24) and :112 "
                     "(_add_step :63) fused by XLA"),
    # K7, one source, per kernel:
    "fp_inv": ("lighthouse_tpu_torch/ops/csrc/fp_pow.cu",
               "none (no pallas_call): lighthouse_tpu/ops/bm/limbs.py:466 inv, pow_fixed(a, "
               "P - 2), its lax.scan at :462 fused by XLA"),
    "fp_pow": ("lighthouse_tpu_torch/ops/csrc/fp_pow.cu",
               "none (no pallas_call): lighthouse_tpu/ops/bm/limbs.py:433 pow_fixed, its "
               "lax.scan at :462 fused by XLA"),
    "fp2_pow": ("lighthouse_tpu_torch/ops/csrc/fp_pow.cu",
                "none (no pallas_call): lighthouse_tpu/ops/bm/tower.py:165 fp2_pow_fixed, its "
                "lax.scan at :193 fused by XLA"),
}


def _sync() -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of back-to-back calls: the wrapper's dispatch included."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean ms of one call replayed from a CUDA graph of `reps` calls: the
    kernel's time on the card, without the host's dispatch."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------------------


def phase_env():
    from lighthouse_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    smi = subprocess.run(["nvidia-smi"], capture_output=True, text=True, check=True,
                         timeout=60).stdout
    versions = next((line.strip(" |") for line in smi.splitlines() if "CUDA Version" in line), "")
    emit({"phase": "env", "gpu": nvidia_smi("name,power.limit"), "nvidia_smi": versions,
          "torch": torch.__version__, "cuda": torch.version.cuda, "nvcc": nvcc,
          "python": sys.version.split()[0], "build_s": build_s, "built": built,
          "ptxas": {name: _build.ptxas_report(name).splitlines() for name in _build.SOURCES}})


def _rand_fp(shape, gen, strides=None, edges=False):
    """Canonical Montgomery limbs (..., 12, n) on the card: random limbs with
    the top limb below p's, and p - 1 and 0 in the first two elements; with
    `edges`, K4's edge pairs in the first columns instead, pair c's first
    value in the even terms of axis -3 and its second in the odd ones. With
    `strides`, a view of those element strides (a stride of 0 broadcasts)."""
    from lighthouse_tpu_torch.ops import limbs as lb

    x = torch.randint(0, 1 << 32, shape, generator=gen, device=DEVICE, dtype=torch.int64)
    x[..., 11, :] %= 0x1A0111EA
    edge = lb.ints_to_limbs([lb.P - 1, 0], DEVICE).to(torch.int64) & 0xFFFFFFFF
    k = min(2, shape[-1])
    x[..., :, :k] = edge[:, :k]
    if edges and len(shape) >= 3:
        pairs = _k4_edge_pairs()[:shape[-1]]
        cols = [_raw_limbs(v).to(torch.int64) & 0xFFFFFFFF for v in zip(*pairs)]
        for j in range(shape[-3]):
            x[..., j, :, :len(pairs)] = cols[j % 2]
    x = torch.where(x > 0x7FFFFFFF, x - (1 << 32), x).to(torch.int32).contiguous()
    if strides is None:
        return x
    compact = tuple(1 if st == 0 else sz for sz, st in zip(shape, strides))
    view = torch.empty_strided(compact, tuple(strides), dtype=torch.int32, device=DEVICE)
    view.copy_(x[tuple(slice(0, c) for c in compact)])
    return view.expand(shape)


def _k4_edge_pairs():
    """K4's edge values as stored limbs (any value below p is a Montgomery
    form): 0, 1, 2, p - 1, p - 2, 2^352 - 1 (limbs 0-10 all ones: + 1
    carries through 11 limbs) and 2^352, every limb all ones but the top
    one, and (p -+ 1) / 2. Every pair of them, then a + b = p and
    a + b = p - 1; a = b (sub) is on the diagonal, and 0 - 1 borrows through
    all 12 limbs."""
    from lighthouse_tpu_torch.crypto.bls.constants import P

    x = (1 << 352) - 1
    y = ((P >> 352) - 1) << 352 | x
    edges = (0, 1, 2, P - 1, P - 2, x, x + 1, y, y + 1, (P - 1) // 2, (P + 1) // 2)
    return tuple((a, b) for a in edges for b in edges) + ((1, P - 1), (1, P - 2), (P - 1, 1))


def _k5_edge_points(group):
    """K5's edge operands as projective integer coordinates (G2's as pairs),
    (P, Q) per column: every pair of O, G, 2G, -G (and [12345]G on G1), once
    with Z = 1 and once with other Zs (infinity as (0 : Z : 0)), so that
    O + O, O + P, P + P with equal and unequal Zs, P + (-P) and Z != 1 all
    occur; a doubling takes P."""
    from lighthouse_tpu_torch.crypto.bls import curves as oc
    from lighthouse_tpu_torch.crypto.bls import fields as ff
    from lighthouse_tpu_torch.crypto.bls.constants import P

    if group == "G1":
        def proj(pt, z):
            return (0, z, 0) if pt is None else (pt[0] * z % P, pt[1] * z % P, z)

        gen = oc.G1_GEN
        pts = [None, gen, oc.g1_mul(gen, 2), oc.g1_neg(gen), oc.g1_mul(gen, 12345)]
        zs = ((1, 1), (7, P - 3))
    else:
        def proj(pt, z):
            return ((0, 0), z, (0, 0)) if pt is None else (ff.fp2_mul(pt[0], z),
                                                           ff.fp2_mul(pt[1], z), z)

        gen = oc.G2_GEN
        pts = [None, gen, oc.g2_mul(gen, 2), oc.g2_neg(gen)]
        zs = (((1, 0), (1, 0)), ((5, 9), (P - 2, 3)))
    return [(proj(a, za), proj(b, zb)) for a in pts for b in pts for za, zb in zs]


def _point_limbs(points, group):
    """Projective integer points -> (3, 12, m) or (3, 2, 12, m) Montgomery
    limbs on the card."""
    from lighthouse_tpu_torch.ops import limbs as lb
    from lighthouse_tpu_torch.ops import tower as tw

    make = lb.ints_to_limbs if group == "G1" else tw.fp2_from_int_pairs
    return torch.stack([make([pt[i] for pt in points], DEVICE) for i in range(3)])


def _raw_limbs(vals):
    """Stored integers below p -> (12, m) int32 limbs on the card."""
    words = [[(v >> (32 * i)) & 0xFFFFFFFF for i in range(12)] for v in vals]
    t = torch.tensor(words, dtype=torch.int64, device=DEVICE).T
    return torch.where(t > 0x7FFFFFFF, t - (1 << 32), t).to(torch.int32).contiguous()


def _operand_shapes(name, shape):
    """The operand shapes of kernel `name` for a first operand of `shape`:
    each operand of its kind's tail over the same lead axes and n."""
    from lighthouse_tpu_torch.ops import fused

    kinds = fused._KERNELS[name][2]
    lead = tuple(shape[:-len(fused._TAIL[kinds[0]]) - 1])
    return [lead + fused._TAIL[k] + (shape[-1],) for k in kinds]


def _operands(name, shapes, gen):
    """Random operands of `name` at `shapes`; K4's first columns hold its
    edge pairs, K5's its edge points (as many as fit), K6's T and Q G2's edge
    points and its P coordinates p.select(-3, i) of one (..., 3, 12, n)
    tensor, as the pairing gives them."""
    if name in K6:
        pts = len(shapes) - 3
        xs = [_rand_fp(tuple(shape), gen) for shape in shapes[:pts]]
        p = _rand_fp(tuple(shapes[-1][:-2]) + (3,) + tuple(shapes[-1][-2:]), gen)
        pairs = _k5_edge_points("G2")[:shapes[0][-1]]
        for x, pt in zip(xs, zip(*pairs)):
            x[..., :len(pt)] = _point_limbs(pt, "G2")
        return xs + [p.select(-3, i) for i in range(3)]
    xs = [_rand_fp(tuple(shape), gen) for shape in shapes]
    if name in K7:
        _pow_edges(name, xs[0])
    if name in K4:
        pairs = _k4_edge_pairs()[:shapes[0][-1]]
        for x, vals in zip(xs, zip(*pairs)):
            x[..., :len(vals)] = _raw_limbs(vals)
    if name in K5:
        group = name[:2].upper()
        pairs = _k5_edge_points(group)[:shapes[0][-1]]
        for x, pts in zip(xs, zip(*pairs)):
            x[..., :len(pts)] = _point_limbs(pts, group)
    return xs


def _pow_edges(name, x):
    """K7's edge values in x's first columns, as Montgomery forms: p - 1,
    0, 1, 2 and R mod p; an Fp2 (p - 1, p - 1), (0, 0), (1, 0) and (0, 1)."""
    from lighthouse_tpu_torch.ops import limbs as lb

    cols = (((lb.P - 1, 0, 1, 2, lb.R_MOD_P),) if name != "fp2_pow"
            else ((lb.P - 1, 0, 1, 0), (lb.P - 1, 0, 0, 1)))
    for c, vals in enumerate(cols):
        k = min(len(vals), x.shape[-1])
        part = x if name != "fp2_pow" else x[..., c, :, :]
        part[..., :k] = lb.ints_to_limbs(vals[:k], x.device)


def _call(name, xs, k=K4_TIMED_K, plain=False):
    """Kernel `name` on xs; k is mul_small's multiple or K7's exponent."""
    from lighthouse_tpu_torch.ops import fused

    fn = (fused.PLAIN if plain else fused.WRAPPERS)[name]
    if name == "fp_lincomb":                # k: the plan's coefficients
        return fn(tuple(xs), k)
    return fn(*xs, k) if name in ("fp_mul_small",) + K7_POW else fn(*xs)


def _check_equal(name, what, xs, k=K4_TIMED_K):
    """Kernel `name` against its plain version on operands xs, tolerance 0
    -> max |limb difference| (0)."""
    got = _call(name, xs, k)
    ref = _call(name, xs, k, plain=True)
    _sync()
    if isinstance(got, tuple):          # K6: the point and the line(s)
        if len(got) != len(ref) or any(g.shape != r.shape for g, r in zip(got, ref)):
            raise AssertionError(f"{name} at {what}: outputs {[tuple(g.shape) for g in got]}, "
                                 f"plain {[tuple(r.shape) for r in ref]}")
    else:
        got, ref = (got,), (ref,)
    err = 0
    for g, r in zip(got, ref):
        if g.shape != r.shape:
            raise AssertionError(f"{name} at {what}: shape {tuple(g.shape)}, plain {tuple(r.shape)}")
        diff = (g.to(torch.int64) & 0xFFFFFFFF) - (r.to(torch.int64) & 0xFFFFFFFF)
        mism = int(diff.ne(0).any(dim=-2).sum())
        if mism:
            raise AssertionError(f"{name} at {what}: {mism} elements differ from the plain version")
        err = max(err, int(diff.abs().max()))
    return err


def _compare(name, shapes, gen):
    """Kernel `name` against its plain version on random operands of the
    given shapes, tolerance 0 -> (operands, max |limb difference|)."""
    xs = _operands(name, shapes, gen)
    return xs, _check_equal(name, shapes, xs)


def _k4_edges():
    """Every K4 entry at every edge pair at once, at (12, m) and (m, 12, 1),
    mul_small at each k of K4_EDGE_KS -> max |limb difference| (0)."""
    from lighthouse_tpu_torch.ops import fused

    pairs = _k4_edge_pairs()
    a, b = (_raw_limbs(v) for v in zip(*pairs))
    col = [x.T.reshape(len(pairs), 12, 1).contiguous() for x in (a, b)]
    err = 0
    for name in K4:
        arity = len(fused._KERNELS[name][2])
        for operands in ((a, b), col):
            xs = operands[:arity]
            for k in (K4_EDGE_KS if name == "fp_mul_small" else (K4_TIMED_K,)):
                err = max(err, _check_equal(name, f"edges {tuple(xs[0].shape)} k={k}", xs, k))
    return err


def _floor(lib, shape, kind, name=None):
    """Graph-replay and call ms of an empty kernel on library `lib`'s grid
    (or kernel `name`'s, FLOOR_ENTRY) for an operand shape of its kernels,
    of operand kind `kind` (its tail fused._TAIL[kind] + (n,)); None where
    the library has none."""
    import ctypes

    from lighthouse_tpu_torch.ops import _build, fused

    fn = getattr(_build.library(lib), FLOOR_ENTRY.get(name) or FLOORED[lib][0], None)
    if fn is None:
        return None, None
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rows = math.prod(shape[:-len(fused._TAIL[kind]) - 1])

    def call():
        if fn(None, rows, shape[-1], torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("empty kernel launch failed")

    return graph_ms(call, 200), cuda_ms(call, 200)


def _timed(name, shapes, gen):
    """Kernel `name` at one operand shape: compared with its plain version
    (tolerance 0), then timed, with its bound from WORK."""
    from lighthouse_tpu_torch.ops import fused

    xs, err = _compare(name, shapes, gen)
    elems = math.prod(shapes[0]) // math.prod(fused._TAIL[fused._KERNELS[name][2][0]])
    reps = 200 if elems < 16384 else 50
    call_ms = cuda_ms(lambda: _call(name, xs), reps)
    ms = graph_ms(lambda: _call(name, xs), reps)
    # The chain's plain version is 68 plain steps (1.4 s at 16385 pairs).
    plain_ms = cuda_ms(lambda: _call(name, xs, plain=True), 1 if name == "miller_chain" else 3)
    mads, nbytes = WORK[name]
    t_ops, t_bytes = elems * mads / INT32_MAD_PER_S * 1e3, elems * nbytes / HBM_BYTES_PER_S * 1e3
    return {"mismatches": 0, "max_abs_err": err, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _pow_exponents(name):
    """The exponents K7 mode `name` is held at: the powers' path exponent
    first (timed), then 0, 1, 15, 16 and 17; the inverse none (None)."""
    from lighthouse_tpu_torch.crypto.bls.constants import P
    from lighthouse_tpu_torch.ops import tower

    if name == "fp_inv":
        return (None,)
    path = P - 2 if name == "fp_pow" else tower._SQRT_RATIO_EXP
    return (path, 0, 1, 15, 16, 17)


def _timed_pow(name, shape, gen):
    """K7 mode `name` at one operand shape: bit for bit with its plain
    version at each exponent of _pow_exponents (edge values in the first
    columns), then timed at the path's exponent beside an empty kernel on
    its grid, with its bound from pow_work (the inverse's from WORK, and the
    power p - 2's beside it as pow_bound_ms, for comparison only)."""
    from lighthouse_tpu_torch.crypto.bls.constants import P
    from lighthouse_tpu_torch.ops import fused

    exps = _pow_exponents(name)
    (x,) = _operands(name, [shape], gen)
    err = max(_check_equal(name, f"{shape} e={e}", [x], e) for e in exps)
    e = exps[0]
    elems = math.prod(shape) // math.prod(fused._TAIL[fused._KERNELS[name][2][0]])
    reps = 20
    call_ms = cuda_ms(lambda: _call(name, [x], e), reps)
    ms = graph_ms(lambda: _call(name, [x], e), reps)
    plain_ms = cuda_ms(lambda: _call(name, [x], e, plain=True), 1)
    def bound(mads, nbytes):
        t_ops = elems * mads / INT32_MAD_PER_S * 1e3
        t_bytes = elems * nbytes / HBM_BYTES_PER_S * 1e3
        return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"

    bound_ms, bound_by = bound(*(WORK[name] if name == "fp_inv" else pow_work(name, e)))
    floor_ms, floor_call_ms = _floor("fp_pow", shape, fused._KERNELS[name][2][0], name)
    row = {"mismatches": 0, "max_abs_err": err, "exponents": len(exps),
           "windows": None if e is None else len(fused._k7_digits(name, e, x.device)),
           "ms": ms, "call_ms": call_ms,
           "plain_ms": plain_ms, "floor_ms": floor_ms, "floor_call_ms": floor_call_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    if name == "fp_inv":
        row["pow_bound_ms"] = bound(*pow_work("fp_pow", P - 2))[0]
    return row


def _entries(lib):
    """(kernel name, operand kinds) of each entry point of library `lib`
    but fp_lincomb, which _lincomb_kernels holds and times per plan."""
    from lighthouse_tpu_torch.ops import fused

    return [(name, kinds) for name, (owner, _, kinds) in fused._KERNELS.items()
            if owner == lib and name != "fp_lincomb"]


def _lincomb_bound(xs, coeffs):
    """fp_lincomb's bound on operands xs: each term that a row reads (a
    nonzero coefficient) read once over its operand's other axes (a
    broadcast axis once), each output Fp written once, 4 bytes a limb; the
    multiply-adds a nonzero coefficient's 12 limbs and a quotient's 12 a
    column -> (bound ms, by)."""
    from lighthouse_tpu_torch.ops import fused

    lead, n = fused._lincomb_shape(xs)
    cols = math.prod(lead) * n
    used = {j for row in coeffs for j, c in enumerate(row) if c}
    read, first = 0, 0
    for x in xs:
        axis = x.dim() - 3
        terms = len(used & set(range(first, first + x.shape[axis])))
        first += x.shape[axis]
        per_term = math.prod(sz for i, (sz, st) in enumerate(zip(x.shape, x.stride()))
                             if st and i != axis)
        read += 4 * per_term * (min(terms, 1) if x.stride(axis) == 0 else terms)
    nbytes = read + 4 * cols * len(coeffs) * 12
    mads = cols * 12 * (sum(1 for row in coeffs for c in row if c) + len(coeffs))
    t_ops, t_bytes = mads / INT32_MAD_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _timed_lincomb(coeffs, xs):
    """fp_lincomb on operands xs: bit for bit with its plain version, then
    timed beside an empty kernel on its grid, with its bound."""
    from lighthouse_tpu_torch.ops import fused

    err = _check_equal("fp_lincomb", f"{[tuple(x.shape) for x in xs]}", xs, coeffs)
    lead, n = fused._lincomb_shape(xs)
    reps = 200 if n < 16384 else 50
    call_ms = cuda_ms(lambda: _call("fp_lincomb", xs, coeffs), reps)
    ms = graph_ms(lambda: _call("fp_lincomb", xs, coeffs), reps)
    plain_ms = cuda_ms(lambda: _call("fp_lincomb", xs, coeffs, plain=True), 3)
    floor_ms, floor_call_ms = _floor("fp_add", lead + (len(coeffs), 12, n), "fp", "fp_lincomb")
    bound_ms, bound_by = _lincomb_bound(xs, coeffs)
    return {"mismatches": 0, "max_abs_err": err, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "floor_ms": floor_ms, "floor_call_ms": floor_call_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def _lincomb_kernels(gen):
    """fp_lincomb at every plan the paths register: bit for bit with its plain
    version at each n of NS, one operand (J, 12, n) with K4's edge pairs in
    its first columns; timed at LINCOMB_NS. Then LINCOMB_WORST with every
    term p - 1, 0 and edge pairs. -> ({plan: {n: row}}, the worst rows'
    max |limb difference|)."""
    from lighthouse_tpu_torch.crypto.bls.constants import P
    from lighthouse_tpu_torch.ops import curves, fused, h2c, tower  # noqa: F401 (their plans)

    per_plan = {}
    for name, coeffs in sorted(fused.LINCOMB_PLANS.items()):
        per_plan[name] = {}
        j = len(coeffs[0])
        for n in NS:
            x = _rand_fp((j, 12, n), gen, edges=True)
            if n in LINCOMB_NS:
                per_plan[name][n] = _timed_lincomb(coeffs, [x])
            else:
                _check_equal("fp_lincomb", f"{name} n={n}", [x], coeffs)
    worst = 0
    for vals in ((P - 1,) * 5, (0,) * 5, None):
        x = (_rand_fp((5, 12, 130), gen, edges=True) if vals is None
             else torch.stack([_raw_limbs([v] * 3) for v in vals]))
        worst = max(worst, _check_equal("fp_lincomb", f"worst rows {vals}", [x], LINCOMB_WORST))
    return per_plan, worst


def _time_shapes(name, shapes, gen):
    """Kernel `name` (K1, K2, K4 or K5) at each operand shape, with its
    library's floor_ms."""
    from lighthouse_tpu_torch.ops import fused

    lib, _, kinds = fused._KERNELS[name]
    per = {}
    for shape in shapes:
        row = _timed(name, _operand_shapes(name, tuple(shape)), gen)
        row["floor_ms"], row["floor_call_ms"] = _floor(lib, tuple(shape), kinds[0], name)
        per[str(tuple(shape))] = row
    return per


def phase_kernels():
    from lighthouse_tpu_torch.ops import fused

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    results = {}
    for name in K7:
        per = {str(shape): _timed_pow(name, shape, gen) for shape in K7_SHAPES[name]}
        results[name] = per
        emit({"phase": "kernels", "kernel": name, "tolerance": 0, "by_shape": per,
              "library_ms": None})
    for name, (lib, _, kinds) in fused._KERNELS.items():
        if name in K7 or name == "fp_lincomb":
            continue
        per_n = {n: _timed(name, [fused._TAIL[k] + (n,) for k in kinds], gen) for n in NS}
        if lib in FLOORED:
            for n, row in per_n.items():
                row["floor_ms"], row["floor_call_ms"] = _floor(
                    lib, fused._TAIL[kinds[0]] + (n,), kinds[0], name)
        results[name] = per_n
        emit({"phase": "kernels", "kernel": name, "tolerance": 0, "by_n": per_n,
              "library_ms": None, **({"k": K4_TIMED_K} if name == "fp_mul_small" else {})})
    k4_err = _k4_edges()
    emit({"phase": "kernels", "k4_edges": {"pairs": len(_k4_edge_pairs()), "ks": K4_EDGE_KS,
                                          "tolerance": 0, "mismatches": 0,
                                          "max_abs_err": k4_err}})
    per_plan, worst_err = _lincomb_kernels(gen)
    results["fp_lincomb"] = per_plan
    emit({"phase": "kernels", "kernel": "fp_lincomb", "tolerance": 0, "ns": NS,
          "by_plan": per_plan, "plans": {k: len(v) for k, v in fused.LINCOMB_PLANS.items()},
          "worst_rows": {"coeffs": LINCOMB_WORST, "mismatches": 0, "max_abs_err": worst_err},
          "library_ms": None})
    by_shape = {}
    for lib in FLOORED:
        for name, _ in _entries(lib):
            shapes = FLOORED[lib][1]
            by_shape[name] = _time_shapes(name, shapes[name] if isinstance(shapes, dict)
                                          else shapes, gen)
    for name, per in by_shape.items():
        emit({"phase": "kernels", "kernel": name, "tolerance": 0, "by_shape": per})
    fused.reset_launches()      # the comparison launches do not count
    return results, by_shape


def _host_us(fn, reps: int = 5000) -> float:
    """Mean host microseconds of one call of fn over `reps` calls."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def phase_wrapper():
    """The host's cost of each part of one K2 wrapper call, at (2, 12, 64),
    and of the whole call; then of one K4 fp_add call at (2, 12, 64), of
    whole K4 calls on strided and broadcast operands, and of fp_lincomb's
    launch arguments and whole call at the isogeny's sums (2, 32, 12, 64)."""
    from lighthouse_tpu_torch.ops import _build, fused, h2c  # noqa: F401 (h2c's plans)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)
    a, b = (_rand_fp((2, 12, 64), gen) for _ in range(2))
    out = torch.empty_like(a)
    fn = getattr(_build.library("fp2_mul"), "lh_fp2_mul")
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (out.data_ptr(), a.data_ptr(), b.data_ptr())

    def device_context():
        with torch.cuda.device(a.device):
            pass

    parts = {
        "check": lambda: fused._check("fp2_mul", (a, b)),
        "empty_like": lambda: torch.empty_like(a),
        "library_getattr": lambda: getattr(_build.library("fp2_mul"), "lh_fp2_mul"),
        "device_context": device_context,
        "current_device": torch.cuda.current_device,
        "current_stream": lambda: torch.cuda.current_stream(a.device).cuda_stream,
        "current_stream_default": lambda: torch.cuda.current_stream().cuda_stream,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(a.device.index),
        "data_ptrs": lambda: (out.data_ptr(), a.data_ptr(), b.data_ptr()),
        "ctypes_launch": lambda: fn(*ptrs, 1, 64, stream),
        "whole_call": lambda: fused.fp2_mul(a, b),
    }
    emit({"phase": "wrapper", "kernel": "fp2_mul", "shape": [2, 12, 64],
          "host_us": {k: _host_us(f) for k, f in parts.items()}})

    k4_fn = fused._kernel_fn("fp_add")
    k4_out, _, k4_args = fused._k4_args("fp_add", (a, b), 0)     # k4_out lives over the launches
    fp2 = _rand_fp((3, 2, 12, 64), gen)
    x0, x1 = fp2[..., 0, :, :], fp2[..., 1, :, :]
    one = _rand_fp((12, 1), gen)
    iso, iso_plan = _rand_fp((2, 32, 12, 64), gen), fused.LINCOMB_PLANS["iso_map_sums"]

    k4_parts = {
        "check": lambda: fused._check_additive("fp_add", (a, b), 0),
        "launch_args": lambda: fused._k4_args("fp_add", (a, b), 0),
        "launch_args_strided": lambda: fused._k4_args("fp_add", (x0, x1), 0),
        "function_lookup": lambda: fused._kernel_fn("fp_add"),
        "current_device": torch.cuda.current_device,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(a.device.index),
        "ctypes_launch": lambda: k4_fn(*k4_args, stream),
        "whole_call": lambda: fused.fp_add(a, b),
        "whole_call_strided": lambda: fused.fp_add(x0, x1),
        "whole_call_broadcast": lambda: fused.fp_add(a, one),
        "whole_call_mul_small": lambda: fused.fp_mul_small(a, K4_TIMED_K),
        "lincomb_check": lambda: fused._check_lincomb((iso,), iso_plan),
        "lincomb_launch_args": lambda: fused._lincomb_args((iso,), iso_plan),
        "whole_call_lincomb": lambda: fused.fp_lincomb(iso, iso_plan),
    }
    emit({"phase": "wrapper", "kernel": "fp_add", "shape": [2, 12, 64],
          "host_us": {k: _host_us(f) for k, f in k4_parts.items()}})

    g2 = _rand_fp((3, 2, 12, 64), gen)
    g1 = _rand_fp((3, 12, 65), gen)
    col = _rand_fp((3, 12, 1), gen).expand(3, 12, 64)
    k5_fn = fused._kernel_fn("g2_add")
    k5_out, _, k5_args = fused._k5_args("g2_add", (g2, g2))   # k5_out lives over the launches
    k5_parts = {
        "launch_args": lambda: fused._k5_args("g2_add", (g2, g2)),
        "launch_args_strided": lambda: fused._k5_args("g1_add", (g1[..., :-1], g1[..., 1:])),
        "function_lookup": lambda: fused._kernel_fn("g2_add"),
        "ctypes_launch": lambda: k5_fn(*k5_args, stream),
        "whole_call": lambda: fused.g2_add(g2, g2),
        "whole_call_double": lambda: fused.g2_double(g2),
        "whole_call_strided": lambda: fused.g1_add(g1[..., :-1], g1[..., 1:]),
        "whole_call_broadcast": lambda: fused.g1_add(g1[..., :-1], col),
    }
    # 500 calls: K5 runs 7-17 us a call on the card, and 5000 back to back
    # would fill the launch queue and time the card instead of the host.
    emit({"phase": "wrapper", "kernel": "g2_add", "shape": [3, 2, 12, 64],
          "host_us": {k: _host_us(f, 500) for k, f in k5_parts.items()}})
    fused.reset_launches()


def _new_shapes(shapes, seen):
    """The operand shapes of `shapes` that `seen` (the headline's record)
    does not hold, per kernel."""
    return {name: v - seen.get(name, set()) for name, v in shapes.items()}


def phase_main_path_shapes(shapes, phase="main_path_shapes", required=None):
    """Every kernel against its plain version at each operand shape a path
    gave it (stacked leading rows included; K4, K5 and K6 at each operand
    layout, its strides, broadcasts and k, fp_lincomb also at each plan with
    K4's edge pairs in its terms' first columns; K7 at each exponent),
    tolerance 0. Each kernel in
    `required` (default: all but OFF_PATH) must have a recorded shape; the
    others are held at theirs, if any."""
    from lighthouse_tpu_torch.ops import fused

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 1)
    required = _main_required() if required is None else required
    errs = {}
    for name in fused._KERNELS:
        if not shapes[name]:
            if name in required:
                raise AssertionError(f"no {phase} recorded for {name}")
            continue
        if name in K7_POW:
            errs[name] = max(_check_equal(name, f"{shape} e={e}",
                                          _operands(name, [shape], gen), e)
                             for shape, e in sorted(shapes[name]))
            recorded = sorted({shape for shape, _ in shapes[name]})
            extra = {"exponents": len({e for _, e in shapes[name]})}
        elif name in K4_FAMILY + K5 + K6:
            err = 0
            for layout, k in sorted(shapes[name]):
                xs = [_rand_fp(sh, gen, st, edges=name == "fp_lincomb") for sh, st in layout]
                err = max(err, _check_equal(name, f"{layout} k={k}", xs, k))
            errs[name] = err
            recorded = sorted({tuple(sh for sh, _ in layout) for layout, _ in shapes[name]})
            extra = {"layouts": len(shapes[name]),
                     "plans": len({k for _, k in shapes[name]}) if name == "fp_lincomb" else None,
                     "strided_or_broadcast": sum(
                         1 for layout, _ in shapes[name]
                         if any(st != torch.empty(sh, device="meta").stride() for sh, st in layout))}
        else:
            errs[name] = max(_compare(name, list(sh), gen)[1] for sh in sorted(shapes[name]))
            recorded, extra = sorted(shapes[name]), {}
        emit({"phase": phase, "kernel": name, "tolerance": 0, "mismatches": 0,
              "max_abs_err": errs[name], "shapes": recorded, **extra})
    fused.reset_launches()
    return errs


def _main_required():
    """The kernels the headline must launch: all but OFF_PATH."""
    from lighthouse_tpu_torch.ops import fused

    return [k for k in fused.launches if k not in OFF_PATH]


def _off_pairing(by_n, n, what):
    """No kernel of OFF_PAIRING launched at the pairing's width n (K6 holds
    the Miller steps' products, additions and group law)."""
    hit = {k: by_n[k][n] for k in OFF_PAIRING if by_n[k].get(n)}
    if hit:
        raise AssertionError(f"{what} launched {hit} at the pairing's n = {n}")


def _sign_sets(api, count, keys, msg_of, key_base):
    sets = []
    for i in range(count):
        sks = [api.SecretKey(key_base + i * 64 + j) for j in range(keys)]
        msg = msg_of(i)
        agg = api.AggregateSignature.aggregate([sk.sign(msg) for sk in sks])
        sets.append(api.SignatureSet(
            signature=api.Signature(point=agg.point, subgroup_checked=True),
            signing_keys=[sk.public_key() for sk in sks], message=msg))
    return sets


def _eager_verify(sets):
    """A headline-style verify on the eager path, uncaptured: staging, then
    backend.core (the function the bucket graphs capture)."""
    from lighthouse_tpu_torch.ops import backend

    args, m_bucket, all_checked = backend.stage(sets, torch.device(DEVICE))
    return bool(backend.core(*args, m_bucket=m_bucket, all_checked=all_checked).item())


def _main_path_runs(verify, eager, what, required=None):
    """The first and a warm run of a main-path verify through its entry
    point (the first captures the bucket's graphs: each stage once eagerly,
    then under capture; the warm one replays), with the launch counts reset
    just before each and read just after. Each kernel of `required`
    (default: all but OFF_PATH) must be launched in the first, none of
    OFF_PATH, and none from Python in the warm one. -> (launches of the
    first run, its wall s, the warm run's wall s)."""
    from lighthouse_tpu_torch.ops import fused

    required = _main_required() if required is None else required
    fused.reset_launches()
    ok, first_s = _timed_verify(verify, *eager)
    launches = dict(fused.launches)
    if ok is not True:
        raise AssertionError(f"{what} did not verify on its first use")
    missing = [k for k in required if launches[k] <= 0]
    if missing:
        raise AssertionError(f"the main path ({what}) launched no {missing}")
    off = {k: launches[k] for k in OFF_PATH if launches[k]}
    if off:
        raise AssertionError(f"the main path ({what}) launched {off}, which no path runs")
    fused.reset_launches()
    ok, wall_s = _timed_verify(verify, *eager)
    if ok is not True:
        raise AssertionError(f"{what} did not verify warm")
    if sum(fused.launches.values()):
        raise AssertionError(f"a warm {what} verify launched {dict(fused.launches)} "
                             "from Python: it did not replay its graphs")
    return launches, first_s, wall_s


def _timed_verify(verify, *args, sync=None):
    """verify(*args) -> (its verdict, wall seconds, synchronised: by `sync`,
    default the whole device)."""
    sync = sync or torch.cuda.synchronize
    sync()
    t0 = time.perf_counter()
    ok = verify(*args)
    sync()
    return ok, time.perf_counter() - t0


def _bls_stages(sets, chunk=0):
    """The headline verify's stages as thunks on fixed inputs, each stage's
    inputs made once by the stages before it: staging on the host, then
    h2g2, prepare (chunked at `chunk`) and pairing (which returns the
    verdict)."""
    from lighthouse_tpu_torch.ops import backend

    device = torch.device(DEVICE)
    args, m_bucket, all_checked = backend.stage(sets, device)
    u, inv_idx, row_mask, pk, sig, sig_checked, set_mask, scalars = args
    h = backend._h2g2(u)
    prep = (pk, sig, sig_checked, set_mask, scalars, inv_idx, m_bucket, all_checked, chunk)
    p_proj, s_proj, valid = backend._prepare(*prep)
    return {"staging": lambda: backend.stage(sets, device),
            "h2g2": lambda: backend._h2g2(u),
            "prepare": lambda: backend._prepare(*prep),
            "pairing": lambda: bool(backend._pairing_check(p_proj, h, s_proj, row_mask,
                                                           valid).item())}


def _stage_seconds(stages, what):
    """Wall seconds of each stage thunk, each ended by a synchronise; the
    last must return True."""
    out = {}
    for name, fn in stages.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = fn()
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
    if ok is not True:
        raise AssertionError(f"{what} did not verify stage by stage")
    return out


def _watched(fn):
    """fn() with every kernel call's operand shapes recorded -> (its result,
    {kernel: set of operand shapes}, {kernel: {operand n: calls}},
    {kernel: {first operand's shape: calls}}). K4's, K5's and K6's records
    are of operand layouts, ((shape, strides) per operand, k) (k = 0 but for
    mul_small; fp_lincomb's k is its plan's coefficients), K7's of (shape,
    exponent), and K4's by_n also counts mul_small's calls per k under
    ("k", k)."""
    from lighthouse_tpu_torch.ops import fused

    shapes = {name: set() for name in fused.launches}
    by_n = {name: {} for name in fused.launches}
    by_shape = {name: {} for name in fused.launches}
    run, run_additive, run_curve = fused._run, fused._run_additive, fused._run_curve
    run_miller, run_pow, run_lincomb = fused._run_miller, fused._run_pow, fused._run_lincomb

    def count(name, xs):
        n = xs[0].shape[-1]
        by_n[name][n] = by_n[name].get(n, 0) + 1
        key = tuple(xs[0].shape)
        by_shape[name][key] = by_shape[name].get(key, 0) + 1

    def watch(name, *xs):
        shapes[name].add(tuple(tuple(x.shape) for x in xs))
        count(name, xs)
        return run(name, *xs)

    def watch_additive(name, xs, k=0):
        shapes[name].add((tuple((tuple(x.shape), tuple(x.stride())) for x in xs), k))
        count(name, xs)
        if name == "fp_mul_small":
            by_n[name][("k", k)] = by_n[name].get(("k", k), 0) + 1
        return run_additive(name, xs, k)

    def watch_curve(name, xs):
        shapes[name].add((tuple((tuple(x.shape), tuple(x.stride())) for x in xs), 0))
        count(name, xs)
        return run_curve(name, xs)

    def watch_miller(name, xs):
        shapes[name].add((tuple((tuple(x.shape), tuple(x.stride())) for x in xs), 0))
        count(name, xs)
        return run_miller(name, xs)

    def watch_pow(name, a, exponent):
        shapes[name].add((tuple(a.shape), exponent))
        count(name, (a,))
        return run_pow(name, a, exponent)

    def watch_lincomb(xs, coeffs):
        shapes["fp_lincomb"].add((tuple((tuple(x.shape), tuple(x.stride())) for x in xs),
                                  coeffs))
        count("fp_lincomb", xs)
        return run_lincomb(xs, coeffs)

    fused._run, fused._run_additive, fused._run_curve = watch, watch_additive, watch_curve
    fused._run_miller, fused._run_pow, fused._run_lincomb = watch_miller, watch_pow, watch_lincomb
    try:
        out = fn()
    finally:
        fused._run, fused._run_additive, fused._run_curve = run, run_additive, run_curve
        fused._run_miller, fused._run_pow, fused._run_lincomb = run_miller, run_pow, run_lincomb
    return out, shapes, by_n, by_shape


def _k4_family(per_verify, by_n, ceiling, m=None):
    """K4's launches in one eager verify by entry point (fp_add, fp_sub,
    fp_neg, fp_mul_small and fp_lincomb), checked against `ceiling`; with m,
    h2g2's (at n = m) and the final exponentiation's (at n = 1) against
    theirs. -> the counts."""
    launched = {k: per_verify[k] for k in K4_FAMILY}
    out = {"by_entry": launched, "total": sum(launched.values()), "ceiling": ceiling}
    if out["total"] > ceiling:
        raise AssertionError(f"{out['total']} K4 launches a verify, past {ceiling}: {launched}")
    if m is not None:
        for part, n in (("h2g2", m), ("final_exp", 1)):
            out[part] = sum(by_n[k].get(n, 0) for k in K4_FAMILY)
            if out[part] > K4_CEILING[part]:
                raise AssertionError(f"{out[part]} K4 launches in {part} (n = {n}), past "
                                     f"{K4_CEILING[part]}")
    return out


def _by_n_json(by_n):
    """{kernel: {n or ("k", k): calls}} -> JSON keys, n first, in order."""
    def key(kv):
        n = kv[0]
        return (1, n[1]) if isinstance(n, tuple) else (0, n)

    return {name: {(f"k={n[1]}" if isinstance(n, tuple) else str(n)): c
                   for n, c in sorted(v.items(), key=key)}
            for name, v in by_n.items()}


def phase_verify():
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.ops import fused

    t0 = time.perf_counter()
    base = _sign_sets(api, HEADLINE["distinct"], HEADLINE["keys"],
                      lambda i: i.to_bytes(4, "big") * 8, 100_000)
    n = HEADLINE["n_sets"]
    sets = (base * (n // len(base) + 1))[:n]
    sign_s = time.perf_counter() - t0

    # First run, eager: allocator warm-up, and the record of every operand
    # shape the path gives each kernel (the timed run below goes unwatched).
    (ok, warm_s), shapes, by_n, by_shape = _watched(lambda: _timed_verify(_eager_verify, sets))
    if ok is not True:
        raise AssertionError("headline batch did not verify")
    fused.reset_launches()
    ok, eager_s = _timed_verify(_eager_verify, sets)
    per_verify = dict(fused.launches)
    if ok is not True:
        raise AssertionError("headline batch did not verify")
    missing = [k for k in _main_required() if per_verify[k] <= 0]
    if missing:
        raise AssertionError(f"the eager headline verify launched no {missing}")
    k4 = _k4_family(per_verify, by_n, K4_CEILING["headline"], HEADLINE["distinct"])
    _off_pairing(by_n, HEADLINE["distinct"] + 1, "the headline")
    # The main path, the API: its first call captures the bucket's graphs.
    launches, first_s, wall_s = _main_path_runs(api.verify_signature_sets, (sets,),
                                                "headline")
    stages_s = _stage_seconds(_bls_stages(sets), "headline batch")

    # Poison set 69: same message as set 5 (69 % 64 == 5), set 6's keys.
    poisoned = list(sets)
    poisoned[69] = api.SignatureSet(sets[69].signature, sets[6].signing_keys, sets[69].message)
    bad, bad_s = _timed_verify(api.verify_signature_sets, poisoned)
    if bad is not False:
        raise AssertionError("poisoned batch verified")

    t1 = time.perf_counter()
    distinct = _sign_sets(api, 256, 1, lambda i: b"distinct" + i.to_bytes(24, "big"), 7_000)
    sign2_s = time.perf_counter() - t1
    ok256, d_s = _timed_verify(api.verify_signature_sets, distinct)
    if ok256 is not True:
        raise AssertionError("256 distinct-message sets did not verify")

    small = list(sets[:32])
    small[13] = api.SignatureSet(sets[14].signature, small[13].signing_keys, small[13].message)
    t2 = time.perf_counter()
    culprits = api.find_invalid_sets(small)
    find_s = time.perf_counter() - t2
    if culprits != [13]:
        raise AssertionError(f"find_invalid_sets named {culprits}, expected [13]")

    emit({"phase": "verify", "headline": {"sets": n, "keys_per_set": HEADLINE["keys"],
                                          "distinct_messages": HEADLINE["distinct"],
                                          "verified": ok, "wall_s": wall_s,
                                          "first_use_s": first_s, "eager_wall_s": eager_s,
                                          "eager_first_run_s": warm_s,
                                          "sigs_per_s": n / wall_s,
                                          "launches": launches,
                                          "launches_per_eager_verify": per_verify,
                                          "k4_family": k4,
                                          "stages_s": stages_s,
                                          "launches_by_n": _by_n_json(by_n),
                                          "launches_by_shape": {
                                              k: {str(sh): c for sh, c in sorted(
                                                  v.items(), key=lambda kv: -kv[1])}
                                              for k, v in by_shape.items()}},
          "poisoned": {"verified": bad, "wall_s": bad_s},
          "distinct_256": {"verified": ok256, "wall_s": d_s, "sigs_per_s": 256 / d_s},
          "find_invalid_32": {"culprits": culprits, "wall_s": find_s},
          "host_signing_s": sign_s + sign2_s})
    return (launches, per_verify, shapes, by_shape,
            (lambda: _eager_verify(sets), lambda: _bls_stages(sets)), sets, poisoned, distinct)


def phase_top_shapes(by_shape, lib):
    """The entries of library `lib` (K1, K2, K4 or K5) timed at the three
    operand shapes with the most launches in the headline verify's record
    (phase k1_shapes, k2_shapes, k4_shapes or k5_shapes)."""
    from lighthouse_tpu_torch.ops import fused

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    top = {name: sorted(by_shape[name], key=lambda sh: -by_shape[name][sh])[:3]
           for name, _ in _entries(lib)}
    for name in top:
        per = _time_shapes(name, top[name], gen)
        tag = "k6" if name in K6 else FLOORED[lib][2]
        emit({"phase": f"{tag}_shapes", "kernel": name, "tolerance": 0,
              "launches": {str(sh): by_shape[name][sh] for sh in top[name]}, "by_shape": per})
    fused.reset_launches()


def _vector_sets(api, kind, inp):
    """Signature sets of one vector case; None if any input fails to
    deserialize (the spec's harness then expects False)."""
    def h(s):
        return bytes.fromhex(s[2:] if s.startswith("0x") else s)

    try:
        if kind == "batch_verify":
            raw = [(s["pubkeys"], s["message"], s["signature"]) for s in inp["sets"]]
        elif kind == "verify":
            raw = [([inp["pubkey"]], inp["message"], inp["signature"])]
        else:
            raw = [(inp["pubkeys"], inp["message"], inp["signature"])]
        return [api.SignatureSet(
            signature=api.Signature.from_bytes(h(sig), subgroup_check=False),
            signing_keys=[api.PublicKey.from_bytes(h(pk)) for pk in pks],
            message=h(msg)) for pks, msg, sig in raw]
    except api.BlsError:
        return None


def phase_vectors():
    from lighthouse_tpu_torch.crypto.bls import api

    base = ROOT / "tests" / "vectors" / "general" / "phase0" / "bls"
    cases = []
    for kind in ("verify", "fast_aggregate_verify", "batch_verify"):
        for meta in sorted((base / kind / "small").glob("*/meta.json")):
            case = json.loads(meta.read_text())
            sets = _vector_sets(api, kind, case["input"])
            got = False if sets is None else api.verify_signature_sets(sets)
            if got != case["output"]:
                raise AssertionError(f"{kind}/{meta.parent.name}: got {got}, want {case['output']}")
            cases.append(f"{kind}/{meta.parent.name}")
    if not cases:
        raise AssertionError("no vectors found")
    emit({"phase": "vectors", "passed": len(cases), "cases": cases})


def _kzg_verifier(tau: int):
    """A Kzg of KZG_ELEMENTS elements from a known tau: [tau]G2 and the
    bit-reversed domain. Its Lagrange points are left out (the batch verify
    never reads them; the constructor takes n from their count)."""
    from lighthouse_tpu_torch.crypto import kzg as kz
    from lighthouse_tpu_torch.crypto.bls import curves as oc

    n = KZG_ELEMENTS
    w = kz._root_of_unity(n)
    bits = n.bit_length() - 1
    domain = [pow(w, kz._bit_reverse(i, bits), kz.R) for i in range(n)]
    return kz.Kzg([None] * n, oc.g2_mul(oc.G2_GEN, tau), domain)


def _kzg_batch(kzg, tau: int, rng, count: int):
    """`count` blobs of random canonical field elements (each below 2^254),
    with commitments C = [p(tau)]G1 and proofs W = [(p(tau) - y) / (tau - z)]G1,
    z the blob's challenge and y = p(z): no MSM over a setup."""
    from lighthouse_tpu_torch.crypto import kzg as kz
    from lighthouse_tpu_torch.crypto.bls import curves as oc

    blobs, commitments, proofs = [], [], []
    for _ in range(count):
        raw = rng.integers(0, 256, size=(KZG_ELEMENTS, 32), dtype=np.uint8)
        raw[:, 0] &= 0x3F
        blob = raw.tobytes()
        evals = kzg.blob_to_field_elements(blob)
        p_tau = kzg.evaluate_polynomial(evals, tau)
        c = oc.g1_mul(oc.G1_GEN, p_tau)
        z = kzg._challenge(blob, c)
        y = kzg.evaluate_polynomial(evals, z)
        blobs.append(blob)
        commitments.append(c)
        proofs.append(oc.g1_mul(oc.G1_GEN, (p_tau - y) * pow(tau - z, -1, kz.R) % kz.R))
    return blobs, commitments, proofs


def _kzg_eager(kzg, blobs, commitments, proofs):
    """verify_blob_kzg_proof_batch on the eager path, uncaptured: the host's
    challenges, staging, then ops/kzg._combine (the function the bucket
    graph captures)."""
    from lighthouse_tpu_torch.ops import kzg as okzg

    zs, ys, r = kzg.batch_inputs(blobs, commitments, proofs)
    staged = okzg.stage(commitments, zs, ys, proofs, r, kzg.g2_tau, torch.device(DEVICE))
    return bool(okzg._combine(*staged)[-1].item())


def _kzg_stages(kzg, blobs, commitments, proofs):
    """A KZG verify's stages as thunks on fixed inputs (as _bls_stages): the
    host's challenges, evaluations and r; staging; stage A; stage B with the
    sums; the pairing."""
    from lighthouse_tpu_torch.ops import kzg as okzg

    device = torch.device(DEVICE)
    zs, ys, r = kzg.batch_inputs(blobs, commitments, proofs)
    staged = okzg.stage(commitments, zs, ys, proofs, r, kzg.g2_tau, device)
    commit, proof, g2_tau, y_words, z_words, r_words = staged
    term = okzg._stage_a(commit, proof, y_words, z_words)
    sums = okzg._stage_b(term, proof, r_words)
    return {"host": lambda: kzg.batch_inputs(blobs, commitments, proofs),
            "staging": lambda: okzg.stage(commitments, zs, ys, proofs, r, kzg.g2_tau, device),
            "stage_a": lambda: okzg._stage_a(commit, proof, y_words, z_words),
            "stage_b": lambda: okzg._stage_b(term, proof, r_words),
            "pairing": lambda: bool(okzg._pairing_check(sums, g2_tau).item())}


def _kzg_vectors():
    """The committed Deneb verify_blob_kzg_proof_batch vectors with the
    production setup: {case: (got, want)}; an input that fails to
    deserialize gives False, as the spec's harness expects."""
    from lighthouse_tpu_torch.crypto import kzg as kz
    from lighthouse_tpu_torch.crypto.bls import curves as oc

    kzg = kz.Kzg.load_trusted_setup()
    out = {}
    base = ROOT / "tests" / "vectors" / "general" / "deneb" / "kzg"
    for meta in sorted((base / "verify_blob_kzg_proof_batch" / "small").glob("*/meta.json")):
        case = json.loads(meta.read_text())
        blobs = [(meta.parent / f"blob_{i}.bin").read_bytes() for i in range(case["count"])]
        try:
            cs = [oc.g1_from_compressed(bytes.fromhex(h[2:]))
                  for h in case["input"]["commitments"]]
            ps = [oc.g1_from_compressed(bytes.fromhex(h[2:])) for h in case["input"]["proofs"]]
            got = kzg.verify_blob_kzg_proof_batch(blobs, cs, ps)
        except (ValueError, kz.KzgError):
            got = False
        out[meta.parent.name] = (got, case["output"])
    return out


def phase_kzg():
    """Deneb's verify_blob_kzg_proof_batch on the card (module docstring,
    phase 6) -> ({batch: launches}, the operand shapes its warm-up runs
    gave each kernel)."""
    from lighthouse_tpu_torch.crypto.bls.constants import R
    from lighthouse_tpu_torch.ops import fused

    rng = np.random.default_rng(SEED)
    tau = int.from_bytes(rng.bytes(32), "big") % R
    kzg = _kzg_verifier(tau)
    t0 = time.perf_counter()
    batches = {name: _kzg_batch(kzg, tau, rng, count) for name, count in KZG_BATCHES.items()}
    make_s = time.perf_counter() - t0

    shapes = {name: set() for name in fused.launches}
    launches, per_verify, runs = {}, {}, {}
    for name, batch in batches.items():
        (ok_first, eager_first_s), rec, by_n, by_shape = _watched(
            lambda: _timed_verify(_kzg_eager, kzg, *batch))
        for k, v in rec.items():
            shapes[k] |= v
        fused.reset_launches()
        ok, eager_s = _timed_verify(_kzg_eager, kzg, *batch)
        per_verify[name] = dict(fused.launches)
        if ok_first is not True or ok is not True:
            raise AssertionError(f"KZG batch {name} did not verify")
        missing = [k for k in KZG_REQUIRED if per_verify[name][k] <= 0]
        if missing:
            raise AssertionError(f"the eager KZG verify ({name}) launched no {missing}")
        k4 = _k4_family(per_verify[name], by_n, K4_CEILING["kzg"])
        _off_pairing(by_n, 2, f"KZG {name}")
        launches[name], first_s, wall_s = _main_path_runs(
            kzg.verify_blob_kzg_proof_batch, batch, f"KZG {name}", KZG_REQUIRED)
        runs[name] = {"blobs": len(batch[0]), "verified": ok, "wall_s": wall_s,
                      "first_use_s": first_s, "eager_wall_s": eager_s,
                      "eager_first_run_s": eager_first_s,
                      "stages_s": _stage_seconds(_kzg_stages(kzg, *batch), f"KZG batch {name}"),
                      "launches": launches[name],
                      "launches_per_eager_verify": per_verify[name],
                      "k4_family": k4,
                      "launches_by_n": _by_n_json(by_n),
                      "launches_by_shape": {
                          k: {str(sh): c for sh, c in sorted(v.items(), key=lambda kv: -kv[1])}
                          for k, v in by_shape.items()}}

    blobs, commitments, proofs = batches["by_root"]
    tampered = bytearray(blobs[1])
    tampered[7 * 32 + 31] ^= 1                  # element 7 of blob 1, still canonical
    zero = bytes(32 * KZG_ELEMENTS)
    n = len(blobs)
    cases = {
        "swapped": ((blobs, commitments, [proofs[1], proofs[0]] + proofs[2:]), False),
        "tampered": (([blobs[0], bytes(tampered)] + blobs[2:], commitments, proofs), False),
        "all_zero": (([zero] * n, [None] * n, [None] * n), True),
    }
    verdicts = {}
    for case, (args, want) in cases.items():
        got, wall_s = _timed_verify(kzg.verify_blob_kzg_proof_batch, *args)
        if got is not want:
            raise AssertionError(f"KZG {case}: got {got}, want {want}")
        verdicts[case] = {"verified": got, "wall_s": wall_s}
    t1 = time.perf_counter()
    vectors = _kzg_vectors()
    vectors_s = time.perf_counter() - t1
    for case, (got, want) in vectors.items():
        if got is not want:
            raise AssertionError(f"KZG vector {case}: got {got}, want {want}")
    if sorted(vectors) != ["empty", "swapped_proofs", "valid_pair"]:
        raise AssertionError(f"KZG vectors found: {sorted(vectors)}")
    emit({"phase": "kzg", **runs, **verdicts, "host_batch_making_s": make_s,
          "vectors": {case: got for case, (got, _) in vectors.items()},
          "vectors_s": vectors_s})
    fused.reset_launches()
    return (launches, per_verify, shapes,
            (lambda: _kzg_eager(kzg, *batches["by_root"]),
             lambda: _kzg_stages(kzg, *batches["by_root"])), (kzg, batches))


# The single verifications: the timed calls a function, and aggregate_verify's
# k, the headline's distinct-message count.
SINGLE_TIMED_CALLS = 5
SINGLE_K = HEADLINE["distinct"]
# Per single verification, the kernels its eager run must launch: K7, each
# pairing's inverse and BLS's h2g2 power.
SINGLE_REQUIRED = {"verify": K7_PATH, f"aggregate_verify_k{SINGLE_K}": K7_PATH,
                   "verify_kzg_proof": ("fp_inv",)}


def _hex(s):
    return bytes.fromhex(s[2:] if s.startswith("0x") else s)


def _single_bls_vectors(api):
    """Every verify / fast_aggregate_verify / aggregate_verify case under
    tests/vectors/general/phase0/bls/*/small through the function itself:
    {case: verdict}. An input that fails to deserialize gives False, as the
    spec's harness expects; the call itself is outside that catch."""
    base = ROOT / "tests" / "vectors" / "general" / "phase0" / "bls"
    cases = {}
    for kind in ("verify", "fast_aggregate_verify", "aggregate_verify"):
        for meta in sorted((base / kind / "small").glob("*/meta.json")):
            case = json.loads(meta.read_text())
            inp = case["input"]
            try:
                sig = api.Signature.from_bytes(_hex(inp["signature"]), subgroup_check=False)
                pks = [api.PublicKey.from_bytes(_hex(pk))
                       for pk in ([inp["pubkey"]] if kind == "verify" else inp["pubkeys"])]
            except api.BlsError:
                got = False
            else:
                if kind == "verify":
                    got = api.verify(pks[0], _hex(inp["message"]), sig)
                elif kind == "fast_aggregate_verify":
                    got = api.fast_aggregate_verify(pks, _hex(inp["message"]), sig)
                else:
                    got = api.aggregate_verify(pks, [_hex(m) for m in inp["messages"]], sig)
            if got != case["output"]:
                raise AssertionError(f"{kind}/{meta.parent.name}: got {got}, want {case['output']}")
            cases[f"{kind}/{meta.parent.name}"] = got
    counts = collections.Counter(c.split("/")[0] for c in cases)
    if counts != {"verify": 6, "fast_aggregate_verify": 3, "aggregate_verify": 2}:
        raise AssertionError(f"BLS single vectors found: {dict(counts)}")
    return cases


def _single_kzg_vectors(kzg):
    """The verify_kzg_proof vectors with the production [tau]G2: {case:
    verdict}; a commitment or proof that fails to decompress gives False."""
    from lighthouse_tpu_torch.crypto.bls import curves as oc

    base = ROOT / "tests" / "vectors" / "general" / "deneb" / "kzg" / "verify_kzg_proof" / "small"
    out = {}
    for meta in sorted(base.glob("*/meta.json")):
        case = json.loads(meta.read_text())
        inp = case["input"]
        try:
            c, w = (oc.g1_from_compressed(_hex(inp[k])) for k in ("commitment", "proof"))
        except ValueError:
            got = False
        else:
            got = kzg.verify_kzg_proof(c, int(inp["z"], 16), int(inp["y"], 16), w)
        if got is not case["output"]:
            raise AssertionError(f"verify_kzg_proof/{meta.parent.name}: got {got}, "
                                 f"want {case['output']}")
        out[meta.parent.name] = got
    if sorted(out) != ["malformed_proof", "valid", "wrong_y"]:
        raise AssertionError(f"KZG single vectors found: {sorted(out)}")
    return out


def _single_eager(pk_points, messages, sig_point):
    """A single verification's product on the eager path, uncaptured: its
    staging, then stage 1 and stage 3 (the functions the graphs capture)."""
    from lighthouse_tpu_torch.ops import backend

    m_bucket = backend.single_m_bucket(len(messages))
    u, p_proj, s_proj, mask = backend.to_device(
        backend.stage_pairs(pk_points, messages, sig_point, m_bucket), DEVICE)
    p_proj = torch.cat([p_proj, backend._neg_g1(p_proj.device)], dim=-1)
    valid = torch.ones((), dtype=torch.bool, device=p_proj.device)
    return bool(backend._pairing_check(p_proj, backend._h2g2(u), s_proj, mask, valid).item())


def _kzg_single_eager(kzg, c, z, y, w):
    """verify_kzg_proof on the eager path: the n = 1 staging and
    ops/kzg._combine."""
    from lighthouse_tpu_torch.ops import kzg as okzg

    staged = okzg.stage([c], [z], [y], [w], 1, kzg.g2_tau, torch.device(DEVICE))
    return bool(okzg._combine(*staged)[-1].item())


def _single_api_runs(fn, what):
    """fn's first call through the API and SINGLE_TIMED_CALLS warm ones,
    the launch counts reset just before each and read just after: every
    call True, no warm call launching from Python. -> (first-use s, its
    launches, the graphs it captured, warm wall s)."""
    from lighthouse_tpu_torch.ops import fused

    def captured():
        return {name for name, g in _all_graphs().items() if g.stats is not None}

    before = captured()
    fused.reset_launches()
    ok, first_s = _timed_verify(fn)
    first = {k: v for k, v in fused.launches.items() if v}
    if ok is not True:
        raise AssertionError(f"{what} did not verify on its first use")
    walls = []
    for _ in range(SINGLE_TIMED_CALLS):
        fused.reset_launches()
        ok, wall_s = _timed_verify(fn)
        if ok is not True:
            raise AssertionError(f"{what} did not verify warm")
        if sum(fused.launches.values()):
            raise AssertionError(f"a warm {what} launched {dict(fused.launches)} from Python")
        walls.append(wall_s)
    return first_s, first, sorted(captured() - before), walls


def _ms_stats(walls):
    return {"median_ms": 1e3 * statistics.median(walls), "min_ms": 1e3 * min(walls),
            "max_ms": 1e3 * max(walls)}


def phase_single(kzg_state, distinct):
    """The single verifications (module docstring, phase 6b) -> the operand
    shapes their eager runs gave each kernel."""
    from lighthouse_tpu_torch.crypto import kzg as kz
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.ops import fused

    kzg, batches = kzg_state
    blobs, commitments, proofs = batches["by_root"]
    group = distinct[:SINGLE_K]
    pks = [s.signing_keys[0] for s in group]
    msgs = [s.message for s in group]
    agg = api.Signature(point=api.AggregateSignature.aggregate(
        [s.signature for s in group]).point, subgroup_checked=True)
    one = group[0]
    zs, ys, _ = kzg.batch_inputs(blobs[:1], commitments[:1], proofs[:1])
    kzg_args = (commitments[0], zs[0], ys[0], proofs[0])
    # First the timed functions, so that each first use is the function's
    # own (verify_kzg_proof's n = 1 graph is new here; the BLS buckets
    # m = 1 and m = SINGLE_K were captured by the verify phase).
    cases = {
        "verify": (lambda: api.verify(one.signing_keys[0], one.message, one.signature),
                   lambda: _single_eager([one.signing_keys[0].point], [one.message],
                                         one.signature.point)),
        f"aggregate_verify_k{SINGLE_K}": (lambda: api.aggregate_verify(pks, msgs, agg),
                                          lambda: _single_eager([p.point for p in pks], msgs,
                                                                agg.point)),
        "verify_kzg_proof": (lambda: kzg.verify_kzg_proof(*kzg_args),
                             lambda: _kzg_single_eager(kzg, *kzg_args)),
    }
    shapes = {name: set() for name in fused.launches}
    runs = {}
    for name, (api_call, eager) in cases.items():
        ok, rec, _, _ = _watched(eager)
        for k, v in rec.items():
            shapes[k] |= v
        fused.reset_launches()
        ok2 = eager()
        per_eager = {k: v for k, v in fused.launches.items() if v}
        if ok is not True or ok2 is not True:
            raise AssertionError(f"{name} did not verify on the eager path")
        missing = [k for k in SINGLE_REQUIRED[name] if k not in per_eager]
        if missing:
            raise AssertionError(f"the eager {name} launched no {missing}")
        first_s, first, new_graphs, walls = _single_api_runs(api_call, name)
        runs[name] = {"first_use_s": first_s, "first_use_launches": first,
                      "graphs_captured_at_first_use": new_graphs,
                      "warm_wall": _ms_stats(walls), "warm_walls_s": walls,
                      "warm_launches": 0, "launches_per_eager_call": per_eager}

    t0 = time.perf_counter()
    bls_vectors = _single_bls_vectors(api)
    production = kz.Kzg.load_trusted_setup()
    kzg_vectors = _single_kzg_vectors(production)
    vectors_s = time.perf_counter() - t0

    blob_verdicts, blob_walls = [], []
    for b, c, w in zip(blobs, commitments, proofs):
        ok, wall_s = _timed_verify(kzg.verify_blob_kzg_proof, b, c, w)
        blob_verdicts.append(ok)
        blob_walls.append(wall_s)
    tampered = bytearray(blobs[1])
    tampered[7 * 32 + 31] ^= 1
    tampered_verdict = kzg.verify_blob_kzg_proof(bytes(tampered), commitments[1], proofs[1])
    if blob_verdicts != [True] * len(blobs) or tampered_verdict is not False:
        raise AssertionError(f"blob proofs {blob_verdicts}, tampered {tampered_verdict}")
    swapped = [msgs[1], msgs[0]] + msgs[2:]
    if api.aggregate_verify(pks, swapped, agg) is not False:
        raise AssertionError(f"aggregate_verify at k = {SINGLE_K} with two messages swapped verified")
    fused.reset_launches()
    emit({"phase": "single", "gpu": nvidia_smi("name,power.limit"),
          "bls_vectors": bls_vectors, "kzg_vectors": kzg_vectors, "vectors_s": vectors_s,
          "blob_proofs": blob_verdicts, "blob_proof_walls_s": blob_walls,
          "blob_proof_tampered": tampered_verdict,
          f"aggregate_verify_k{SINGLE_K}_swapped": False, "runs": runs})
    return shapes


# The wide phase: the headline's sets tiled past 4096, each bucket
# monolithic and chunked (LIGHTHOUSE_TPU_PREP_CHUNK), and the multi phase:
# the sharded verify over meshes on the card.
WIDE_NS = (8192, 16384)
WIDE_CHUNK = 4096
WIDE_MODES = {"monolithic": 0, "chunked": WIDE_CHUNK}
MULTI_SHARDS = (2, 4)       # shards laid on the lead card, beside every card's mesh


def _tiled(base, n):
    """`base` repeated to n sets, and a copy with set len(base) + 5 (69 for
    the headline's 64) poisoned: set 5's message under set 6's keys."""
    from lighthouse_tpu_torch.crypto.bls import api

    sets = (base * (n // len(base) + 1))[:n]
    poisoned = list(sets)
    i = len(base) + 5
    poisoned[i] = api.SignatureSet(sets[i].signature, sets[6].signing_keys, sets[i].message)
    return sets, poisoned


def _staging_split(sets, reps=3):
    """stage_host's wall, `reps` times, and the share of it spent in
    limbs.ints_to_limbs_np (the Montgomery conversion in Python integers),
    with the coordinates it converted."""
    from lighthouse_tpu_torch.ops import backend
    from lighthouse_tpu_torch.ops import limbs as lb

    orig = lb.ints_to_limbs_np
    spent = {"s": 0.0, "coordinates": 0}

    def timed(xs):
        t0 = time.perf_counter()
        out = orig(xs)
        spent["s"] += time.perf_counter() - t0
        spent["coordinates"] += out.shape[-1]
        return out

    walls, conv = [], []
    lb.ints_to_limbs_np = timed
    try:
        for _ in range(reps):
            spent.update(s=0.0, coordinates=0)
            t0 = time.perf_counter()
            backend.stage_host(sets)
            walls.append(time.perf_counter() - t0)
            conv.append(spent["s"])
    finally:
        lb.ints_to_limbs_np = orig
    return {"stage_host_s": walls, "ints_to_limbs_np_s": conv,
            "coordinates": spent["coordinates"]}


def _chunk_equal(sets, n):
    """On one staged batch with fixed scalars, the chunked prepare's
    p_proj, s_proj and sets_valid torch.equal to the monolithic one's."""
    from lighthouse_tpu_torch.ops import backend

    from lighthouse_tpu_torch.ops import fused

    args, m_bucket, checked = backend.stage(sets, torch.device(DEVICE),
                                            scalars=backend.draw_scalars(n, n))
    u, inv_idx, row_mask, pk, sig, sig_checked, set_mask, scalars = args
    outs, used = {}, {}
    for mode, chunk in WIDE_MODES.items():
        fused.reset_launches()
        outs[mode] = backend._prepare(pk, sig, sig_checked, set_mask, scalars, inv_idx,
                                      m_bucket, checked, chunk)
        _sync()
        used[mode] = sorted(k for k, v in fused.launches.items() if v)
    mono, chunked = outs["monolithic"], outs["chunked"]
    return _same({name: (a, b) for name, a, b in zip(("p_proj", "s_proj", "sets_valid"),
                                                       mono, chunked)},
                 f"n = {n}: chunked against monolithic prepare"), used


def _replayed_stage_ms(verify, what, calls=3):
    """engine_stage_seconds{engine="gpu"} (CUDA events around each stage's
    replays) over `calls` warm verifies -> ({stage: device ms a verify},
    {stage: samples a verify}: one a shard for a sharded verify's h2g2
    and prepare)."""
    from lighthouse_tpu_torch.observability import stages

    names = ("h2g2", "prepare", "pairing")
    hist = stages.stage_seconds()
    stages.force_timing(True)
    try:
        before = _stage_device_s(hist, names)
        for _ in range(calls):
            if verify() is not True:
                raise AssertionError(f"{what} did not verify with stage timing on")
        stages.settle(wait=True)
        after = _stage_device_s(hist, names)
    finally:
        stages.force_timing(False)
    return ({k: (after[k][1] - before[k][1]) / calls * 1e3 for k in names},
            {k: (after[k][0] - before[k][0]) / calls for k in names})


def phase_wide(base):
    """Batches past 4096 sets (module docstring, phase 6c) -> (the operand
    shapes the wide verifies gave each kernel, their launches per run)."""
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.ops import backend, fused

    if backend.max_n_bucket() < max(WIDE_NS):
        raise AssertionError(f"max_n_bucket() is {backend.max_n_bucket()}")
    dev = torch.device(DEVICE)
    shapes = {name: set() for name in fused.launches}
    launches, runs = {}, {}
    default = os.environ.get("LIGHTHOUSE_TPU_PREP_CHUNK")
    try:
        for n in WIDE_NS:
            sets, poisoned = _tiled(base, n)
            equal, prepare_kernels = _chunk_equal(sets, n)
            runs[n] = {"chunked_equals_monolithic": equal, "staging": _staging_split(sets)}
            for mode, width in WIDE_MODES.items():
                os.environ["LIGHTHOUSE_TPU_PREP_CHUNK"] = str(width)   # the chunk width
                what = f"wide {n} x {HEADLINE['keys']} {mode}"
                (ok, eager_first_s), rec, _, _ = _watched(
                    lambda: _timed_verify(_eager_verify, sets))
                for k, v in rec.items():
                    shapes[k] |= v
                eager = _eager_launches(lambda: _eager_verify(sets), what)
                torch.cuda.reset_peak_memory_stats()
                # Stage 1 and 3 may replay graphs captured before (m = 64
                # at n = 16384: the headline's): the first call captures
                # the prepare graph, whose kernels must all be counted.
                first, first_s, warm_s = _main_path_runs(api.verify_signature_sets, (sets,),
                                                         what, prepare_kernels[mode])
                launches[f"{n} {mode}"] = {"first_api_call": first, "eager_verify": eager}
                core = backend.graph_core(n, HEADLINE["keys"],
                                          backend._m_bucket_for(n, len(base)), True, dev)
                if not core.prepare.name.endswith(f"chunk={width}"):
                    raise AssertionError(f"{what} reached {core.prepare.name}")
                bad, bad_s = _timed_verify(api.verify_signature_sets, poisoned)
                if bad is not False:
                    raise AssertionError(f"{what}: the poisoned copy verified")
                runs[n][mode] = {
                    "verified": ok, "poisoned": bad, "poisoned_wall_s": bad_s,
                    "first_use_s": first_s, "warm_wall_s": warm_s,
                    "eager_first_run_s": eager_first_s,
                    "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                    "graphs": {g.name: _stats(g) for g in core.graphs},
                    "walls": _walls(lambda: _eager_verify(sets),
                                    lambda: api.verify_signature_sets(sets), what),
                    "stages_s": _stage_seconds(_bls_stages(sets, width), what),
                    "replayed_stage_device_ms": _replayed_stage_ms(
                        lambda: api.verify_signature_sets(sets), what)[0]}
                runs[n][mode]["sigs_per_s_replayed"] = \
                    n / runs[n][mode]["walls"]["graph"]["median_s"]
    finally:
        if default is None:
            os.environ.pop("LIGHTHOUSE_TPU_PREP_CHUNK", None)
        else:
            os.environ["LIGHTHOUSE_TPU_PREP_CHUNK"] = default
    fused.reset_launches()
    emit({"phase": "wide", "gpu": nvidia_smi("name,power.limit"), "keys_per_set": HEADLINE["keys"],
          "distinct_messages": HEADLINE["distinct"], "chunk": WIDE_CHUNK,
          "default_chunk": backend.DEFAULT_PREP_CHUNK, "max_n_bucket": backend.max_n_bucket(),
          "runs": {str(n): v for n, v in runs.items()}, "launches": launches})
    return shapes, launches


def _eager_launches(verify, what):
    """One eager verify with the launch counts reset just before and read
    just after: it must verify and launch every kernel but OFF_PATH's."""
    from lighthouse_tpu_torch.ops import fused

    fused.reset_launches()
    ok = verify()
    launched = dict(fused.launches)
    # (A rehearsal on the CPU runs the plain versions: nothing is counted.)
    missing = [k for k in _main_required() if launched[k] <= 0 and DEVICE == "cuda"]
    if ok is not True or missing:
        raise AssertionError(f"{what} on the eager path: verdict {ok}, launched no {missing}")
    return launched


def _eager_sharded(sets, mesh):
    """A sharded verify on the eager path: staging with the mesh's floors,
    then backend.core_sharded."""
    from lighthouse_tpu_torch.ops import backend

    d = len(mesh)
    host, m_bucket, checked = backend.stage_host(sets, n_floor=d, m_floor=d)
    return bool(backend.core_sharded(*backend.shard_staged(host, mesh), m_bucket,
                                     checked).item())


def _sharded_stage2(sets, mesh):
    """On one batch with fixed scalars, the lead's stage-2 outputs of the
    sharded path (each shard's partial prepare, joined) against the
    unsharded prepare's, as affine points on the batch's message rows and
    the -g1 row; the joined h2g2 columns torch.equal to the unsharded
    ones; and the validity bits equal."""
    from lighthouse_tpu_torch.ops import backend, fused
    from lighthouse_tpu_torch.ops import curves as cv

    d, lead = len(mesh), mesh[0]
    n_bucket = backend._next_pow2(len(sets), floor=d)
    host, m_bucket, checked = backend.stage_host(sets, backend.draw_scalars(len(sets), n_bucket),
                                                 n_floor=d, m_floor=d)
    u, inv_idx, row_mask, pk, sig, sig_checked, set_mask, scalars = backend.to_device(host, lead)
    h = backend._h2g2(u)
    p_proj, s_proj, valid = backend._prepare(pk, sig, sig_checked, set_mask, scalars, inv_idx,
                                             m_bucket, checked)
    shards, _ = backend.shard_staged(host, mesh)
    parts = []
    for su, sinv, spk, ssig, schk, smask, ssc in shards:
        a, s, ok = backend._partial_prepare(spk, ssig, schk, smask, ssc, sinv, m_bucket, checked)
        parts.append(tuple(backend._to_lead(x, lead) for x in (backend._h2g2(su), a, s, ok)))
    fused.reset_launches()
    backend._partial_prepare(*shards[0][2:], shards[0][1], m_bucket, checked)
    _sync()
    used = sorted(k for k, v in fused.launches.items() if v)
    g_p, g_h, g_s, g_valid = backend._join_shards(parts)
    rows = row_mask.nonzero().flatten().tolist() + [m_bucket]
    same = {"p_proj": cv.to_affine_ints(p_proj[..., rows], "G1")
            == cv.to_affine_ints(g_p[..., rows], "G1"),
            "s_proj": cv.to_affine_ints(s_proj, "G2") == cv.to_affine_ints(g_s, "G2"),
            "sets_valid": bool(valid) == bool(g_valid), "h_unique": torch.equal(h, g_h)}
    if not all(same.values()):
        raise AssertionError(f"{d} shards: the lead's stage-2 outputs differ: {same}")
    return {"rows": len(rows), "affine_equal": sorted(same),
            "projective_equal_p_proj": torch.equal(p_proj[..., rows], g_p[..., rows])}, used


def phase_multi(sets, poisoned, distinct):
    """The sharded verify (module docstring, phase 6d) -> (the operand
    shapes its eager runs gave each kernel, its launches per mesh)."""
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.ops import backend, fused
    from lighthouse_tpu_torch.parallel import mesh as pm

    every = pm.get_mesh()
    meshes = {f"every_card_{len(every)}": every,
              **{f"{d}_shards_on_{every[0]}": pm.get_mesh(devices=[every[0]] * d)
                 for d in MULTI_SHARDS}}
    batches = {"headline": (sets, True), "poisoned": (poisoned, False),
               "distinct_256": (distinct, True)}
    unsharded = {name: api.verify_signature_sets(b, sharded=False)
                 for name, (b, _) in batches.items()}
    if unsharded != {name: want for name, (_, want) in batches.items()}:
        raise AssertionError(f"unsharded verdicts {unsharded}")
    shapes = {name: set() for name in fused.launches}
    launches, out = {}, {}
    for label, mesh in meshes.items():
        d = len(mesh)
        what = f"sharded headline over {label}"
        _, rec, _, _ = _watched(lambda: _eager_sharded(sets, mesh))
        for k, v in rec.items():
            shapes[k] |= v
        eager = _eager_launches(lambda: _eager_sharded(sets, mesh), what)
        stage2, partial_kernels = _sharded_stage2(sets, mesh)
        host, m_bucket, checked = backend.stage_host(sets, n_floor=d, m_floor=d)
        core = backend.sharded_core(host[3].shape[-1], host[3].shape[0], m_bucket, checked, mesh)
        fresh = [g.name for g in core.graphs if g.stats is None]
        # The first call captures the graphs no mesh before captured (a
        # shard's partial prepare is keyed by its device and width, so two
        # meshes may share one): the kernels of a fresh partial prepare
        # must all be counted.
        fused.reset_launches()
        first_ok, first_s = _timed_verify(lambda: api.verify_signature_sets(sets, mesh=mesh))
        first = dict(fused.launches)
        if any(name.startswith("partial_prepare") for name in fresh):
            missing = [k for k in partial_kernels if first[k] <= 0]
        else:
            missing = []
        uncaptured = [g.name for g in core.graphs if g.stats is None and DEVICE == "cuda"]
        if first_ok is not True or missing or uncaptured:
            raise AssertionError(f"{what}: verdict {first_ok}, launched no {missing}, "
                                 f"left {uncaptured} uncaptured")
        launches[label] = {"first_api_call": first, "eager_verify": eager}
        fused.reset_launches()
        warm_ok, warm_s = _timed_verify(lambda: api.verify_signature_sets(sets, mesh=mesh))
        warm = {k: v for k, v in fused.launches.items() if v}
        join = {"g1_add": d - 1, "g2_add": d - 1} if d > 1 and DEVICE == "cuda" else {}
        if warm_ok is not True or warm != join:
            raise AssertionError(f"{what} warm: verdict {warm_ok}, launched {warm} from Python, "
                                 f"the join's {join}")
        verdicts = {name: api.verify_signature_sets(b, mesh=mesh) for name, (b, _) in
                    batches.items()}
        if verdicts != unsharded:
            raise AssertionError(f"{what}: verdicts {verdicts}, unsharded {unsharded}")
        stage_ms, samples = _replayed_stage_ms(
            lambda: api.verify_signature_sets(sets, mesh=mesh), what)
        out[label] = {"devices": [str(x) for x in mesh], "shards": d,
                      "distinct_cards": len(set(mesh)), "verdicts": verdicts,
                      "equal_to_unsharded": True, "first_use_s": first_s,
                      "graphs_captured_at_first_use": fresh,
                      "warm_wall_s": warm_s, "warm_launches_from_python": warm,
                      "stage2": stage2,
                      "replayed_stage_device_ms": {"ms": stage_ms,
                                                   "samples_per_verify": samples},
                      "walls": _walls(lambda: _eager_sharded(sets, mesh),
                                      lambda: api.verify_signature_sets(sets, mesh=mesh), what)}
    fused.reset_launches()
    emit({"phase": "multi", "gpu": nvidia_smi("name,power.limit"),
          "device_count": torch.cuda.device_count(),
          "degenerate": "one card: every mesh lays its shards on the one device, so this "
                        "shows the split and the join are right and what they cost, not "
                        "scaling" if torch.cuda.device_count() == 1 else None,
          "unsharded_verdicts": unsharded, "meshes": out})
    return shapes, launches


# The port's own kernels in a trace (csrc/*.cu, each in an anonymous
# namespace; a template's name starts with its return type, K7's plain
# functions' do not): matched against the wrapper's launch counts. Group 2
# is the kernel's stem, _kernel_stem's value for the wrappers that launch it.
PORT_KERNEL = re.compile(
    r"^(void )?\(anonymous namespace\)::(lincomb|fp_mul|fp2|fp12|fp_inv|fp_pow|fp2_pow|curve|chain)"
    r"_kernel")
_LIB_STEM = {"fp_mul": "fp_mul", "fp2_mul": "fp2", "fp12_op": "fp12", "fp_add": "lincomb",
             "curve_op": "curve"}


def _kernel_stem(name):
    """The stem of the CUDA kernel wrapper `name` launches (PORT_KERNEL's
    group 2): its library's, K6's chain_kernel, or for K7 (one kernel a
    mode) its own name."""
    from lighthouse_tpu_torch.ops import fused

    if name in K6:
        return "chain"

    lib = fused._KERNELS[name][0]
    return _LIB_STEM.get(lib, name)


def _trace(fn):
    """fn() under torch.profiler -> (its result, the CUDA kernels it ran,
    the port's among them, the device's busy ms (the union of every device
    event's span), its idle share of the wall, the ten kernels launched
    most often)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in events if not e.name.startswith(("Memcpy", "Memset"))]
    busy, end = 0.0, -math.inf
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in events):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    counts = collections.Counter(e.name for e in kernels)
    stems = collections.Counter(m.group(2) for m in map(PORT_KERNEL.match, (e.name for e in kernels))
                                if m)
    return out, {"wall_s": wall, "kernels": len(kernels), "device_events": len(events),
                 "port_kernels": sum(stems.values()), "port_kernel_stems": dict(stems),
                 "busy_ms": busy / 1e3, "idle_share_of_wall": 1 - busy / 1e6 / wall,
                 "top_by_count": [{"name": name[:160], "count": c}
                                  for name, c in counts.most_common(10)],
                 "postprocess_s": time.perf_counter() - t1}


def _profiled(fn):
    """fn() once to warm, then traced -> (its result, the trace, the wrapper
    launches of the traced call). A trace is complete when it holds every
    port kernel the wrappers launched; torch.profiler has been seen to drop
    them from a short trace taken right after a long one, so an incomplete
    trace is taken once more, and a second one fails the phase."""
    from lighthouse_tpu_torch.ops import fused

    fn()
    for attempt in range(2):
        fused.reset_launches()
        out, tr = _trace(fn)
        launched = dict(fused.launches)
        if tr["port_kernels"] == sum(launched.values()):
            return out, tr, launched
        want = collections.Counter()
        for name, count in launched.items():
            want[_kernel_stem(name)] += count
        missing = {stem: {"launched": c, "traced": tr["port_kernel_stems"].get(stem, 0),
                          "by": sorted(k for k, v in launched.items()
                                       if v and _kernel_stem(k) == stem)}
                   for stem, c in want.items() if c != tr["port_kernel_stems"].get(stem, 0)}
        print(json.dumps({"trace_short_of_port_kernels": missing, "attempt": attempt + 1}),
              flush=True)
    raise AssertionError(f"the trace holds {tr['port_kernels']} port kernels of the "
                         f"{sum(launched.values())} launched")


def _units(gen):
    """One call of each unit at the headline's shapes (G1 at n sets, G2 and
    the Miller steps and T chain at m messages and m + 1 pairs, the Fp
    inverse at one element, the sqrt-ratio power at h2g2's 2 x m): name ->
    thunk."""
    from lighthouse_tpu_torch.ops import curves as cv
    from lighthouse_tpu_torch.ops import fused, h2c, pairing  # noqa: F401 (h2c's plans)
    from lighthouse_tpu_torch.ops import limbs as lb
    from lighthouse_tpu_torch.ops import tower as tw

    n, m = HEADLINE["n_sets"], HEADLINE["distinct"]
    a, b = (_rand_fp((6, 12, n), gen) for _ in range(2))
    fp2 = _rand_fp((3, 2, 12, m), gen)
    one = _rand_fp((12, 1), gen)
    g1a, g1b = (_rand_fp((3, 12, n), gen) for _ in range(2))
    g2a, g2b = (_rand_fp((3, 2, 12, m), gen) for _ in range(2))
    t, q = (_rand_fp((3, 2, 12, m + 1), gen) for _ in range(2))
    px, py, pz = _rand_fp((3, 12, m + 1), gen).unbind(0)     # p_proj.select(-3, i)
    s = _rand_fp((2, 2, 12, m), gen)                          # h2g2's two rows
    iso = _rand_fp((2, 32, 12, m), gen)                       # the isogeny's 16 products
    fp6 = _rand_fp((18, 12, 1), gen)                          # an Fp6 product's 9
    plans = fused.LINCOMB_PLANS
    return {
        "fp_add": lambda: fused.fp_add(a, b),
        "fp_sub": lambda: fused.fp_sub(a, b),
        "fp_neg": lambda: fused.fp_neg(a),
        "fp_mul_small": lambda: fused.fp_mul_small(a, K4_TIMED_K),
        "fp_add_broadcast": lambda: fused.fp_add(a, one),
        "fp_add_strided": lambda: fused.fp_add(fp2[..., 0, :, :], fp2[..., 1, :, :]),
        "fp_lincomb": lambda: fused.fp_lincomb(iso, plans["iso_map_sums"]),
        "fp_lincomb_fp6": lambda: fused.fp_lincomb(fp6, plans["fp6_mul"]),
        "g1_add": lambda: cv.G1.add(g1a, g1b),
        "g1_double": lambda: cv.G1.double(g1a),
        "g2_add": lambda: cv.G2.add(g2a, g2b),
        "g2_double": lambda: cv.G2.double(g2a),
        "miller_dbl_step": lambda: pairing._dbl_step(t, px, py, pz),
        "miller_add_step": lambda: pairing._add_step(t, q, px, py, pz),
        "miller_chain": lambda: fused.miller_chain(q, q, px, py, pz),
        "fp_inv": lambda: lb.inv(one),
        "fp2_sqrt_ratio_pow": lambda: tw.fp2_pow_fixed(s, tw._SQRT_RATIO_EXP),
    }


def phase_profile(headline, kzg_by_root):
    """The CUDA kernels of one call of each unit, of each device stage of
    the headline and by_root verifies, then torch.profiler over one warm
    eager headline verify and one warm by_root KZG verify (module
    docstring, phase 8). The short traces go first: see _profiled.
    headline and kzg_by_root are (verify thunk, stage thunks maker)."""
    from lighthouse_tpu_torch.ops import fused

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 4)
    per_unit = {}
    for name, fn in _units(gen).items():
        _, tr, launched = _profiled(fn)
        per_unit[name] = {"kernels": tr["kernels"], "wrapper_launches": sum(launched.values()),
                          "busy_ms": tr["busy_ms"]}
    for name in (("fp_add", "fp_sub", "fp_add_broadcast", "fp_add_strided", "fp_lincomb",
                  "fp_lincomb_fp6") + K5
                 + ("miller_dbl_step", "miller_add_step", "miller_chain", "fp_inv",
                    "fp2_sqrt_ratio_pow")):
        if per_unit[name]["kernels"] != 1:
            raise AssertionError(f"{name} ran {per_unit[name]['kernels']} CUDA kernels, not 1")
    per_stage = {}
    for path, (_, make_stages) in (("bls_headline", headline), ("kzg_by_root", kzg_by_root)):
        per_stage[path] = {}
        for stage, fn in make_stages().items():
            if stage in ("host", "staging"):
                continue
            _, tr, launched = _profiled(fn)
            per_stage[path][stage] = {"kernels": tr["kernels"], "busy_ms": tr["busy_ms"],
                                      "wall_s": tr["wall_s"],
                                      "wrapper_launches": sum(launched.values())}
    runs = {}
    for name, (verify, _) in (("bls_headline", headline), ("kzg_by_root", kzg_by_root)):
        ok, runs[name], runs[name]["wrapper_launches"] = _profiled(verify)
        if ok is not True:
            raise AssertionError(f"{name} did not verify under the profiler")
    emit({"phase": "profile", **runs, "kernels_per_stage": per_stage,
          "kernels_per_unit_call": per_unit})
    fused.reset_launches()
    return runs


# The graphs phase: warm verifies timed per path, the warmer's rungs, and the
# warm grid's graphs (tests/test_torch_graphs.py counts them).
GRAPH_TIMED_CALLS = 5
WARMER_RUNGS = ((64, 1), (64, 4), (4096, 4), (16384, 4))
MAIN_THREAD_RUNG = (2048, 1)    # a rung no other phase reaches


def _grid_kinds(grid):
    """The stage graphs a warm of `grid` captures, by kind: a prepare graph
    per (n, k, m) and a stage-1 and a stage-3 graph per m, m over each
    rung's menu."""
    from lighthouse_tpu_torch.beacon_processor.warming import m_menu

    prepare = {(n, k, m) for n, k in grid for m in m_menu(n)}
    ms = {m for _, _, m in prepare}
    return {"prepare": len(prepare), "h2g2": len(ms), "pairing": len(ms)}


def _all_graphs():
    """Every StaticGraph the process has built: the BLS stage graphs and the
    KZG graphs, by name."""
    from lighthouse_tpu_torch.ops import backend
    from lighthouse_tpu_torch.ops import kzg as okzg

    builders = (backend._stage1_graph, backend._prepare_graph, backend._partial_prepare_graph,
                backend._stage3_graph, okzg._graphed)
    return {g.name: g for b in builders for g in b.cache.values()}


def _stats(graph):
    if graph.stats is None:
        raise AssertionError(f"graph {graph.name} was never captured")
    return {"name": graph.name, "calls": graph.calls, **graph.stats}


def _same(pairs, what):
    """torch.equal on each (eager, graph) pair of outputs -> their names;
    the first pair that differs fails the phase."""
    for name, (eager, graph) in pairs.items():
        if not torch.equal(eager, graph):
            raise AssertionError(f"{what}: the replayed {name} differs from the eager one")
    return sorted(pairs)


def _bls_replay_checks(sets):
    """On the same staged headline batch and scalars, the replayed stage
    outputs against the eager stages', bit for bit; then two replays with
    different scalars: different p_proj, both True."""
    from lighthouse_tpu_torch.ops import backend

    dev = torch.device(DEVICE)
    n_bucket = backend._next_pow2(len(sets))
    args, m_bucket, all_checked = backend.stage(
        sets, dev, scalars=backend.draw_scalars(len(sets), n_bucket))
    u, inv_idx, row_mask, pk, sig, sig_checked, set_mask, scalars = args
    h = backend._h2g2(u)
    p_proj, s_proj, valid = backend._prepare(pk, sig, sig_checked, set_mask, scalars, inv_idx,
                                             m_bucket, all_checked)
    verdict = backend._pairing_check(p_proj, h, s_proj, row_mask, valid)
    core = backend.graph_core(n_bucket, pk.shape[0], m_bucket, all_checked, u.device)
    with core.lock:
        got = core(*args)
        g_p, g_s, g_valid = core.prepare.outputs
        equal = _same({"h_unique": (h, core.h2g2.outputs), "p_proj": (p_proj, g_p),
                       "s_proj": (s_proj, g_s), "sets_valid": (valid, g_valid),
                       "verdict": (verdict, got)}, "headline")
        if not got.item():
            raise AssertionError("the replayed headline did not verify")
    p_by_draw = []
    for _ in range(2):
        args, _, _ = backend.stage(sets, dev, scalars=backend.draw_scalars(len(sets), n_bucket))
        with core.lock:
            if not core(*args).item():
                raise AssertionError("a replay with fresh scalars did not verify")
            p_by_draw.append(core.prepare.outputs[0].clone())
    if torch.equal(*p_by_draw):
        raise AssertionError("two replays with different scalars gave the same p_proj")
    return core, {"key": [n_bucket, pk.shape[0], m_bucket, all_checked], "equal": equal,
                  "p_proj_differs_between_draws": True, "both_draws_verified": True}


def _kzg_replay_checks(kzg, batch):
    """On the same staged KZG batch, the replayed terms, sums and verdict
    against the eager _combine's, bit for bit."""
    from lighthouse_tpu_torch.ops import kzg as okzg

    blobs, commitments, proofs = batch
    zs, ys, r = kzg.batch_inputs(blobs, commitments, proofs)
    staged = okzg.stage(commitments, zs, ys, proofs, r, kzg.g2_tau, torch.device(DEVICE))
    term, sums, verdict = okzg._combine(*staged)
    graph = okzg._graphed(staged[0].shape[-1], 256, staged[0].device)
    with graph.lock:
        g_term, g_sums, g_verdict = graph(*staged)
        equal = _same({"term": (term, g_term), "sums": (sums, g_sums),
                       "verdict": (verdict, g_verdict)}, f"KZG n_bucket {staged[0].shape[-1]}")
        if not g_verdict.item():
            raise AssertionError("the replayed KZG batch did not verify")
    return {"key": [staged[0].shape[-1], 256], "equal": equal}


def _walls(eager, graph, what):
    """Warm verifies on the eager path and through the graphs, in turns,
    GRAPH_TIMED_CALLS each -> {path: median, spread and every wall s}."""
    runs = {"eager": [], "graph": []}
    for _ in range(GRAPH_TIMED_CALLS):
        for path, fn in (("eager", eager), ("graph", graph)):
            ok, wall_s = _timed_verify(fn)
            if ok is not True:
                raise AssertionError(f"{what} ({path}) did not verify")
            runs[path].append(wall_s)
    return {path: {"median_s": statistics.median(v), "min_s": min(v), "max_s": max(v),
                   "runs_s": v} for path, v in runs.items()}


def _replay_trace(verify, graphs, what):
    """torch.profiler over one warm verify through the graphs: nothing
    launched from Python, and every port kernel the graphs captured in the
    trace (taken once more if not, as _profiled does)."""
    from lighthouse_tpu_torch.ops import fused

    captured = sum(g.stats["launches"] for g in graphs)
    verify()
    for _ in range(2):
        fused.reset_launches()
        ok, tr = _trace(verify)
        if sum(fused.launches.values()):
            raise AssertionError(f"a replayed {what} launched {dict(fused.launches)} from Python")
        if tr["port_kernels"] == captured:
            break
    else:
        raise AssertionError(f"the trace of a replayed {what} holds {tr['port_kernels']} port "
                             f"kernels of the {captured} its graphs captured")
    if ok is not True:
        raise AssertionError(f"a replayed {what} did not verify under the profiler")
    return {**tr, "captured_port_launches": captured,
            "graph_nodes": sum(g.stats["nodes"] for g in graphs)}


def phase_graphs(sets, kzg_state):
    """The bucket graphs (module docstring, phase 9): each graph's capture
    costs, bit-equality of replay and eager stage outputs, scalars as a
    replayed input, eager against graph warm verifies, and one replayed
    headline and by_root verify under the profiler."""
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.ops import backend
    from lighthouse_tpu_torch.ops import kzg as okzg

    kzg, batches = kzg_state
    core, bls_equal = _bls_replay_checks(sets)
    kzg_graphs = {name: okzg._graphed(backend._next_pow2(len(b[0])), 256, core.h2g2.device)
                  for name, b in batches.items()}
    keys = {"headline": {g.name: _stats(g) for g in core.graphs},
            **{name: _stats(g) for name, g in kzg_graphs.items()}}
    bit_equal = {"headline": bls_equal,
                 **{name: _kzg_replay_checks(kzg, b) for name, b in batches.items()}}
    walls = {"headline": _walls(lambda: _eager_verify(sets),
                                lambda: api.verify_signature_sets(sets), "headline")}
    for name, batch in batches.items():
        walls[name] = _walls(lambda: _kzg_eager(kzg, *batch),
                             lambda: kzg.verify_blob_kzg_proof_batch(*batch), f"KZG {name}")
    # The widest bucket at the default chunk width (the wide phase captured
    # it): traced here, after the profile phase's short traces.
    n = max(WIDE_NS)
    wide, _ = _tiled(sets[:HEADLINE["distinct"]], n)
    m = backend._m_bucket_for(n, HEADLINE["distinct"])
    wide_core = backend.graph_core(n, HEADLINE["keys"], m, True, core.h2g2.device)
    traces = {"headline": _replay_trace(lambda: api.verify_signature_sets(sets), core.graphs,
                                        "headline"),
              f"wide_{n}": _replay_trace(lambda: api.verify_signature_sets(wide), wide_core.graphs,
                                         f"wide {n}"),
              "by_root": _replay_trace(lambda: kzg.verify_blob_kzg_proof_batch(*batches["by_root"]),
                                       [kzg_graphs["by_root"]], "by_root")}
    emit({"phase": "graphs", "keys": keys, "bit_equal": bit_equal, "walls": walls,
          "replay_profile": traces})


def phase_warmer(sets):
    """The port's ShapeWarmer over WARMER_RUNGS, every m of each, with one
    headline verify run while it warms; one prepare graph captured on this
    thread to compare; then every graph the process captured, and the warm
    grid's cost extrapolated from them by kind."""
    from lighthouse_tpu_torch.beacon_processor.warming import ShapeWarmer, m_menu, synthetic_batch
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.ops import backend
    from lighthouse_tpu_torch.ops.graphs import rss_bytes

    rss0, reserved0 = rss_bytes(), torch.cuda.memory_reserved()
    warmer = ShapeWarmer(shapes=WARMER_RUNGS, device=DEVICE)
    t0 = time.perf_counter()
    warmer.start()
    # While the warmer's thread captures, CUDA refuses a synchronise of the
    # whole device: this thread waits for its own stream only.
    ok, verify_s = _timed_verify(api.verify_signature_sets, sets,
                                 sync=lambda: torch.cuda.current_stream().synchronize())
    rungs_done_at_verify = len(warmer.warmed)
    warmer.join(timeout=900)
    warm_s = time.perf_counter() - t0
    if warmer.failed:
        raise AssertionError(f"the warmer failed: {warmer.failed}")
    if warmer.warmed != list(WARMER_RUNGS):
        raise AssertionError(f"the warmer warmed {warmer.warmed} of {WARMER_RUNGS}")
    if ok is not True:
        raise AssertionError("the headline did not verify while the warmer ran")
    # The same kind of key captured on this thread, in the same state of the
    # process, to compare with the warmer thread's captures.
    n, k = MAIN_THREAD_RUNG
    m = m_menu(n)[0]
    core = backend.graph_core(n, k, m, True, torch.device(DEVICE))
    if core.prepare.stats is not None:
        raise AssertionError(f"{core.prepare.name} was captured before")
    with core.lock:
        core(*synthetic_batch(n, k, m, DEVICE)).item()
    every = [_stats(g) for g in _all_graphs().values()]
    from lighthouse_tpu_torch.beacon_processor.warming import DEFAULT_SHAPE_GRID

    grid_kinds = _grid_kinds(DEFAULT_SHAPE_GRID)
    per_kind = {}
    for kind, grid_count in grid_kinds.items():
        rows = [r for r in every if r["name"].split()[0] == kind]
        cost = {f: statistics.mean(r[f] for r in rows)
                for f in ("warmup_s", "capture_s", "instantiate_s", "nodes", "rss_bytes",
                          "pool_bytes")}
        per_kind[kind] = {"graphs": len(rows), "mean": cost, "grid_graphs": grid_count}
    grid = {f: sum(v["mean"][f] * v["grid_graphs"] for v in per_kind.values())
            for f in ("warmup_s", "capture_s", "instantiate_s", "rss_bytes", "pool_bytes")}
    emit({"phase": "warmer", "rungs": WARMER_RUNGS, "warm_s": warm_s,
          "captured": [{"name": n, **st} for n, st in warmer.captured],
          "headline_during_warm": {"verified": ok, "wall_s": verify_s,
                                   "rungs_done_when_it_ended": rungs_done_at_verify},
          "main_thread_capture": _stats(core.prepare),
          "rss_delta_bytes": rss_bytes() - rss0,
          "reserved_delta_bytes": torch.cuda.memory_reserved() - reserved0,
          "every_graph": every, "per_kind": per_kind,
          "grid_extrapolation": {"graphs": sum(grid_kinds.values()), **grid,
                                 "seconds": grid["warmup_s"] + grid["capture_s"]
                                 + grid["instantiate_s"]},
          "process_rss_bytes": rss_bytes(),
          "memory_reserved_bytes": torch.cuda.memory_reserved()})


# The serving phase: the headline pipelined, the stage timers, the native
# CPU route, and the scheduler over the router.
PIPELINED_BATCHES = 20      # every fifth one poisoned
STAGE_TIMED_CALLS = 5
CPU_ROUTE_SIZES = (1, 4, 16)
CPU_ROUTE_RUNS = 3
SINGLE_JOBS = 8


def _host_cpu() -> dict:
    """The host CPU as /proc/cpuinfo names it (a virtual machine may say
    "unknown" for the model name: its family, model and stepping then
    identify it), with the cores this process may use."""
    keys = ("model name", "vendor_id", "cpu family", "model", "stepping", "cpu MHz")
    out = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            key = key.strip()
            if key in keys and key not in out:
                out[key] = value.strip()
    if "model name" not in out:
        raise AssertionError("no model name in /proc/cpuinfo")
    out["usable_cores"] = len(os.sched_getaffinity(0))
    return out


def _pipelined(batches, expected, what):
    """Dispatch every batch through the async API, then read every verdict
    -> (wall s from the first dispatch to the last verdict, dispatch s)."""
    from lighthouse_tpu_torch.ops import backend

    t0 = time.perf_counter()
    pending = [backend.verify_signature_sets_gpu_async(b) for b in batches]
    dispatched = time.perf_counter() - t0
    got = [bool(p) for p in pending]
    wall = time.perf_counter() - t0
    if got != expected:
        raise AssertionError(f"{what}: verdicts {got}, expected {expected}")
    return wall, dispatched


def _blocking(batches, expected, what):
    from lighthouse_tpu_torch.crypto.bls import api

    t0 = time.perf_counter()
    got = [api.verify_signature_sets(b) for b in batches]
    wall = time.perf_counter() - t0
    if got != expected:
        raise AssertionError(f"{what}: verdicts {got}, expected {expected}")
    return wall


def _stage_device_s(reg_hist, stages_):
    """{stage: (count, sum s)} of engine_stage_seconds{engine="gpu"}."""
    out = {}
    for stage in stages_:
        child = reg_hist.labels(engine="gpu", stage=stage)
        _, count, total = child.snapshot()
        out[stage] = (count, total)
    return out


def _dispatch_split(sets, reps=5):
    """The async verify's host work in its parts, `reps` batches pipelined
    as verify_signature_sets_gpu_async runs them: stage_host, to_device,
    the bucket's dispatch (copies into the static inputs, three replays,
    the verdict's copy and event), then every verdict read at the end."""
    from lighthouse_tpu_torch.ops import backend

    out = {"stage_host_s": [], "to_device_s": [], "dispatch_s": []}
    pending = []
    for _ in range(reps):
        t0 = time.perf_counter()
        host, m_bucket, checked = backend.stage_host(sets)
        t1 = time.perf_counter()
        args = backend.to_device(host, DEVICE)
        t2 = time.perf_counter()
        k_bucket, _, _, n_bucket = args[3].shape
        pending.append(backend.graph_core(n_bucket, k_bucket, m_bucket, checked,
                                          args[0].device).dispatch(*args))
        t3 = time.perf_counter()
        for key, dt in (("stage_host_s", t1 - t0), ("to_device_s", t2 - t1),
                        ("dispatch_s", t3 - t2)):
            out[key].append(dt)
    t4 = time.perf_counter()
    if [bool(p) for p in pending] != [True] * reps:
        raise AssertionError("the dispatch split's batches did not verify")
    out["read_all_s"] = time.perf_counter() - t4
    return out


def _serving_pipeline(sets, poisoned):
    """The headline batch dispatched PIPELINED_BATCHES times, every fifth
    the poisoned copy: blocking and pipelined in turns, then the pipelined
    run traced; the async verify's host work timed in its parts."""
    n = len(sets)
    batches = [poisoned if i % 5 == 4 else sets for i in range(PIPELINED_BATCHES)]
    expected = [i % 5 != 4 for i in range(PIPELINED_BATCHES)]
    walls = {"blocking": [], "pipelined": []}
    dispatch_s = []
    for mode in ("blocking", "pipelined", "pipelined", "blocking"):
        if mode == "blocking":
            walls[mode].append(_blocking(batches, expected, "blocking loop"))
        else:
            wall, disp = _pipelined(batches, expected, "pipelined loop")
            walls[mode].append(wall)
            dispatch_s.append(disp)
    _, tr = _trace(lambda: _pipelined(batches, expected, "traced pipelined loop"))
    rates = {mode: [len(batches) * n / w for w in v] for mode, v in walls.items()}
    return {"dispatch_split": _dispatch_split(sets),
            "batches": len(batches), "sets_per_batch": n, "poisoned_every": 5,
            "verdicts_as_expected": True, "walls_s": walls, "sets_per_s": rates,
            "pipelined_dispatch_s": dispatch_s,
            "pipelined_over_blocking": statistics.median(rates["pipelined"])
            / statistics.median(rates["blocking"]),
            "profile": {k: tr[k] for k in ("wall_s", "kernels", "port_kernels", "busy_ms",
                                           "idle_share_of_wall", "postprocess_s")}}


def _serving_stages(sets, stages_s):
    """engine_stage_seconds{engine="gpu"} over STAGE_TIMED_CALLS replayed
    verifies and as many eager ones (CUDA events, settled once read),
    beside the eager run's synchronised stage walls."""
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.observability import stages

    names = ("h2g2", "prepare", "pairing")
    hist = stages.stage_seconds()
    out = {}
    stages.force_timing(True)
    try:
        for path, fn in (("replayed", lambda: api.verify_signature_sets(sets)),
                         ("eager", lambda: _eager_verify(sets))):
            before = _stage_device_s(hist, names)
            for _ in range(STAGE_TIMED_CALLS):
                if fn() is not True:
                    raise AssertionError(f"the {path} headline did not verify with timing on")
            stages.settle(wait=True)
            after = _stage_device_s(hist, names)
            counts = {k: after[k][0] - before[k][0] for k in names}
            if counts != {k: STAGE_TIMED_CALLS for k in names}:
                raise AssertionError(f"{path}: stage samples {counts}")
            out[path] = {k: (after[k][1] - before[k][1]) / STAGE_TIMED_CALLS for k in names}
    finally:
        stages.force_timing(False)
    return {"engine": "gpu", "mean_device_s": out, "eager_wall_stages_s": stages_s,
            "calls": STAGE_TIMED_CALLS}


def _serving_cpu_route(sets, distinct):
    """The native cpu backend at CPU_ROUTE_SIZES sets of the headline (4
    keys a set) and of the 256 distinct one-key sets, a poisoned batch,
    and the batch_verify vectors."""
    from lighthouse_tpu_torch.crypto.bls import api, cpu_backend

    t0 = time.perf_counter()
    cpu_backend.get_lib()
    build_s = time.perf_counter() - t0
    per = {}
    for what, pool in (("headline_4_keys", sets), ("distinct_1_key", distinct)):
        for size in CPU_ROUTE_SIZES:
            runs = []
            for _ in range(CPU_ROUTE_RUNS):
                t1 = time.perf_counter()
                ok = api.verify_signature_sets(pool[:size], backend="cpu")
                runs.append(time.perf_counter() - t1)
                if ok is not True:
                    raise AssertionError(f"cpu route: {size} {what} sets did not verify")
            per[f"{what}/{size}"] = {"ms_per_set": 1e3 * statistics.median(runs) / size,
                                     "runs_s": runs}
    bad = list(sets[:16])
    bad[13] = api.SignatureSet(sets[14].signature, bad[13].signing_keys, bad[13].message)
    if api.verify_signature_sets(bad, backend="cpu") is not False:
        raise AssertionError("cpu route: a poisoned batch of 16 verified")
    base = ROOT / "tests" / "vectors" / "general" / "phase0" / "bls" / "batch_verify" / "small"
    cases = {}
    for meta in sorted(base.glob("*/meta.json")):
        case = json.loads(meta.read_text())
        vsets = _vector_sets(api, "batch_verify", case["input"])
        got = False if vsets is None else api.verify_signature_sets(vsets, backend="cpu")
        if got != case["output"]:
            raise AssertionError(f"cpu route: batch_verify/{meta.parent.name} gave {got}")
        cases[meta.parent.name] = got
    if not cases:
        raise AssertionError("no batch_verify vectors found")
    return {"host_cpu": _host_cpu(), "build_s": build_s, "by_size": per,
            "poisoned_16": False, "batch_verify_vectors": cases}


def _serving_scheduler(sets, poisoned_set, distinct):
    """The warmer with the batch policy over the default grid, then a
    ContinuousBatchScheduler with the real router draining the headline as
    gossip_aggregate (4096, the queue's capacity), the poisoned set as
    gossip_attestation, the 256 distinct sets as gossip_sync_signature, and
    SINGLE_JOBS single sets submitted alone."""
    from lighthouse_tpu_torch.beacon_processor.processor import AdaptiveBatchPolicy
    from lighthouse_tpu_torch.beacon_processor.warming import DEFAULT_SHAPE_GRID, ShapeWarmer
    from lighthouse_tpu_torch.common import metrics
    from lighthouse_tpu_torch.common.slot_clock import SystemTimeSlotClock
    from lighthouse_tpu_torch.serving.router import CostModelRouter
    from lighthouse_tpu_torch.serving.scheduler import ContinuousBatchScheduler, VerifyJob

    policy = AdaptiveBatchPolicy()
    cap_before = policy.batch_limit(1 << 20)
    warmer = ShapeWarmer(policy=policy, device=DEVICE)
    t0 = time.perf_counter()
    warmer.start()
    warmer.join(timeout=900)
    warm_s = time.perf_counter() - t0
    if warmer.failed or warmer.warmed != list(DEFAULT_SHAPE_GRID):
        raise AssertionError(f"the warmer warmed {warmer.warmed}, failed {warmer.failed}")
    reg = metrics.Registry()
    router = CostModelRouter(registry=reg)
    clock = SystemTimeSlotClock(genesis_time=int(time.time()) - 1, seconds_per_slot=12)
    sched = ContinuousBatchScheduler(clock, policy, router, registry=reg)
    batches = []
    verify = router.verify

    def logged(batch, deadline_budget=None):
        t1 = time.perf_counter()
        ok, route = verify(batch, deadline_budget)
        batches.append({"sets": len(batch), "route": route, "ok": ok,
                        "wall_s": time.perf_counter() - t1, "budget_s": deadline_budget})
        return ok, route

    router.verify = logged
    verdicts, expected = [], []

    def submit(kind, sset, ok):
        i = len(verdicts)
        verdicts.append(None)
        expected.append(ok)
        if not sched.submit(VerifyJob(kind, sset, lambda v, i=i: verdicts.__setitem__(i, v))):
            raise AssertionError(f"the scheduler dropped a {kind} job")

    t0 = time.perf_counter()
    for s in sets:
        submit("gossip_aggregate", s, True)
    submit("gossip_attestation", poisoned_set, False)     # the aggregates' queue is full
    for s in distinct:
        submit("gossip_sync_signature", s, True)
    drained = sched.run_until_idle()
    for s in distinct[-SINGLE_JOBS:]:
        submit("gossip_sync_signature", s, True)
        drained += sched.run_until_idle()
    drain_s = time.perf_counter() - t0
    if verdicts != expected:
        wrong = [i for i, (v, e) in enumerate(zip(verdicts, expected)) if v != e]
        raise AssertionError(f"scheduler: {len(wrong)} jobs got the wrong verdict, first {wrong[:5]}")
    router.verify = verify
    close = reg.counter_vec("serving_scheduler_close_total")
    routes = reg.counter_vec("serving_router_route_total")
    reasons = reg.counter_vec("serving_router_reason_total")
    return (reg, sched), {"warm_s": warm_s, "warmed": warmer.warmed, "graphs_captured": len(warmer.captured),
            "batch_cap_before_warm": cap_before, "batch_cap_after_warm": policy.batch_limit(1 << 20),
            "jobs": len(verdicts), "verdicts_as_expected": True, "drain_s": drain_s,
            "batches_dispatched": drained, "batches": batches,
            "stats": {"batches": sched.stats.batches, "items": sched.stats.items,
                      "deadline_hits": sched.stats.deadline_hits,
                      "deadline_misses": sched.stats.deadline_misses,
                      "poisoned": sched.stats.poisoned, "by_route": sched.stats.by_route},
            "close_causes": {c: close.get(c) for c in ("bucket_full", "deadline", "flush")},
            "routes": {r: routes.get(r) for r in ("cpu", "device")},
            "reasons": {r: reasons.get(r) for r in ("small", "deadline", "cost", "default")},
            "learned_table_s": router.table.snapshot()}


def phase_serving(sets, poisoned, distinct, stages_s):
    """The serving path in front of the card (module docstring, phase 10),
    one line a part. -> (the scheduler's registry, the scheduler)."""
    gpu = nvidia_smi("name,power.limit")
    emit({"phase": "serving", "gpu": gpu, "pipelined": _serving_pipeline(sets, poisoned)})
    emit({"phase": "serving", "gpu": gpu, "stages": _serving_stages(sets, stages_s)})
    emit({"phase": "serving", "gpu": gpu, "cpu_route": _serving_cpu_route(sets, distinct)})
    stack, scheduler = _serving_scheduler(sets, poisoned[69], distinct)
    emit({"phase": "serving", "gpu": gpu, "scheduler": scheduler})
    return stack


# The control phase: rounds of headline traffic, each drained, with an
# autotuner step after each; then two restarts.
CONTROL_ROUNDS = 6
RESTART_TIMEOUT_S = 600


def _point_json(pt):
    return [_point_json(v) for v in pt] if isinstance(pt, tuple) else pt


def _point_tuple(pt):
    return tuple(_point_tuple(v) for v in pt) if isinstance(pt, list) else pt


def _grid_graphs(grid):
    """The number of stage graphs a warm of `grid` captures."""
    return sum(_grid_kinds(grid).values())


def _restart(mode, bundle_dir):
    """One fresh process restarting as `mode` (chip_smoke.py --restart):
    its JSON line. A failed process fails the phase."""
    launched = time.time()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--restart", mode,
                           bundle_dir, repr(launched)], capture_output=True, text=True,
                          timeout=RESTART_TIMEOUT_S, cwd=ROOT)
    if proc.returncode != 0:
        raise AssertionError(f"the {mode} restart exited {proc.returncode}: "
                             f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_control(stack, sets):
    """The serving control plane (module docstring, phase 11): the
    autotuner over the serving phase's scheduler, router and batch policy
    between drains of the headline; its policy saved; two restarts, one
    warming DEFAULT_SHAPE_GRID, one the tuned grid."""
    import shutil
    import tempfile

    from lighthouse_tpu_torch.observability.slo import SloEngine
    from lighthouse_tpu_torch.observability.timeseries import TimeSeries
    from lighthouse_tpu_torch.serving.autotune import Autotuner
    from lighthouse_tpu_torch.serving.scheduler import VerifyJob

    reg, sched = stack
    ts = TimeSeries(reg)
    slo = SloEngine(ts, registry=reg)
    tuner = Autotuner(scheduler=sched, batch_policy=sched.policy, timeseries=ts, slo=slo,
                      registry=reg)
    rounds = [{"round": "before", "decisions": [d.as_dict() for d in
                                                tuner.step(now=time.monotonic())]}]
    for i in range(CONTROL_ROUNDS):
        verdicts = []
        t0 = time.perf_counter()
        for s in sets:
            if not sched.submit(VerifyJob("gossip_aggregate", s, verdicts.append)):
                raise AssertionError("the scheduler dropped a headline job")
        batches = sched.run_until_idle()
        drain_s = time.perf_counter() - t0
        if verdicts != [True] * len(sets):
            raise AssertionError(f"control round {i}: {verdicts.count(False)} headline jobs False")
        decisions = tuner.step(now=time.monotonic())
        rounds.append({"round": i, "batches": batches, "drain_s": drain_s,
                       "slo": slo.snapshot(), "decisions": [d.as_dict() for d in decisions]})
    policy = tuner.current_policy()
    bundle = tempfile.mkdtemp(prefix="chip_smoke_policy_")
    try:
        tuner.save(bundle)
        base = sets[:HEADLINE["distinct"]]
        with open(os.path.join(bundle, "sets.json"), "w") as f:
            json.dump([{"pks": [_point_json(pk.point) for pk in s.signing_keys],
                        "sig": _point_json(s.signature.point), "msg": s.message.hex()}
                       for s in base], f)
        restarts = {mode: _restart(mode, bundle) for mode in ("default", "tuned")}
    finally:
        shutil.rmtree(bundle, ignore_errors=True)
    emit({"phase": "control", "gpu": nvidia_smi("name,power.limit"), "rounds": rounds,
          "policy": policy, "restarts": restarts})


def restart_main(mode, bundle_dir, launched_unix) -> int:
    """A restarted node (phase_control's subprocess): import, load the
    kernel libraries and the native verifier from their caches, apply the
    saved policy ("tuned") or not ("default"), warm that grid, then verify
    the headline batch through the router. Prints one JSON line: the time
    of each step, their sum (restart to the first verified batch), and the
    provenance counts after the warm and after the batch."""
    t_main = time.time()
    out = {"mode": mode, "process_start_to_main_s": t_main - float(launched_unix)}
    t0 = time.perf_counter()
    from lighthouse_tpu_torch.beacon_processor import warming
    from lighthouse_tpu_torch.beacon_processor.processor import AdaptiveBatchPolicy
    from lighthouse_tpu_torch.common import metrics
    from lighthouse_tpu_torch.common.slot_clock import SystemTimeSlotClock
    from lighthouse_tpu_torch.crypto.bls import api, cpu_backend
    from lighthouse_tpu_torch.observability import compile_events
    from lighthouse_tpu_torch.ops import _build
    from lighthouse_tpu_torch.serving import aot, autotune
    from lighthouse_tpu_torch.serving.router import CostModelRouter
    from lighthouse_tpu_torch.serving.scheduler import ContinuousBatchScheduler

    t1 = time.perf_counter()
    for name in _build.SOURCES:
        _build.library(name)
    t2 = time.perf_counter()
    cpu_backend.get_lib()
    t3 = time.perf_counter()
    policy = AdaptiveBatchPolicy()
    reg = metrics.Registry()
    router = CostModelRouter(registry=reg)
    clock = SystemTimeSlotClock(genesis_time=int(time.time()) - 1, seconds_per_slot=12)
    sched = ContinuousBatchScheduler(clock, policy, router, registry=reg)
    grid = warming.DEFAULT_SHAPE_GRID
    if mode == "tuned":
        tuned = aot.load_policy(bundle_dir)
        out["applied"] = [d.as_dict() for d in autotune.apply_policy(
            tuned, scheduler=sched, router=router, batch_policy=policy)]
        grid = warming.tuned_shape_grid(tuned)
    t4 = time.perf_counter()
    warmer = warming.ShapeWarmer(policy=policy, shapes=grid, device=DEVICE).start()
    warmer.join(timeout=RESTART_TIMEOUT_S)
    t5 = time.perf_counter()
    if warmer.failed or warmer.warmed != list(grid):
        raise AssertionError(f"the warmer warmed {warmer.warmed} of {grid}: {warmer.failed}")
    after_warm = compile_events.counts()
    with open(os.path.join(bundle_dir, "sets.json")) as f:
        base = [api.SignatureSet(
            signature=api.Signature(point=_point_tuple(s["sig"]), subgroup_checked=True),
            signing_keys=[api.PublicKey(point=_point_tuple(pk)) for pk in s["pks"]],
            message=bytes.fromhex(s["msg"])) for s in json.load(f)]
    sets = (base * (HEADLINE["n_sets"] // len(base) + 1))[:HEADLINE["n_sets"]]
    t6 = time.perf_counter()
    ok, route = router.verify(sets)
    torch.cuda.synchronize()
    t7 = time.perf_counter()
    if ok is not True:
        raise AssertionError(f"the {mode} restart's first headline batch gave {ok} ({route})")
    expected = _grid_graphs(grid)
    if after_warm["graph_capture"] != expected or after_warm["kernel_build"] \
            or after_warm["kernel_cache_hit"] != len(_build.SOURCES):
        raise AssertionError(f"the {mode} restart's provenance {after_warm}, expected "
                             f"{expected} graph captures and {len(_build.SOURCES)} cache hits")
    steps = {"import_s": t1 - t0, "kernel_libraries_s": t2 - t1, "native_s": t3 - t2,
             "warm_grid_s": t5 - t4, "first_batch_s": t7 - t6}
    out.update(steps, grid=[list(r) for r in grid], grid_graphs=expected,
               setup_s=(t4 - t3) + (t6 - t5), route=route, verified=ok,
               restart_to_first_verified_batch_s=out["process_start_to_main_s"]
               + sum(steps.values()),
               compile_events_after_warm=after_warm,
               compile_events=compile_events.counts(),
               capture_s=sum(st["warmup_s"] + st["capture_s"] + st["instantiate_s"]
                             for _, st in warmer.captured))
    emit(out)
    return 0


def _summary(kernels, by_shape, launches, shape_errs, launches_kzg, per_verify=None,
             per_verify_kzg=None, launches_paths=None):
    """The kernels line. `launches` counts the main path's first headline
    verify through the API (which runs each stage eagerly, then captures
    it), `launches_per_verify` one eager verify, which is what a replay
    runs; likewise `launches_kzg` and `launches_kzg_per_verify`, and
    `launches_wide` and `launches_multi` per run of those phases (the
    first API call and one eager verify)."""
    from lighthouse_tpu_torch.ops import fused

    summary = []
    for name, per_n in kernels.items():
        source, replaces = SOURCES.get(name, SOURCES[fused._KERNELS[name][0]])
        if name in K7:          # per shape, at its path's exponent
            top = per_n[str(K7_MAIN[name])]
            extra = {"shape": list(K7_MAIN[name]),
                     "ms_by_shape": {sh: v["ms"] for sh, v in per_n.items()},
                     "floor_ms_by_shape": {sh: v["floor_ms"] for sh, v in per_n.items()}}
        elif name == "fp_lincomb":  # per plan, at LINCOMB_NS
            plan, n = LINCOMB_MAIN
            top = per_n[plan][n]
            per_n = {f"{p} n={m}": v for p, rows in per_n.items() for m, v in rows.items()}
            extra = {"plan": plan, "n": n, "ms_by_plan": {k: v["ms"] for k, v in per_n.items()},
                     "floor_ms_by_plan": {k: v["floor_ms"] for k, v in per_n.items()}}
        else:
            top = per_n[max(NS)]
            extra = {"n": max(NS), "ms_by_n": {n: v["ms"] for n, v in per_n.items()}}
        summary.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches.get(name),
                        "max_abs_err": max([shape_errs.get(name, 0)]
                                           + [v["max_abs_err"] for v in per_n.values()]),
                        "ms": top["ms"], "plain_ms": top["plain_ms"],
                        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
                        "library_ms": None, **extra,
                        "launches_kzg": {b: v[name] for b, v in launches_kzg.items()},
                        "launches_per_verify": (per_verify or {}).get(name),
                        "launches_kzg_per_verify": {b: v[name] for b, v in
                                                    (per_verify_kzg or {}).items()},
                        **{f"launches_{path}": {run: {k: v[name] for k, v in counts.items()}
                                                for run, counts in runs.items()}
                           for path, runs in (launches_paths or {}).items()}})
        if name in by_shape:
            summary[-1].update(
                floor_ms_by_n={n: v["floor_ms"] for n, v in per_n.items()},
                ms_by_shape={sh: v["ms"] for sh, v in by_shape[name].items()},
                floor_ms_by_shape={sh: v["floor_ms"] for sh, v in by_shape[name].items()})
    return summary


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if argv[:1] == ["--restart"] and len(argv) == 4:
        import lighthouse_tpu_torch  # noqa: F401
        return restart_main(*argv[1:])
    if argv not in ([], ["--kernels-only"]):
        print(f"usage: chip_smoke.py [--kernels-only], not {argv}", file=sys.stderr)
        return 2
    import lighthouse_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    t0 = time.perf_counter()
    phase_env()
    kernels, kernel_by_shape = phase_kernels()
    phase_wrapper()
    if argv:
        print(nvidia_smi("name,power.limit"), flush=True)
        emit({"kernels": _summary(kernels, kernel_by_shape, {}, {}, {})})
        return 0
    launches, per_verify, shapes, by_shape, headline, sets, poisoned, distinct = phase_verify()
    shape_errs = phase_main_path_shapes(shapes)
    for lib in FLOORED:
        phase_top_shapes(by_shape, lib)
    phase_vectors()
    launches_kzg, per_verify_kzg, kzg_shapes, kzg_by_root, kzg_state = phase_kzg()
    kzg_errs = phase_main_path_shapes(kzg_shapes, "kzg_shapes", KZG_REQUIRED)
    single_shapes = phase_single(kzg_state, distinct)
    single_errs = phase_main_path_shapes(
        single_shapes, "single_shapes",
        sorted({k for k, v in single_shapes.items() if v} | set(K7_PATH)))
    wide_shapes, launches_wide = phase_wide(sets[:HEADLINE["distinct"]])
    wide_errs = phase_main_path_shapes(_new_shapes(wide_shapes, shapes), "wide_shapes", [])
    multi_shapes, launches_multi = phase_multi(sets, poisoned, distinct)
    multi_errs = phase_main_path_shapes(_new_shapes(multi_shapes, shapes), "multi_shapes", [])
    errs = {k: max(shape_errs[k], kzg_errs.get(k, 0), single_errs.get(k, 0),
                   wide_errs.get(k, 0), multi_errs.get(k, 0)) for k in shape_errs}
    phase_warmer(sets)
    phase_profile(headline, kzg_by_root)
    phase_graphs(sets, kzg_state)
    stack = phase_serving(sets, poisoned, distinct,
                          _stage_seconds(headline[1](), "headline batch"))
    phase_control(stack, sets)
    summary = _summary(kernels, kernel_by_shape, launches, errs, launches_kzg, per_verify,
                       per_verify_kzg, {"wide": launches_wide, "multi": launches_multi})
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    print(nvidia_smi("name,power.limit"), flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
