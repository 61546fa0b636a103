#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (fourier_tpu_torch) on one NVIDIA card.

Run from the root of the repository:

    python3 chip_smoke.py            # the full run at scale 20

It takes no arguments: the main path always runs at SCALE.

Phases, in order; any failure exits non-zero and prints no result line:

0. The card's name and power limit (nvidia-smi), its integer and memory
   peaks (for each kernel's bound); build the CUDA kernels.
1. Each kernel against its plain PyTorch twin on the card, bit for bit:
   small batches of adversarial lanes (the lane plan of
   tests/test_pallas.py: same point, inverse pair, identity on either side
   and both, in a width that is no multiple of a block; K2 on it is also
   the check of the complete-add TPU kernel it replaces; K1 on runs of up
   to three pieces; the tree kernel on groups whose halves meet the same
   point, its inverse or an identity; K3 on coordinates 0, 1, p - 1,
   identities and lanes whose redundant values come near 2p, repeated 1,
   3 and 16 times; K2 and K5 on such lanes too, with P = Q and P = -Q
   (tests/torch_redundant.py picks them);
   K5's ladder at 8 and 64 lanes and 0, 1 and 255 bits, with a point at
   infinity and scalars 0, 1, r - 1 and r + 2; K4 on all-identity terms,
   one finite lane, equal terms and identity lanes), then the shapes the
   scale-20 main path gives it, timed (kernel and plain): K1 at one
   commit's 2^23 rows, the tree kernel over the trees of one BGMW
   reduction of its buckets, K4 at that reduction's K = 16 terms of 64
   lanes and at the tableless MSM's K = 260 terms of 32 lanes; K5's
   ladder, K2 and K5 at msm_naive's shapes (rows of 8 and 64 points, tree
   levels of 1 to 32 lanes) and at their throughput shapes, with latency
   floors from the product and square latencies measured in one warp
   (csrc/fp_mul_bench.cu) in the same run.  Then the open's quotient
   (csrc/fr_quotient.cu, four kernels a call) against its plain twin, y,
   q and the flag, at a workerOpen's T = 2^19 x 1 row and at 2^18 x 4
   rows, each kernel's device time by torch.profiler, the inversion's
   latency floor its time over one block.
2. The pinned protocol transcript (tests/fixtures) reproduced on the card.
3. worker_commit at T = 2^12 (signed digits, c = 11) against the host C++
   MSM of fourier_tpu_torch.native on the same row.
4. The main path: `python -m fourier_tpu_torch run --scale 20
   --machines-scale 1 --msm-devices cuda:0` in a subprocess, driven over
   HTTP through the whole worker and master flow; both worker proofs and
   the master proof must verify and a repeated commitment must come back
   identical.  The kernel launches are the server's own counts of that
   run.
5. Files: `setup --generate-setup --generate-precompute` writes the
   scale-20 setup and precompute files into a fresh directory of the
   checkout (removed at the end); `run --setup-path --precompute-path`
   serves from them through the same flow; a fixed row's commitment from
   that server equals the one of an in-process backend that loads only
   the setup file and regenerates its tables.  The multi-card server:
   `run --setup-path --msm-devices cuda:0,cuda:0,cuda:0,cuda:0` splits
   every MSM over four shards of the card (tables built in memory at
   c = 13, each shard's rows on its device), drives the same flow, and
   its commitment of the fixed row must equal the file-loaded server's;
   its per-request latency is printed beside phase 4's.  On a host of N
   >= 2 cards it runs again over cuda:0..1 and over cuda:0..N-1.
6. Tableless: on that in-process backend, row 0 without its table commits
   and opens to the tabled bytes (K1, the tree kernel, K4), and so it
   does over four shards of the card (the points split); the
   pinned transcript's rows (8 points each) without tables take msm_naive
   (K5's ladder, then K2), and so does a 64-point MSM held against
   refimpl: each msm_naive call must launch the ladder once, K3 and the
   batched K5 never and K2 at most ceil(log2 n) times.  Then the
   univariate KZG (models/univariate.py) over that backend's X-side SRS:
   a polynomial of T = 2^19 coefficients (the tableless MSM) and one of 64
   (msm_naive), each committed, opened, verified on the host, and a wrong
   value rejected.  Then the round as one call (parallel/prove_sharded.py)
   on that backend's two rows: tabled (its c = 16 tables reused) and
   tableless, each byte-equal to the per-request round of the same rows,
   verified, a wrong z rejected, and timed beside it.
7. The distributed round through the port's own client
   (runtime/client.py, test_routine's flow) at scale 20 / machines_scale
   2: Client.start spawns `python -m fourier_tpu_torch run --device cuda`
   (M = 4 workers, T = 2^18 coefficients a row, tables in memory); each
   row's inverse FFT, workerCommit, workerOpen and workerVerify, then
   masterCommit, masterOpen and masterVerify; every proof must verify and
   a tampered z must be rejected.  Client latency per method (median and
   spread) and the server's KERNEL_LAUNCHES per request are printed.
8. G2 on the card (ops/fp2.py, plain torch): g2_scalar_mul over 1,024
   lanes of random scalars, timed, 8 lanes held against refimpl.

The main path is phases 4 to 7, eleven paths (more on a host of several
cards): the in-memory server, the file-loaded server, the server over
four shards, the tableless MSM at T = 2^19 on one shard and over four,
msm_naive at scale 4, the univariate KZG at T = 2^19 and at 64
coefficients, the round as one call at scale 20 / machines 1, tabled and
tableless, and the client's round at scale 20 / machines 2.  Every phase but the sharded
ones pins one shard (`--msm-devices cuda:0`, or FOURIER_SHARD_MSM=0 for
the client's server).  Launches are counted from 0 before each path and
read after it (a server's are its own counts of its run), and reported
per path; a workerCommit of a server must launch no K2 and no quotient
kernel and, over D shards, K1 and K4 D times each and the tree kernel 4 D
times (1 or 2 on one shard); a workerOpen and the round as one call each
of the quotient's four kernels once.  The line before the last is the kernels' JSON record;
the last line is {"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": ...}}.
"""

from __future__ import annotations

import json
import os
import random
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "protocol_transcript_s4_m1.json")
# the reference's default deployment (fourier_tpu/models/piano.py SetupConfig):
# T = 2^19 coefficients per worker, M = 2 workers
SCALE = 20
# Every phase but the sharded ones runs a worker's MSM on one card, as a
# one-card host does, so that its numbers stay one card's on any host.
ONE_SHARD = ["cuda:0"]

KERNEL_INFO = {
    "accumulate": ("fourier_tpu_torch/csrc/accumulate.cu", "fourier_tpu/ops/msm_fused.py:165"),
    "g1_add": ("fourier_tpu_torch/csrc/g1_add.cu", "fourier_tpu/ops/pallas_curve.py:470"),
    "g1_tree_reduce": ("fourier_tpu_torch/csrc/g1_tree.cu",
                       "fourier_tpu/ops/pallas_curve.py:470"),
    "g1_dbl": ("fourier_tpu_torch/csrc/g1_dbl.cu", "fourier_tpu/ops/pallas_curve.py:224"),
    "horner_2k": ("fourier_tpu_torch/csrc/horner_2k.cu", "fourier_tpu/ops/pallas_curve.py:255"),
    "g1_madd": ("fourier_tpu_torch/csrc/g1_madd.cu", "fourier_tpu/ops/pallas_curve.py:198"),
    # msm_naive's steps in the reference: add_fast and dbl_fast
    # (fourier_tpu/ops/msm.py:209) reach _add_inc_kernel and _dbl_kernel
    "g1_madd_ladder": ("fourier_tpu_torch/csrc/g1_madd.cu",
                       "fourier_tpu/ops/pallas_curve.py:470 and :224"),
    # the open's evaluation-form quotient, four launches of one call of
    # kernels.fr_quotient; fourier_tpu's _eval_form_open is jnp
    **{k: ("fourier_tpu_torch/csrc/fr_quotient.cu", "none (jnp fused by XLA)")
       for k in ("fr_quotient_inv", "fr_quotient_sum", "fr_quotient_eval", "fr_quotient_qhat")},
}
QUOTIENT_KERNELS = tuple(k for k in KERNEL_INFO if k.startswith("fr_quotient_"))

# Work counts for the bounds.  A Montgomery product of 12-word Fp values
# (CIOS) is 2 * 12 * 12 + 12 = 300 32-bit multiply-adds; a complete
# Jacobian add spends 16 products, a mixed add 11 (its doubling branch 4 +
# 7 as well), a doubling 7.  Bytes count each input read once and each
# output written once, at what the function needs: 48 bytes per Fp
# coordinate (the port's int64 limb layout moves 4x that), 1 per mask lane.
MADS_PER_PRODUCT = 300
PRODUCTS = {"add": 16, "madd": 11, "dbl": 7}
COORD_BYTES = 48
# The same for 8-word Fr values: 2 * 8 * 8 + 8 = 136 multiply-adds a
# product, 32 bytes an element (the port's limbs move 4x that).
FR_MADS_PER_PRODUCT = 136
FR_BYTES = 32
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA's data sheet
# 32-bit integer multiply-adds per clock and SM on compute capability 9.0
# (the arithmetic-instruction throughput table of the CUDA C++ Programming
# Guide); the peak is this x SMs x the card's maximum SM clock.
IMAD_PER_CLOCK_PER_SM = 64
# Products and squares of each point operation, for its latency floor: its
# products and squares in series at the latencies phase 1 measures (a
# ladder's floor is its longest lane's chain of operations).
PRODUCTS_SQUARES = {"add": (11, 5), "madd": (7, 4), "dbl": (2, 5)}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# -- helpers ------------------------------------------------------------------------

def rand_fp(n, gen, device):
    """Canonical random Fp limbs [24, n] (top limb below p's)."""
    import torch

    x = torch.randint(0, 1 << 16, (24, n), generator=gen, device=device, dtype=torch.int64)
    x[23] = torch.randint(0, 0x1A01, (n,), generator=gen, device=device, dtype=torch.int64)
    return x


def rand_fr(n, gen, device):
    import torch

    x = torch.randint(0, 1 << 16, (16, n), generator=gen, device=device, dtype=torch.int64)
    x[15] = torch.randint(0, 0x73ED, (n,), generator=gen, device=device, dtype=torch.int64)
    return x


def max_abs_err(a, b):
    return max(int((x - y).abs().max()) if x.numel() else 0 for x, y in zip(a, b))


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps runs, by CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def queued_ms(fn, reps):
    """Mean milliseconds of fn() over reps runs, by CUDA events, the
    launches queued behind ~50 ms of sleep on the card: device time, host
    time between launches not counted (for launches of a few lanes)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    return cuda_ms(fn, reps)


def device_ms(fn, reps):
    """Device milliseconds of each kernel (and copy) of one fn() call, by
    name (its first 60 characters): torch.profiler over reps calls after a
    warm one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if us:
            out[e.key[:60]] = us * 1e-3 / reps
    return out


def int_peak():
    """(int32 multiply-adds a second, SMs, maximum SM MHz) of card 0."""
    import torch

    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits", "-i", "0"],
                         capture_output=True, text=True)
    check(clk.returncode == 0, f"nvidia-smi failed: {clk.stderr.strip()}")
    mhz = float(clk.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return IMAD_PER_CLOCK_PER_SM * sms * mhz * 1e6, sms, mhz


def fp_latency_us(lib):
    """(product, square): microseconds of one redundant Fp product and one
    square (csrc/g1.cuh fp_mul_lazy, fp_sqr_lazy) in one warp's dependent
    chain of 256 (csrc/fp_mul_bench.cu in the library lib), by CUDA
    events, mean of 3 after a warm run."""
    import ctypes

    import torch

    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.fk_bench_lazy_chain.argtypes = [vp, vp, ci, i64, ci, vp]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    words = torch.randint(0, 1 << 32, (2, 12, 32), generator=gen, device="cuda",
                          dtype=torch.int64)
    words[:, 11] %= 0x1A0111EA                      # below p's top word: canonical
    w, m = (words - ((words >> 31) << 32)).to(torch.int32)
    stream = torch.cuda.current_stream().cuda_stream
    out = []
    for square in (0, 1):
        def chain():
            rc = lib.fk_bench_lazy_chain(w.data_ptr(), m.data_ptr(), 256, 32, square, stream)
            check(rc == 0, f"bench_lazy_chain failed: CUDA error {rc}")

        chain()
        ms, _ = cuda_ms(chain, 3)
        out.append(ms * 1e3 / 256)
    return tuple(out)


def _wnaf(k, w):
    """The width-w non-adjacent form of k >= 0, least significant digit
    first."""
    out = []
    while k:
        d = 0
        if k & 1:
            d = k % (1 << w)
            d -= (1 << w) if d >= 1 << (w - 1) else 0
            k -= d
        out.append(d)
        k >>= 1
    return out


def to_dev(p, device):
    return type(p)(*(c.to(device) for c in p))


# -- phase 0 ------------------------------------------------------------------------

def phase0_card_and_build():
    from fourier_tpu_torch.ops import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    peak, sms, mhz = int_peak()
    log(f"phase 0: int32 multiply-add peak {peak:.4e}/s ({sms} SMs x {mhz:.0f} MHz x "
        f"{IMAD_PER_CLOCK_PER_SM}), memory {HBM_BYTES_PER_S:.3e} B/s")
    t0 = time.perf_counter()
    kernels.build()
    log(f"phase 0: kernels built in {time.perf_counter() - t0:.3f} s")
    return card, peak


def bound(mads, nbytes, peak):
    """(bound ms, what sets it): the larger of the operations at the
    int32 peak and the bytes at the memory rate."""
    t_ops, t_bytes = mads / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# -- phase 1 ------------------------------------------------------------------------

def _adversarial(device):
    """Kernel vs plain twin on small batches with the lanes that break
    incomplete formulas; every comparison is exact."""
    import torch

    from fourier_tpu_torch.constants import R
    from fourier_tpu_torch.refimpl.curve import G1_GEN, g1_add, g1_mul, g1_neg
    from fourier_tpu_torch.ops import curve as cv
    from fourier_tpu_torch.ops import kernels
    from fourier_tpu_torch.ops.curve import G1Aff, G1Jac
    from fourier_tpu_torch.ops.field import FP
    from fourier_tpu_torch.ops.limbs import ints_to_vec
    from fourier_tpu_torch.ops.msm_fused import pack_points

    import torch_redundant as rd

    rng = random.Random(0x5EED)
    base = [g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(24)]
    n = 300  # no multiple of the 128-thread block
    ps = [rng.choice(base) for _ in range(n)]
    qs = [rng.choice(base) for _ in range(n)]
    qs[10] = ps[10]                    # same point: the doubling branch
    qs[11] = g1_neg(ps[11])            # inverse pair: the identity
    ps[12] = None                      # identity on the left
    qs[13] = None                      # identity on the right
    ps[14] = qs[14] = None
    expect = [g1_add(a, b) for a, b in zip(ps, qs)]
    same = sum(1 for a, b in zip(ps, qs) if a is not None and a == b)

    p = to_dev(cv.from_affine(cv.affine_from_ints(ps)), device)
    q_aff = to_dev(cv.affine_from_ints(qs), device)
    q = cv.from_affine(q_aff)

    before = kernels.COUNTERS.collisions()["g1_add"]
    got = kernels.g1_add(p, q)
    plain = kernels.g1_add_plain(to_dev(p, "cpu"), to_dev(q, "cpu"))
    check(max_abs_err(to_dev(got, "cpu"), plain) == 0, "g1_add differs from its twin")
    check(cv.jac_to_int_points(got) == expect, "g1_add differs from refimpl")
    col = kernels.COUNTERS.collisions()["g1_add"] - before
    check(col == same, f"g1_add counted {col} doubling lanes, expected {same}")

    # K5 on the same lanes, q affine with its infinity mask
    before = kernels.COUNTERS.collisions()["g1_madd"]
    got = kernels.g1_madd(p, q_aff)
    plain = kernels.g1_madd_plain(to_dev(p, "cpu"), to_dev(q_aff, "cpu"))
    check(max_abs_err(to_dev(got, "cpu"), plain) == 0, "g1_madd differs from its twin")
    check(cv.jac_to_int_points(got) == expect, "g1_madd differs from refimpl")
    col = kernels.COUNTERS.collisions()["g1_madd"] - before
    check(col == same, f"g1_madd counted {col} doubling lanes, expected {same}")

    # K2 and K5 on the edge lanes of their redundant form (identities with
    # x and y zero or not, P = Q also scaled, P = -Q, 0, 1, p - 1, values
    # nearest 2p) against their canonical twins, same-point lanes counted
    def limbs(vals):
        return torch.as_tensor(ints_to_vec(list(vals), 24).astype("int64"), device=device)

    for op in ("add", "madd"):
        pairs = rd.addition_edge_lanes(rng, op == "madd")
        a = G1Jac(*(limbs(u[k] for u, _ in pairs) for k in range(3)))
        if op == "madd":
            b = G1Aff(limbs(v[0] for _, v in pairs), limbs(v[1] for _, v in pairs),
                      torch.zeros(len(pairs), dtype=torch.bool, device=device))
            same = sum(1 for u, v in pairs if u[2] and rd.affine_ints(u) == v)
            run, plain_fn = kernels.g1_madd, kernels.g1_madd_plain
        else:
            b = G1Jac(*(limbs(v[k] for _, v in pairs) for k in range(3)))
            same = sum(1 for u, v in pairs
                       if u[2] and v[2] and rd.affine_ints(u) == rd.affine_ints(v))
            run, plain_fn = kernels.g1_add, kernels.g1_add_plain
        before = kernels.COUNTERS.collisions()["g1_" + op]
        got = run(a, b)
        check(max_abs_err(to_dev(got, "cpu"), plain_fn(to_dev(a, "cpu"), to_dev(b, "cpu"))) == 0,
              f"g1_{op} differs from its twin on the edge lanes")
        col = kernels.COUNTERS.collisions()["g1_" + op] - before
        check(col == same, f"g1_{op} counted {col} doubling lanes on the edge lanes, "
                           f"expected {same}")

    # K5's ladder: curve points with one at infinity, scalars 0, 1, r - 1,
    # r + 2 (the sum meets the point before the last bit: the doubling
    # branch) and random ones, at 8 and 64 lanes, 0, 1 and 255 bits
    for n in (8, 64):
        pts = [rng.choice(base) for _ in range(n)]
        pts[5] = None
        sc = [0, 1, R - 1, R + 2, R + 2] + [rng.randrange(R) for _ in range(n - 5)]
        aff = cv.affine_from_ints(pts)
        tsc = torch.as_tensor(ints_to_vec(sc, 16).astype("int64"))
        for nbits in (0, 1, 255):
            before = kernels.COUNTERS.collisions()["g1_madd"]
            got = kernels.g1_madd_ladder(to_dev(aff, device), tsc.to(device), nbits)
            plain = kernels.g1_madd_ladder_plain(aff, tsc, nbits)
            check(max_abs_err(to_dev(got, "cpu"), plain) == 0,
                  f"g1_madd_ladder differs from its twin ({n} lanes, {nbits} bits)")
            mask = (1 << nbits) - 1
            check(cv.jac_to_int_points(got) == [g1_mul(pt, s & mask) if pt is not None else None
                                                for pt, s in zip(pts, sc)],
                  f"g1_madd_ladder differs from refimpl ({n} lanes, {nbits} bits)")
            col = kernels.COUNTERS.collisions()["g1_madd"] - before
            check(col == (2 if nbits == 255 else 0),
                  f"g1_madd_ladder counted {col} doubling steps ({n} lanes, {nbits} bits)")

    # K3 on the curve lanes, and on coordinates 0, 1, p - 1, identities and
    # lanes whose redundant doubling holds values nearest 2p after one step
    pm = FP.modulus
    lanes = [(0, 0, 0), (rng.randrange(pm), rng.randrange(pm), 0), (pm - 1, 1, 0), (1, 1, 1),
             (pm - 1, pm - 1, pm - 1), (0, rng.randrange(pm), 1), (1, pm - 1, pm - 1)]
    cands = [tuple(rng.randrange(pm) for _ in range(3)) for _ in range(3000)]
    vals = [rd.g1_dbl_redundant(*c) for c in cands]
    lanes += [cands[i] for i in sorted(range(len(cands)),
                                       key=lambda i: 2 * pm - max(vals[i][-3:]))[:6]]
    lanes += [cands[i] for i in sorted(range(len(cands)), key=lambda i: 2 * pm - max(vals[i]))[:4]]
    edge = G1Jac(*(torch.as_tensor(ints_to_vec([ln[k] for ln in lanes], 24).astype("int64"),
                                   device=device) for k in range(3)))
    for pts in (p, edge):
        for repeat in (1, 3, 16):
            got = kernels.g1_dbl(pts, repeat=repeat)
            plain = kernels.g1_dbl_plain(to_dev(pts, "cpu"), repeat)
            check(max_abs_err(to_dev(got, "cpu"), plain) == 0,
                  f"g1_dbl differs from its twin ({pts.x.shape[1]} lanes x {repeat})")

    # K1: runs over a 64-row table with identities, negations, a repeated
    # row (doubling), a row and its negation (identity mid-run), empty
    # runs, and runs of up to 3 pieces: two equal piece sums (doubling in
    # the second pass), two opposite ones (the identity)
    P = kernels.PIECE
    table_pts = [rng.choice(base) for _ in range(64)]
    table_pts[3] = None
    table = to_dev(cv.affine_from_ints(table_pts), device)
    entries, start, count = [], [], []
    for s in range(n):
        k = rng.choice([rng.randrange(0, 7), P - 1, P + 1, 3 * P])
        run = [(rng.randrange(64) << 2) | (rng.randrange(2) << 1) for _ in range(k)]
        if s == 20:
            run = [5 << 2, 5 << 2, 7 << 2]
        if s == 21:
            run = [5 << 2, (5 << 2) | 2, 9 << 2]
        if s == 22:
            run = [(3 << 2) | 1, 6 << 2]
        if s == 23:
            run = [7 << 2] * (2 * P)
        if s == 24:
            run = [9 << 2] * P + [(9 << 2) | 2] * P
        start.append(len(entries))
        count.append(len(run))
        entries += [e | int(table_pts[e >> 2] is None) for e in run]
    i32 = dict(dtype=torch.int32, device=device)
    index = torch.tensor(entries, **i32)
    start, count = torch.tensor(start, **i32), torch.tensor(count, **i32)
    packed = pack_points(table)
    got = kernels.accumulate(packed, index, start, count)
    args = (packed.cpu(), index.cpu(), start.cpu(), count.cpu())
    plain = kernels.accumulate_plain(*args, piece=P)
    check(max_abs_err(to_dev(got, "cpu"), plain) == 0, "accumulate differs from its twin")
    check(cv.jac_to_int_points(got) == cv.jac_to_int_points(kernels.accumulate_plain(*args)),
          "accumulate's pieces differ from whole runs as group elements")

    # the tree kernel: groups whose first level pairs a point with itself,
    # with its inverse, and identities on either side; a width folded while
    # loading, strided leaves, and several roots a group (3 of them: a
    # count that is not a power of two)
    for groups, width, axis, to in ((4, 37, -1, 4), (5, 16, -2, 1), (2, 2100, -1, 1),
                                    (2, 1000, -1, 3)):
        half = (to << (-(-width // to) - 1).bit_length()) // 2
        pts = []
        for _ in range(groups):
            row = [rng.choice(base) for _ in range(width)]
            row[half] = row[0]
            row[half + 1] = g1_neg(row[1])
            row[2] = None
            row[half + 3] = None
            pts += row
        leaves = cv.from_affine(cv.affine_from_ints(pts))
        grid = type(leaves)(*(c.reshape(24, groups, width) for c in leaves))
        if axis == -2:
            grid = type(grid)(*(c.transpose(1, 2) for c in grid))
        got = kernels.g1_tree_reduce([(to_dev(grid, device), axis, to)])[0]
        plain = kernels.g1_tree_reduce_plain(grid, axis, to)
        check(max_abs_err(to_dev(got, "cpu"), plain) == 0,
              f"g1_tree_reduce differs from its twin ({groups} x {width} -> {to})")

    # K4: K = 6 terms of 37 lanes with identity lanes inside (two blocks);
    # all-identity terms; one finite lane; equal terms (same-point adds in
    # the fold and the tree); 70 terms of 3 lanes (two blocks, the last
    # short); each against its twin and refimpl
    P = base[0]
    plans = []
    pts = [rng.choice(base) for _ in range(6 * 37)]
    pts[37 + 3] = None
    pts[5 * 37 + 1] = None
    plans.append(("identity lanes", 6, 37, pts))
    plans.append(("all identity", 5, 8, [None] * 40))
    one = [None] * (9 * 16)
    one[7 * 16 + 5] = P
    plans.append(("one finite lane", 9, 16, one))
    plans.append(("equal terms", 8, 4, [P] * 32))
    plans.append(("short last block", 70, 3, [rng.choice(base) for _ in range(210)]))
    for label, K, width, pts in plans:
        expect = None
        for k in range(K):
            for pt in pts[k * width:(k + 1) * width]:
                expect = g1_add(expect, g1_mul(pt, 1 << k) if pt is not None else None)
        terms = to_dev(cv.from_affine(cv.affine_from_ints(pts)), device)
        before = kernels.COUNTERS.collisions()["horner_2k"]
        got = kernels.horner_2k(terms, width)
        plain = kernels.horner_2k_plain(to_dev(terms, "cpu"), width)
        check(max_abs_err(to_dev(got, "cpu"), plain) == 0,
              f"horner_2k differs from its twin ({label})")
        check(cv.jac_to_int_points(got) == [expect], f"horner_2k differs from refimpl ({label})")
        if label == "equal terms":
            col = kernels.COUNTERS.collisions()["horner_2k"] - before
            check(col > 0, "horner_2k counted no doubling lanes on equal terms")


def _tree_work(p, axis, to):
    """(finite adds, bytes) of one tree: the pairs of non-identity lanes
    over every level, and the leaves read and roots written at 48 bytes a
    coordinate."""
    import torch

    live = (p.z != 0).any(0).movedim(axis - 1 if axis > 0 else axis, -1)
    n = live.shape[-1]
    width = to << (-(-n // to) - 1).bit_length()
    live = torch.cat([live, live.new_zeros(live.shape[:-1] + (width - n,))], -1)
    adds = 0
    while width > to:
        width //= 2
        adds += int((live[..., :width] & live[..., width:]).sum())
        live = live[..., :width] | live[..., width:]
    groups = live.numel() // to
    return adds, 3 * COORD_BYTES * groups * (n + to)


def _tree_reduction(buckets, weights, c, signed, peak):
    """g1_tree_reduce over the trees of one BGMW reduction (rows, columns
    and spare slots in one launch, the two bit-partial-sum trees in a
    second; K4 folds its residual lanes itself), each launch's inputs recorded
    from one run of the reduction: kernel against plain twin on them,
    exact; the kernel's time is that of all the launches, replayed back
    to back on a card kept busy while they are queued (host time between
    launches is not counted); the plain time is the twin's over the same
    trees."""
    import torch

    from fourier_tpu_torch.ops import kernels
    from fourier_tpu_torch.ops import msm_fused as mf

    Bpow = 1 << (c - 1) if signed else 1 << c
    real = kernels.g1_tree_reduce
    launches = []

    def recorded(trees):
        launches.append(list(trees))
        return real(trees)

    kernels.g1_tree_reduce = recorded
    try:
        terms = mf._weighted_sums_factored(buckets, weights, c, Bpow)
    finally:
        kernels.g1_tree_reduce = real
    trees = [tree for launch in launches for tree in launch]
    got = [root for launch in launches for root in real(launch)]
    plain_ms, plain = cuda_ms(lambda: [kernels.g1_tree_reduce_plain(*t) for t in trees], 1)
    err = max(max_abs_err(a, b) for a, b in zip(got, plain))
    reps = 5
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)           # ~50 ms: the queue fills meanwhile
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for launch in launches:
            real(launch)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    work = [_tree_work(*t) for t in trees]
    adds = sum(a for a, _ in work)
    shapes = "; ".join(", ".join(f"{tuple(p.x.shape[1:])}/{axis}->{to}" for p, axis, to in launch)
                       for launch in launches)
    return (err, ms, plain_ms, f"{len(launches)} launches, {len(trees)} trees of one reduction "
            f"({shapes}; {adds} finite adds)",
            bound(adds * PRODUCTS["add"] * MADS_PER_PRODUCT, sum(b for _, b in work), peak),
            terms)


def _main_path_shapes(device, peak, op_us):
    """Kernel vs plain twin, exact and timed, at the shapes the main path
    gives each kernel: T = 2^(SCALE-1) points per row, c = the table's
    window (16 at scale 20); K5, which the scale-20 path does not run, at
    T lanes.  Each result carries the kernel's bound on these inputs, and
    K2's, K5's and the ladder's their latency floor from op_us (the
    microseconds of each point operation's products in series)."""
    import torch

    from fourier_tpu_torch.models.piano import PianoPrecompute
    from fourier_tpu_torch.ops import kernels
    from fourier_tpu_torch.ops import msm_fused as mf
    from fourier_tpu_torch.ops.curve import G1Aff, G1Jac

    gen = torch.Generator(device=device)
    gen.manual_seed(20)
    T = 1 << (SCALE - 1)
    c = PianoPrecompute.window_for(T)
    W = -(-256 // c)
    rows = W * T
    results = {}

    # K1: the BGMW accumulation of one commit (W*T rows into 2^c + spare slots)
    table = mf.pack_points(G1Aff(rand_fp(rows, gen, device), rand_fp(rows, gen, device),
                                 torch.zeros(rows, dtype=torch.bool, device=device)))
    inf = torch.zeros(rows, dtype=torch.bool, device=device)
    digits, neg = mf.bgmw_digits_for(rand_fr(T, gen, device), c, W)
    index, start, count, weights = mf.bucket_runs(inf, digits, c, neg)
    kernels.accumulate(table, index, start, count)
    ms, buckets = cuda_ms(lambda: kernels.accumulate(table, index, start, count), 3)
    plain_ms, plain = cuda_ms(lambda: kernels.accumulate_plain(table, index, start, count,
                                                               piece=kernels.PIECE), 1)
    # the function's work: no row here is at infinity, and a run of k rows
    # needs k - 1 mixed adds (the pieces' second pass is the kernel's own)
    adds = int((count.to(torch.int64).clamp(min=1) - 1).sum())
    nbytes = (table.numel() + index.numel() + 2 * start.numel()) * 4 \
        + 3 * COORD_BYTES * start.numel()
    results["accumulate"] = (max_abs_err(buckets, plain), ms, plain_ms,
                             f"{rows} rows -> {start.shape[0]} slots, piece {kernels.PIECE}",
                             bound(adds * PRODUCTS["madd"] * MADS_PER_PRODUCT, nbytes, peak))
    del table, index, start, count, plain

    # the trees of one BGMW reduction of those buckets
    *tree, terms = _tree_reduction(buckets, weights, c, neg is not None, peak)
    results["g1_tree_reduce"] = tuple(tree)
    del buckets, weights

    # K4 on that reduction's terms (K = c, 64 lanes), and at the tableless
    # MSM's shape (K = 20 windows x 13 bits, 32 lanes; random coordinates)
    L, K, R = terms.x.shape
    shapes = [(G1Jac(*(t.reshape(L, K * R) for t in terms)), R, 20),
              (G1Jac(*(rand_fp(260 * 32, gen, device) for _ in range(3))), 32, 5)]
    k4 = []
    for flat, width, reps in shapes:
        kernels.horner_2k(flat, width)
        ms, got = cuda_ms(lambda: kernels.horner_2k(flat, width), reps)
        plain_ms, plain = cuda_ms(lambda: kernels.horner_2k_plain(flat, width), 1)
        n_terms = flat.x.shape[1] // width
        finite = int((flat.z != 0).any(0).sum())
        k4.append((max_abs_err(got, plain), ms, plain_ms, f"K={n_terms} x {width} lanes",
                   bound((max(finite - 1, 0) * PRODUCTS["add"] + (n_terms - 1) * PRODUCTS["dbl"])
                         * MADS_PER_PRODUCT, 3 * COORD_BYTES * (flat.x.shape[1] + 1), peak)))
    results["horner_2k"] = k4[0]
    results["horner_2k@tableless"] = k4[1]
    del terms, shapes

    # K2 at msm_naive's tree levels (4, 2, 1 lanes for the transcript's
    # 8-point rows, 32 for a 64-point row) and at 32,768 lanes (its
    # throughput reading); device time of launches queued on a busy card
    k2 = {}
    for n in (4, 2, 1, 32, 1 << 15):
        p = G1Jac(*(rand_fp(n, gen, device) for _ in range(3)))
        q = G1Jac(*(rand_fp(n, gen, device) for _ in range(3)))
        kernels.g1_add(p, q)
        ms, got = queued_ms(lambda: kernels.g1_add(p, q), 20)
        plain_ms, plain = cuda_ms(lambda: kernels.g1_add_plain(p, q), 1)
        finite = int(((p.z != 0).any(0) & (q.z != 0).any(0)).sum())
        k2[n] = (max_abs_err(got, plain), ms, plain_ms, f"{n} lanes",
                 bound(finite * PRODUCTS["add"] * MADS_PER_PRODUCT, 9 * COORD_BYTES * n, peak),
                 op_us["add"] * 1e-3)
    results["g1_add"] = k2.pop(4)
    for n, res in k2.items():
        results[f"g1_add@{n}"] = res

    # K3: c doublings of a whole row between two table windows
    p = G1Jac(*(rand_fp(T, gen, device) for _ in range(3)))
    kernels.g1_dbl(p, c)
    ms, got = cuda_ms(lambda: kernels.g1_dbl(p, c), 5)
    plain_ms, plain = cuda_ms(lambda: kernels.g1_dbl_plain(p, c), 1)
    results["g1_dbl"] = (max_abs_err(got, plain), ms, plain_ms, f"{T} lanes x {c}",
                         bound(T * c * PRODUCTS["dbl"] * MADS_PER_PRODUCT,
                               6 * COORD_BYTES * T, peak))

    # K5: 2^19 lanes of p + q, q affine with one lane in 64 at infinity
    # (its throughput reading; no path of the port launches the batched
    # entry), and msm_naive's rows of 8 and 64 lanes
    k5 = {}
    for n in (T, 8, 64):
        a = G1Jac(*(c[:, :n].contiguous() for c in p))
        q_aff = G1Aff(rand_fp(n, gen, device), rand_fp(n, gen, device),
                      torch.arange(n, device=device) % 64 == 0)
        kernels.g1_madd(a, q_aff)
        ms, got = queued_ms(lambda: kernels.g1_madd(a, q_aff), 20)
        plain_ms, plain = cuda_ms(lambda: kernels.g1_madd_plain(a, q_aff), 1)
        finite = int(((a.z != 0).any(0) & ~q_aff.inf).sum())
        k5[n] = (max_abs_err(got, plain), ms, plain_ms, f"{n} lanes",
                 bound(finite * PRODUCTS["madd"] * MADS_PER_PRODUCT,
                       8 * COORD_BYTES * n + n, peak), op_us["madd"] * 1e-3)
    results["g1_madd"] = k5.pop(T)
    for n, res in k5.items():
        results[f"g1_madd@{n}"] = res
    del p, q_aff, got, plain

    # K5's ladder at msm_naive's rows (8 and 64 points, 255-bit scalars).
    # Work: a finite lane's binary chain from its scalar's leading set bit,
    # i.e. a doubling a bit below it and a mixed add a set bit below it
    # (the first add is a select); the latency floor is the longest lane's
    # chain.  Beside it, the floor of a width-5 NAF ladder on the same
    # scalars: 2P and 7 full adds for the odd multiples up to 15P, then a
    # doubling a digit below the top and a full add a nonzero digit below it
    ladder = {}
    for n in (8, 64):
        pts = G1Aff(rand_fp(n, gen, device), rand_fp(n, gen, device),
                    torch.zeros(n, dtype=torch.bool, device=device))
        sc = rand_fr(n, gen, device)
        nbits = 255
        kernels.g1_madd_ladder(pts, sc, nbits)
        ms, got = queued_ms(lambda: kernels.g1_madd_ladder(pts, sc, nbits), 5)
        plain_ms, plain = cuda_ms(lambda: kernels.g1_madd_ladder_plain(pts, sc, nbits), 1)
        ks = [sum(v << (16 * j) for j, v in enumerate(col)) & ((1 << nbits) - 1)
              for col in sc.T.tolist()]
        ks = [k for k, fin in zip(ks, (~pts.inf).tolist()) if fin and k]
        chains = [(k.bit_length() - 1, bin(k).count("1") - 1) for k in ks]
        mads = sum(d * PRODUCTS["dbl"] + a * PRODUCTS["madd"] for d, a in chains)
        longest = max(chains, key=lambda c: c[0] * op_us["dbl"] + c[1] * op_us["madd"])
        floor_us = longest[0] * op_us["dbl"] + longest[1] * op_us["madd"]
        naf = [_wnaf(k, 5) for k in ks]
        naf_us = max(op_us["dbl"] + 7 * op_us["add"] + (len(ds) - 1) * op_us["dbl"]
                     + (sum(1 for d in ds if d) - 1) * op_us["add"] for ds in naf)
        log(f"phase 1: g1_madd_ladder at {n} lanes x {nbits} bits: the longest lane's chain "
            f"{longest[0]} doublings and {longest[1]} mixed adds; a width-5 NAF ladder's "
            f"floor on these scalars {naf_us * 1e-3:.4g} ms")
        ladder[n] = (max_abs_err(got, plain), ms, plain_ms, f"{n} lanes x {nbits} bits",
                     bound(mads * MADS_PER_PRODUCT, (5 * COORD_BYTES + 1 + 32) * n, peak),
                     floor_us * 1e-3)
    results["g1_madd_ladder"] = ladder.pop(8)
    results["g1_madd_ladder@64"] = ladder[64]

    return results


def _quotient(device, peak):
    """The open's quotient (kernels.fr_quotient, four launches a call)
    against its plain twin, exact, at the shapes the main path gives it: a
    workerOpen's row of T = 2^(SCALE-1) lanes, and four rows of T/2 (the
    round as one call's batch).  A result per kernel: its device time
    (torch.profiler, mean of 5 calls); the twin's time is the whole
    quotient's (it has no per-kernel twin) and so is max_abs_err (y and q;
    the flags must agree).  Each kernel's bound counts its own products
    and the Fr elements it reads and writes; fr_quotient_inv's latency floor
    is its time over one block of 16 lanes (its scans and Fermat chain)."""
    import torch

    from fourier_tpu_torch.ops import kernels

    gen = torch.Generator(device=device)
    gen.manual_seed(12)
    results = {}
    for log_t, B in ((SCALE - 1, 1), (SCALE - 2, 4)):
        T = 1 << log_t
        roots = rand_fr(T, gen, device)
        f = rand_fr(B * T, gen, device).reshape(16, B, T) if B > 1 else rand_fr(T, gen, device)
        args = (roots, f, rand_fr(1, gen, device), rand_fr(1, gen, device))
        y, q, flag = kernels.fr_quotient(*args)
        times = device_ms(lambda: kernels.fr_quotient(*args), 5)
        plain_ms, (py, pq, pflag) = cuda_ms(lambda: kernels.fr_quotient_plain(*args), 1)
        check(flag == pflag, f"fr_quotient's flag {flag}, its twin's {pflag}")
        err = max_abs_err((y, q), (py, pq))
        # products a lane (the inversion's way up and down: 4; a row's sum
        # and q: 1 each) and Fr elements read and written a lane
        work = {"fr_quotient_inv": (4 * T, 3 * T),
                "fr_quotient_sum": (B * T, B * T + T),
                "fr_quotient_eval": (2 * log_t + 1 + B, 2 + B),
                "fr_quotient_qhat": (B * T, 2 * B * T + T)}
        floor = []
        if B == 1:
            small = [rand_fr(n, gen, device) for n in (16, 16, 1, 1)]
            floor = [_kernel_ms(device_ms(lambda: kernels.fr_quotient(*small), 20),
                                "fr_quotient_inv")]
        suffix = "" if B == 1 else f"@2^{log_t}x{B}"
        for name, (products, elements) in work.items():
            results[name + suffix] = (
                err, _kernel_ms(times, name), plain_ms, f"T = 2^{log_t} x {B} rows",
                bound(products * FR_MADS_PER_PRODUCT, elements * FR_BYTES, peak),
                *(floor if name == "fr_quotient_inv" else ()))
        log(f"phase 1: the quotient at T = 2^{log_t} x {B} rows: device ms {times}")
        del roots, f, args, y, q, py, pq
    return results


def _kernel_ms(times, name):
    ms = [v for k, v in times.items() if k.startswith(name + "_kernel")]
    check(len(ms) == 1, f"the profiler saw no single {name} kernel: {sorted(times)}")
    return ms[0]


def phase1_kernels(device, peak):
    from fourier_tpu_torch.ops import kernels

    _adversarial(device)
    log(f"phase 1: adversarial lanes exact; launches {kernels.COUNTERS.launches}, "
        f"doubling-branch lanes {kernels.COUNTERS.collisions()}")
    product_us, square_us = fp_latency_us(kernels.build())
    op_us = {op: a * product_us + b * square_us for op, (a, b) in PRODUCTS_SQUARES.items()}
    log(f"phase 1: one warp's dependent chain: a redundant product {product_us:.4f} us, a "
        f"square {square_us:.4f} us; in series an add {op_us['add']:.4f} us, a mixed add "
        f"{op_us['madd']:.4f} us, a doubling {op_us['dbl']:.4f} us")
    results = {**_main_path_shapes(device, peak, op_us), **_quotient(device, peak)}
    for name, (err, ms, plain_ms, shape, (bound_ms, bound_by), *floor) in results.items():
        log(f"phase 1: {name} at {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4g} ms ({bound_by})"
            + (f", latency floor {floor[0]:.4g} ms" if floor else "") + f", max_abs_err {err}")
        check(err == 0, f"{name} differs from its plain twin at main-path shapes")
    return results


# -- phases 2 and 3 -------------------------------------------------------------------

def phase2_transcript(device):
    from fourier_tpu_torch.refimpl.curve import g1_to_bytes
    from fourier_tpu_torch.refimpl.field import fr_to_bytes
    from fourier_tpu_torch.runtime import wire
    from fourier_tpu_torch.models.piano import (PianoBackend, PianoFFTSettings,
                                                PianoPrecompute, generate_trusted_setup)

    with open(FIXTURE) as fh:
        fx = json.load(fh)
    t0 = time.perf_counter()
    fft = PianoFFTSettings(fx["scale"], fx["machines_scale"], device)
    settings = generate_trusted_setup(fft, tuple(bytes.fromhex(h) for h in fx["secrets_hex"]))
    settings.precompute = PianoPrecompute.generate(settings)
    b = PianoBackend(fft, settings, device, ONE_SHARD)

    def g1(p):
        return wire.b64_encode(g1_to_bytes(p))

    def fr(v):
        return wire.b64_encode(fr_to_bytes(v))

    alpha, beta = fx["alpha"], fx["beta"]
    coms, evals, proofs = [], [], []
    for i, row in enumerate(fx["rows"]):
        com = b.worker_commit(i, row)
        y, pi = b.worker_open(i, row, alpha)
        check(g1(com) == fx["commitments"][i], f"transcript commitment {i}")
        check(fr(y) == fx["evals"][i] and g1(pi) == fx["proofs"][i], f"transcript open {i}")
        check(b.worker_verify(i, com, alpha, y, pi), f"transcript verify {i}")
        coms.append(com)
        evals.append(y)
        proofs.append(pi)
    mc = b.master_commit(coms)
    z, (pi0, pi1) = b.master_open(evals, proofs, beta)
    check(g1(mc) == fx["master_commitment"], "transcript master commitment")
    check(fr(z) == fx["z"] and g1(pi0) == fx["pi_0"] and g1(pi1) == fx["pi_1"],
          "transcript master open")
    check(b.master_verify(mc, beta, alpha, z, (pi0, pi1)), "transcript master verify")
    log(f"phase 2: pinned transcript reproduced on {device} "
        f"({time.perf_counter() - t0:.3f} s)")


def phase3_oracle(device):
    from fourier_tpu_torch import native
    from fourier_tpu_torch.constants import R
    from fourier_tpu_torch.models.piano import (PianoBackend, PianoFFTSettings,
                                                PianoPrecompute, generate_trusted_setup)
    from fourier_tpu_torch.ops import curve as cv

    t0 = time.perf_counter()
    fft = PianoFFTSettings(12, 0, device)
    settings = generate_trusted_setup(fft, (b"\x07" * 32, b"\x08" * 32))
    settings.precompute = PianoPrecompute.generate(settings)
    check(settings.precompute.c == 11, f"window {settings.precompute.c} at T=2^12, expected 11")
    b = PianoBackend(fft, settings, device, ONE_SHARD)
    rng = random.Random(12)
    row = [rng.randrange(R) for _ in range(fft.T)]
    got = b.worker_commit(0, row)
    points = cv.jac_to_int_points(cv.from_affine(settings.u_row(0)))
    want = native.g1_msm(points, row)        # raises if g++ cannot build it
    check(got == want, "worker_commit at T=2^12 differs from fourier_tpu_torch.native.g1_msm")
    log(f"phase 3: worker_commit at T=2^12 (c=11, signed digits) equals "
        f"fourier_tpu_torch.native.g1_msm ({time.perf_counter() - t0:.3f} s)")


# -- phase 4 ------------------------------------------------------------------------

class ServerProcess:
    """`python -m fourier_tpu_torch run` with its log lines collected."""

    def __init__(self, port, extra_args=(), env=None):
        self.lines = []
        self.launches = []
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "fourier_tpu_torch", "run", "--scale", str(SCALE),
             "--machines-scale", "1", "--host", "127.0.0.1", "--port", str(port),
             "--device", "cuda", *extra_args],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=None if env is None else dict(os.environ, **env))
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            line = line.rstrip("\n")
            self.lines.append(line)
            print(f"[server] {line}", file=sys.stderr, flush=True)
            if "KERNEL_LAUNCHES " in line:
                self.launches.append(json.loads(line.split("KERNEL_LAUNCHES ", 1)[1]))

    def wait_for(self, pred, timeout, what):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if pred():
                return
            check(self.proc.poll() is None,
                  f"server exited ({self.proc.returncode}) while waiting for {what}")
            time.sleep(0.2)
        raise SmokeFailure(f"timed out after {timeout} s waiting for {what}")

    def stop(self):
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(30)
        self._reader.join(10)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _log_seconds(lines, what):
    """The seconds of a `... took X s` (or `Xs`) log line, or None."""
    for ln in lines:
        if what in ln and " took " in ln:
            return float(ln.split(" took ", 1)[1].split()[0].rstrip("s"))
    return None


def drive_server(label, card, extra_args=(), env=None, fixed_row=None,
                 setup_kernels=("accumulate", "g1_dbl"), shards=1):
    """Start a scale-20 server, drive the worker and master flow over HTTP
    (every proof must verify, a repeated commitment must repeat) and stop
    it.  Returns (launch totals of the run, the server's setup seconds,
    its log lines, the commitment of `fixed_row` (wire strings) at i = 0
    or None, the launches of its first workerCommit and workerOpen, the
    milliseconds of each method's requests).  `setup_kernels` must have
    run during the server's setup.  A BGMW workerCommit over `shards`
    shards launches no K2, K1 and K4 once a shard, and the tree kernel at
    most twice on one shard (the factorised reduction), four times a shard
    on several (the exchange's sums, the rows and column partials, the
    gathered columns with the high bits, the residual lanes)."""
    from fourier_tpu_torch.runtime import wire

    port = _free_port()
    url = f"http://127.0.0.1:{port}/"
    t0 = time.perf_counter()
    server = ServerProcess(port, extra_args, env)
    timings = []
    fixed_com = None
    per_request = {}

    def rpc(method, params=None, expect_device=False):
        n_before = len(server.launches)
        body = wire.serialize_request(method, params).encode()
        req = urllib.request.Request(url, data=body, method="POST")
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as resp:
            data = resp.read()
        dt = time.perf_counter() - t
        out = json.loads(data)
        check(not (isinstance(out, dict) and set(out) == {"message"}),
              f"{method} failed: {out}")
        launches = None
        if expect_device:
            server.wait_for(lambda: len(server.launches) > n_before, 30,
                            f"the launch counts of {method}")
            launches = server.launches[-1]["launches"]
        timings.append((method, dt, launches))
        log(f"{label}: {method} {dt * 1000:.3f} ms" +
            (f" launches {launches}" if launches is not None else ""))
        return out, launches

    try:
        server.wait_for(lambda: any(ln.endswith("Serving") for ln in server.lines), 900,
                        "the server to finish setup")
        boot = time.perf_counter() - t0
        setup_line = next(ln for ln in server.lines if "setup took" in ln)
        log(f"{label}: server serving after {boot:.3f} s (process start, setup, kernel "
            f"build, warm-up commit); {setup_line.split('INFO fourier_tpu: ')[-1]}; {card}")
        setup_launches = server.launches[0]["launches"]
        log(f"{label}: launches at server setup {setup_launches}, at the warm-up commit "
            f"{server.launches[1]['launches']}")
        for k in setup_kernels:
            check(setup_launches[k] > 0, f"{label}: the server's setup ran no {k} kernel")
        rpc("ping")
        poly = rpc("randomPoly")[0]["poly"]
        alpha = rpc("randomPoint")[0]["point"]
        beta = rpc("randomPoint")[0]["point"]
        coms, evals, proofs, rows = [], [], [], []
        for i, f in enumerate(poly):
            row = rpc("fft", {"poly": f, "left": True, "inverse": True}, True)[0]["poly"]
            rows.append(row)
            out, launches = rpc("workerCommit", {"i": i, "poly": row}, True)
            trees = launches["g1_tree_reduce"]
            check(launches["g1_add"] == 0 and launches["accumulate"] == shards
                  and launches["horner_2k"] == shards
                  and (0 < trees <= 2 if shards == 1 else trees == 4 * shards)
                  and not any(launches[k] for k in QUOTIENT_KERNELS),
                  f"workerCommit launched K2 {launches['g1_add']} times, K1 "
                  f"{launches['accumulate']}, the tree kernel {trees} and K4 "
                  f"{launches['horner_2k']} times (expected 0, {shards}, "
                  f"{'1 or 2' if shards == 1 else 4 * shards} and {shards}), and the "
                  f"quotient's {[launches[k] for k in QUOTIENT_KERNELS]} (expected none)")
            per_request.setdefault("workerCommit", launches)
            com = out["commitment"]
            opened, launches = rpc("workerOpen", {"i": i, "poly": row, "x": alpha}, True)
            check(all(launches[k] == 1 for k in QUOTIENT_KERNELS),
                  f"workerOpen launched the quotient's kernels "
                  f"{[launches[k] for k in QUOTIENT_KERNELS]} times (expected once each)")
            per_request.setdefault("workerOpen", launches)
            ok = rpc("workerVerify", {"i": i, "alpha": alpha, "proof": opened["proof"],
                                      "eval": opened["eval"], "commitment": com})[0]
            check(ok["valid"] is True, f"worker {i}: proof rejected")
            coms.append(com)
            evals.append(opened["eval"])
            proofs.append(opened["proof"])
        mc = rpc("masterCommit", {"commitments": coms})[0]["commitment"]
        mo = rpc("masterOpen", {"evals": evals, "proofs": proofs, "beta": beta}, True)[0]
        ok = rpc("masterVerify", {"commitment": mc, "beta": beta, "alpha": alpha,
                                  "z": mo["z"], "pi_0": mo["pi_0"], "pi_1": mo["pi_1"]})[0]
        check(ok["valid"] is True, "master proof rejected")
        again = rpc("workerCommit", {"i": 0, "poly": rows[0]}, True)[0]["commitment"]
        check(again == coms[0], "a repeated workerCommit returned other bytes")
        if fixed_row is not None:
            fixed_com = rpc("workerCommit", {"i": 0, "poly": fixed_row}, True)[0]["commitment"]
    finally:
        server.stop()
    totals = dict.fromkeys(KERNEL_INFO, 0)
    for rec in server.launches:
        for k, v in rec["launches"].items():
            totals[k] += v
    log(f"{label}: scale {SCALE} / machines 1 served and verified; kernel launches {totals}")
    ms = {}
    for method, dt, _ in timings:
        ms.setdefault(method, []).append(dt * 1e3)
    return (totals, _log_seconds(server.lines, "setup took"), server.lines, fixed_com,
            per_request, ms)


def phase4_main_path(card):
    totals, setup_s, _, _, per_request, ms = drive_server(
        "phase 4", card, ["--msm-devices", ",".join(ONE_SHARD)])
    for k in ("accumulate", "g1_tree_reduce", "g1_dbl", "horner_2k"):
        check(totals[k] > 0, f"the main path launched no {k} kernel")
    check(totals["g1_add"] == 0, f"the main path launched K2 {totals['g1_add']} times")
    return totals, setup_s, per_request, ms


def _ms_list(values):
    return " / ".join(f"{v:.3f}" for v in values)


def phase5_sharded(card, setup_path, served, row_strs, phase4_ms):
    """The multi-card server: `run --setup-path S --msm-devices ...` with the
    tables built in memory at the window of its shard count (c = 13 at four
    shards: W = 20, 10,485,760 rows a row table), first four shards of
    cuda:0, then, on a host of N >= 2 cards, the distinct cards cuda:0..1
    and cuda:0..N-1.  Each drives the whole flow (every proof verifies),
    its per-request launches are checked for its shard count, and its
    commitment of the fixed row must equal `served`, that of the server
    that loaded S and its c = 16 tables from files (phase 5; phase 4's
    server drew its SRS from fresh secrets, which no other server can
    reproduce).  Returns ({path: launch totals}, {path: per-request
    launches})."""
    import torch

    runs = [("server_sharded4_s20", ["cuda:0"] * 4)]
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        runs += [(f"server_{D}cards_s20", [f"cuda:{i}" for i in range(D)])
                 for D in sorted({2, n_cards})]
    paths, requests = {}, {}
    for path, devices in runs:
        label = f"phase 5 ({path})"
        totals, setup_s, _, com, per_request, ms = drive_server(
            label, card, ["--setup-path", setup_path, "--msm-devices", ",".join(devices)],
            fixed_row=row_strs, setup_kernels=("g1_dbl",), shards=len(devices))
        check(com == served, f"{label}: the fixed row's commitment differs from the one-card "
                             f"server's over the same setup file")
        for method in ("workerCommit", "workerOpen"):
            log(f"{label}: {method} {_ms_list(ms[method])} ms against phase 4's (one shard, "
                f"c = 16) {_ms_list(phase4_ms[method])} ms; {card}")
        log(f"{label}: the fixed row commits like the one-card server from files (byte for "
            f"byte); server setup {setup_s:.3f} s")
        paths[path], requests[path] = totals, per_request
    return paths, requests


# -- phases 5 and 6 -------------------------------------------------------------------

def _fixed_row(T):
    """A fixed row of T canonical scalars: (int64 [16, T] limbs, wire strings)."""
    import numpy as np

    from fourier_tpu_torch.runtime.server import _enc_fr_batch

    rng = np.random.default_rng(5)
    limbs = rng.integers(0, 1 << 16, size=(16, T), dtype=np.int64)
    limbs[15] = rng.integers(0, 0x73ED, size=T)      # below r's top limb: canonical
    return limbs, _enc_fr_batch(limbs)


def phase5_files(card, setup_in_memory_s, phase4_ms):
    """Setup and precompute files at the full scale: written by `setup`,
    served by `run`, held against tables regenerated from the setup file;
    the sharded servers over the same setup file (phase5_sharded)."""
    import torch

    from fourier_tpu_torch.models.piano import PianoBackend, SetupConfig
    from fourier_tpu_torch.ops.kernels import COUNTERS
    from fourier_tpu_torch.refimpl.curve import g1_to_bytes
    from fourier_tpu_torch.runtime import io as rio
    from fourier_tpu_torch.runtime import wire

    T = 1 << (SCALE - 1)
    d = tempfile.mkdtemp(prefix=".smoke-files-", dir=ROOT)
    try:
        setup_path, pre_path = os.path.join(d, "setup"), os.path.join(d, "precompute")
        log(f"phase 5: free disk {shutil.disk_usage(d).free / 1e9:.3f} GB before writing "
            f"(expected: setup file ~{(3 * T + 2) * 48 / 1e6:.0f} MB, precompute file "
            f"~{2 * 16 * T * 193 / 1e9:.2f} GB)")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "fourier_tpu_torch", "setup", "--scale", str(SCALE),
             "--machines-scale", "1", "--setup-path", setup_path, "--precompute-path",
             pre_path, "--generate-setup", "--generate-precompute",
             "--msm-devices", ",".join(ONE_SHARD)],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        check(res.returncode == 0, f"`setup` exited {res.returncode}:\n{res.stderr[-4000:]}")
        log(f"phase 5: `setup` wrote {os.path.getsize(setup_path)} B of setup file and "
            f"{os.path.getsize(pre_path)} B of precompute file in "
            f"{time.perf_counter() - t0:.3f} s")

        limbs, row_strs = _fixed_row(T)
        totals, setup_s, lines, served, _, _ = drive_server(
            "phase 5", card, ["--setup-path", setup_path, "--precompute-path", pre_path,
                              "--msm-devices", ",".join(ONE_SHARD)],
            env={"FOURIER_LOG": "debug"}, fixed_row=row_strs, setup_kernels=())
        for k in ("accumulate", "g1_tree_reduce", "horner_2k"):
            check(totals[k] > 0, f"the file-loaded server launched no {k} kernel")
        log(f"phase 5: server setup from files {setup_s:.3f} s (reading the setup file "
            f"{_log_seconds(lines, 'Reading trusted setup'):.3f} s, loading the "
            f"precompute file {_log_seconds(lines, 'Loading Precomputations'):.3f} s) vs "
            f"{setup_in_memory_s:.3f} s generated in memory (phase 4); {card}")
        sharded = phase5_sharded(card, setup_path, served, row_strs, phase4_ms)

        t0 = time.perf_counter()
        COUNTERS.reset()
        b = PianoBackend.setup(SetupConfig(scale=SCALE, machines_scale=1, setup_path=setup_path,
                                           generate_setup=False), "cuda", ONE_SHARD)
        torch.cuda.synchronize()
        log(f"phase 5: in-process backend from the setup file alone, tables regenerated, "
            f"in {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        rio.load_setup(setup_path, True, "cuda")
        torch.cuda.synchronize()
        log(f"phase 5: load_setup alone (decompressing {3 * T + 2} points on the card) "
            f"{time.perf_counter() - t0:.3f} s; {card}")
        local = wire.b64_encode(g1_to_bytes(b.worker_commit(0, limbs)))
        check(served == local, "the file-loaded server's commitment differs from the one "
                               "of tables regenerated from the setup file")
        log("phase 5: loaded tables commit like regenerated ones (byte for byte)")
        return totals, b, limbs, sharded
    finally:
        shutil.rmtree(d, ignore_errors=True)


def phase6_tableless(b, limbs):
    """Row 0 without its table (tableless msm at T = 2^(SCALE-1)) must give
    the tabled bytes, on one shard and over four shards of cuda:0 (the
    points split, msm_fused_sharded at the window of 2^(SCALE-3) points);
    the pinned transcript's 8-point rows without tables take msm_naive."""
    import dataclasses

    import torch

    from fourier_tpu_torch.constants import R
    from fourier_tpu_torch.models.piano import (PianoBackend, PianoFFTSettings,
                                                generate_trusted_setup)
    from fourier_tpu_torch.ops import curve as cv
    from fourier_tpu_torch.ops import msm as msm_mod
    from fourier_tpu_torch.ops.curve import G1Jac
    from fourier_tpu_torch.ops.kernels import COUNTERS
    from fourier_tpu_torch.ops.limbs import ints_to_vec
    from fourier_tpu_torch.refimpl.curve import G1_GEN, g1_msm, g1_mul, g1_to_bytes
    from fourier_tpu_torch.refimpl.field import fr_to_bytes
    from fourier_tpu_torch.runtime import wire

    alpha = 0x1234567890ABCDEF

    def commit_open(label, backend=b):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        com = backend.worker_commit(0, limbs)
        t1 = time.perf_counter()
        y, pi = backend.worker_open(0, limbs, alpha)
        t2 = time.perf_counter()
        log(f"phase 6: {label} worker_commit {(t1 - t0) * 1e3:.3f} ms, worker_open "
            f"{(t2 - t1) * 1e3:.3f} ms (in process, T = {limbs.shape[1]})")
        return g1_to_bytes(com), fr_to_bytes(y), g1_to_bytes(pi)

    commit_open("tabled (warm-up)")
    tabled = commit_open("tabled")
    table = b.settings.precompute.u_rows[0]
    b.settings.precompute.u_rows[0] = None
    try:
        COUNTERS.reset()
        tableless = commit_open("tableless")
        big = dict(COUNTERS.launches)
    finally:
        b.settings.precompute.u_rows[0] = table
    check(tableless == tabled, "tableless commit/open differs from the tabled bytes")
    for k in ("accumulate", "g1_tree_reduce", "horner_2k"):
        check(big[k] > 0, f"the tableless MSM launched no {k} kernel")
    log(f"phase 6: tableless equals tabled at T = {limbs.shape[1]}; launches {big}")
    shards = 4
    split = PianoBackend(b.fft, dataclasses.replace(b.settings, precompute=None), "cuda",
                         ["cuda:0"] * shards)
    commit_open(f"tableless over {shards} shards (warm-up)", split)
    COUNTERS.reset()
    tableless_split = commit_open(f"tableless over {shards} shards of cuda:0", split)
    big_split = dict(COUNTERS.launches)
    check(tableless_split == tableless,
          f"the tableless commit/open over {shards} shards differs from one shard's")
    check(big_split["accumulate"] == 2 * shards and big_split["horner_2k"] == 2 * shards
          and big_split["g1_tree_reduce"] > 0 and big_split["g1_add"] == 0,
          f"the tableless commit and open over {shards} shards launched {big_split} (expected "
          f"K1 and K4 {2 * shards} times each, the tree kernel, no K2)")
    log(f"phase 6: tableless over {shards} shards equals one shard's; launches {big_split}")

    with open(FIXTURE) as fh:
        fx = json.load(fh)
    fft = PianoFFTSettings(fx["scale"], fx["machines_scale"], "cuda")
    settings = generate_trusted_setup(fft, tuple(bytes.fromhex(h) for h in fx["secrets_hex"]))
    small = PianoBackend(fft, settings, "cuda", ONE_SHARD)   # no precompute: every row tableless
    real = msm_mod.msm_naive
    calls = []

    def recorded(points, scalars):
        """msm_naive, with the launches of each call recorded."""
        before = dict(COUNTERS.launches)
        out = real(points, scalars)
        calls.append((points.x.shape[-1],
                      {k: COUNTERS.launches[k] - before[k] for k in KERNEL_INFO}))
        return out

    msm_mod.msm_naive = recorded
    try:
        COUNTERS.reset()
        for i, row in enumerate(fx["rows"]):
            com = small.worker_commit(i, row)
            y, pi = small.worker_open(i, row, fx["alpha"])
            check(wire.b64_encode(g1_to_bytes(com)) == fx["commitments"][i]
                  and wire.b64_encode(fr_to_bytes(y)) == fx["evals"][i]
                  and wire.b64_encode(g1_to_bytes(pi)) == fx["proofs"][i],
                  f"tableless transcript row {i}")
        naive = dict(COUNTERS.launches)
        # the path's full width: 64 points (one at infinity) against refimpl
        rng = random.Random(64)
        pts = [g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(64)]
        pts[7] = None
        sc = [rng.randrange(R) for _ in range(64)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = msm_mod.msm_naive(to_dev(cv.affine_from_ints(pts), "cuda"),
                                torch.as_tensor(ints_to_vec(sc, 16).astype("int64"),
                                                device="cuda"))
        torch.cuda.synchronize()
        wide_ms = (time.perf_counter() - t0) * 1e3
        check(cv.jac_to_int_points(G1Jac(*(c[..., None] for c in got))) == [g1_msm(pts, sc)],
              "msm_naive of 64 points differs from refimpl")
    finally:
        msm_mod.msm_naive = real
    check(len(calls) == 2 * len(fx["rows"]) + 1, f"{len(calls)} msm_naive calls recorded")
    for n, launches in calls:
        check(launches["g1_madd_ladder"] == 1 and launches["g1_dbl"] == 0
              and launches["g1_madd"] == 0 and launches["g1_add"] <= (n - 1).bit_length(),
              f"an msm_naive call of {n} points launched the ladder "
              f"{launches['g1_madd_ladder']} times, K3 {launches['g1_dbl']}, the batched K5 "
              f"{launches['g1_madd']} and K2 {launches['g1_add']} times (expected 1, 0, 0 and "
              f"at most {(n - 1).bit_length()})")
    log(f"phase 6: the pinned transcript's rows commit and open tableless (msm_naive); "
        f"launches {naive}; a 64-point msm_naive equals refimpl ({wide_ms:.3f} ms wall), "
        f"launches {calls[-1][1]}; every msm_naive call launched the ladder once, K3 and the "
        f"batched K5 never, K2 at most ceil(log2 n) times")
    return big, naive, big_split


def phase6_univariate(b):
    """UnivariateKZG over the scale-20 backend's X-side SRS: a polynomial of
    T = 2^(SCALE-1) coefficients through the tableless MSM and one of 64
    through msm_naive, each committed, opened and verified on the host
    (a wrong value must be rejected).  Returns each path's launches."""
    import torch

    from fourier_tpu_torch.constants import R
    from fourier_tpu_torch.models.univariate import UnivariateKZG
    from fourier_tpu_torch.ops import curve as cv
    from fourier_tpu_torch.ops.kernels import COUNTERS
    from fourier_tpu_torch.refimpl.curve import g1_msm

    kzg = UnivariateKZG(b.settings, b.fft)
    rng = random.Random(19)
    x = rng.randrange(R)
    paths = {}
    for label, n in ((f"univariate_T2^{SCALE - 1}", b.fft.T), ("univariate_64", 64)):
        coeffs = [rng.randrange(R) for _ in range(n)]
        torch.cuda.synchronize()
        COUNTERS.reset()
        t0 = time.perf_counter()
        com = kzg.commit_to_poly(coeffs)
        t1 = time.perf_counter()
        y, proof = kzg.compute_proof_single(coeffs, x)
        t2 = time.perf_counter()
        launches = paths[label] = dict(COUNTERS.launches)
        check(kzg.verify_proof_single(com, x, y, proof), f"{label}: the proof was rejected")
        check(not kzg.verify_proof_single(com, x, (y + 1) % R, proof),
              f"{label}: a wrong value was accepted")
        if n <= 64:
            points = cv.jac_to_int_points(cv.from_affine(kzg._tau_powers(n)))
            check(com == g1_msm(points, coeffs), f"{label}: the commitment differs from refimpl")
            check(launches["g1_madd_ladder"] == 2 and launches["accumulate"] == 0,
                  f"{label}: launches {launches} (expected the ladder twice, K1 never)")
        else:
            check(all(launches[k] > 0 for k in ("accumulate", "g1_tree_reduce", "horner_2k"))
                  and launches["g1_madd_ladder"] == 0,
                  f"{label}: launches {launches} (expected K1, the tree kernel and K4, no "
                  f"ladder)")
        log(f"phase 6: {label}: commit {(t1 - t0) * 1e3:.3f} ms, open {(t2 - t1) * 1e3:.3f} ms "
            f"(in process, host quotient included), verified and a wrong value rejected; "
            f"launches {launches}")
    return paths


def phase6_round(b, limbs, card):
    """The round as one call (parallel/prove_sharded.py) on phase 5's
    backend at scale 20 / machines_scale 1 (M = 2 rows of T = 2^19): tabled
    (the backend's c = 16 tables reused, so no K3) and tableless, each
    byte-equal to the per-request round of the same rows and verified, a
    wrong z rejected.  Returns each path's launches."""
    import numpy as np
    import torch

    from fourier_tpu_torch.constants import R
    from fourier_tpu_torch.convert import prove_outputs_to_ints
    from fourier_tpu_torch.ops.kernels import COUNTERS
    from fourier_tpu_torch.parallel import prove_sharded as ps
    from fourier_tpu_torch.refimpl.curve import g1_to_bytes
    from fourier_tpu_torch.refimpl.field import fr_to_bytes

    M, T = b.fft.M, b.fft.T
    rng = np.random.default_rng(6)
    rows = [limbs]
    for _ in range(1, M):
        row = rng.integers(0, 1 << 16, size=(16, T), dtype=np.int64)
        row[15] = rng.integers(0, 0x73ED, size=T)        # below r's top limb: canonical
        rows.append(row)
    alpha, beta = 0x1234567890ABCDEF, 0xFEDCBA0987654321

    def wire(coms, evals, proofs, mc, z, pi0, pi1):
        return ([g1_to_bytes(c) for c in coms], [fr_to_bytes(y) for y in evals],
                [g1_to_bytes(p) for p in proofs], g1_to_bytes(mc), fr_to_bytes(z),
                g1_to_bytes(pi0), g1_to_bytes(pi1))

    per_request_ms = []
    for run in range(2):                            # timed twice, as the round is
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        coms = [b.worker_commit(i, r) for i, r in enumerate(rows)]
        opens = [b.worker_open(i, r, alpha) for i, r in enumerate(rows)]
        mc = b.master_commit(coms)
        z, (pi0, pi1) = b.master_open([y for y, _ in opens], [p for _, p in opens], beta)
        per_request_ms.append((time.perf_counter() - t0) * 1e3)
        got = wire(coms, [y for y, _ in opens], [p for _, p in opens], mc, z, pi0, pi1)
        check(run == 0 or got == want, "the per-request round differs between two calls")
        want = got
    per_request = " / ".join(f"{ms:.3f}" for ms in per_request_ms)
    log(f"phase 6 (round): the per-request round (M = {M} commits and opens, then the "
        f"master on the host) {per_request} ms (first / second call)")

    paths = {}
    for label, table_c in ((f"prove_round_s{SCALE}", b.settings.precompute.c),
                           (f"prove_round_tableless_s{SCALE}", None)):
        prove = ps.build_distributed_prove(None, table_c)
        times = []
        for run in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            COUNTERS.reset()
            t0 = time.perf_counter()
            args = ps.prove_inputs_from_backend(b, rows, alpha, beta, table_c)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = prove(*args)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            times.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3,
                          (torch.cuda.max_memory_allocated() - base) / 2**30))
            if run == 0:
                launches = paths[label] = dict(COUNTERS.launches)
            del args
        got = prove_outputs_to_ints(out)
        check(wire(got["commits"], got["evals"], got["proofs"], got["master_com"], got["z"],
                   got["pi0"], got["pi1"]) == want,
              f"{label}: the round differs from the per-request round")
        pi = (got["pi0"], got["pi1"])
        check(b.master_verify(got["master_com"], beta, alpha, got["z"], pi),
              f"{label}: the aggregate proof was rejected")
        check(not b.master_verify(got["master_com"], beta, alpha, (got["z"] + 1) % R, pi),
              f"{label}: a wrong z was accepted")
        check(launches["accumulate"] == 2 * M and launches["horner_2k"] == 2 * M
              and launches["g1_madd_ladder"] == 1 and launches["g1_dbl"] == 0
              and launches["g1_madd"] == 0 and all(launches[k] == 1 for k in QUOTIENT_KERNELS),
              f"{label}: launches {launches} (expected K1 and K4 {2 * M} times each, the "
              f"ladder once for pi1, no K3 and no batched K5, the quotient's once each)")
        log(f"phase 6 (round): {label}: inputs {times[0][0]:.3f} / {times[1][0]:.3f} ms, the "
            f"round {times[0][1]:.3f} / {times[1][1]:.3f} ms (first / second call, each after "
            f"torch.cuda.synchronize()), peak device memory above the backend's "
            f"{times[0][2]:.3f} / {times[1][2]:.3f} GiB, against the per-request round's "
            f"{per_request} ms; byte-equal to it, verified, a wrong z rejected; "
            f"launches {launches}; {card}")
    return paths


# -- phase 7 ------------------------------------------------------------------------

def _read_server_log(path):
    """(lines, KERNEL_LAUNCHES records) of a server's log file so far."""
    with open(path) as fh:
        lines = fh.read().split("\n")[:-1]          # the last line may be partly written
    return lines, [json.loads(ln.split("KERNEL_LAUNCHES ", 1)[1]) for ln in lines
                   if "KERNEL_LAUNCHES " in ln]


def phase7_client_round(card, machines_scale=2):
    """test_routine's flow through the port's own client: Client.start
    spawns `python -m fourier_tpu_torch run --scale SCALE --machines-scale
    machines_scale --device cuda` (tables generated in memory), then the
    random polynomial, each row's inverse FFT, workerCommit, workerOpen and
    workerVerify for each of the M workers, masterCommit, masterOpen and
    masterVerify, and a tampered z that must be rejected; the server stops
    in `finally`.  Returns (launch totals of the server's run, launches of
    each device method's first request)."""
    import statistics

    from fourier_tpu_torch.constants import R
    from fourier_tpu_torch.refimpl.field import fr_from_bytes, fr_to_bytes
    from fourier_tpu_torch.runtime import client as cl
    from fourier_tpu_torch.runtime import wire

    label = f"phase 7 (scale {SCALE} / machines {machines_scale})"
    M, T = 1 << machines_scale, 1 << (SCALE - machines_scale)
    d = tempfile.mkdtemp(prefix=".smoke-files-", dir=ROOT)
    log_path = os.path.join(d, "server.log")
    times, per_request = {}, {}
    try:
        with open(log_path, "w") as out:
            rpc = cl.Client(host="127.0.0.1", port=_free_port(), device="cuda", output=out)
            try:
                t0 = time.perf_counter()
                check(rpc.start(scale=SCALE, machines_scale=machines_scale, timeout=900) is None,
                      f"{label}: the client's server did not start")
                start_s = time.perf_counter() - t0
                lines, launches = _read_server_log(log_path)
                setup_line = next(ln for ln in lines if "setup took" in ln)
                log(f"{label}: Client.start returned after {start_s:.3f} s (process start, "
                    f"setup, warm-up commit); {setup_line.split('INFO fourier_tpu: ')[-1]}; "
                    f"launches at setup {launches[0]['launches']}; {card}")

                def call(method, fn, *args, device=False):
                    n = len(_read_server_log(log_path)[1])
                    t = time.perf_counter()
                    res = fn(rpc, *args)
                    times.setdefault(method, []).append(time.perf_counter() - t)
                    if device:
                        deadline = time.monotonic() + 30
                        while len(recs := _read_server_log(log_path)[1]) <= n:
                            check(time.monotonic() < deadline,
                                  f"{label}: no launch counts logged for {method}")
                            time.sleep(0.05)
                        per_request.setdefault(method, recs[-1]["launches"])
                    return res

                f = call("randomPoly", cl.random_poly)
                check(len(f) == M and all(len(row) == T for row in f),
                      f"{label}: randomPoly gave {len(f)} rows")
                alpha, beta = cl.random_point(rpc), cl.random_point(rpc)
                coms, evals, proofs = [], [], []
                for i in range(M):
                    row = call("fft", cl.fft, f[i], True, True, device=True)
                    com = call("workerCommit", cl.worker_commit, i, row, device=True)
                    y, pi = call("workerOpen", cl.worker_open, i, row, alpha, device=True)
                    check(call("workerVerify", cl.worker_verify, i, pi, alpha, y, com) is True,
                          f"{label}: worker {i}: proof rejected")
                    coms.append(com)
                    evals.append(y)
                    proofs.append(pi)
                mc = call("masterCommit", cl.master_commit, coms)
                z, pi0, pi1 = call("masterOpen", cl.master_open, evals, proofs, beta,
                                   device=True)
                check(call("masterVerify", cl.master_verify, mc, beta, alpha, z, pi0, pi1)
                      is True, f"{label}: the master proof was rejected")
                bad_z = wire.b64_encode(fr_to_bytes((fr_from_bytes(wire.b64_decode(z)) + 1) % R))
                check(cl.master_verify(rpc, mc, beta, alpha, bad_z, pi0, pi1) is False,
                      f"{label}: a tampered z was accepted")
            finally:
                rpc.stop()
        lines, launches = _read_server_log(log_path)
    finally:
        for ln in _read_server_log(log_path)[0] if os.path.exists(log_path) else ():
            print(f"[server] {ln}", file=sys.stderr)
        shutil.rmtree(d, ignore_errors=True)
    for method, ts in times.items():
        ms = [t * 1e3 for t in ts]
        log(f"{label}: {method} client latency median {statistics.median(ms):.3f} ms, "
            f"min {min(ms):.3f}, max {max(ms):.3f} over {len(ms)} requests")
    for method, counts in per_request.items():
        log(f"{label}: KERNEL_LAUNCHES of the first {method}: {counts}")
    c = per_request["workerCommit"]
    check(c["accumulate"] == 1 and 0 < c["g1_tree_reduce"] <= 2 and c["horner_2k"] == 1
          and c["g1_add"] == 0, f"{label}: a workerCommit launched {c}")
    totals = dict.fromkeys(KERNEL_INFO, 0)
    for rec in launches:
        for k, v in rec["launches"].items():
            totals[k] += v
    check(all(totals[k] > 0 for k in ("accumulate", "g1_tree_reduce", "g1_dbl", "horner_2k",
                                      *QUOTIENT_KERNELS)),
          f"{label}: the run launched {totals}")
    log(f"{label}: {M} workers and the master verified, a tampered z rejected; kernel "
        f"launches {totals}")
    return totals, per_request


# -- phase 8 ------------------------------------------------------------------------

def phase8_g2(card, n=1024):
    """g2_scalar_mul (ops/fp2.py, plain torch: the JAX module reaches no
    Pallas kernel) over n lanes of the G2 generator with random scalars,
    timed; 8 lanes held against refimpl."""
    import torch

    from fourier_tpu_torch.ops import fp2
    from fourier_tpu_torch.ops.curve import G1Jac
    from fourier_tpu_torch.refimpl.curve import G2_GEN, g2_mul

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    sc = rand_fr(n, gen, "cuda")
    p = fp2.g2_generator_jac((n,), "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fp2.g2_scalar_mul(p, sc)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    ks = [sum(v << (16 * j) for j, v in enumerate(col)) for col in sc[:, :8].T.tolist()]
    got = fp2.g2_jac_to_int_points(G1Jac(*(c[..., :8] for c in out)))
    want = [((q[0].c0, q[0].c1), (q[1].c0, q[1].c1)) for q in (g2_mul(G2_GEN, k) for k in ks)]
    check(got == want, "g2_scalar_mul on the card differs from refimpl")
    log(f"phase 8: g2_scalar_mul over {n} lanes x 256 bits on the card {dt:.3f} s (plain "
        f"torch); 8 lanes equal refimpl; {card}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "fourier_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository (no fourier_tpu_torch/ "
              "beside it)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(1, os.path.join(ROOT, "tests"))      # torch_redundant: the edge lanes
    t_start = time.perf_counter()

    def timed_phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"{name} took {time.perf_counter() - t0:.3f} s")
        return out

    try:
        card, peak = timed_phase("phase 0", phase0_card_and_build)
        results = timed_phase("phase 1", phase1_kernels, "cuda", peak)
        timed_phase("phase 2", phase2_transcript, "cuda")
        timed_phase("phase 3", phase3_oracle, "cuda")
        torch.cuda.empty_cache()
        served, setup_s, per_request, phase4_ms = timed_phase("phase 4", phase4_main_path, card)
        from_files, backend, limbs, (sharded, sharded_requests) = timed_phase(
            "phase 5", phase5_files, card, setup_s, phase4_ms)
        tableless, naive, tableless_split = timed_phase("phase 6", phase6_tableless, backend,
                                                        limbs)
        univariate = timed_phase("phase 6 (univariate)", phase6_univariate, backend)
        rounds = timed_phase("phase 6 (round)", phase6_round, backend, limbs, card)
        del backend
        torch.cuda.empty_cache()
        shard_env = os.environ.get("FOURIER_SHARD_MSM")
        os.environ["FOURIER_SHARD_MSM"] = "0"            # the client's server: one card
        try:
            client_round, client_requests = timed_phase("phase 7", phase7_client_round, card)
        finally:
            os.environ.pop("FOURIER_SHARD_MSM")
            if shard_env is not None:
                os.environ["FOURIER_SHARD_MSM"] = shard_env
        timed_phase("phase 8", phase8_g2, card)
        check(not any(m == "jax" or m.startswith("jax.") or m == "fourier_tpu"
                      or m.startswith("fourier_tpu.") for m in sys.modules),
              "the port imported jax or the JAX package")
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    paths = {"server_in_memory_s20": served, "server_from_files_s20": from_files, **sharded,
             "tableless_T2^19": tableless, "tableless_sharded4_T2^19": tableless_split,
             "msm_naive_s4": naive, **univariate, **rounds,
             "client_round_s20_m2": client_round}
    per_request = {f"{m} ({phase})": c for phase, requests in
                   (("phase 4", per_request),
                    *((f"phase 5, {path}", r) for path, r in sharded_requests.items()),
                    ("phase 7", client_requests))
                   for m, c in requests.items()}
    for path, counts in paths.items():
        log(f"launches on path {path}: {dict((k, counts[k]) for k in KERNEL_INFO)}")
    for method, counts in per_request.items():
        log(f"launches per {method}: {dict((k, counts[k]) for k in KERNEL_INFO)}")
    log(f"whole run {time.perf_counter() - t_start:.3f} s")
    # `launches` is the count on the first path (in the order above) that
    # runs the kernel, named by `launches_path` (0 and null for the batched
    # K5, which no path of the port launches: msm_naive runs its ladder
    # entry, and the reference's msm_naive does not reach _madd_kernel
    # either); every path's own count is in `launches_by_path`, and the
    # first request of each device method of the phase 4 and phase 7
    # servers in `launches_per_request`.  `shape` names the inputs
    # the numbers were taken on; `other_shapes` holds a kernel's numbers at
    # its other shapes (K4 at the tableless MSM's; K2, K5 and the ladder at
    # msm_naive's and at their throughput shapes; the quotient's at 2^18 x 4
    # rows); `latency_floor_ms`, where present, is the chain of dependent
    # products the launch cannot beat, at the product and square latencies
    # phase 1 measured in this run (for fr_quotient_inv, its time over one
    # block, measured in this run).
    first = {k: next((p for p, c in paths.items() if c[k] > 0), None) for k in KERNEL_INFO}

    def numbers(res):
        out = {"shape": res[3], "max_abs_err": res[0], "ms": res[1], "plain_ms": res[2],
               "bound_ms": res[4][0], "bound_by": res[4][1]}
        if len(res) > 5:
            out["latency_floor_ms"] = res[5]
        return out

    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": paths[first[name]][name] if first[name] else 0,
                "launches_path": first[name],
                "launches_by_path": {p: c[name] for p, c in paths.items()},
                "launches_per_request": {m: c[name] for m, c in per_request.items()},
                **numbers(results[name]), "library_ms": None,
                "other_shapes": [numbers(r) for k, r in results.items()
                                 if k.startswith(name + "@")]}
               for name, (src, rep) in KERNEL_INFO.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
