#!/usr/bin/env python3
"""Times the hand-written kernels of one scale-20 BGMW commit on one NVIDIA
card, and the Fp product they are built on.

Run from the root of the repository, on a machine with a card:

    python3 kernel_probe.py                        # the package beside this file
    python3 kernel_probe.py --tree DIR --label X   # the package in DIR (e.g. a
                                                   # parent commit from git archive)

Sections (each printed; the whole report is printed last as one JSON
object, and written to --out FILE where one is given):

1. the card's name and power limit (nvidia-smi);
2. with --sass, the Fp Montgomery product and square (csrc/fp_mul_bench.cu):
   registers (ptxas), instructions of one product (one square) by opcode
   (cuobjdump -sass of a one-product kernel), the rate of dependent chains
   over 2^20 lanes and the latency of one product (square) in a single
   warp's chain (CUDA events), the latency of the redundant product and
   square (no final subtraction), and the latency of one complete add and
   one mixed add (a chain of 64 dependent ones of random coordinates on
   32 lanes); then ptxas's registers, stack and spills for each kernel of
   the library;
3. K1 (accumulate) at the main path's shape: 2^23 table rows (16 windows x
   2^19 points, c = 16, unsigned digits) into 65,536 + 1,024 slots, kernel
   mean of 3 launches after a warm one;
4. the reduction of those buckets: `_weighted_sums_factored` (the rows,
   columns, bit and spare trees), then K4 on its [16, 64] terms with the
   tree-kernel fold of the residual lanes after it where the package
   returns more than one lane: CUDA events around the calls (host time
   between launches included) and host wall (after a synchronize), mean
   of 5 (the trees) or 20 (K4) runs each, and the launches of each kernel;
5. the whole BGMW MSM (digits to one point) at that shape: CUDA events and
   host wall, mean of 3, and its launches;
6. K4 (and its fold) at the tableless shape, K = 20 x 13 = 260 terms of 32
   lanes (random Fp coordinates), mean of 5; K3 at 2^19 lanes x 16
   doublings, mean of 5, and on one warp (32 lanes x 256 doublings: the
   latency of a doubling); K2 at 1, 2, 4 and 32 lanes (msm_naive's tree
   levels) and 32,768, K5 at 8 and 64 lanes (msm_naive's rows) and 2^19,
   mean of 20, and K5's ladder entry, where the package has one, at 8 and
   64 lanes x 255 bits, mean of 5; all by CUDA events after a warm launch,
   K2, K5 and the ladder with the launches queued behind a sleep on the
   card (device time), K2 and K5 also back to back without it (a call's
   time as a caller sees it);
7. msm_naive at 8 and 64 random points (events around the call and wall,
   and its launches), and in-process worker_commit and worker_open of the
   pinned scale-4 transcript's rows without tables (msm_naive);
8. worker_commit in process at T = 2^19 over random row points (c = 16
   BGMW table, and tableless at c = 13): CUDA events around the call
   (coefficient upload to affine point on the host), mean of 3 after a
   warm one;
9. with --setup, only the in-memory server setup at scale 20 / machines 1
   (host wall after a synchronize, and its launches), instead of 2-8;
10. the open's evaluation-form quotient (`models/piano.py` `_eval_form_open`,
   on a card the kernels of csrc/fr_quotient.cu where the package has them)
   at the main path's shapes, one row of 2^19 and four rows of 2^18: a
   call's host wall (mean of 5 after a warm one; the call ends in its
   flag's read-back), its launches, each kernel's device time
   (torch.profiler, mean of 5 calls), the bound, and the plain twin's wall
   on the card (mean of 2) with bit-equality of y, q and the flag; and the
   inversion kernel alone at T = 16 (one block: its Fermat chain and scans,
   the latency floor of the design).  With --quotient, only this section
   (after 1).

To compare two trees, run the script on each in turn in one chip call
(parent, change, change, parent): a tree's first run builds its kernels.

No number from this script is a CPU number: it exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

# the timing helpers of the smoke beside this file (imported before --tree
# puts another checkout, with its own chip_smoke.py, first on sys.path)
from chip_smoke import (FR_BYTES, FR_MADS_PER_PRODUCT, bound, cuda_ms, device_ms, fp_latency_us,
                        int_peak, log, queued_ms)

ROOT = os.path.dirname(os.path.abspath(__file__))
SCALE = 20


def wall_ms(fn, reps):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps, out


def launches_of(fn):
    from fourier_tpu_torch.ops import kernels

    before = dict(kernels.COUNTERS.launches)
    out = fn()
    return {k: v - before.get(k, 0) for k, v in kernels.COUNTERS.launches.items()
            if v - before.get(k, 0)}, out


# -- section 2 ------------------------------------------------------------------------

def _sass_opcodes(sass: str, function: str) -> dict:
    """Opcode counts of one function in cuobjdump -sass output."""
    counts, inside = {}, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = function in line
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if inside and m:
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return counts


def fp_mul(build_dir):
    import ctypes

    import torch

    from fourier_tpu_torch.ops import kernels

    nvcc = kernels._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    # compiled from a copy, so that its g1.cuh is the one of the package probed
    src = os.path.join(build_dir, "fp_mul_bench.cu")
    shutil.copyfile(os.path.join(ROOT, "fourier_tpu_torch", "csrc", "fp_mul_bench.cu"), src)
    flags = [*kernels._ARCH, "-std=c++17", "-O3", "-I", kernels.CSRC]
    n, iters = 1 << 20, 64
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    words = torch.randint(0, 1 << 32, (2, 12, n), generator=gen, device="cuda",
                          dtype=torch.int64)
    words[:, 11] %= 0x1A0111EA                      # below p's top word: canonical
    a32 = (words - ((words >> 31) << 32)).to(torch.int32)
    so = os.path.join(build_dir, "libbench.so")
    cubin = os.path.join(build_dir, "bench.cubin")
    res = subprocess.run([nvcc, *flags, "-Xptxas", "-v", "-Xcompiler", "-fPIC", "-shared",
                          "-o", so, src], capture_output=True, text=True, check=True)
    regs = {k: int(r) for k, r in re.findall(
        r"Compiling entry function '(\w+)'[\s\S]*?Used (\d+) registers", res.stderr)}
    subprocess.run([nvcc, *flags, "-cubin", "-o", cubin, src], check=True, capture_output=True)
    sass = subprocess.run([cuobjdump, "-sass", cubin], check=True, capture_output=True,
                          text=True).stdout
    ops = _sass_opcodes(sass, "bench_one")
    sqr_ops = _sass_opcodes(sass, "bench_sqr_one")
    lib = ctypes.CDLL(so)
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.fk_bench_chain.argtypes = [vp, vp, ci, i64, vp]
    lib.fk_bench_sqr_chain.argtypes = [vp, ci, i64, vp]
    stream = torch.cuda.current_stream().cuda_stream

    def chain(x, m, k, lanes):
        rc = lib.fk_bench_chain(x.data_ptr(), m.data_ptr(), k, lanes, stream)
        if rc != 0:
            raise RuntimeError(f"bench_chain failed: CUDA error {rc}")

    y = a32[0].clone()
    chain(y, a32[1], iters, n)
    ms, _ = cuda_ms(lambda: chain(y, a32[1], iters, n), 3)
    # one warp alone: the latency of a product in a dependent chain
    w = a32[0, :, :32].contiguous()
    m = a32[1, :, :32].contiguous()
    one_warp_ms, _ = cuda_ms(lambda: chain(w, m, 256, 32), 3)

    def sqr_chain(x, k, lanes):
        rc = lib.fk_bench_sqr_chain(x.data_ptr(), k, lanes, stream)
        if rc != 0:
            raise RuntimeError(f"bench_sqr_chain failed: CUDA error {rc}")

    sqr_chain(y, iters, n)
    sqr_ms, _ = cuda_ms(lambda: sqr_chain(y, iters, n), 3)
    sqr_warp_ms, _ = cuda_ms(lambda: sqr_chain(w, 256, 32), 3)

    # the redundant product and square (no final subtraction) in one warp
    lazy_us = dict(zip(("mul", "sqr"), fp_latency_us(lib)))

    # one warp's chain of 64 dependent complete (mixed) additions of
    # random coordinates: the latency of one addition
    lib.fk_bench_add_chain.argtypes = [vp, vp, ci, ci, i64, vp]
    pts = torch.randint(0, 1 << 32, (2, 3, 12, 32), generator=gen, device="cuda",
                        dtype=torch.int64)
    pts[:, :, 11] %= 0x1A0111EA
    pts = (pts - ((pts >> 31) << 32)).to(torch.int32)
    add_us = {}
    for label, mixed in (("add", 0), ("madd", 1)):
        acc = pts[0].clone()

        def add_chain():
            rc = lib.fk_bench_add_chain(acc.data_ptr(), pts[1].data_ptr(), mixed, 64, 32,
                                        stream)
            if rc != 0:
                raise RuntimeError(f"bench_add_chain failed: CUDA error {rc}")

        add_chain()
        add_ms, _ = cuda_ms(add_chain, 3)
        add_us[label] = add_ms * 1e3 / 64
    rec = {"registers": regs, "sass_total": sum(ops.values()),
           "sass_imad": sum(c for op, c in ops.items() if op.startswith("IMAD")),
           "sass_imad_wide": sum(c for op, c in ops.items() if op.startswith("IMAD.WIDE")),
           "sass_imad_mov": sum(c for op, c in ops.items() if op.startswith("IMAD.MOV")),
           "sass_iadd3": sum(c for op, c in ops.items() if op.startswith("IADD3")),
           "opcodes": dict(sorted(ops.items(), key=lambda kv: -kv[1])[:12]),
           "chain_ms": ms, "products_per_s": n * iters / (ms * 1e-3),
           "latency_us": one_warp_ms * 1e3 / 256,
           "sqr_sass_total": sum(sqr_ops.values()),
           "sqr_sass_imad": sum(c for op, c in sqr_ops.items() if op.startswith("IMAD")),
           "sqr_per_s": n * iters / (sqr_ms * 1e-3), "sqr_latency_us": sqr_warp_ms * 1e3 / 256,
           "lazy_latency_us": lazy_us["mul"], "lazy_sqr_latency_us": lazy_us["sqr"],
           "add_latency_us": add_us["add"], "madd_latency_us": add_us["madd"]}
    log(f"fp_mul: {rec['sass_imad']} IMAD-class ({rec['sass_imad_wide']} wide, "
        f"{rec['sass_imad_mov']} moves), {rec['sass_iadd3']} IADD3, {rec['sass_total']} "
        f"SASS instructions in a one-product kernel; registers {regs}; "
        f"{n} lanes x {iters} dependent products {ms:.4f} ms = "
        f"{rec['products_per_s']:.4e} products/s; one warp: {rec['latency_us']:.4f} us a "
        f"dependent product; fp_sqr: {rec['sqr_sass_imad']} IMAD-class, "
        f"{rec['sqr_sass_total']} SASS instructions, {rec['sqr_per_s']:.4e} squares/s, one "
        f"warp {rec['sqr_latency_us']:.4f} us a dependent square; redundant (no final "
        f"subtraction): {rec['lazy_latency_us']:.4f} us a product, "
        f"{rec['lazy_sqr_latency_us']:.4f} us a square; one warp: "
        f"{rec['add_latency_us']:.4f} us a dependent complete add, "
        f"{rec['madd_latency_us']:.4f} us a dependent mixed add")
    return rec


def kernel_resources(build_dir):
    """ptxas's registers, stack and spills for every kernel of the library."""
    from fourier_tpu_torch.ops import kernels

    nvcc = kernels._nvcc()
    srcs = [name for name in kernels._SOURCES if name not in ("errors.cu", "fp_mul_bench.cu")]
    procs = [subprocess.Popen([nvcc, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                               os.path.join(kernels.CSRC, name), "-o",
                               os.path.join(build_dir, name + ".o")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name in srcs]
    out = {}
    for name, proc in zip(srcs, procs):
        text = proc.communicate()[0]
        for fn, body in re.findall(r"Compiling entry function '(\w+)'([\s\S]*?)(?=Compiling "
                                   r"entry function|\Z)", text):
            regs = re.search(r"Used (\d+) registers", body)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
            stack = re.search(r"(\d+) bytes stack frame", body)
            out[fn] = {"source": name, "registers": int(regs.group(1)) if regs else None,
                       "stack_bytes": int(stack.group(1)) if stack else None,
                       "spill_store_bytes": int(spill.group(1)) if spill else None,
                       "spill_load_bytes": int(spill.group(2)) if spill else None}
            log(f"ptxas {name} {fn}: {out[fn]}")
    return out


# -- sections 3 to 5 ------------------------------------------------------------------

def rand_fp(n, gen):
    import torch

    x = torch.randint(0, 1 << 16, (24, n), generator=gen, device="cuda", dtype=torch.int64)
    x[23] = torch.randint(0, 0x1A01, (n,), generator=gen, device="cuda", dtype=torch.int64)
    return x


def rand_fr(n, gen):
    import torch

    x = torch.randint(0, 1 << 16, (16, n), generator=gen, device="cuda", dtype=torch.int64)
    x[15] = torch.randint(0, 0x73ED, (n,), generator=gen, device="cuda", dtype=torch.int64)
    return x


def main_path(report):
    import torch

    from fourier_tpu_torch.ops import kernels
    from fourier_tpu_torch.ops import msm_fused as mf
    from fourier_tpu_torch.ops.curve import G1Aff, G1Jac

    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    T = 1 << (SCALE - 1)
    c = mf.bgmw_auto_window(T)
    W = -(-256 // c)
    rows = W * T
    table = mf.pack_points(G1Aff(rand_fp(rows, gen), rand_fp(rows, gen),
                                 torch.zeros(rows, dtype=torch.bool, device="cuda")))
    inf = torch.zeros(rows, dtype=torch.bool, device="cuda")
    scalars = rand_fr(T, gen)
    digits, neg = mf.bgmw_digits_for(scalars, c, W)
    index, start, count, weights = mf.bucket_runs(inf, digits, c, neg)
    shape = f"{rows} rows -> {start.shape[0]} slots"

    # K1
    kernels.accumulate(table, index, start, count)
    k1_ms, buckets = cuda_ms(lambda: kernels.accumulate(table, index, start, count), 3)
    report["k1"] = {"shape": shape, "ms": k1_ms, "piece": getattr(kernels, "PIECE", None)}
    log(f"K1 accumulate at {shape}: {k1_ms:.4f} ms")
    del table, index, start, count

    # the reduction: its trees, then K4 (with the fold after it, where the
    # package has one)
    Bpow = 1 << (c - 1) if neg is not None else 1 << c
    terms_launches, terms = launches_of(lambda: mf._weighted_sums_factored(buckets, weights,
                                                                           c, Bpow))
    sums_ms, _ = cuda_ms(lambda: mf._weighted_sums_factored(buckets, weights, c, Bpow), 5)
    sums_wall, _ = wall_ms(lambda: mf._weighted_sums_factored(buckets, weights, c, Bpow), 5)
    L, K, R = terms.x.shape
    flat = G1Jac(*(t.reshape(L, K * R) for t in terms))
    k4 = horner_step(flat, R, 20)
    red = {"weighted_sums_ms": sums_ms, "weighted_sums_wall_ms": sums_wall,
           "weighted_sums_launches": terms_launches, "k4": k4,
           "total_ms": sums_ms + k4["ms"], "total_wall_ms": sums_wall + k4["wall_ms"],
           "terms_shape": [K, R]}
    report["reduction"] = red
    log(f"reduction of {buckets.x.shape[-1]} buckets (c = {c}): weighted sums "
        f"{sums_ms:.4f} ms (wall {sums_wall:.4f} ms, launches {terms_launches}); K4 at "
        f"K = {K} x {R} lanes {k4['ms']:.4f} ms (wall {k4['wall_ms']:.4f} ms, K4 alone "
        f"{k4['k4_ms']:.4f} ms, launches {k4['launches']}); total "
        f"{sums_ms + k4['ms']:.4f} ms on the card, {sums_wall + k4['wall_ms']:.4f} ms wall")
    del buckets, terms, flat

    # the whole MSM
    table = mf.pack_points(G1Aff(rand_fp(rows, gen), rand_fp(rows, gen), inf))
    msm_launches, _ = launches_of(lambda: mf.msm_fused_bgmw(table, inf, scalars, c))
    msm_ms, _ = cuda_ms(lambda: mf.msm_fused_bgmw(table, inf, scalars, c), 3)
    msm_wall, _ = wall_ms(lambda: mf.msm_fused_bgmw(table, inf, scalars, c), 3)
    report["msm"] = {"ms": msm_ms, "wall_ms": msm_wall, "launches": msm_launches,
                     "points_per_s": T / (msm_wall * 1e-3)}
    log(f"BGMW MSM of {T} points (c = {c}): {msm_ms:.4f} ms on the card, wall "
        f"{msm_wall:.4f} ms, launches {msm_launches}")


def horner_step(terms, width, reps):
    """K4 over [24, K * width] terms, and the tree-kernel fold of its
    residual lanes after it where the package's K4 returns more than one
    lane (the parent's form): CUDA events and wall around both, K4 alone
    by events, and the launches of one step."""
    from fourier_tpu_torch.ops import curve as cv
    from fourier_tpu_torch.ops import kernels

    def step():
        res = kernels.horner_2k(terms, width)
        return cv.fold_small(res) if res.x.shape[-1] > 1 else res

    launches, _ = launches_of(step)
    ms, _ = cuda_ms(step, reps)
    wall, _ = wall_ms(step, reps)
    k4_ms, _ = cuda_ms(lambda: kernels.horner_2k(terms, width), reps)
    return {"ms": ms, "wall_ms": wall, "k4_ms": k4_ms, "launches": launches, "reps": reps}


def kernels_alone(report):
    """K4 at the tableless shape, K3, K2 and K5 at the main path's shapes."""
    import torch

    from fourier_tpu_torch.ops import kernels
    from fourier_tpu_torch.ops.curve import G1Aff, G1Jac

    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    T = 1 << (SCALE - 1)
    K, R = 20 * 13, 32
    terms = G1Jac(*(rand_fp(K * R, gen) for _ in range(3)))
    kernels.horner_2k(terms, R)
    k4 = horner_step(terms, R, 5)
    report["k4_tableless"] = dict(k4, shape=[K, R])
    log(f"K4 at the tableless shape K = {K} x {R} lanes: {k4['ms']:.4f} ms with its fold "
        f"(wall {k4['wall_ms']:.4f} ms, K4 alone {k4['k4_ms']:.4f} ms, launches "
        f"{k4['launches']})")
    del terms

    p = G1Jac(*(rand_fp(T, gen) for _ in range(3)))
    kernels.g1_dbl(p, 16)
    k3_ms, _ = cuda_ms(lambda: kernels.g1_dbl(p, 16), 5)
    warp = G1Jac(*(c[:, :32].contiguous() for c in p))
    kernels.g1_dbl(warp, 256)
    warp_ms, _ = cuda_ms(lambda: kernels.g1_dbl(warp, 256), 3)
    report["k3"] = {"ms": k3_ms, "shape": [T, 16], "one_warp_dbl_us": warp_ms * 1e3 / 256}
    log(f"K3 at {T} lanes x 16: {k3_ms:.4f} ms; one warp: {warp_ms * 1e3 / 256:.4f} us a "
        f"dependent doubling")

    # K2 at msm_naive's tree levels (1-32 lanes) and at 32,768 lanes (its
    # throughput reading); K5 at msm_naive's rows (8, 64 lanes) and 2^19:
    # device time (launches queued), and a call's time back to back (the
    # wrapper's host time where that is longer)
    k2, k5, k2_call, k5_call = {}, {}, {}, {}
    for n in (1, 2, 4, 32, 1 << 15):
        q = G1Jac(*(rand_fp(n, gen) for _ in range(3)))
        a = G1Jac(*(c[:, :n].contiguous() for c in p))
        kernels.g1_add(a, q)
        k2[n], _ = queued_ms(lambda: kernels.g1_add(a, q), 20)
        k2_call[n], _ = cuda_ms(lambda: kernels.g1_add(a, q), 20)
    for n in (8, 64, T):
        q_aff = G1Aff(rand_fp(n, gen), rand_fp(n, gen), torch.arange(n, device="cuda") % 64 == 0)
        a = G1Jac(*(c[:, :n].contiguous() for c in p))
        kernels.g1_madd(a, q_aff)
        k5[n], _ = queued_ms(lambda: kernels.g1_madd(a, q_aff), 20)
        k5_call[n], _ = cuda_ms(lambda: kernels.g1_madd(a, q_aff), 20)
    report["k2"] = {"ms_by_lanes": k2, "call_ms_by_lanes": k2_call}
    report["k5"] = {"ms_by_lanes": k5, "call_ms_by_lanes": k5_call}
    log(f"K2 ms by lanes: {k2} (a call back to back: {k2_call}); K5 ms by lanes: {k5} "
        f"(a call back to back: {k5_call})")
    if hasattr(kernels, "g1_madd_ladder"):
        ladder = {}
        for n in (8, 64):
            pts = G1Aff(rand_fp(n, gen), rand_fp(n, gen),
                        torch.zeros(n, dtype=torch.bool, device="cuda"))
            sc = rand_fr(n, gen)
            kernels.g1_madd_ladder(pts, sc, 255)
            ladder[n], _ = queued_ms(lambda: kernels.g1_madd_ladder(pts, sc, 255), 5)
        report["ladder"] = {"ms_by_lanes": ladder, "nbits": 255}
        log(f"K5 ladder (255 bits) ms by lanes: {ladder}")


def msm_naive_calls(report):
    """msm_naive (every lane's double-and-add, then K2's tree) on 8 and
    64 random points with random 255-bit scalars: CUDA events around the
    call and host wall, mean of 5 after a warm one, and its launches; then
    in-process worker_commit and worker_open of the pinned scale-4
    transcript's two rows without tables (8 points a row, msm_naive), each
    by events and wall, mean of 3 after a warm one."""
    import torch

    from fourier_tpu_torch.models.piano import (PianoBackend, PianoFFTSettings,
                                                generate_trusted_setup)
    from fourier_tpu_torch.ops import msm as msm_mod
    from fourier_tpu_torch.ops.curve import G1Aff

    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    out = {}
    for n in (8, 64):
        pts = G1Aff(rand_fp(n, gen), rand_fp(n, gen),
                    torch.zeros(n, dtype=torch.bool, device="cuda"))
        sc = rand_fr(n, gen)
        launches, _ = launches_of(lambda: msm_mod.msm_naive(pts, sc))
        ms, _ = cuda_ms(lambda: msm_mod.msm_naive(pts, sc), 5)
        wall, _ = wall_ms(lambda: msm_mod.msm_naive(pts, sc), 5)
        out[n] = {"ms": ms, "wall_ms": wall, "launches": launches}
        log(f"msm_naive of {n} points: {ms:.4f} ms on the card, wall {wall:.4f} ms, "
            f"launches {launches}")
    report["msm_naive"] = out

    with open(os.path.join(ROOT, "tests", "fixtures", "protocol_transcript_s4_m1.json")) as fh:
        fx = json.load(fh)
    fft = PianoFFTSettings(fx["scale"], fx["machines_scale"], "cuda")
    settings = generate_trusted_setup(fft, tuple(bytes.fromhex(h) for h in fx["secrets_hex"]))
    backend = PianoBackend(fft, settings, "cuda")        # no precompute: msm_naive
    rows = []
    for i, row in enumerate(fx["rows"]):
        rec = {}
        for label, call in (("commit", lambda: backend.worker_commit(i, row)),
                            ("open", lambda: backend.worker_open(i, row, fx["alpha"]))):
            launches, _ = launches_of(call)
            ms, _ = cuda_ms(call, 3)
            wall, _ = wall_ms(call, 3)
            rec[label] = {"ms": ms, "wall_ms": wall, "launches": launches}
            log(f"transcript row {i} worker_{label} without a table: {ms:.4f} ms on the card, "
                f"wall {wall:.4f} ms, launches {launches}")
        rows.append(rec)
    report["transcript_rows"] = rows


def worker_commits(report):
    """In-process worker_commit of one random row at T = 2^(SCALE-1): with
    a BGMW table of random points (c = 16) and without one (the tableless
    MSM, c = 13)."""
    import types

    import numpy as np
    import torch

    from fourier_tpu_torch.models.piano import PianoBackend, PianoPrecompute, PianoSettings
    from fourier_tpu_torch.ops import msm_fused as mf
    from fourier_tpu_torch.ops.curve import G1Aff

    gen = torch.Generator(device="cuda")
    gen.manual_seed(22)
    T = 1 << (SCALE - 1)
    c = mf.bgmw_auto_window(T)
    rows = -(-256 // c) * T
    no_inf = torch.zeros(rows, dtype=torch.bool, device="cuda")
    u = G1Aff(rand_fp(T, gen)[:, None], rand_fp(T, gen)[:, None], no_inf[None, :T])
    pre = PianoPrecompute(c=c, u_rows=[G1Aff(None, None, no_inf)])
    pre._packed[0] = mf.pack_points(G1Aff(rand_fp(rows, gen), rand_fp(rows, gen), no_inf))
    settings = PianoSettings(g=None, g_tau_x=None, g_tau_y=None, u=u, g2=None,
                             g2_tau_x=None, g2_tau_y=None, precompute=pre)
    fft = types.SimpleNamespace(T=T, M=1, device=torch.device("cuda"))
    backend = PianoBackend(fft, settings, "cuda")
    rng = np.random.default_rng(5)
    limbs = rng.integers(0, 1 << 16, size=(16, T), dtype=np.int64)
    limbs[15] = rng.integers(0, 0x73ED, size=T)
    out = {}
    for label, precompute in (("tabled", pre), ("tableless", None)):
        settings.precompute = precompute
        backend.worker_commit(0, limbs)
        ms, _ = cuda_ms(lambda: backend.worker_commit(0, limbs), 3)
        launches, _ = launches_of(lambda: backend.worker_commit(0, limbs))
        out[label] = {"ms": ms, "launches": launches}
        log(f"worker_commit in process, {label}, T = {T}: {ms:.4f} ms, launches {launches}")
    report["worker_commit"] = out


def setup_in_memory(report):
    """A scale-20 backend built in memory (SRS, fixed-base MSMs, BGMW
    tables): host wall after a synchronize, and its kernel launches."""
    import torch

    from fourier_tpu_torch.models.piano import PianoBackend, SetupConfig
    from fourier_tpu_torch.ops import kernels

    kernels.COUNTERS.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    backend = PianoBackend.setup(SetupConfig(scale=SCALE, machines_scale=1), "cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    report["setup_in_memory"] = {"s": seconds, "launches": dict(kernels.COUNTERS.launches)}
    log(f"setup in memory at scale {SCALE} / machines 1: {seconds:.3f} s, launches "
        f"{kernels.COUNTERS.launches}")
    del backend


# -- section 10 -----------------------------------------------------------------------

def quotient(report):
    import torch

    from fourier_tpu_torch.models import piano
    from fourier_tpu_torch.ops import kernels

    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    twin = getattr(kernels, "fr_quotient_plain", None)
    peak = int_peak()[0]
    out = {}
    for log_t, B in ((SCALE - 1, 1), (SCALE - 2, 4)):
        T = 1 << log_t
        roots = rand_fr(T, gen)
        f = rand_fr(T * B, gen).reshape(16, B, T) if B > 1 else rand_fr(T, gen)
        alpha, t_inv = rand_fr(1, gen), rand_fr(1, gen)

        def call():
            return piano._eval_form_open(roots, f, alpha, t_inv)

        launches, got = launches_of(call)
        wall, _ = wall_ms(call, 5)
        # the function's elements: the roots and f read, q written; its
        # products: the inversion's way up and down 4 a lane, the sum and q
        # one a lane and row
        bound_ms, bound_by = bound(FR_MADS_PER_PRODUCT * T * (4 + 2 * B),
                                   FR_BYTES * T * (1 + 2 * B), peak)
        row = {"T": T, "rows": B, "wall_ms": wall, "launches": launches,
               "bound_ms": bound_ms, "bound_by": bound_by}
        if twin is not None:
            row["device_ms"] = device_ms(call, 5)
            want = twin(roots, f, alpha, t_inv)
            row["equal_to_plain_twin"] = got[2] == want[2] and all(
                torch.equal(a, b) for a, b in zip(got[:2], want[:2]))
            row["plain_ms"], _ = wall_ms(lambda: twin(roots, f, alpha, t_inv), 2)
        out[f"2^{log_t}x{B}"] = row
        log(f"quotient at T = 2^{log_t} x {B} rows: wall {wall:.4f} ms, launches {launches}, "
            f"bound {bound_ms:.4f} ms ({bound_by}); {row}")
        del roots, f
    if twin is not None:
        small = [rand_fr(16, gen), rand_fr(16, gen), rand_fr(1, gen), rand_fr(1, gen)]
        out["one_block_T16"] = device_ms(lambda: kernels.fr_quotient(*small), 20)
        log(f"quotient at T = 16 (one block), device ms: {out['one_block_T16']}")
    report["quotient"] = out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT, help="directory holding fourier_tpu_torch/")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", help="also write the JSON report to this file")
    ap.add_argument("--setup", action="store_true",
                    help="time only the in-memory server setup (section 9)")
    ap.add_argument("--sass", action="store_true",
                    help="also time the Fp product and count its SASS (section 2)")
    ap.add_argument("--quotient", action="store_true",
                    help="time only the open's quotient (section 10)")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device is visible", file=sys.stderr)
        return 1
    from fourier_tpu_torch.ops import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"{card} (package from {tree})")
    report = {"label": args.label, "card": card}
    t0 = time.perf_counter()
    kernels.build()
    report["build_s"] = time.perf_counter() - t0
    build_dir = os.path.join(kernels.BUILD_DIR, "probe")
    os.makedirs(build_dir, exist_ok=True)
    if args.setup:
        setup_in_memory(report)
        return _write(report, args.out)
    if args.quotient:
        quotient(report)
        return _write(report, args.out)
    if args.sass:
        report["fp_mul"] = fp_mul(build_dir)
        report["ptxas"] = kernel_resources(build_dir)
    main_path(report)
    kernels_alone(report)
    msm_naive_calls(report)
    worker_commits(report)
    quotient(report)
    return _write(report, args.out)


def _write(report, out) -> int:
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as fh:
            json.dump(report, fh, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
