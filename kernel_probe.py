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
2. with --sass, the Fp Montgomery product (csrc/fp_mul_bench.cu):
   registers (ptxas), instructions of one product by opcode (cuobjdump
   -sass of a one-product kernel), the rate of dependent chains over 2^20
   lanes and the latency of one product in a single warp's chain (CUDA
   events); then ptxas's registers, stack and spills for each kernel of
   the library;
3. K1 (accumulate) at the main path's shape: 2^23 table rows (16 windows x
   2^19 points, c = 16, unsigned digits) into 65,536 + 1,024 slots, kernel
   mean of 3 launches after a warm one;
4. the reduction of those buckets: `_weighted_sums_factored` (the rows,
   columns, bit and spare trees) and `fold_small` after the K4 Horner,
   without K4: CUDA events around the calls (host time between launches
   included) and host wall (after a synchronize), mean of 5 runs each,
   and the launches of each kernel;
5. the whole BGMW MSM (digits to one point) at that shape: CUDA events and
   host wall, mean of 3, and its launches;
6. with --setup, only the in-memory server setup at scale 20 / machines 1
   (host wall after a synchronize, and its launches), instead of 2-5.

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

ROOT = os.path.dirname(os.path.abspath(__file__))
SCALE = 20


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


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
    lib = ctypes.CDLL(so)
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.fk_bench_chain.argtypes = [vp, vp, ci, i64, vp]
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
    rec = {"registers": regs, "sass_total": sum(ops.values()),
           "sass_imad": sum(c for op, c in ops.items() if op.startswith("IMAD")),
           "sass_imad_wide": sum(c for op, c in ops.items() if op.startswith("IMAD.WIDE")),
           "sass_imad_mov": sum(c for op, c in ops.items() if op.startswith("IMAD.MOV")),
           "sass_iadd3": sum(c for op, c in ops.items() if op.startswith("IADD3")),
           "opcodes": dict(sorted(ops.items(), key=lambda kv: -kv[1])[:12]),
           "chain_ms": ms, "products_per_s": n * iters / (ms * 1e-3),
           "latency_us": one_warp_ms * 1e3 / 256}
    log(f"fp_mul: {rec['sass_imad']} IMAD-class ({rec['sass_imad_wide']} wide, "
        f"{rec['sass_imad_mov']} moves), {rec['sass_iadd3']} IADD3, {rec['sass_total']} "
        f"SASS instructions in a one-product kernel; registers {regs}; "
        f"{n} lanes x {iters} dependent products {ms:.4f} ms = "
        f"{rec['products_per_s']:.4e} products/s; one warp: {rec['latency_us']:.4f} us a "
        f"dependent product")
    return rec


def kernel_resources(build_dir):
    """ptxas's registers, stack and spills for every kernel of the library."""
    from fourier_tpu_torch.ops import kernels

    nvcc = kernels._nvcc()
    srcs = [name for name in kernels._SOURCES if name != "errors.cu"]
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

    from fourier_tpu_torch.ops import curve as cv
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

    # the reduction around K4, without K4
    Bpow = 1 << (c - 1) if neg is not None else 1 << c
    terms_launches, terms = launches_of(lambda: mf._weighted_sums_factored(buckets, weights,
                                                                           c, Bpow))
    sums_ms, _ = cuda_ms(lambda: mf._weighted_sums_factored(buckets, weights, c, Bpow), 5)
    sums_wall, _ = wall_ms(lambda: mf._weighted_sums_factored(buckets, weights, c, Bpow), 5)
    L, K, R = terms.x.shape
    res = kernels.horner_2k(G1Jac(*(t.reshape(L, K * R) for t in terms)), width=R)
    fold_launches, _ = launches_of(lambda: cv.fold_small(res))
    fold_ms, _ = cuda_ms(lambda: cv.fold_small(res), 5)
    fold_wall, _ = wall_ms(lambda: cv.fold_small(res), 5)
    red = {"weighted_sums_ms": sums_ms, "weighted_sums_wall_ms": sums_wall,
           "weighted_sums_launches": terms_launches, "fold_ms": fold_ms,
           "fold_wall_ms": fold_wall, "fold_launches": fold_launches,
           "total_ms": sums_ms + fold_ms, "total_wall_ms": sums_wall + fold_wall,
           "terms_shape": [K, R]}
    report["reduction"] = red
    log(f"reduction of {buckets.x.shape[-1]} buckets (c = {c}): weighted sums "
        f"{sums_ms:.4f} ms (wall {sums_wall:.4f} ms, launches {terms_launches}), fold "
        f"{fold_ms:.4f} ms (wall {fold_wall:.4f} ms, launches {fold_launches}); total "
        f"{sums_ms + fold_ms:.4f} ms on the card, {sums_wall + fold_wall:.4f} ms wall")
    del buckets, terms, res

    # the whole MSM
    table = mf.pack_points(G1Aff(rand_fp(rows, gen), rand_fp(rows, gen), inf))
    msm_launches, _ = launches_of(lambda: mf.msm_fused_bgmw(table, inf, scalars, c))
    msm_ms, _ = cuda_ms(lambda: mf.msm_fused_bgmw(table, inf, scalars, c), 3)
    msm_wall, _ = wall_ms(lambda: mf.msm_fused_bgmw(table, inf, scalars, c), 3)
    report["msm"] = {"ms": msm_ms, "wall_ms": msm_wall, "launches": msm_launches,
                     "points_per_s": T / (msm_wall * 1e-3)}
    log(f"BGMW MSM of {T} points (c = {c}): {msm_ms:.4f} ms on the card, wall "
        f"{msm_wall:.4f} ms, launches {msm_launches}")


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT, help="directory holding fourier_tpu_torch/")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", help="also write the JSON report to this file")
    ap.add_argument("--setup", action="store_true",
                    help="time only the in-memory server setup (section 6)")
    ap.add_argument("--sass", action="store_true",
                    help="also time the Fp product and count its SASS (section 2)")
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
    if args.sass:
        report["fp_mul"] = fp_mul(build_dir)
        report["ptxas"] = kernel_resources(build_dir)
    main_path(report)
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
