#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (fourier_tpu_torch) on one NVIDIA card.

Run from the root of the repository:

    python3 chip_smoke.py            # the full run, scale 20 / machines 1

It takes no arguments: the main path always runs at SCALE.

Phases, in order; any failure exits non-zero and prints no result line:

0. The card's name and power limit (nvidia-smi); build the CUDA kernels.
1. Each kernel against its plain PyTorch twin on the card, bit for bit:
   small batches of adversarial lanes (same point, inverse pair, identity
   on either side, widths that are no multiple of a block), then the
   shapes the scale-20 main path gives it, timed (kernel and plain).
2. The pinned protocol transcript (tests/fixtures) reproduced on the card.
3. worker_commit at T = 2^12 (signed digits, c = 11) against the host C++
   MSM of fourier_tpu.native on the same row.
4. The main path: `python -m fourier_tpu_torch run --scale 20
   --machines-scale 1` in a subprocess, driven over HTTP through the
   whole worker and master flow; both worker proofs and the master proof
   must verify and a repeated commitment must come back identical.  The
   kernel launches are the server's own counts of that run.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import random
import socket
import subprocess
import sys
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "protocol_transcript_s4_m1.json")
# the reference's default deployment (fourier_tpu/models/piano.py SetupConfig):
# T = 2^19 coefficients per worker, M = 2 workers
SCALE = 20

KERNEL_INFO = {
    "accumulate": ("fourier_tpu_torch/csrc/accumulate.cu", "fourier_tpu/ops/msm_fused.py:165"),
    "g1_add": ("fourier_tpu_torch/csrc/g1_add.cu", "fourier_tpu/ops/pallas_curve.py:470"),
    "g1_dbl": ("fourier_tpu_torch/csrc/g1_dbl.cu", "fourier_tpu/ops/pallas_curve.py:224"),
    "horner_2k": ("fourier_tpu_torch/csrc/horner_2k.cu", "fourier_tpu/ops/pallas_curve.py:255"),
}


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
    t0 = time.perf_counter()
    kernels.build()
    log(f"phase 0: kernels built in {time.perf_counter() - t0:.3f} s")
    return card


# -- phase 1 ------------------------------------------------------------------------

def _adversarial(device):
    """Kernel vs plain twin on small batches with the lanes that break
    incomplete formulas; every comparison is exact."""
    import torch

    from fourier_tpu.constants import R
    from fourier_tpu.refimpl.curve import G1_GEN, g1_add, g1_mul, g1_neg
    from fourier_tpu_torch.ops import curve as cv
    from fourier_tpu_torch.ops import kernels
    from fourier_tpu_torch.ops.msm_fused import pack_points

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

    got = kernels.g1_dbl(p, repeat=3)
    plain = kernels.g1_dbl_plain(to_dev(p, "cpu"), 3)
    check(max_abs_err(to_dev(got, "cpu"), plain) == 0, "g1_dbl differs from its twin")

    # K1: runs over a 64-row table with identities, negations, a repeated
    # row (doubling), a row and its negation (identity mid-run), empty runs
    table_pts = [rng.choice(base) for _ in range(64)]
    table_pts[3] = None
    table = to_dev(cv.affine_from_ints(table_pts), device)
    entries, start, count = [], [], []
    for s in range(n):
        k = rng.randrange(0, 7)
        run = [(rng.randrange(64) << 2) | (rng.randrange(2) << 1) for _ in range(k)]
        if s == 20:
            run = [5 << 2, 5 << 2, 7 << 2]
        if s == 21:
            run = [5 << 2, (5 << 2) | 2, 9 << 2]
        if s == 22:
            run = [(3 << 2) | 1, 6 << 2]
        start.append(len(entries))
        count.append(len(run))
        entries += [e | int(table_pts[e >> 2] is None) for e in run]
    i32 = dict(dtype=torch.int32, device=device)
    index = torch.tensor(entries, **i32)
    start, count = torch.tensor(start, **i32), torch.tensor(count, **i32)
    packed = pack_points(table)
    got = kernels.accumulate(packed, index, start, count)
    plain = kernels.accumulate_plain(packed.cpu(), index.cpu(), start.cpu(), count.cpu())
    check(max_abs_err(to_dev(got, "cpu"), plain) == 0, "accumulate differs from its twin")

    # K4 over K = 6 terms of 37 lanes with identity lanes inside
    K, width = 6, 37
    pts = [rng.choice(base) for _ in range(K * width)]
    pts[width + 3] = None
    pts[5 * width + 1] = None
    terms = to_dev(cv.from_affine(cv.affine_from_ints(pts)), device)
    got = kernels.horner_2k(terms, width)
    plain = kernels.horner_2k_plain(to_dev(terms, "cpu"), width)
    check(max_abs_err(to_dev(got, "cpu"), plain) == 0, "horner_2k differs from its twin")


def _main_path_shapes(device):
    """Kernel vs plain twin, exact and timed, at the shapes the main path
    gives each kernel: T = 2^(SCALE-1) points per row, c = the table's
    window (16 at scale 20)."""
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
    index, start, count, _ = mf.bucket_runs(inf, digits, c, neg)
    kernels.accumulate(table, index, start, count)
    ms, got = cuda_ms(lambda: kernels.accumulate(table, index, start, count), 3)
    plain_ms, plain = cuda_ms(lambda: kernels.accumulate_plain(table, index, start, count), 1)
    results["accumulate"] = (max_abs_err(got, plain), ms, plain_ms,
                             f"{rows} rows -> {start.shape[0]} slots")
    del table, index, start, count, got, plain

    # K2: the widest level of the bucket-reduction trees
    n = 1 << (c - 1)
    p = G1Jac(*(rand_fp(n, gen, device) for _ in range(3)))
    q = G1Jac(*(rand_fp(n, gen, device) for _ in range(3)))
    kernels.g1_add(p, q)
    ms, got = cuda_ms(lambda: kernels.g1_add(p, q), 20)
    plain_ms, plain = cuda_ms(lambda: kernels.g1_add_plain(p, q), 1)
    results["g1_add"] = (max_abs_err(got, plain), ms, plain_ms, f"{n} lanes")

    # K3: c doublings of a whole row between two table windows
    p = G1Jac(*(rand_fp(T, gen, device) for _ in range(3)))
    kernels.g1_dbl(p, c)
    ms, got = cuda_ms(lambda: kernels.g1_dbl(p, c), 5)
    plain_ms, plain = cuda_ms(lambda: kernels.g1_dbl_plain(p, c), 1)
    results["g1_dbl"] = (max_abs_err(got, plain), ms, plain_ms, f"{T} lanes x {c}")

    # K4: the Horner combine, K = c terms of 64 residual lanes
    terms = G1Jac(*(rand_fp(c * 64, gen, device) for _ in range(3)))
    kernels.horner_2k(terms, 64)
    ms, got = cuda_ms(lambda: kernels.horner_2k(terms, 64), 20)
    plain_ms, plain = cuda_ms(lambda: kernels.horner_2k_plain(terms, 64), 1)
    results["horner_2k"] = (max_abs_err(got, plain), ms, plain_ms, f"K={c} x 64 lanes")
    return results


def phase1_kernels(device):
    from fourier_tpu_torch.ops import kernels

    _adversarial(device)
    log(f"phase 1: adversarial lanes exact; launches {kernels.COUNTERS.launches}, "
        f"doubling-branch lanes {kernels.COUNTERS.collisions()}")
    results = _main_path_shapes(device)
    for name, (err, ms, plain_ms, shape) in results.items():
        log(f"phase 1: {name} at {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"max_abs_err {err}")
        check(err == 0, f"{name} differs from its plain twin at main-path shapes")
    return results


# -- phases 2 and 3 -------------------------------------------------------------------

def phase2_transcript(device):
    from fourier_tpu.refimpl.curve import g1_to_bytes
    from fourier_tpu.refimpl.field import fr_to_bytes
    from fourier_tpu.runtime import wire
    from fourier_tpu_torch.models.piano import (PianoBackend, PianoFFTSettings,
                                                PianoPrecompute, generate_trusted_setup)

    with open(FIXTURE) as fh:
        fx = json.load(fh)
    t0 = time.perf_counter()
    fft = PianoFFTSettings(fx["scale"], fx["machines_scale"], device)
    settings = generate_trusted_setup(fft, tuple(bytes.fromhex(h) for h in fx["secrets_hex"]))
    settings.precompute = PianoPrecompute.generate(settings)
    b = PianoBackend(fft, settings, device)

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
    from fourier_tpu import native
    from fourier_tpu.constants import R
    from fourier_tpu_torch.models.piano import (PianoBackend, PianoFFTSettings,
                                                PianoPrecompute, generate_trusted_setup)
    from fourier_tpu_torch.ops import curve as cv

    t0 = time.perf_counter()
    fft = PianoFFTSettings(12, 0, device)
    settings = generate_trusted_setup(fft, (b"\x07" * 32, b"\x08" * 32))
    settings.precompute = PianoPrecompute.generate(settings)
    check(settings.precompute.c == 11, f"window {settings.precompute.c} at T=2^12, expected 11")
    b = PianoBackend(fft, settings, device)
    rng = random.Random(12)
    row = [rng.randrange(R) for _ in range(fft.T)]
    got = b.worker_commit(0, row)
    points = cv.jac_to_int_points(cv.from_affine(settings.u_row(0)))
    want = native.g1_msm(points, row)
    check(want is not False, "fourier_tpu.native did not build: no host C++ MSM to hold "
                             "the commit against")
    check(got == want, "worker_commit at T=2^12 differs from fourier_tpu.native.g1_msm")
    log(f"phase 3: worker_commit at T=2^12 (c=11, signed digits) equals "
        f"fourier_tpu.native.g1_msm ({time.perf_counter() - t0:.3f} s)")


# -- phase 4 ------------------------------------------------------------------------

class ServerProcess:
    """`python -m fourier_tpu_torch run` with its log lines collected."""

    def __init__(self, port, device="cuda"):
        self.lines = []
        self.launches = []
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "fourier_tpu_torch", "run", "--scale", str(SCALE),
             "--machines-scale", "1", "--host", "127.0.0.1", "--port", str(port),
             "--device", device],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
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


def phase4_main_path(card, device="cuda"):
    from fourier_tpu.runtime import wire

    port = _free_port()
    url = f"http://127.0.0.1:{port}/"
    t0 = time.perf_counter()
    server = ServerProcess(port, device)
    timings = []

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
        log(f"phase 4: {method} {dt * 1000:.3f} ms" +
            (f" launches {launches}" if launches is not None else ""))
        return out, launches

    try:
        server.wait_for(lambda: any(ln.endswith("Serving") for ln in server.lines), 1000,
                        "the server to finish setup")
        boot = time.perf_counter() - t0
        setup_line = next(ln for ln in server.lines if "setup took" in ln)
        log(f"phase 4: server serving after {boot:.3f} s (process start, setup, kernel "
            f"build, warm-up commit); {setup_line.split('INFO fourier_tpu: ')[-1]}; {card}")
        rpc("ping")
        poly = rpc("randomPoly")[0]["poly"]
        alpha = rpc("randomPoint")[0]["point"]
        beta = rpc("randomPoint")[0]["point"]
        coms, evals, proofs, rows = [], [], [], []
        for i, f in enumerate(poly):
            row = rpc("fft", {"poly": f, "left": True, "inverse": True}, True)[0]["poly"]
            rows.append(row)
            out, launches = rpc("workerCommit", {"i": i, "poly": row}, True)
            for k in ("accumulate", "g1_add", "horner_2k"):
                check(launches[k] > 0, f"workerCommit ran no {k} kernel")
            com = out["commitment"]
            opened = rpc("workerOpen", {"i": i, "poly": row, "x": alpha}, True)[0]
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
    finally:
        server.stop()
    totals = dict.fromkeys(KERNEL_INFO, 0)
    for rec in server.launches:
        for k, v in rec["launches"].items():
            totals[k] += v
    log(f"phase 4: main path at scale {SCALE} / machines 1 served and verified; "
        f"kernel launches {totals}")
    for k, v in totals.items():
        check(v > 0, f"the main path launched no {k} kernel")
    return totals


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
    try:
        card = phase0_card_and_build()
        results = phase1_kernels("cuda")
        phase2_transcript("cuda")
        phase3_oracle("cuda")
        torch.cuda.empty_cache()
        launches = phase4_main_path(card)
        check("jax" not in sys.modules, "the port imported jax")
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], "max_abs_err": results[name][0],
                "ms": results[name][1], "plain_ms": results[name][2]}
               for name, (src, rep) in KERNEL_INFO.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
