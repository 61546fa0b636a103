#!/usr/bin/env python3
"""Times the BGMW MSM with its table rows split over several cards
(fourier_tpu_torch/parallel/msm_fused_sharded.py) against the same MSM on
one card: one process a card over NCCL, or, with ``--in-process``, the
shards of one process (parallel/mesh.py LocalMesh, as the multi-card
server runs them).

Run from the root of the repository, on a machine with at least two cards:

    python3 sharded_msm_probe.py                       # 4 cards, 2^19 points, c = 16
    python3 sharded_msm_probe.py --num-processes 2 --log-n 19 --c 16
    python3 sharded_msm_probe.py --device cpu --num-processes 2 --log-n 6 --c 8
    python3 sharded_msm_probe.py --in-process --c 16,13  # one card or more

``--in-process`` builds one table a window c on cuda:0 and places each
shard's rows on its card beforehand, as the server does; it times one
card, four shards of cuda:0, and the distinct cards cuda:0..1 and
cuda:0..N-1 where there are N >= 2, each result held against one card's.
``--profile DIR`` adds one profiled call of each (torch.profiler: the ops
by host and device time, the Chrome trace in DIR).

Every process builds the same random table (fixed seed) and scalars, times
``msm_fused_bgmw`` on its own card, then ``msm_fused_bgmw_sharded`` over
the first 2 ranks and over all of them: each timed call after a warm one,
every rank starting each call together (a barrier), the host clock around
the call and a synchronize, median and min-max of 5.  Each sharded result
must equal the one-card MSM on every rank, or the run fails.  Rank 0
prints the card's name and power limit (nvidia-smi).  ``--device cpu``
runs the same over gloo: a check, not a measurement.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import time

import numpy as np
import torch
import torch.multiprocessing as mp


def _log(rank, msg):
    print(f"[sharded_msm_probe p{rank}] {msg}", flush=True)


def _worker(rank, coordinator, n_processes, log_n, c, device):
    from fourier_tpu_torch.ops import curve as cv
    from fourier_tpu_torch.ops import msm as msm_mod
    from fourier_tpu_torch.ops import msm_fused as mf
    from fourier_tpu_torch.ops.curve import G1Jac
    from fourier_tpu_torch.ops.limbs import ints_to_vec
    from fourier_tpu_torch.parallel.mesh import make_mesh
    from fourier_tpu_torch.parallel.msm_fused_sharded import msm_fused_bgmw_sharded
    from fourier_tpu_torch.parallel.multihost import coordination_barrier, initialize
    from fourier_tpu_torch.refimpl.curve import G1_GEN

    torch.set_num_threads(1)
    dev = initialize(coordinator, n_processes, rank, device)
    n = 1 << log_n
    rng = np.random.default_rng(11)
    sc = [int.from_bytes(rng.bytes(32), "big") >> 3 for _ in range(2 * n)]
    base = cv.to_affine_batched(msm_mod.fixed_base_msm(
        G1_GEN, torch.as_tensor(ints_to_vec(sc[:n], 16).astype(np.int64), device=dev)))
    table = msm_mod.bgmw_expand(base, c)
    packed = mf.pack_points(table)
    scalars = torch.as_tensor(ints_to_vec(sc[n:], 16).astype(np.int64), device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(fn, reps=5):
        """fn's result and the median, min and max ms of reps calls after a
        warm one."""
        out, ms = fn(), []
        for _ in range(reps):
            sync()
            coordination_barrier("timed-call")
            t0 = time.perf_counter()
            out = fn()
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        ms.sort()
        return out, f"{ms[len(ms) // 2]:.3f} ms ({ms[0]:.3f}-{ms[-1]:.3f})"

    def point(p):
        return cv.jac_to_int_points(G1Jac(*(t[..., None] for t in p)))[0]

    want, one = timed(lambda: mf.msm_fused_bgmw(packed, table.inf, scalars, c))
    want = point(want)
    _log(rank, f"msm_fused_bgmw at 2^{log_n} points, c = {c}, one device: {one}")
    for D in sorted({2, n_processes}):
        group = make_mesh(D)
        if group.rank < 0:                      # not in the subgroup: meet timed()'s barriers
            for _ in range(5):
                coordination_barrier("timed-call")
            continue
        got, ms = timed(lambda: msm_fused_bgmw_sharded(packed, table.inf, scalars, c, group))
        if point(got) != want:
            raise AssertionError(f"the MSM over {D} ranks differs from one device's")
        _log(rank, f"msm_fused_bgmw_sharded over {D} ranks equals one device's: {ms} "
                   f"(one device {one}), median (min-max) of 5 after a warm call")
    coordination_barrier("done")
    torch.distributed.destroy_process_group()


def _profile(label, fn, out_dir):
    """fn() once under torch.profiler (a warm call before): the ops by
    host and by device time, and the trace as Chrome JSON in out_dir."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)
    table = prof.key_averages()
    print(f"[profile {label}] by host time:\n"
          f"{table.table(sort_by='self_cpu_time_total', row_limit=15)}", flush=True)
    print(f"[profile {label}] by device time:\n"
          f"{table.table(sort_by='self_cuda_time_total', row_limit=12)}", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, f"{label}.json"))


def _in_process(log_n, windows, profile_dir=None):
    """One card against LocalMesh shards, for each table window; with
    profile_dir, each also once under torch.profiler."""
    from fourier_tpu_torch.models.piano import PianoPrecompute
    from fourier_tpu_torch.ops import curve as cv
    from fourier_tpu_torch.ops import msm as msm_mod
    from fourier_tpu_torch.ops import msm_fused as mf
    from fourier_tpu_torch.ops.curve import G1Jac
    from fourier_tpu_torch.ops.limbs import ints_to_vec
    from fourier_tpu_torch.parallel.mesh import LocalMesh
    from fourier_tpu_torch.parallel.msm_fused_sharded import msm_fused_bgmw_local
    from fourier_tpu_torch.refimpl.curve import G1_GEN

    dev = torch.device("cuda:0")
    n = 1 << log_n
    rng = np.random.default_rng(11)
    sc = [int.from_bytes(rng.bytes(32), "big") >> 3 for _ in range(2 * n)]
    base = cv.to_affine_batched(msm_mod.fixed_base_msm(
        G1_GEN, torch.as_tensor(ints_to_vec(sc[:n], 16).astype(np.int64), device=dev)))
    scalars = torch.as_tensor(ints_to_vec(sc[n:], 16).astype(np.int64), device=dev)
    n_cards = torch.cuda.device_count()
    meshes = [["cuda:0"] * 4] + [[f"cuda:{i}" for i in range(D)]
                                 for D in (sorted({2, n_cards}) if n_cards >= 2 else ())]

    def timed(fn, reps=5):
        out, ms = fn(), []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            for d in range(n_cards):
                torch.cuda.synchronize(d)
            ms.append((time.perf_counter() - t0) * 1e3)
        ms.sort()
        return out, f"{ms[len(ms) // 2]:.3f} ms ({ms[0]:.3f}-{ms[-1]:.3f})"

    def point(p):
        return cv.jac_to_int_points(G1Jac(*(t[..., None] for t in p)))[0]

    for c in windows:
        pc = PianoPrecompute(c=c, u_rows=[msm_mod.bgmw_expand(base, c)])
        table = pc.u_rows[0]
        want, one = timed(lambda: mf.msm_fused_bgmw(pc.packed_row(0), table.inf, scalars, c))
        want = point(want)
        print(f"[in-process] c = {c}: one card {one}", flush=True)
        if profile_dir is not None:
            _profile(f"c{c}_one_card", lambda: mf.msm_fused_bgmw(pc.packed_row(0), table.inf,
                                                                 scalars, c), profile_dir)
        for devices in meshes:
            mesh = LocalMesh(devices)
            rows = pc.shard_rows(0, mesh.devices)
            got, ms = timed(lambda: msm_fused_bgmw_local(mesh, rows, scalars, c))
            if point(got) != want:
                raise AssertionError(f"the MSM over {devices} differs from one card's")
            if profile_dir is not None:
                _profile(f"c{c}_{len(devices)}_shards_{len(set(devices))}_cards",
                         lambda: msm_fused_bgmw_local(mesh, rows, scalars, c), profile_dir)
            print(f"[in-process] c = {c}: {len(devices)} shards on {','.join(devices)} equal "
                  f"one card's: {ms} (one card {one}), median (min-max) of 5 after a warm "
                  f"call", flush=True)
            del rows
            pc._packed.clear()
        del pc, table
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num-processes", type=int, default=4)
    ap.add_argument("--log-n", type=int, default=19)
    ap.add_argument("--c", default=None,
                    help="table window (default 16); --in-process takes a comma list "
                         "(default 16,13)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--in-process", action="store_true",
                    help="the shards of one process (LocalMesh) instead of one process a card")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="with --in-process: each MSM once more under torch.profiler, its "
                         "ops printed and its trace written to DIR")
    args = ap.parse_args()
    if args.in_process:
        if not torch.cuda.is_available():
            raise SystemExit("--in-process needs a card")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip(), flush=True)
        _in_process(args.log_n, [int(c) for c in (args.c or "16,13").split(",")],
                    args.profile)
        print("sharded_msm_probe: OK", flush=True)
        return
    args.c = int(args.c or 16)
    if args.device == "cuda":
        if torch.cuda.device_count() < args.num_processes:
            raise SystemExit(f"{args.num_processes} processes need {args.num_processes} "
                             f"cards, {torch.cuda.device_count()} are visible")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip(), flush=True)
        from fourier_tpu_torch.ops import kernels

        kernels.build()                         # once, before the processes load it
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{s.getsockname()[1]}"
    # a process that raises stops the others, and this raises with its traceback
    mp.start_processes(_worker, (coordinator, args.num_processes, args.log_n, args.c,
                                 args.device), nprocs=args.num_processes,
                       start_method="spawn")
    print("sharded_msm_probe: OK", flush=True)


if __name__ == "__main__":
    main()
