#!/usr/bin/env python3
"""Times the BGMW MSM with its table rows split over several cards
(fourier_tpu_torch/parallel/msm_fused_sharded.py) against the same MSM on
one card, one process a card over NCCL.

Run from the root of the repository, on a machine with at least two cards:

    python3 sharded_msm_probe.py                       # 4 cards, 2^19 points, c = 16
    python3 sharded_msm_probe.py --num-processes 2 --log-n 19 --c 16
    python3 sharded_msm_probe.py --device cpu --num-processes 2 --log-n 6 --c 8

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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num-processes", type=int, default=4)
    ap.add_argument("--log-n", type=int, default=19)
    ap.add_argument("--c", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
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
