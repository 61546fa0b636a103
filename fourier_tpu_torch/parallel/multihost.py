"""Several processes, one card each (or CPU processes), running the round
as one group.

Port of ``fourier_tpu.parallel.multihost``.  The reference joins hosts
into one ``jax.distributed`` cluster and runs the round as one SPMD
program over a global mesh; here each process joins one
``torch.distributed`` group over TCP (NCCL for cards, rank r on cuda:r;
gloo on the CPU), holds its share of the workers, and the master step's
gathers are collectives of that group.

    from fourier_tpu_torch.parallel import multihost
    multihost.initialize("10.0.0.1:29500", num_processes, process_id, "cuda")
    out = multihost.run_prove(backend, rows, alpha, beta)

Every process passes the whole logical inputs and keeps its own rows.

``python -m fourier_tpu_torch.parallel.multihost --dryrun ...`` runs N
local processes through the round (``spawn_dryrun``); with
``--coordinator`` and ``--process-id`` it is one of them.
"""

from __future__ import annotations

import argparse
import datetime
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Group, make_mesh

# A collective that waits longer than this fails the run (a rank that died
# leaves the others waiting in a collective).
COLLECTIVE_TIMEOUT_S = 600.0


def initialize(coordinator: str, num_processes: int, process_id: int,
               device: str = "cuda") -> torch.device:
    """Join the process group at coordinator (host:port), once a process:
    NCCL on cards, rank r taking cuda:r; gloo on the CPU.  Returns the
    device this rank computes on."""
    dev = torch.device("cpu") if device == "cpu" else torch.device("cuda", process_id)
    if dev.type == "cuda":
        if process_id >= torch.cuda.device_count():
            raise RuntimeError(f"rank {process_id} needs cuda:{process_id}, and "
                               f"{torch.cuda.device_count()} cards are visible")
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo", init_method=f"tcp://{coordinator}",
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S),
            **({"device_id": dev} if dev.type == "cuda" else {}))
    return dev


# the reference's global_mesh: the group of every process, None where there is one
global_group = make_mesh


def coordination_barrier(name: str, timeout_s: float = 600.0) -> bool:
    """Block until every process reaches the barrier `name`: a monitored
    barrier (which names the ranks that did not arrive) on gloo, a barrier
    on NCCL.  A barrier that fails raises with its name.  False where
    torch.distributed is not initialised."""
    if not dist.is_initialized():
        return False
    try:
        if dist.get_backend() == "gloo":
            dist.monitored_barrier(timeout=datetime.timedelta(seconds=timeout_s))
        else:
            dist.barrier()
    except RuntimeError as e:
        raise RuntimeError(f"coordination barrier {name!r} failed: {e}") from e
    return True


def run_prove(backend, rows, alpha: int, beta: int, group: Group | None = None):
    """The round over the group (tableless, as the reference's): every
    process passes the whole rows and keeps its share.  Returns
    prove_sharded's dict, equal on every rank."""
    from .prove_sharded import build_distributed_prove, local_inputs, prove_inputs_from_backend

    group = make_mesh() if group is None else group
    args = prove_inputs_from_backend(backend, rows, alpha, beta)
    return build_distributed_prove(group)(*local_inputs(args, group))


# ---------------------------------------------------------------------------
# The dryrun: N local processes
# ---------------------------------------------------------------------------

def _log(process_id, msg):
    print(f"[multihost dryrun p{process_id}] {msg}", flush=True)


def _dryrun_worker(coordinator: str, num_processes: int, process_id: int,
                   scale: int, machines_scale: int, device: str) -> None:
    """One process: join the group, run the round, hold its master outputs
    against this backend's per-request round (its precompute tables) and
    verify the aggregate proof."""
    from ..constants import FR_LIMBS, R
    from ..models.piano import (PianoBackend, PianoFFTSettings, PianoPrecompute,
                                generate_trusted_setup)
    from ..ops import curve as cv
    from ..ops.limbs import vec_to_int

    torch.set_num_threads(1)
    _log(process_id, f"joining the group at {coordinator}")
    dev = initialize(coordinator, num_processes, process_id, device)
    _log(process_id, f"joined: {dist.get_world_size()} processes, {dist.get_backend()} on {dev}")

    # the same backend on every process (fixed secrets)
    t0 = time.perf_counter()
    fft = PianoFFTSettings(scale, machines_scale, dev)
    settings = generate_trusted_setup(fft, (b"\x2a" * 32, b"\x2b" * 32))
    settings.precompute = PianoPrecompute.generate(settings)
    backend = PianoBackend(fft, settings)
    rng = np.random.default_rng(7)
    # rows of values below 2^62, as [FR_LIMBS, T] limbs (no host conversion
    # of T Python ints a row inside the timed round)
    vals = rng.integers(0, 1 << 62, size=(fft.M, 1, fft.T), dtype=np.int64)
    rows = list(np.concatenate([(vals >> (16 * np.arange(4)[:, None])) & 0xFFFF,
                                np.zeros((fft.M, FR_LIMBS - 4, fft.T), np.int64)], axis=1))
    alpha = int(rng.integers(1, 1 << 62))
    beta = int(rng.integers(1, 1 << 62))
    _log(process_id, f"backend ready in {time.perf_counter() - t0:.3f} s; starting the round")

    t0 = time.perf_counter()
    out = run_prove(backend, rows, alpha, beta)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    _log(process_id, f"round done in {time.perf_counter() - t0:.3f} s")

    def pt(p):
        return cv.jac_to_int_points(p)[0]

    master_com, pi0, pi1 = pt(out["master_com"]), pt(out["pi0"]), pt(out["pi1"])
    z = vec_to_int(out["z"].cpu().numpy())
    commits, evals, proofs = [], [], []
    for i in range(fft.M):
        commits.append(backend.worker_commit(i, rows[i]))
        y, pi = backend.worker_open(i, rows[i], alpha)
        evals.append(y)
        proofs.append(pi)
    if cv.jac_to_int_points(out["commits"]) != commits:
        raise AssertionError("commits differ from the per-request round")
    if master_com != backend.master_commit(commits):
        raise AssertionError("master_com differs from the per-request round")
    z_ref, (pi0_ref, pi1_ref) = backend.master_open(evals, proofs, beta)
    if (z, pi0, pi1) != (z_ref, pi0_ref, pi1_ref):
        raise AssertionError("z, pi0 or pi1 differs from the per-request round")
    if not backend.master_verify(master_com, beta, alpha, z, (pi0, pi1)):
        raise AssertionError("the aggregate proof does not verify")
    if backend.master_verify(master_com, beta, alpha, (z + 1) % R, (pi0, pi1)):
        raise AssertionError("a wrong z verifies")
    _log(process_id, "equal to the per-request round; the aggregate proof verifies")
    coordination_barrier("dryrun-done")
    dist.destroy_process_group()
    print(f"[multihost dryrun] process {process_id}/{num_processes}: OK", flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_dryrun(n_processes: int = 2, scale: int = 5, machines_scale: int = 2,
                 device: str = "cuda", timeout: float = 900.0) -> None:
    """Start n local processes of the dryrun and wait for all of them.  A
    process that fails stops the others, and this raises with every
    process's tail; so does the timeout.  device="cuda" needs a card a
    process; device="cpu" runs them over gloo."""
    if device == "cuda":
        if torch.cuda.device_count() < n_processes:
            raise RuntimeError(f"{n_processes} processes need {n_processes} cards, "
                               f"{torch.cuda.device_count()} are visible")
        from ..ops import kernels

        kernels.build()                         # once, before the processes load it
    coordinator = f"127.0.0.1:{_free_port()}"
    procs, logs = [], []
    try:
        for pid in range(n_processes):
            log = tempfile.TemporaryFile(mode="w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "fourier_tpu_torch.parallel.multihost", "--dryrun",
                 "--coordinator", coordinator, "--num-processes", str(n_processes),
                 "--process-id", str(pid), "--device", device,
                 "--scale", str(scale), "--machines-scale", str(machines_scale)],
                stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    failures, tails = [], []
    for pid, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        if p.returncode != 0:
            failures.append((pid, p.returncode))
        tails.append(f"--- process {pid} (rc={p.returncode}) tail ---\n"
                     + "\n".join(text.splitlines()[-40:]))
    if failures:
        raise RuntimeError(f"multihost dryrun failed: {failures}\n" + "\n".join(tails))
    print("\n".join(tails), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="fourier_tpu_torch.parallel.multihost")
    ap.add_argument("--dryrun", action="store_true", required=True)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--coordinator", help="host:port; with --process-id, run one process")
    ap.add_argument("--process-id", type=int)
    ap.add_argument("--scale", type=int, default=5)
    ap.add_argument("--machines-scale", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args(argv)
    if args.process_id is None:
        spawn_dryrun(args.num_processes, args.scale, args.machines_scale, args.device,
                     args.timeout)
    else:
        _dryrun_worker(args.coordinator, args.num_processes, args.process_id, args.scale,
                       args.machines_scale, args.device)


if __name__ == "__main__":
    main()
