"""The in-process shards of parallel/mesh.py (LocalMesh) on the CPU: the
sharded MSMs, the point-split msm_sharded and the round as one call over
2 and 4 "cpu" shards of one process, as a multi-card server runs them.

- msm_fused_bgmw_sharded and msm_bgmw_sharded at the cases of
  tests/test_torch_parallel.py: n = 16, c = 8 (unsigned digits, W = 32;
  and all-equal scalars), n = 8, c = 11 (signed, W = 24) and n = 16, c = 9
  (signed, W = 29: shard edges inside a window);
- msm_sharded with 2 shards of more than 64 points (the windowed MSM of
  msm_fused_sharded's point split) and 4 of at most 64 (msm_naive); the
  tableless msm_fused_sharded itself runs over 2 shards in a server's
  tableless branch (tests/test_torch_sweep_sharded.py): a shard's
  tableless MSM costs ~8 s of plain twins on the CPU (K4's alone ~4 s),
  and the shards of one CPU take turns;
- every shard's result must equal refimpl's g1_msm and the one-device
  MSM.  Comparisons are exact: the arithmetic is integer.
- 3 shards, which do not divide the bucket space, raise ValueError in
  every shard; a shard that raises fails the call at once, and one that
  never reaches a collective fails it after the barrier's timeout.
- the round as one call (parallel/prove_sharded.py) over the shards at
  scale 4 / machines_scale 2 equals the backend's per-request round.
- the launch counters stay exact under threads.
"""

import functools
import random
import sys
import threading
import time

import pytest
import torch

from fourier_tpu_torch.constants import R
from fourier_tpu_torch.convert import prove_outputs_to_ints
from fourier_tpu_torch.models.piano import PianoBackend, SetupConfig
from fourier_tpu_torch.ops import curve as tcv
from fourier_tpu_torch.ops import kernels
from fourier_tpu_torch.ops import msm as tmsm
from fourier_tpu_torch.ops import msm_fused as tmf
from fourier_tpu_torch.ops.curve import G1Jac
from fourier_tpu_torch.ops.limbs import ints_to_vec
from fourier_tpu_torch.parallel import msm_fused_sharded as mfs
from fourier_tpu_torch.parallel import prove_sharded as ps
from fourier_tpu_torch.parallel.mesh import LocalMesh, all_gather_last, local_mesh
from fourier_tpu_torch.parallel.msm_sharded import msm_sharded
from fourier_tpu_torch.refimpl.curve import G1_GEN, g1_msm, g1_mul

torch.set_num_threads(1)


def _point(p: G1Jac):
    return tcv.jac_to_int_points(G1Jac(*(c[..., None] for c in p)))[0]


@functools.lru_cache(maxsize=None)
def _points(n: int, seed: int):
    rng = random.Random(seed)
    pts = [g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(n)]
    return pts, tcv.affine_from_ints(pts)


@functools.lru_cache(maxsize=None)
def _inputs(n: int, seed: int, equal: bool = False, bits: int = 255):
    """(points, scalars, affine points, scalar limbs, refimpl's MSM)."""
    pts, points = _points(n, seed)
    rng = random.Random(seed + 1)
    scalars = [rng.randrange(min(R, 1 << bits)) for _ in range(n)]
    if equal:
        scalars = [scalars[0]] * n
    return (pts, scalars, points, torch.as_tensor(ints_to_vec(scalars, 16).astype("int64")),
            g1_msm(pts, scalars))


@functools.lru_cache(maxsize=None)
def _table(n: int, c: int, seed: int):
    """The BGMW table of window c over _points(n, seed), and its packed rows."""
    table = tmsm.bgmw_expand(_points(n, seed)[1], c)
    return table, tmf.pack_points(table)


def _cpu_mesh(D: int) -> LocalMesh:
    mesh = local_mesh(["cpu"] * D)
    assert mesh.size == D and all(d.type == "cpu" for d in mesh.devices)
    return mesh


def test_local_mesh_of_one_device_is_none():
    assert local_mesh(["cpu"]) is None
    assert mfs.local_mesh(["cpu", "cpu"]).size == 2


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("n,c,equal", [(16, 8, False), (16, 8, True), (8, 11, False),
                                       (16, 9, False)],
                         ids=["c8", "c8-equal", "c11-signed", "c9-midwindow"])
def test_bgmw_sharded_matches_refimpl(n_shards, n, c, equal):
    _, _, _, sc, want = _inputs(n, 0x5A, equal)
    table, packed = _table(n, c, 0x5A)
    if n_shards == 2:
        assert _point(tmf.msm_fused_bgmw(packed, table.inf, sc, c)) == want
    got = _cpu_mesh(n_shards).run(lambda shard: (
        _point(mfs.msm_fused_bgmw_sharded(packed, table.inf, sc, c, shard)),
        _point(mfs.msm_bgmw_sharded(table, sc, c, shard))))
    assert got == [(want, want)] * n_shards


@pytest.mark.parametrize("n,n_shards,bits", [(130, 2, 255), (16, 4, 32)],
                         ids=["65-point-shards", "4-point-shards"])
def test_msm_sharded_matches_refimpl(n, n_shards, bits):
    """Shards of 65 points take the windowed MSM, of 4 msm_naive (with
    32-bit scalars, so that its ladder's CPU twin stays short)."""
    _, _, points, sc, want = _inputs(n, 0x5C + n, bits=bits)
    if n <= 64:
        assert _point(msm_sharded(points, sc, None)) == want      # one device
    got = _cpu_mesh(n_shards).run(lambda shard: _point(msm_sharded(points, sc, shard)))
    assert got == [want] * n_shards
    with pytest.raises(ValueError, match="not divisible by mesh axis size 3"):
        _cpu_mesh(3).run(lambda shard: msm_sharded(points, sc, shard))


def test_three_shards_raise_in_every_shard():
    _, _, _, sc, _ = _inputs(3, 0x33)
    table, packed = _table(3, 8, 0x33)
    messages = []
    lock = threading.Lock()

    def shard_fn(shard):
        for fn in (lambda: mfs.msm_fused_bgmw_sharded(packed, table.inf, sc, 8, shard),
                   lambda: mfs.msm_bgmw_sharded(table, sc, 8, shard)):
            try:
                fn()
            except ValueError as e:
                with lock:
                    messages.append(str(e))
        return len(messages)

    _cpu_mesh(3).run(shard_fn)
    assert len(messages) == 6
    assert all("3 ranks do not divide the 256 buckets" in m for m in messages)


def test_failing_shard_ends_the_call():
    """A shard that raises breaks the others' collective at once; a shard
    that never reaches the collective fails the call after the timeout.
    The mesh then serves the next call."""
    mesh = _cpu_mesh(4)
    t = torch.arange(3)

    def gather(shard):
        if shard.rank == 2:
            raise KeyError("shard 2 failed")
        return all_gather_last(t + shard.rank, shard)

    t0 = time.monotonic()
    with pytest.raises(KeyError, match="shard 2 failed"):
        mesh.run(gather)
    assert time.monotonic() - t0 < mesh.timeout_s / 2

    quick = LocalMesh(["cpu"] * 2, timeout_s=0.5)
    with pytest.raises(TimeoutError, match="waited over 0.5 s"):
        quick.run(lambda shard: None if shard.rank else all_gather_last(t, shard))
    got = mesh.run(lambda shard: all_gather_last(t + shard.rank, shard))
    assert all(torch.equal(g, torch.cat([t + r for r in range(4)])) for g in got)
    assert threading.active_count() < 50


@functools.lru_cache(maxsize=None)
def _round_case():
    """(table_c, prove's arguments with the backend's row tables, the
    per-request round's outputs) at scale 4, machines_scale 2 (M = 4)."""
    b = PianoBackend.setup(SetupConfig(scale=4, machines_scale=2), "cpu")
    rng = random.Random(0x7B)
    rows = b.random_bivariate_polynomial()
    alpha, beta = rng.randrange(R), rng.randrange(R)
    commits = [b.worker_commit(i, r) for i, r in enumerate(rows)]
    opens = [b.worker_open(i, r, alpha) for i, r in enumerate(rows)]
    evals, proofs = [y for y, _ in opens], [p for _, p in opens]
    z, (pi0, pi1) = b.master_open(evals, proofs, beta)
    want = {"master_com": b.master_commit(commits), "z": z, "pi0": pi0, "pi1": pi1,
            "commits": commits, "evals": evals, "proofs": proofs}
    table_c = b.settings.precompute.c
    return table_c, ps.prove_inputs_from_backend(b, rows, alpha, beta, table_c), want


@pytest.mark.parametrize("n_shards", [2, 4])
def test_round_over_shards_matches_per_request(n_shards):
    table_c, args, want = _round_case()
    got = _cpu_mesh(n_shards).run(lambda shard: prove_outputs_to_ints(
        ps.build_distributed_prove(shard, table_c)(*ps.local_inputs(args, shard, table_c))))
    assert got == [want] * n_shards


def test_launch_counts_exact_under_threads():
    """8 threads count 2,000 launches each with a short switch interval: a
    lost update would show."""
    counters = kernels.KernelCounters()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [counters.count("g1_dbl")
                                                    for _ in range(2000)])
                   for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    assert counters.launches["g1_dbl"] == 16000
