"""The port's sharded MSMs on the CPU over gloo: the counterparts of
tests/test_parallel.py's (its multihost dryruns are in
test_torch_multihost.py).

One world of 4 processes for this module takes the cases: the BGMW MSM
with its table rows split over 2 and over 4 ranks, fused
(msm_fused_bgmw_sharded) and plain (msm_bgmw_sharded), at n = 16, c = 8
(unsigned digits, W = 32; and all-equal scalars), n = 8, c = 11 (signed,
W = 24) and n = 16, c = 9 (signed, W = 29: shard edges inside a window);
the tableless msm_fused_sharded; 3 ranks, which do not divide the bucket
space, raise ValueError.  Every rank's result must equal refimpl's g1_msm
and the one-device MSM.  The round as one call over the backend's tables
(parallel/prove_sharded.py), its rows split over 2 and over 4 ranks, must
equal the backend's per-request round on every rank.
"""

import functools
import multiprocessing as mp
import queue
import random
import socket
import traceback

import pytest
import torch
import torch.distributed as dist

from fourier_tpu_torch.constants import R
from fourier_tpu_torch.convert import prove_outputs_to_ints
from fourier_tpu_torch.models.piano import PianoBackend, SetupConfig
from fourier_tpu_torch.ops import curve as tcv
from fourier_tpu_torch.ops import msm as tmsm
from fourier_tpu_torch.ops import msm_fused as tmf
from fourier_tpu_torch.ops.curve import G1Jac
from fourier_tpu_torch.ops.limbs import ints_to_vec
from fourier_tpu_torch.parallel import msm_fused_sharded as mfs
from fourier_tpu_torch.parallel import prove_sharded as ps
from fourier_tpu_torch.parallel.mesh import make_mesh
from fourier_tpu_torch.parallel.multihost import initialize
from fourier_tpu_torch.refimpl.curve import G1_GEN, g1_msm, g1_mul

torch.set_num_threads(1)

WORLD = 4
TIMEOUT_S = 300


def _point(p: G1Jac):
    return tcv.jac_to_int_points(G1Jac(*(c[..., None] for c in p)))[0]


@functools.lru_cache(maxsize=None)
def _inputs(n: int, c: int, seed: int, equal: bool = False):
    """(points, scalars, affine points, scalar limbs, BGMW table of window c)."""
    rng = random.Random(seed)
    pts = [g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(n)]
    scalars = [rng.randrange(R) for _ in range(n)]
    if equal:
        scalars = [scalars[0]] * n
    points = tcv.affine_from_ints(pts)
    return (pts, scalars, points, torch.as_tensor(ints_to_vec(scalars, 16).astype("int64")),
            tmsm.bgmw_expand(points, c))


# -- what every rank of the world runs ------------------------------------------

def _case_bgmw(D, c, table, sc):
    """Both sharded BGMW MSMs over the first D ranks (None off the group);
    the whole world's group from local_group()."""
    group = mfs.local_group() if D == WORLD else make_mesh(D)
    if group.rank < 0:
        return None
    return (_point(mfs.msm_fused_bgmw_sharded(tmf.pack_points(table), table.inf, sc, c, group)),
            _point(mfs.msm_bgmw_sharded(table, sc, c, group)))


def _case_tableless(D, c, points, sc):
    group = make_mesh(D)
    if group.rank < 0:
        return None
    return _point(mfs.msm_fused_sharded(points, sc, c, group))


def _case_bad_group(D, c, table, sc):
    """The ValueError's message of each sharded BGMW MSM on each rank."""
    group = make_mesh(D)
    if group.rank < 0:
        return None
    messages = []
    for fn in (lambda: mfs.msm_fused_bgmw_sharded(tmf.pack_points(table), table.inf, sc, c,
                                                  group),
               lambda: mfs.msm_bgmw_sharded(table, sc, c, group)):
        try:
            fn()
        except ValueError as e:
            messages.append(str(e))
    return messages


def _case_round(D, table_c, args):
    """The round over the first D ranks, each holding its M / D rows."""
    group = make_mesh(D)
    if group.rank < 0:
        return None
    out = ps.build_distributed_prove(group, table_c)(*ps.local_inputs(args, group, table_c))
    return prove_outputs_to_ints(out)


CASES = {"bgmw": _case_bgmw, "tableless": _case_tableless, "bad_group": _case_bad_group,
         "round": _case_round}


def _rank_main(rank, port, inbox, outbox):
    torch.set_num_threads(1)
    initialize(f"127.0.0.1:{port}", WORLD, rank, "cpu")
    while (task := inbox.get()) is not None:
        name, args = task
        try:
            outbox.put((rank, True, CASES[name](*args)))
        except Exception:
            outbox.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def world():
    """submit(case, *args) sends a case to every rank of one world of WORLD
    processes, started for the module, and returns collect(), which waits
    for every rank's result."""
    ctx = mp.get_context("spawn")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    inboxes = [ctx.Queue() for _ in range(WORLD)]
    outbox = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, port, inboxes[r], outbox), daemon=True)
             for r in range(WORLD)]
    for p in procs:
        p.start()

    def submit(name, *args):
        for box in inboxes:
            box.put((name, args))

        def collect():
            results = {}
            try:
                while len(results) < WORLD:
                    rank, ok, value = outbox.get(timeout=TIMEOUT_S)
                    assert ok, f"rank {rank} failed:\n{value}"
                    results[rank] = value
            except queue.Empty:
                raise AssertionError(f"ranks {sorted(set(range(WORLD)) - set(results))} "
                                     f"gave no result in {TIMEOUT_S} s") from None
            return [results[r] for r in range(WORLD)]

        return collect

    try:
        yield submit
    finally:
        for box in inboxes:
            box.put(None)
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()


@pytest.mark.parametrize("n_ranks", [2, 4])
@pytest.mark.parametrize("n,c,equal", [(16, 8, False), (16, 8, True), (8, 11, False),
                                       (16, 9, False)],
                         ids=["c8", "c8-equal", "c11-signed", "c9-midwindow"])
def test_bgmw_sharded_matches_refimpl(world, n_ranks, n, c, equal):
    pts, scalars, _, sc, table = _inputs(n, c, 0x5A, equal)
    collect = world("bgmw", n_ranks, c, table, sc)
    want = g1_msm(pts, scalars)
    one = tmf.msm_fused_bgmw(tmf.pack_points(table), table.inf, sc, c)
    assert _point(one) == want
    assert mfs.local_group() is None             # no process group in this process
    for alone in (mfs.msm_fused_bgmw_sharded(tmf.pack_points(table), table.inf, sc, c, None),
                  mfs.msm_bgmw_sharded(table, sc, c, None)):
        assert all(torch.equal(a, b) for a, b in zip(alone, one))
    got = collect()
    assert got[:n_ranks] == [(want, want)] * n_ranks
    assert got[n_ranks:] == [None] * (WORLD - n_ranks)


@functools.lru_cache(maxsize=None)
def _tableless_want(c):
    pts, scalars, points, sc, _ = _inputs(16, 8, 0x5A)
    want = g1_msm(pts, scalars)
    assert _point(tmf.msm_fused(points, sc, c)) == want
    return want


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_tableless_sharded_matches_refimpl(world, n_ranks):
    _, _, points, sc, _ = _inputs(16, 8, 0x5A)
    collect = world("tableless", n_ranks, 5, points, sc)
    want = _tableless_want(5)
    assert collect()[:n_ranks] == [want] * n_ranks


def test_group_not_dividing_buckets_raises(world):
    _, _, _, sc, table = _inputs(3, 8, 0x33)
    got = world("bad_group", 3, 8, table, sc)()
    for messages in got[:3]:
        assert len(messages) == 2
        assert all("3 ranks do not divide the 256 buckets" in m for m in messages)
    assert got[3] is None


@functools.lru_cache(maxsize=None)
def _round_case():
    """(table_c, prove's arguments with the backend's row tables, the
    per-request round's outputs) at scale 4, machines_scale 2 (M = 4)."""
    b = PianoBackend.setup(SetupConfig(scale=4, machines_scale=2), "cpu")
    rng = random.Random(0x7A)
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


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_tabled_round_sharded_matches_per_request(world, n_ranks):
    table_c, args, want = _round_case()
    got = world("round", n_ranks, table_c, args)()
    assert got[:n_ranks] == [want] * n_ranks
    assert got[n_ranks:] == [None] * (WORLD - n_ranks)
