"""The comparison that decides `correct`: every answer of the window against
the plain reference (reference.py), worked out again from the seed's
secrets, rows and points, in worker processes once the window has closed
and the program's state is freed.

Each number compared counts answers that differ from the reference's, or
requests that never answered; each has the limit 0, as an exact
comparison does.  Where a window answered more rows than MAX_ROWS, a
sample drawn from the seed is compared: MAX_ROWS rows, or the rounds that
hold at most that many.
"""

from __future__ import annotations

import concurrent.futures as cf
import multiprocessing
import os
import random
from multiprocessing import resource_tracker

from . import data, reference

MAX_ROWS = 24
# the reference's worker processes: a fixed number, whatever the host's cores
WORKERS = 6

_dep: reference.Deployment | None = None


def _init(scale: int, machines_scale: int, secrets) -> None:
    global _dep
    _dep = reference.Deployment(scale, machines_scale, secrets)


def _row_task(i: int, row_be, with_fft: bool, alpha: bytes | None) -> dict:
    """The reference's answers for one row."""
    values = data.be_to_ints(row_be)
    out = {}
    if with_fft:
        values = reference.intt(values, _dep.t)
        out["fft"] = data.ints_to_be(values)
    a = None if alpha is None else int.from_bytes(alpha, "big")
    out["f_tau"], out["commit"], out["y"], out["proof"] = _dep.worker(i, values, a)
    return out


def compare(config: dict, seed: int, loop) -> dict:
    """{name: mismatches} over every answer the loop recorded."""
    ops = set(loop.mix["row_ops"]) | set(loop.mix.get("round_ops", []))
    tr = loop.tr
    counts = dict.fromkeys(
        [n for n, op in (("fft_wrong", "fft"), ("commit_wrong", "workerCommit"),
                         ("eval_wrong", "workerOpen"), ("proof_wrong", "workerOpen"),
                         ("rejected", "workerVerify"), ("master_wrong", "masterCommit"),
                         ("master_wrong", "masterOpen"), ("rejected", "masterVerify"))
         if op in ops], 0)
    counts["unanswered"] = sum(not ok for *_, ok in loop.requests)
    pick = random.Random(seed)
    rounds = loop.rounds
    if len(rounds) * loop.M > MAX_ROWS:
        rounds = sorted(pick.sample(rounds, MAX_ROWS // loop.M), key=lambda rnd: rnd["r"])
    rows = [r for r in (loop.rows if not loop.rounds else
                        [row for rnd in rounds for row in rnd["rows"]])
            if "commit" in r or "fft" in r]
    if len(rows) > MAX_ROWS:
        rows = sorted(pick.sample(rows, MAX_ROWS), key=lambda r: r["k"])
    n_workers = max(1, min(len(rows), WORKERS, len(os.sched_getaffinity(0)) - 1))
    try:
        return _compare(config, seed, loop, tr, ops, rounds, rows, counts, n_workers)
    finally:
        # the spawn context's resource tracker would outlive the run
        stop = getattr(resource_tracker._resource_tracker, "_stop", None)
        if stop is not None:
            stop()


def _compare(config, seed, loop, tr, ops, rounds, rows, counts, n_workers) -> dict:
    ctx = multiprocessing.get_context("spawn")
    with cf.ProcessPoolExecutor(n_workers, mp_context=ctx, initializer=_init,
                                initargs=(config["scale"], config["machines_scale"],
                                          data.secrets(seed))) as ex:
        futs = [ex.submit(_row_task, r["i"], loop.pool.row_be(r["k"]), "fft" in ops,
                          r["alpha"] if "eval" in r else None) for r in rows]
        refs = {r["k"]: f.result() for r, f in zip(rows, futs)}
        for r in rows:
            ref = refs[r["k"]]
            if "fft" in r:
                counts["fft_wrong"] += tr.row_out(r["fft"]) != data.b64_strings(ref["fft"])
            if "commit" in r:
                counts["commit_wrong"] += tr.g1_out(r["commit"]) != data.b64(ref["commit"])
            if "eval" in r:
                counts["eval_wrong"] += tr.fr_out(r["eval"]) != data.b64(reference.fr_bytes(ref["y"]))
                counts["proof_wrong"] += tr.g1_out(r["proof"]) != data.b64(ref["proof"])
            if "verify" in r:
                counts["rejected"] += r["verify"] is not True
        masters = [(rnd, ex.submit(_master_task, [refs[r["k"]]["f_tau"] for r in rnd["rows"]],
                                   [refs[r["k"]]["y"] for r in rnd["rows"]], rnd["alpha"],
                                   rnd["beta"]))
                   for rnd in rounds if "master_commit" in rnd]
        for rnd, f in masters:
            com, z, pi0, pi1 = f.result()
            got = [tr.g1_out(rnd["master_commit"])]
            want = [data.b64(com)]
            if "z" in rnd:
                got += [tr.fr_out(rnd["z"]), tr.g1_out(rnd["pi_0"]), tr.g1_out(rnd["pi_1"])]
                want += [data.b64(reference.fr_bytes(z)), data.b64(pi0), data.b64(pi1)]
            counts["master_wrong"] += got != want
            if "master_verify" in rnd:
                counts["rejected"] += rnd["master_verify"] is not True
    return counts


def _master_task(f_taus, ys, alpha: bytes, beta: bytes):
    return _dep.master(f_taus, ys, int.from_bytes(alpha, "big"), int.from_bytes(beta, "big"))
