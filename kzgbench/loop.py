"""The shared generator: one client in a closed loop (it sends a request
when the last has returned) over a transport, driven by the mix's data
file.  `kzgbench/generators/closed_loop.py` serves it; another generator
(several clients, an open loop) is a file of its own there, which may
reuse the steps below.

A mix is `kzgbench/traffic/<name>.json`:

- `generator`: the file under kzgbench/generators/ that runs it;
- `transport`: the file under kzgbench/transports/ that carries its
  requests: `http` (the port's `Client` against the port's server in
  another process) or `inproc` (the port's `PianoBackend` called in this
  process);
- `unit`: `row` (each step is one row: row k goes to worker k mod M with a
  fresh alpha) or `round` (each step is a Pianist round: M rows, one a
  worker, sharing a fresh alpha, then the master's requests at a fresh
  beta);
- `row_ops`: the requests a row makes, in order, from `fft` (the row's
  inverse left NTT, which the later requests then carry, as the reference
  client's `test_routine` does), `workerCommit`, `workerOpen`,
  `workerVerify`;
- `round_ops`: the master's requests after a round's rows, from
  `masterCommit`, `masterOpen`, `masterVerify`.

The window issues requests until `--seconds` have passed since its first;
the request in flight then completes.  A row step in flight completes as
well; a round in flight is abandoned, its requests still counted.
"""

from __future__ import annotations

import time

from . import data

ROW_OPS = ("fft", "workerCommit", "workerOpen", "workerVerify")
ROUND_OPS = ("masterCommit", "masterOpen", "masterVerify")


def check_mix(mix: dict) -> None:
    if mix["unit"] not in ("row", "round"):
        raise ValueError(f"this generator steps by rows or rounds, not {mix['unit']!r}")
    bad = [op for op in mix["row_ops"] if op not in ROW_OPS] + \
          [op for op in mix.get("round_ops", []) if op not in ROUND_OPS]
    if bad:
        raise ValueError(f"unknown requests {bad}")


class Deadline(Exception):
    """The window closed before a request was issued."""


class Loop:
    """One run's requests: their latencies and answers."""

    def __init__(self, mix: dict, tr, pool: data.Pool, M: int):
        check_mix(mix)
        self.mix, self.tr, self.pool, self.M = mix, tr, pool, M
        self.requests: list[tuple[str, float, float, bool]] = []
        self.rows: list[dict] = []
        self.rounds: list[dict] = []
        self.error: str | None = None
        self.deadline = float("inf")

    def _call(self, method: str, fn, *args):
        if time.perf_counter() >= self.deadline:
            raise Deadline
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception as e:
            self.requests.append((method, t0, time.perf_counter(), False))
            raise RuntimeError(f"{method}: {type(e).__name__}: {e}") from e
        self.requests.append((method, t0, time.perf_counter(), True))
        return out

    def _row(self, ops, i: int, row, alpha, ans: dict):
        tr = self.tr
        for op in ops:
            if op == "fft":
                row = ans["fft"] = self._call(op, tr.fft, row)
            elif op == "workerCommit":
                ans["commit"] = self._call(op, tr.commit, i, row)
            elif op == "workerOpen":
                ans["eval"], ans["proof"] = self._call(op, tr.open, i, row, alpha)
            elif op == "workerVerify":
                ans["verify"] = self._call(op, tr.verify, i, ans["proof"], alpha, ans["eval"],
                                           ans["commit"])
        return row

    def _master(self, rows: list[dict], alpha, beta, ans: dict):
        tr = self.tr
        for op in self.mix.get("round_ops", []):
            if op == "masterCommit":
                ans["master_commit"] = self._call(op, tr.master_commit,
                                                  [r["commit"] for r in rows])
            elif op == "masterOpen":
                ans["z"], ans["pi_0"], ans["pi_1"] = self._call(
                    op, tr.master_open, [r["eval"] for r in rows], [r["proof"] for r in rows],
                    beta)
            elif op == "masterVerify":
                ans["master_verify"] = self._call(op, tr.master_verify, ans["master_commit"],
                                                  beta, alpha, ans["z"], ans["pi_0"],
                                                  ans["pi_1"])

    def warm_up(self) -> None:
        """Every request of the mix once on the warm row, at worker 0, and a
        commit at every other worker (each row's table is readied at its
        first MSM); the master's requests on worker 0's answers."""
        tr, pool = self.tr, self.pool
        alpha, beta = tr.point(pool.warm_points[0]), tr.point(pool.warm_points[1])
        first: dict = {}
        row = self._row(self.mix["row_ops"], 0, pool.warm_row(), alpha, first)
        for i in range(1, self.M):
            tr.commit(i, row)
        if self.mix["unit"] == "round":
            self._master([first] * self.M, alpha, beta, {})
        self.requests.clear()

    def run(self, seconds: float) -> dict:
        """The window: its start, the end of its last completed step, and
        the steps completed."""
        t_start = time.perf_counter()
        self.deadline = t_start + seconds
        t_done, steps = t_start, 0
        try:
            if self.mix["unit"] == "row":
                while time.perf_counter() < self.deadline:
                    self._row_step(steps)
                    steps += 1
                    t_done = time.perf_counter()
            else:
                while True:
                    self._round_step(steps)
                    steps += 1
                    t_done = time.perf_counter()
        except Deadline:
            pass
        except (RuntimeError, ValueError) as e:   # a request failed; the pool ran out
            self.error = str(e)
        return {"start": t_start, "done": t_done, "steps": steps}

    def commits(self) -> list:
        """For each commit the window answered, in order, a function that
        gives the scalars it sent ([T, 32] big-endian bytes): the row, or
        the row's fft where the mix sends that."""
        def sent(row):
            if "fft" in row:
                return lambda: data.strings_to_be(self.tr.row_out(row["fft"]))
            return lambda: self.pool.row_be(row["k"])
        return [sent(r) for r in self.rows if "commit" in r]

    def _row_step(self, k: int):
        raw = self.pool.point(k)
        ans = {"k": k, "i": k % self.M, "alpha": raw}
        self.rows.append(ans)
        self.deadline, deadline = float("inf"), self.deadline   # a row completes
        try:
            self._row(self.mix["row_ops"], k % self.M, self.pool.row(k), self.tr.point(raw), ans)
        finally:
            self.deadline = deadline

    def _round_step(self, r: int):
        raw_a, raw_b = self.pool.point(2 * r), self.pool.point(2 * r + 1)
        alpha = self.tr.point(raw_a)
        rnd = {"r": r, "alpha": raw_a, "beta": raw_b, "rows": []}
        self.rounds.append(rnd)
        for i in range(self.M):
            k = r * self.M + i
            ans = {"k": k, "i": i, "alpha": raw_a}
            self.rows.append(ans)
            rnd["rows"].append(ans)
            if time.perf_counter() >= self.deadline:
                raise Deadline
            self._row(self.mix["row_ops"], i, self.pool.row(k), alpha, ans)
        self._master(rnd["rows"], alpha, self.tr.point(raw_b), rnd)
