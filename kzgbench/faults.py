"""Broken stand-ins for the timed path, which only the control runs and the
tests pass (`--fault`); a benchmark run passes none.  Each wraps a
backend's worker_commit and worker_open where they produce their answer:

- control: the plain reference in the program's place, breaking the
  guarantee that a commitment binds every value of the row sent: it
  commits to and opens the row with its last value dropped;
- stale: a call returns the previous call's answer (state left unchanged);
- half_row: the second half of the row is left out;
- altered: the answer is altered where it is produced (g added to the
  point, 1 to the evaluation).
"""

from __future__ import annotations

import numpy as np

from . import data, reference

FAULTS = ("control", "stale", "half_row", "altered")


def _ints(limbs) -> list[int]:
    """[16, T] 16-bit limbs -> Python ints."""
    return data.be_to_ints(data.limbs_to_be(limbs))


def apply(name: str, backend, config: dict, seed: int) -> None:
    commit, open_ = backend.worker_commit, backend.worker_open
    if name == "control":
        dep = reference.Deployment(config["scale"], config["machines_scale"], data.secrets(seed))

        def row(coeffs):
            f = _ints(coeffs)
            f[-1] = 0
            return f

        def commit_f(i, coeffs):
            return reference.g1_mul(reference.G1, dep.r_tau[i] * dep.row_at_tau(row(coeffs)))

        def open_f(i, coeffs, alpha):
            f = row(coeffs)
            y = dep.row_at(f, alpha)
            q = (dep.row_at_tau(f) - y) * pow(dep.tau_x - alpha, -1, reference.R)
            return y, reference.g1_mul(reference.G1, dep.r_tau[i] * q)
    elif name == "stale":
        last = {}

        def commit_f(i, coeffs):
            out = last.get("commit") or commit(i, coeffs)
            last["commit"] = out
            return out

        def open_f(i, coeffs, alpha):
            out = last.get("open") or open_(i, coeffs, alpha)
            last["open"] = out
            return out
    elif name == "half_row":
        def half(coeffs):
            a = np.array(coeffs, dtype=np.uint32, copy=True)
            a[:, a.shape[1] // 2:] = 0
            return a

        def commit_f(i, coeffs):
            return commit(i, half(coeffs))

        def open_f(i, coeffs, alpha):
            return open_(i, half(coeffs), alpha)
    elif name == "altered":
        def commit_f(i, coeffs):
            return reference.g1_add(commit(i, coeffs), reference.G1)

        def open_f(i, coeffs, alpha):
            y, pi = open_(i, coeffs, alpha)
            return (y + 1) % reference.R, reference.g1_add(pi, reference.G1)
    else:
        raise ValueError(f"unknown fault {name!r}; known: {', '.join(FAULTS)}")
    backend.worker_commit, backend.worker_open = commit_f, open_f
