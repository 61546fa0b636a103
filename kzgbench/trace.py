"""Spans and the device trace of a `--trace 1` run, taken in the process
that drives the cards (the server of an HTTP cell, the harness itself in
process).

Spans are the benchmark's own wrappers around calls into the port, patched
in for the traced window only.  What to wrap comes from the cell's metrics
(spec.trace_needs): a target `module:qualname` and the span's name.  Each
span ends in a synchronize of the backend's cards and keeps its wall-clock
ends, so the trace's idle gaps can be named by the span the host was in
and kernels can be paired with the span they ran in.
"""

from __future__ import annotations

import importlib
import threading
import time
from collections import defaultdict

import torch

# what occupies a card (the device's copies of record_function ranges, if
# any, do not)
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def resolve(target: str):
    """(owner, attribute) of `module:qualname`."""
    mod_name, qual = target.split(":")
    owner = importlib.import_module(mod_name)
    *path, attr = qual.split(".")
    for part in path:
        owner = getattr(owner, part)
    return owner, attr


class Spans:
    """Spans of the calls named by `targets` ({target: name}), patched into
    the port for a window."""

    def __init__(self, backend, targets: dict):
        self.devices = sorted({str(d) for d in [backend.device, *backend.msm_devices]})
        self.targets = targets
        self.records: list[dict] = []
        self._local = threading.local()
        self._lock = threading.Lock()
        self._saved: list = []

    def _sync(self):
        for d in self.devices:
            if d.startswith("cuda"):
                torch.cuda.synchronize(d)

    def _stack(self) -> list:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    def wrap(self, name: str, fn):
        spans = self

        def wrapped(*args, **kwargs):
            stack = spans._stack()
            rec = {"name": name, "parent": stack[-1]["name"] if stack else None}
            spans._sync()
            rec["t0"], rec["w0"] = time.perf_counter(), time.time_ns()
            stack.append(rec)
            try:
                return fn(*args, **kwargs)
            finally:
                spans._sync()
                rec["t1"], rec["w1"] = time.perf_counter(), time.time_ns()
                stack.pop()
                with spans._lock:
                    spans.records.append(rec)

        return wrapped

    def install(self):
        for target, name in self.targets.items():
            owner, attr = resolve(target)
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, self.wrap(name, fn))

    def uninstall(self):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()

    def summary(self) -> list[dict]:
        return sorted(self.records, key=lambda r: r["t0"])


class DeviceTrace:
    """torch.profiler over the window: device time, idle gaps, and the
    events of the kernels named in `kernels` (substrings of their names)."""

    def __init__(self, devices, kernels=()):
        self.devices = sorted({torch.device(d).index or 0 for d in devices
                               if torch.device(d).type == "cuda"})
        self.kernels = tuple(kernels)
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])

    def start(self):
        self.prof.__enter__()
        self.t0_ns = time.time_ns()
        self.t0 = time.perf_counter()

    def stop(self, spans: Spans) -> dict:
        for d in self.devices:
            torch.cuda.synchronize(d)
        self.t1_ns = time.time_ns()
        window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        return self.analyse(window_s, spans.records)

    def analyse(self, window_s: float, records: list[dict]) -> dict:
        """Busy seconds (the mean over the cards), the device operations
        that took most, the idle gaps of the first card by the span the
        host was in, and [name, start ns, seconds] of each kept kernel."""
        lo, hi = self.t0_ns, self.t1_ns
        busy = defaultdict(list)
        by_name = defaultdict(float)
        kept = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA or not _is_work(e):
                continue
            start, end = e.start_ns(), e.start_ns() + e.duration_ns()
            if end <= lo or start >= hi:
                continue
            busy[e.device_index()].append((max(start, lo), min(end, hi)))
            name = e.name()
            by_name[name[:120]] += e.duration_ns() * 1e-9
            if any(k in name for k in self.kernels):
                kept.append([name, start, e.duration_ns() * 1e-9])
        merged = {d: _merge(v) for d, v in busy.items()}
        busy_s = (sum(sum(b - a for a, b in merged.get(d, [])) for d in self.devices)
                  * 1e-9 / max(1, len(self.devices)))
        first = merged.get(self.devices[0], []) if self.devices else []
        edges = [lo] + [x for iv in first for x in iv] + [hi]
        named = [(r["w0"], r["w1"], r["name"]) for r in records]
        gaps = _name_gaps([(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a], named)
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"busy_s": busy_s, "window_s": window_s, "device_ops": top(by_name),
                "idle_gaps": top(gaps), "kernels": sorted(kept, key=lambda k: k[1])}


def _is_work(e) -> bool:
    """A kernel, copy or fill on the card; not the card's copy of a
    record_function range."""
    if hasattr(e, "activity_type"):
        return e.activity_type() in DEVICE_WORK
    return not getattr(e, "is_user_annotation", bool)()


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _name_gaps(gaps, spans) -> dict:
    """Idle seconds by the innermost span the host was in at each gap's
    middle (spans of one thread nest; the innermost began last)."""
    out = defaultdict(float)
    spans = sorted(spans)
    j, active = 0, []
    for a, b in gaps:
        t = (a + b) // 2
        while j < len(spans) and spans[j][0] <= t:
            active.append(spans[j])
            j += 1
        active = [s for s in active if s[1] >= t]
        name = max(active)[2] if active else None
        out["idle in " + name if name else "idle outside the spans"] += (b - a) * 1e-9
    return out
