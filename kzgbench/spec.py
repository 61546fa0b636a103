"""BENCHMARK.json and the files it names, each found by name:

- a cell's configuration: the `file` of its entry in `configs`;
- its traffic mix: `kzgbench/traffic/<traffic>.json`, data that names the
  generator and the transport it runs on;
- a generator: `kzgbench/generators/<name>.py`, with `make(mix, tr, pool,
  M)` and `compare(config, seed, generator)`, the comparison that decides
  `correct`;
- a transport: `kzgbench/transports/<name>.py`, with a `Transport` class;
- a set-up: `kzgbench/setups/<name>.py` (the configuration's `setup`), with
  `build(config, seed, device) -> (backend, phases)`;
- a metric: `kzgbench/metrics/<name>.py`, with `read(run) -> float | None`
  and optionally `SPANS` and `KERNELS`, what the traced run has to take for
  it (trace.py).

A new cell, mix, generator, transport, set-up or metric is new files and
new entries in BENCHMARK.json."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Spec:
    def __init__(self):
        with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
            self.bench = json.load(fh)

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        entry = next(c for c in self.bench["configs"] if c["name"] == cell["config"])
        with open(os.path.join(ROOT, entry["file"])) as fh:
            return json.load(fh)

    def traffic(self, cell: dict) -> dict:
        with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as fh:
            return json.load(fh)

    def end_to_end(self, cell: dict) -> list[dict]:
        return [m for m in self.bench["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def per_layer(self, cell: dict) -> list[dict]:
        """The cell's per-layer metrics: those that list it, and those with
        no list whose end-to-end metric the cell reports."""
        moved = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.bench["per_layer"]
                if cell["name"] in m.get("workloads", [cell["name"]] if m["moves"] in moved
                                         else [])]


_loaded: dict = {}


def module(kind: str, name: str):
    """kzgbench/<kind>/<name>.py, loaded once."""
    key = (kind, name)
    if key not in _loaded:
        path = os.path.join(HERE, kind, name + ".py")
        mod_name = f"kzgbench_{kind}_" + "".join(ch if ch.isalnum() else "_" for ch in name)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[key] = mod
    return _loaded[key]


def reader(name: str):
    """The `read` function of kzgbench/metrics/<name>.py."""
    return module("metrics", name).read


def trace_needs(metrics: list[dict]) -> dict:
    """What a traced run of these metrics has to take: the spans to patch
    in ({target: name}) and the kernels whose device events to keep."""
    spans, kernels = {}, set()
    for m in metrics:
        mod = module("metrics", m["name"])
        for target, name in getattr(mod, "SPANS", ()):
            if spans.setdefault(target, name) != name:
                raise ValueError(f"{target} is spanned as {spans[target]!r} and {name!r}")
        kernels.update(getattr(mod, "KERNELS", ()))
    return {"spans": spans, "kernels": sorted(kernels)}
