"""One run of one cell: set-up, warm-up, the measured window, the
comparison with the reference, the metrics and the result line.

The cell's mix names its generator and transport and its configuration
names its set-up (spec.py); the cell's per-layer metrics name what a
traced window takes."""

from __future__ import annotations

import json
import sys
import tempfile
import time

from . import data, readers, spec

JAX_NAMES = ("jax", "jaxlib", "flax", "fourier_tpu")


class RunError(RuntimeError):
    """A run that cannot report a result."""


def jax_modules() -> list[str]:
    """Modules loaded whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(JAX_NAMES))


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             overrides: dict | None = None, fault: str | None = None,
             setup_origin: float | None = None) -> dict:
    """The result of one run (see run.py).  `setup_origin`: the
    perf_counter reading of the process's start."""
    t_origin = time.perf_counter() if setup_origin is None else setup_origin
    sp = spec.Spec()
    cell = sp.cell(name)
    config = {**sp.config(cell), **(overrides or {})}
    mix = sp.traffic(cell)
    generator = spec.module("generators", mix["generator"])
    transport = spec.module("transports", mix["transport"])
    needs = spec.trace_needs(sp.per_layer(cell)) if trace else None
    T, M = 1 << (config["scale"] - config["machines_scale"]), 1 << config["machines_scale"]
    run: dict = {"transport": mix["transport"], "unit": mix.get("unit"), "cards": config["cards"]}
    with tempfile.TemporaryDirectory(prefix="kzgbench-") as tmp:
        system = transport.Transport(config, seed, device, fault, tmp)
        try:
            pool = data.Pool(seed, T, strings=transport.STRINGS)
            gen = generator.make(mix, system.start(), pool, M)
            gen.warm_up()
            system.open_window(needs)
            run["setup_s"] = time.perf_counter() - t_origin
            run["window"] = gen.run(seconds)
            run.update(system.close_window())
        finally:
            system.close()
    found = sorted(set(jax_modules()) | set(run.pop("jax_modules", [])))
    if found:
        raise RunError(f"loaded {found}")
    if gen.error:
        print(f"kzgbench: the window stopped at an error: {gen.error}", file=sys.stderr)
    run["requests"] = gen.requests
    run["commits"] = gen.commits()
    t = time.perf_counter()
    counts = generator.compare(config, seed, gen)
    # the same work for a seed in every run: a reading of the host's speed
    print(f"kzgbench: the reference took {time.perf_counter() - t:.1f} s", file=sys.stderr)
    return _result(sp, cell, run, counts, trace)


def _result(sp, cell, run, counts, trace) -> dict:
    metrics = {}
    for m in sp.end_to_end(cell) if not trace else sp.per_layer(cell):
        value = spec.reader(m["name"])(run)
        if value is None and not trace:
            raise RunError(f"no reading of {m['name']}")
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    reqs = run["requests"]
    for method in sorted({r[0] for r in reqs}):
        lat = sorted(r[2] - r[1] for r in reqs if r[0] == method)
        print(f"kzgbench: {method}: {len(lat)} requests, median {readers.median_ms(lat):.3f} ms, "
              f"max {lat[-1] * 1e3:.3f} ms", file=sys.stderr)
    print(f"kzgbench: set-up phases {json.dumps(run.get('setup'))}", file=sys.stderr)
    kind = run["kind"]
    device = {"platform": "gpu" if kind != "cpu" else "cpu", "kind": kind,
              "count": run["cards"], "memory_peak_bytes": run["memory_peak_bytes"]}
    out = {"correct": not any(counts.values()), "attempted": len(reqs),
           "failed": sum(not r[3] for r in reqs), "metrics": metrics, "device": device}
    if trace and run.get("trace"):
        device["busy_s"] = run["trace"]["busy_s"]
        device["window_s"] = run["trace"]["window_s"]
        out["breakdown"] = {"device_ops": run["trace"]["device_ops"],
                            "idle_gaps": run["trace"]["idle_gaps"]}
        if run.get("peak"):
            print(f"kzgbench: card {json.dumps(run['peak'])}", file=sys.stderr)
    out["checks"] = {k: {"value": v, "limit": 0} for k, v in counts.items()}
    return out
