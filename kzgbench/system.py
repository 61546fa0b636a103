"""The system under test: the port's PianoBackend, built by the set-up that
the configuration names (`setup`: kzgbench/setups/<name>.py) from the
seed, and what the harness reads off it."""

from __future__ import annotations

import torch

from . import spec


def sync(devices) -> None:
    for d in {torch.device(d) for d in devices}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def msm_devices(config: dict, device: str) -> list[str]:
    """One entry a card the configuration gives a worker's MSM."""
    if device == "cpu":
        return ["cpu"] * config["cards"]
    return [f"cuda:{k}" for k in range(config["cards"])]


def build_backend(config: dict, seed: int, device: str):
    """(backend, set-up seconds by phase)."""
    return spec.module("setups", config["setup"]).build(config, seed, device)


def msm_layout(backend) -> dict:
    """The tables' window c, windows a row (0 without tables) and the MSM's
    shard count: what a count of K1's work needs."""
    pc = backend.settings.precompute
    table = None if pc is None else next((t for t in pc.u_rows if t is not None), None)
    return {"c": None if pc is None else pc.c,
            "windows": 0 if table is None else table.x.shape[-1] // backend.fft.T,
            "shards": len(backend.msm_devices)}


def peak_memory(devices) -> int:
    """The largest peak of allocated bytes over the cards."""
    return max((torch.cuda.max_memory_allocated(d) for d in {torch.device(x) for x in devices}
                if d.type == "cuda"), default=0)
