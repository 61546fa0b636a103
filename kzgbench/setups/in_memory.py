"""The port's `run` command's in-memory start, from the seed's secrets: the
SRS by `generate_trusted_setup`, the tables by `PianoPrecompute.generate`
at the window of the MSM's shard count, the tables placed on the shards by
`PianoBackend`.  Every phase ends in a synchronize of the cards it used
and is timed here."""

from __future__ import annotations

import time

from fourier_tpu_torch.models import piano
from fourier_tpu_torch.ops import kernels

from kzgbench import data, system


def build(config: dict, seed: int, device: str):
    """(backend, set-up seconds by phase)."""
    shards = system.msm_devices(config, device)
    devices = [device] + shards
    phases = {}
    t = time.perf_counter()
    if device != "cpu":
        kernels.build()
    phases["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    fft = piano.PianoFFTSettings(config["scale"], config["machines_scale"], device)
    settings = piano.generate_trusted_setup(fft, data.secrets(seed))
    system.sync(devices)
    phases["srs_s"] = time.perf_counter() - t
    t = time.perf_counter()
    settings.precompute = piano.PianoPrecompute.generate(settings, shards=len(shards))
    backend = piano.PianoBackend(fft, settings, device, shards)
    system.sync(devices)
    phases["tables_s"] = time.perf_counter() - t
    return backend, phases
