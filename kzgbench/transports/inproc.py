"""The port's PianoBackend, built and called in the harness's own process
on limbs and ints: no client, wire or server."""

from __future__ import annotations

import gc

from kzgbench import data, reference

STRINGS = False   # rows travel as [16, T] limbs


class Requests:
    """The requests of a mix, on the backend."""

    def __init__(self, backend):
        self.b = backend

    def point(self, raw: bytes):
        return int.from_bytes(raw, "big")

    def fft(self, row):
        return self.b.fft.fft_limbs(row, True, True)

    def commit(self, i, row):
        return self.b.worker_commit(i, row)

    def open(self, i, row, alpha):
        return self.b.worker_open(i, row, alpha)

    def verify(self, i, proof, alpha, y, com):
        return self.b.worker_verify(i, com, alpha, y, proof)

    def master_commit(self, coms):
        return self.b.master_commit(coms)

    def master_open(self, ys, proofs, beta):
        z, (pi0, pi1) = self.b.master_open(ys, proofs, beta)
        return z, pi0, pi1

    def master_verify(self, com, beta, alpha, z, pi0, pi1):
        return self.b.master_verify(com, beta, alpha, z, (pi0, pi1))

    # answers in the wire's strings, for the comparison
    def row_out(self, limbs):
        return data.b64_strings(data.limbs_to_be(limbs))

    def fr_out(self, v):
        return data.b64(reference.fr_bytes(v))

    def g1_out(self, v):
        return data.b64(reference.g1_bytes(v))


class Transport:
    def __init__(self, config: dict, seed: int, device: str, fault: str | None, tmp: str):
        self.config, self.seed, self.device, self.fault = config, seed, device, fault
        self.backend = self.requests = self.spans = self.device_trace = None

    def start(self) -> Requests:
        from kzgbench import faults, system

        self.backend, self.setup = system.build_backend(self.config, self.seed, self.device)
        if self.fault:
            faults.apply(self.fault, self.backend, self.config, self.seed)
        self.requests = Requests(self.backend)
        return self.requests

    def cards(self) -> list[str]:
        return sorted({str(d) for d in [self.backend.device, *self.backend.msm_devices]})

    def open_window(self, needs: dict | None) -> None:
        """Start the spans and the device trace that `needs` names."""
        if needs is None:
            return
        from kzgbench import trace

        self.spans = trace.Spans(self.backend, needs["spans"])
        self.spans.install()
        if self.device != "cpu":
            self.device_trace = trace.DeviceTrace(self.cards(), needs["kernels"])
            self.device_trace.start()

    def close_window(self) -> dict:
        from kzgbench import roofline, system

        out = {"setup": self.setup}
        if self.device_trace is not None:
            out["trace"] = self.device_trace.stop(self.spans)
        if self.spans is not None:
            self.spans.uninstall()
            out["spans"] = self.spans.summary()
        out["msm_layout"] = system.msm_layout(self.backend)
        out["memory_peak_bytes"] = system.peak_memory(self.cards())
        out["kind"] = self.device
        if self.device != "cpu":
            import torch

            out["peak"] = roofline.card_peak(0)
            out["kind"] = torch.cuda.get_device_name(0)
        return out

    def close(self) -> None:
        """Free the program's state before the reference runs."""
        if self.requests is not None:
            self.requests.b = None
        self.backend = self.requests = self.spans = self.device_trace = None
        gc.collect()
        if self.device != "cpu":
            import torch

            torch.cuda.empty_cache()
