"""The port's `Client` against the port's server: kzgbench/server.py, in a
process of its own, serves a backend built from the seed through the
port's RpcHandler and HTTP handler on a free port of 127.0.0.1."""

from __future__ import annotations

import json
import os
import queue
import subprocess
import sys
import threading

from kzgbench import data
from kzgbench.harness import RunError

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRINGS = True   # rows travel as the wire's base64 strings


class Requests:
    """The requests of a mix, through the port's client helpers."""

    def __init__(self, port: int):
        from fourier_tpu_torch.runtime import client

        self.c = client
        self.rpc = client.Client(host="127.0.0.1", port=port)

    def point(self, raw: bytes):
        return data.b64(raw)

    def fft(self, row):
        return self.c.fft(self.rpc, row, left=True, inverse=True)

    def commit(self, i, row):
        return self.c.worker_commit(self.rpc, i, row)

    def open(self, i, row, alpha):
        return self.c.worker_open(self.rpc, i, row, alpha)

    def verify(self, i, proof, alpha, y, com):
        return self.c.worker_verify(self.rpc, i, proof, alpha, y, com)

    def master_commit(self, coms):
        return self.c.master_commit(self.rpc, coms)

    def master_open(self, ys, proofs, beta):
        return self.c.master_open(self.rpc, ys, proofs, beta)

    def master_verify(self, com, beta, alpha, z, pi0, pi1):
        return self.c.master_verify(self.rpc, com, beta, alpha, z, pi0, pi1)

    # answers are already the wire's strings
    def row_out(self, row):
        return row

    def fr_out(self, v):
        return v

    def g1_out(self, v):
        return v


class Transport:
    """kzgbench/server.py in a process of its own, steered over its pipes;
    it starts building the backend at once."""

    def __init__(self, config: dict, seed: int, device: str, fault: str | None, tmp: str):
        self.out = os.path.join(tmp, "server.json")
        self.log_path = os.path.join(tmp, "server.log")
        cmd = [sys.executable, os.path.join(HERE, "server.py"), "--config", json.dumps(config),
               "--seed", str(seed), "--device", device, "--out", self.out]
        if fault:
            cmd += ["--fault", fault]
        self.log = open(self.log_path, "wb")
        self.p = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                  stderr=self.log, text=True, bufsize=1)
        self.lines: queue.Queue = queue.Queue()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.p.stdout:
            self.lines.put(line.strip())
        self.lines.put(None)

    def _send(self, line: str) -> None:
        self.p.stdin.write(line + "\n")
        self.p.stdin.flush()

    def _expect(self, word: str, timeout: float) -> str:
        try:
            line = self.lines.get(timeout=timeout)
        except queue.Empty:
            line = None
        if line is None or not line.startswith(word):
            raise RunError(f"server: expected {word}, got {line!r}; its log ends:\n"
                              + self.log_tail())
        return line

    def log_tail(self, n: int = 4000) -> str:
        self.log.flush()
        with open(self.log_path, "rb") as fh:
            return fh.read()[-n:].decode(errors="replace")

    def start(self) -> Requests:
        return Requests(int(self._expect("READY", 900).split()[1]))

    def open_window(self, needs: dict | None) -> None:
        self._send("window " + json.dumps(needs))
        self._expect("WINDOW", 60)

    def close_window(self) -> dict:
        self._send("stop")
        self._expect("STOPPED", 300)
        self.p.wait(timeout=120)
        with open(self.out) as fh:
            return json.load(fh)

    def close(self) -> None:
        if self.p.poll() is None:
            self.p.kill()
        self.p.wait()
        self.log.close()
