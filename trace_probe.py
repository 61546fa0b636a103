#!/usr/bin/env python3
"""Reads the port's own spans (fourier_tpu_torch/utils/trace.py) over one
cell of BENCHMARK.json on a card: the wire split, the tracer's cost, the
quotient's launches and the shared clock.

Run from the root of the repository, on a machine with a card:

    python3 trace_probe.py --workload s20m1.worker.http --seed 7 --seconds 15 \\
        --out chiprun_out/trace_probe.json

It builds the cell's backend from the seed as the benchmark does
(kzgbench/setups/), in a server process of its own for an HTTP cell
(the port's RpcHandler and HTTP handler, its spans appended to a file as
FOURIER_TRACE does) or in this process, runs the cell's mix through the
benchmark's closed loop (kzgbench/loop.py), and measures five windows of
--seconds each: the tracer off on both sides, on, off, on, and on under
torch.profiler in the process that drives the card.  It prints, and
writes to --out:

- per window, the median and p90 of each method's client latency (the
  tracer's cost is the on windows against the off ones);
- per workerCommit of the traced windows, medians of the client's share
  (client.request less client.post), the transfer (client.post less the
  server.request of the same id up to the end of its server.write), the
  server's codec (that less server.call), what the server does after the
  write (the request's objects freed), the upload (commit.upload), the host's share of the
  protocol (worker_commit less msm) and the MSM (msm), and of the wire as
  the benchmark's wire_ms.commit reads it (the client's latency less the
  server's worker_commit);
- from the profiled window: busy and window seconds, the device's idle
  time by the innermost program span of either process at each instant,
  the device kernels (and copies) that start inside each open.quotient
  span, the names of the most frequent of them, the hand-written kernels
  each span counts (`launches`), how many K1 kernels (accumulate) start
  inside a program msm span, and for each commit where its K1 kernels
  start in its msm span.

--device cpu and --scale run it here at a small size (no profiler).
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
K1 = ("accumulate_pieces_kernel", "accumulate_slots_kernel")


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


# -- what the process that drives the card measures -------------------------------

class Profile:
    """torch.profiler over a window, analysed against the program's spans."""

    def __init__(self, device: str):
        import torch

        self.on = device != "cpu"
        if self.on:
            self.prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            self.prof.__enter__()
        self.t0 = time.time_ns()

    def stop(self, spans: list[dict]) -> dict:
        from fourier_tpu_torch.utils.trace import sync_cards
        from kzgbench import trace as kt

        sync_cards()
        t1 = time.time_ns()
        if not self.on:
            return {"window_s": (t1 - self.t0) * 1e-9}
        self.prof.__exit__(None, None, None)
        import torch

        work = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA or not kt._is_work(e):
                continue
            start = e.start_ns()
            if self.t0 <= start <= t1:
                work.append((start, start + e.duration_ns(), e.name()))
        work.sort()
        busy = kt._merge([(a, min(b, t1)) for a, b, _ in work])
        edges = [self.t0] + [x for iv in busy for x in iv] + [t1]
        gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        starts = [w[0] for w in work]

        def inside(s, pred=lambda w: True):
            lo, hi = bisect.bisect_left(starts, s["t0"]), bisect.bisect_right(starts, s["t1"])
            return [w for w in work[lo:hi] if pred(w)]

        is_k1 = lambda w: any(k in w[2] for k in K1)
        is_kernel = lambda w: not w[2].startswith(("Memcpy", "Memset"))
        quot = [s for s in spans if s["name"] == "open.quotient"]
        msms = [s for s in spans if s["name"] == "msm"]
        k1 = [w for w in work if is_k1(w)]
        commits = []
        for s in (s for s in msms if s["parent"] == "worker_commit"):
            near = [w for w in k1 if s["t0"] - 50_000_000 <= w[0] <= s["t1"] + 50_000_000]
            commits.append({"inside": sum(s["t0"] <= w[0] <= s["t1"] for w in near),
                            "k1_start_after_t0_ms": [(w[0] - s["t0"]) * 1e-6 for w in near],
                            "k1_start_before_t1_ms": [(s["t1"] - w[0]) * 1e-6 for w in near]})
        return {
            "window_s": (t1 - self.t0) * 1e-9,
            "busy_s": sum(b - a for a, b in busy) * 1e-9,
            "idle_gaps": attribute(gaps, spans),
            "quotient_kernels": [len(inside(s, is_kernel)) for s in quot],
            "quotient_copies": [len(inside(s, lambda w: not is_kernel(w))) for s in quot],
            "quotient_kernel_names": dict(collections.Counter(
                w[2][:60] for s in quot for w in inside(s, is_kernel)).most_common(12)),
            "quotient_launches": [s.get("launches") for s in quot],
            "k1_events": len(k1), "k1_in_msm_spans": sum(len(inside(s, is_k1)) for s in msms),
            "commits": commits,
        }


def attribute(gaps, spans) -> list:
    """Idle seconds by the innermost span open at each instant (of those
    open, the one begun last), each gap cut at the spans' edges; largest
    first."""
    cuts = sorted({t for s in spans for t in (s["t0"], s["t1"])})
    names = []
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2
        open_ = [s for s in spans if s["t0"] <= mid < s["t1"]]
        names.append(max(open_, key=lambda s: s["t0"])["name"] if open_ else None)
    out: dict = {}
    for a, b in gaps:
        x, j = a, bisect.bisect_right(cuts, a) - 1    # piece j is [cuts[j], cuts[j + 1])
        while x < b:
            if 0 <= j < len(names):
                end, name = min(b, cuts[j + 1]), names[j]
            else:
                end, name = (min(b, cuts[0]) if j < 0 and cuts else b), None
            key = "idle in " + name if name else "idle outside the spans"
            out[key] = out.get(key, 0.0) + (end - x) * 1e-9
            x, j = end, j + 1
    return sorted(([k, v] for k, v in out.items()), key=lambda kv: -kv[1])


def serve(args) -> int:
    """The server process of an HTTP cell, steered by lines on stdin:
    `tracer on|off`, `profile`, `stop <client spans file>`."""
    ctl = os.fdopen(os.dup(1), "w", buffering=1)
    os.dup2(2, 1)
    from http.server import ThreadingHTTPServer
    import threading

    from fourier_tpu_torch.runtime import server as rs
    from fourier_tpu_torch.utils.trace import TRACER
    from kzgbench import system

    backend, _ = system.build_backend(json.loads(args.config), args.seed, args.device)
    handler = type("ProbeHandler", (rs._HTTPHandler,), {"rpc": rs.RpcHandler(backend)})
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    ctl.write(f"READY {httpd.server_address[1]}\n")
    profile = None
    try:
        for line in sys.stdin:
            cmd, _, rest = line.strip().partition(" ")
            if cmd == "tracer":
                if rest == "on":
                    handler.trace_path = args.spans
                    TRACER.enable()
                else:
                    TRACER.disable()
                    handler.trace_path = None
            elif cmd == "profile":
                profile = Profile(args.device)
            elif cmd == "stop":
                with open(rest) as fh:
                    client_spans = json.load(fh)
                server_spans = [s for ln in open(args.spans) for s in json.loads(ln)]
                out = profile.stop(server_spans + client_spans) if profile else {}
                with open(args.out, "w") as fh:
                    json.dump(out, fh)
                ctl.write("STOPPED\n")
                return 0
            ctl.write("OK\n")
        return 1
    finally:
        httpd.shutdown()
        httpd.server_close()


class Server:
    def __init__(self, config: dict, args, tmp: str):
        self.spans, self.out = os.path.join(tmp, "server.jsonl"), os.path.join(tmp, "server.json")
        cmd = [sys.executable, os.path.abspath(__file__), "--serve", "--config",
               json.dumps(config), "--seed", str(args.seed), "--device", args.device,
               "--spans", self.spans, "--out", self.out]
        self.p = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
                                  bufsize=1)
        line = self.p.stdout.readline().split()
        if not line or line[0] != "READY":
            raise RuntimeError(f"server: {line}")
        self.port = int(line[1])

    def send(self, line: str, want: str = "OK"):
        self.p.stdin.write(line + "\n")
        self.p.stdin.flush()
        got = self.p.stdout.readline().strip()
        if got != want:
            raise RuntimeError(f"server answered {got!r} to {line!r}")

    def server_spans(self) -> list[dict]:
        if not os.path.exists(self.spans):
            return []
        with open(self.spans) as fh:
            return [s for ln in fh for s in json.loads(ln)]

    def close(self):
        if self.p.poll() is None:
            self.p.kill()
        self.p.wait()


# -- the readings -------------------------------------------------------------------

def latencies(requests) -> dict:
    out = {}
    for m in sorted({r[0] for r in requests}):
        xs = sorted((r[2] - r[1]) * 1e3 for r in requests if r[0] == m)
        p90 = statistics.quantiles(xs, n=10, method="inclusive")[8] if len(xs) > 1 else xs[0]
        out[m] = {"n": len(xs), "median_ms": statistics.median(xs), "p90_ms": p90}
    return out


def split(spans: list[dict], requests) -> dict:
    """Medians (ms) of each workerCommit's shares: its protocol spans are
    those inside its worker_commit span, its client and server spans
    those of its request's id."""
    dur = lambda s: (s["t1"] - s["t0"]) * 1e-6
    by_id: dict = {}
    for s in spans:
        if s["request"] is not None:
            by_id.setdefault(s["request"], {}).setdefault(s["name"], s)
    commits = sorted((s for s in spans if s["name"] == "worker_commit"), key=lambda s: s["t0"])
    parts: dict = {k: [] for k in ("client_ms", "transfer_ms", "server_codec_ms",
                                   "server_after_write_ms", "upload_ms", "commit_host_ms",
                                   "msm_ms", "wire_ms")}
    for c in commits:
        kids = {s["name"]: s for s in spans if s["parent"] == "worker_commit"
                and c["t0"] <= s["t0"] and s["t1"] <= c["t1"]}
        parts["upload_ms"].append(dur(kids["commit.upload"]))
        parts["commit_host_ms"].append(dur(c) - dur(kids["msm"]))
        parts["msm_ms"].append(dur(kids["msm"]))
        one = by_id.get(c["request"], {})
        if "client.request" in one and "server.request" in one:
            # the server's request up to its reply's write: what the client waits on
            req, wrote = one["server.request"], one["server.write"]
            served = (wrote["t1"] - req["t0"]) * 1e-6
            parts["client_ms"].append(dur(one["client.request"]) - dur(one["client.post"]))
            parts["transfer_ms"].append(dur(one["client.post"]) - served)
            parts["server_codec_ms"].append(served - dur(one["server.call"]))
            parts["server_after_write_ms"].append((req["t1"] - wrote["t1"]) * 1e-6)
    lat = [(r[2] - r[1]) * 1e3 for r in requests if r[0] == "workerCommit"]
    if parts["client_ms"] and len(lat) == len(commits):
        parts["wire_ms"] = [a - dur(c) for a, c in zip(lat, commits)]
    return {k: statistics.median(v) for k, v in parts.items() if v} | {"commits": len(commits)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="s20m1.worker.http")
    ap.add_argument("--seed", type=int, default=2**31 + 11)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=int, default=None, help="override (CPU rehearsals)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--serve", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--config", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--spans", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = "4"
    if args.serve:
        return serve(args)

    from fourier_tpu_torch.utils.trace import TRACER
    from kzgbench import data, loop, spec
    from kzgbench.transports import http, inproc

    sp = spec.Spec()
    cell = sp.cell(args.workload)
    config = sp.config(cell) | ({"scale": args.scale} if args.scale else {})
    mix = sp.traffic(cell)
    T, M = 1 << (config["scale"] - config["machines_scale"]), 1 << config["machines_scale"]
    report = {"workload": args.workload, "seed": args.seed, "card": card(),
              "seconds": args.seconds, "windows": {}}
    print(f"trace_probe: {args.workload} on {report['card']}", flush=True)
    with tempfile.TemporaryDirectory(prefix="trace-probe-") as tmp:
        server = backend = None
        try:
            if mix["transport"] == "http":
                server = Server(config, args, tmp)
                reqs = http.Requests(server.port)
            else:
                from kzgbench import system

                backend, _ = system.build_backend(config, args.seed, args.device)
                reqs = inproc.Requests(backend)
            pool = data.Pool(args.seed, T, strings=mix["transport"] == "http")
            gen = loop.Loop(mix, reqs, pool, M)
            gen.warm_up()
            for window in ("off", "on", "off2", "on2", "profiled"):
                on = not window.startswith("off")
                if server:
                    server.send(f"tracer {'on' if on else 'off'}")
                    if window == "profiled":
                        server.send("profile")
                if on:
                    TRACER.enable()
                else:
                    TRACER.disable()
                TRACER.drain()
                profile = Profile(args.device) if window == "profiled" and not server else None
                gen = loop.Loop(mix, reqs, pool, M)
                w = gen.run(args.seconds)
                time.sleep(0.5)     # the server appends a request's spans after its reply
                spans = TRACER.drain()
                entry = {"steps": w["steps"], "latency": latencies(gen.requests)}
                if server:
                    if window == "profiled":
                        path = os.path.join(tmp, "client.json")
                        with open(path, "w") as fh:
                            json.dump(spans, fh)
                        server.send(f"stop {path}", "STOPPED")
                        with open(server.out) as fh:
                            entry["device"] = json.load(fh)
                    all_spans = spans + server.server_spans()
                    if os.path.exists(server.spans):
                        os.remove(server.spans)
                else:
                    all_spans = spans
                    if profile:
                        entry["device"] = profile.stop(spans)
                if on:
                    entry["commit_split"] = split(all_spans, gen.requests)
                    entry["spans"] = len(all_spans)
                report["windows"][window] = entry
                print(f"trace_probe: {window}: {json.dumps(entry)}", flush=True)
        finally:
            TRACER.disable()
            if server:
                server.close()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
