"""The server of an HTTP cell: the port's RpcHandler and HTTP handler, as
`python -m fourier_tpu_torch run` serves them, over a backend built from
the seed (system.py), on a free port of 127.0.0.1.

The harness starts it and steers it by lines on its standard input:
`window <needs>` opens the window (`needs`, JSON: null, or the spans and
kernels a traced window takes, spec.trace_needs), `stop` ends it: the
server writes what it measured to `--out` as JSON and exits.  End of input
ends it too.  It answers on its standard output (READY <port>, WINDOW,
STOPPED); everything else it prints goes to standard error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True, help="the configuration, as JSON")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    ctl = os.fdopen(os.dup(1), "w", buffering=1)
    os.dup2(2, 1)
    sys.path.insert(0, ROOT)
    from http.server import ThreadingHTTPServer

    from fourier_tpu_torch.runtime import server as rs
    from kzgbench import harness
    from kzgbench.transports import inproc

    # the backend as the in-process transport builds, traces and frees it
    system = inproc.Transport(json.loads(args.config), args.seed, args.device, args.fault,
                              tmp=None)
    handler = type("BenchHandler", (rs._HTTPHandler,), {"rpc": rs.RpcHandler(system.start().b)})
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    serving = threading.Thread(target=httpd.serve_forever, daemon=True)
    serving.start()
    ctl.write(f"READY {httpd.server_address[1]}\n")
    try:
        for line in sys.stdin:
            cmd, _, rest = line.strip().partition(" ")
            if cmd == "window":
                system.open_window(json.loads(rest))
                ctl.write("WINDOW\n")
            elif cmd == "stop":
                out = system.close_window()
                out["jax_modules"] = harness.jax_modules()
                with open(args.out, "w") as fh:
                    json.dump(out, fh)
                ctl.write("STOPPED\n")
                return 0
        return 1
    finally:
        httpd.shutdown()
        httpd.server_close()


if __name__ == "__main__":
    sys.exit(main())
