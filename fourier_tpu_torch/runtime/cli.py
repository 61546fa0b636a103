"""Command line: `python -m fourier_tpu_torch run|setup`.

Port of ``fourier_tpu.runtime.cli`` with the reference's flags, plus
``--device`` (default ``cuda``) on `run`.  `run` refuses to start when
the device is CUDA and no card is visible: nothing moves to the CPU
unless ``--device cpu`` says so.  Setup and precompute files are not
ported yet, so ``--setup-path``/``--precompute-path`` and the `setup`
subcommand exit with an error.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

_NOT_PORTED = ("setup and precompute files are not yet ported to fourier_tpu_torch "
               "(runtime/io.py); run without --setup-path/--precompute-path to "
               "generate them in memory")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="fourier-tpu-torch", description="Fourier RPC server (PyTorch + CUDA)")
    sub = parser.add_subparsers(dest="command", required=True)

    run = sub.add_parser("run", help="start the RPC server")
    run.add_argument("--setup-path", default=None)
    run.add_argument("--precompute-path", default=None)
    run.add_argument("--scale", type=int, default=20)
    run.add_argument("--machines-scale", type=int, default=1)
    run.add_argument("--uncompressed", action="store_true", default=False)
    run.add_argument("--host", default="localhost")
    run.add_argument("--port", type=int, default=1337)
    run.add_argument("--device", default="cuda",
                     help="torch device: cuda (the hand-written kernels) or cpu")

    sub.add_parser("setup", help="generate/convert setup files (not yet ported)")
    return parser


def cmd_run(args) -> int:
    log = logging.getLogger("fourier_tpu")
    if args.setup_path is not None or args.precompute_path is not None:
        log.error(_NOT_PORTED)
        return 2
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        log.error("no CUDA device is visible; pass --device cpu to serve on the CPU")
        return 2
    from ..models.piano import SetupConfig
    from .server import ServerConfig, start_rpc_server

    cfg = ServerConfig(host=args.host, port=args.port, device=str(device),
                       backend=SetupConfig(scale=args.scale,
                                           machines_scale=args.machines_scale))
    start_rpc_server(cfg)
    return 0


def main(argv=None) -> int:
    level_str = os.environ.get("FOURIER_LOG") or os.environ.get("RUST_LOG") or "info"
    level = getattr(logging, level_str.split(",")[0].upper(), logging.INFO)
    logging.basicConfig(level=level,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    parser = build_parser()
    # `setup` takes the reference's flags but reads none of them
    args, rest = parser.parse_known_args(argv)
    if args.command != "run":
        logging.getLogger("fourier_tpu").error(_NOT_PORTED)
        return 2
    if rest:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    return cmd_run(args)


if __name__ == "__main__":
    sys.exit(main())
