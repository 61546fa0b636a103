"""Command line: `python -m fourier_tpu_torch run|setup`.

Port of ``fourier_tpu.runtime.cli`` with the reference's flags, defaults
and checks (RunArgs, SetupArgs and SetupArgs::can_proceed, reference
src/cli.rs:17-123), plus ``--device`` (default ``cuda``) on both
subcommands.  `run` starts the RPC server, generating the SRS and the
tables in memory or loading them from ``--setup-path`` and
``--precompute-path``; `setup` generates and saves them, or converts an
existing setup file between the compressed and uncompressed encodings.
Nothing moves to the CPU unless ``--device cpu`` says so: with a CUDA
device and no visible card both subcommands refuse to start.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

log = logging.getLogger("fourier_tpu")


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--scale", type=int, default=20)
    p.add_argument("--machines-scale", type=int, default=1)
    p.add_argument("--uncompressed", action="store_true", default=False)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the hand-written kernels) or cpu")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="fourier-tpu-torch", description="Fourier RPC server (PyTorch + CUDA)")
    sub = parser.add_subparsers(dest="command", required=True)

    run = sub.add_parser("run", help="start the RPC server")
    run.add_argument("--setup-path", default=None)
    run.add_argument("--precompute-path", default=None)
    _add_common(run)
    run.add_argument("--host", default="localhost")
    run.add_argument("--port", type=int, default=1337)

    setup = sub.add_parser("setup", help="generate/convert setup files")
    setup.add_argument("--setup-path", default="data/setup")
    setup.add_argument("--precompute-path", default="data/precompute")
    _add_common(setup)
    setup.add_argument("--overwrite", action="store_true", default=False)
    setup.add_argument("--generate-setup", action="store_true", default=False)
    setup.add_argument("--generate-precompute", action="store_true", default=False)
    setup.add_argument("--decompress-existing", action="store_true", default=False)
    setup.add_argument("--compress-existing", action="store_true", default=False)
    return parser


def can_proceed(args) -> bool:
    """SetupArgs::can_proceed (reference src/cli.rs:90-123)."""
    for path, generate in ((args.setup_path, args.generate_setup),
                           (args.precompute_path, args.generate_precompute)):
        if os.path.exists(path) and generate and not args.overwrite:
            log.error("File %s already exists, use --overwrite to overwrite", path)
            return False
    if args.compress_existing and args.decompress_existing:
        log.error("Cannot compress and decompress at the same time, choose one")
        return False
    if args.compress_existing and not args.uncompressed:
        log.error("Cannot compress an already compressed file")
        return False
    if args.decompress_existing and args.uncompressed:
        log.error("Cannot decompress an already decompressed file")
        return False
    return True


def _device(args):
    """The torch device of the command, or None (logged) when it names
    CUDA and no card is visible."""
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        log.error("no CUDA device is visible; pass --device cpu to run on the CPU")
        return None
    return device


def cmd_run(args) -> int:
    device = _device(args)
    if device is None:
        return 2
    from ..models.piano import SetupConfig
    from .server import ServerConfig, start_rpc_server

    # an omitted or missing path means generate (reference config.rs:174-200)
    backend = SetupConfig(
        scale=args.scale, machines_scale=args.machines_scale,
        setup_path=args.setup_path, precompute_path=args.precompute_path,
        compressed=not args.uncompressed,
        generate_setup=args.setup_path is None or not os.path.exists(args.setup_path),
        generate_precompute=(args.precompute_path is None
                             or not os.path.exists(args.precompute_path)))
    start_rpc_server(ServerConfig(host=args.host, port=args.port, device=str(device),
                                  backend=backend))
    return 0


def cmd_setup(args) -> int:
    if not can_proceed(args):
        return 1
    if args.compress_existing or args.decompress_existing:
        return _convert_compression(args)
    device = _device(args)
    if device is None:
        return 2
    from ..models.piano import PianoBackend, SetupConfig

    PianoBackend.setup_and_save(SetupConfig(
        scale=args.scale, machines_scale=args.machines_scale,
        setup_path=args.setup_path, precompute_path=args.precompute_path,
        compressed=not args.uncompressed,
        generate_setup=args.generate_setup or not os.path.exists(args.setup_path),
        generate_precompute=(args.generate_precompute
                             or not os.path.exists(args.precompute_path))), device)
    return 0


def _convert_compression(args) -> int:
    """Rewrite the setup file in the other point encoding (the precompute
    file holds Montgomery limbs, the same for both)."""
    device = _device(args)
    if device is None:
        return 2
    from . import io as rio

    src_compressed = bool(args.decompress_existing)
    settings = rio.load_setup(args.setup_path, compressed=src_compressed, device=device)
    rio.save_setup(settings, args.setup_path, compressed=not src_compressed)
    return 0


def main(argv=None) -> int:
    level_str = os.environ.get("FOURIER_LOG") or os.environ.get("RUST_LOG") or "info"
    level = getattr(logging, level_str.split(",")[0].upper(), logging.INFO)
    logging.basicConfig(level=level,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    if args.command == "run":
        return cmd_run(args)
    return cmd_setup(args)


if __name__ == "__main__":
    sys.exit(main())
