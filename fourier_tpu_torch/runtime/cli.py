"""Command line: `python -m fourier_tpu_torch run|setup`.

Port of ``fourier_tpu.runtime.cli`` with the reference's flags, defaults
and checks (RunArgs, SetupArgs and SetupArgs::can_proceed, reference
src/cli.rs:17-123), plus ``--device`` (default ``cuda``) on both
subcommands, and ``--msm-devices``: the comma list of torch devices a
worker's MSM splits over, one shard each (a device may repeat; default
every visible card under ``--device cuda``, the device alone otherwise;
``FOURIER_SHARD_MSM=0`` keeps one).  `run` starts the RPC server,
generating the SRS and the tables in memory or loading them from
``--setup-path`` and ``--precompute-path``; `setup` generates and saves
them (tables sized for the shard count), or converts an existing setup
file between the compressed and uncompressed encodings.  Nothing moves to
the CPU unless ``--device cpu`` says so: with a CUDA device and no visible
card both subcommands refuse to start, and so does a shard count that
cannot split the tables.
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
    p.add_argument("--msm-devices", type=_device_list, default=None,
                   help="comma list of torch devices the MSM splits over, one shard "
                        "each (e.g. cuda:0,cuda:1); default every visible card under "
                        "--device cuda")


def _device_list(text: str) -> list[str]:
    import torch

    devices = [d.strip() for d in text.split(",")]
    try:
        return [str(torch.device(d)) for d in devices]
    except RuntimeError as e:
        raise argparse.ArgumentTypeError(str(e)) from None


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
    """The torch device of the command, or None (logged) when it or an
    MSM device names CUDA and no card, or no such card, is visible."""
    import torch

    device = torch.device(args.device)
    for d in [device] + [torch.device(m) for m in args.msm_devices or ()]:
        if d.type == "cuda" and not torch.cuda.is_available():
            log.error("no CUDA device is visible; pass --device cpu to run on the CPU")
            return None
        if d.type == "cuda" and (d.index or 0) >= torch.cuda.device_count():
            log.error("%s is not visible (%d cards)", d, torch.cuda.device_count())
            return None
    return device


def cmd_run(args) -> int:
    device = _device(args)
    if device is None:
        return 2
    from ..models.piano import SetupConfig
    from ..parallel.msm_fused_sharded import ShardSplitError
    from .server import ServerConfig, start_rpc_server

    # an omitted or missing path means generate (reference config.rs:174-200)
    backend = SetupConfig(
        scale=args.scale, machines_scale=args.machines_scale,
        setup_path=args.setup_path, precompute_path=args.precompute_path,
        compressed=not args.uncompressed,
        generate_setup=args.setup_path is None or not os.path.exists(args.setup_path),
        generate_precompute=(args.precompute_path is None
                             or not os.path.exists(args.precompute_path)))
    try:
        start_rpc_server(ServerConfig(host=args.host, port=args.port, device=str(device),
                                      backend=backend, msm_devices=args.msm_devices))
    except ShardSplitError as e:
        log.error("the MSM's shards cannot split the tables: %s", e)
        return 2
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
                             or not os.path.exists(args.precompute_path))), device,
        args.msm_devices)
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
