"""The benchmark of fourier_tpu_torch on the H100: one run of one cell.

    python3 kzgbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of BENCHMARK.json names a configuration (kzgbench/configs/), a
traffic mix (kzgbench/traffic/) and, through its metrics, their readers
(kzgbench/metrics/).  The run builds the port's server or backend from
the seed, warms up every request of the mix, measures for --seconds,
compares every answer with the plain reference, and prints one JSON line
last on standard output: with --trace 0 the cell's end-to-end metrics,
with --trace 1 its per-layer metrics from spans and the device trace.
The result's `device` names the CPUs the run may use.  Without as many
CUDA cards as the cell asks for, it exits 2 and prints no result.
--fault breaks the timed path (the control and the tests only).
"""

import argparse
import json
import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# CPU threads of each process of a run (this one, the server's), fixed so
# that runs on hosts of different core counts do the same host work
THREADS = "4"


def process_age() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return max(0.0, uptime - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def main(argv=None) -> int:
    age = process_age() - (time.perf_counter() - T0)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = THREADS
    from kzgbench import harness, spec

    chips = spec.Spec().cell(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"kzgbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  fault=args.fault, setup_origin=T0 - age)
    except harness.RunError as e:
        print(f"kzgbench: {e}", file=sys.stderr)
        return 1
    result["device"]["cpus"] = sorted(os.sched_getaffinity(0))
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
