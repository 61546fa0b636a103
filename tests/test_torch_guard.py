"""The port stays free of JAX and refuses what it does not serve.

- A fresh interpreter imports every fourier_tpu_torch module, commits a
  scale-4 row on the CPU and finds no jax module loaded.
- No port source (nor chip_smoke.py, nor the card-only kernel tests)
  names jax.
- `run` refuses a CUDA device when none is visible, and the setup-file
  paths and the `setup` subcommand exit with a "not yet ported" error.
- chip_smoke.py exits non-zero with no result line when no card is seen.
- The kernel wrappers check their arguments before anything launches.
"""

import os
import re
import subprocess
import sys

import pytest
import torch

from fourier_tpu_torch.ops import curve as tcv
from fourier_tpu_torch.ops import kernels

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "fourier_tpu_torch")

_SLICE = """
import sys
import torch
torch.set_num_threads(1)
import fourier_tpu_torch, fourier_tpu_torch.convert
import fourier_tpu_torch.runtime.cli, fourier_tpu_torch.runtime.server
from fourier_tpu_torch.models.piano import (PianoBackend, PianoFFTSettings,
                                            PianoPrecompute, generate_trusted_setup)
fft = PianoFFTSettings(4, 1)
settings = generate_trusted_setup(fft, (b"\\x2a" * 32, b"\\x2b" * 32))
settings.precompute = PianoPrecompute.generate(settings)
com = PianoBackend(fft, settings).worker_commit(0, [1, 4, 7, 10, 13, 16, 19, 22])
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
print("COMMIT", com[0] % 1000, "JAX", loaded)
"""


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    env.update(extra)
    return env


def test_slice_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _SLICE], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert "COMMIT" in out.stdout
    assert out.stdout.strip().endswith("JAX []"), out.stdout


def test_port_sources_never_name_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|fourier_tpu\.(ops\.(field|curve|"
                         r"msm|msm_fused|ntt|serialize|pallas_curve|fp2)|models|"
                         r"runtime\.(server|cli|io|client|aot)|parallel))\b", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "tests", "test_torch_kernels.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as fh:
            hit = pattern.search(fh.read())
        assert hit is None, f"{path} names {hit.group(0)!r}"


@pytest.mark.parametrize("args", [
    ["run", "--scale", "4", "--machines-scale", "1"],                  # no card visible
    ["run", "--device", "cpu", "--setup-path", "setup.bin"],
    ["run", "--device", "cpu", "--precompute-path", "pre.bin"],
    ["setup", "--scale", "4"],
])
def test_cli_refuses_what_it_does_not_serve(args):
    out = subprocess.run([sys.executable, "-m", "fourier_tpu_torch", *args], cwd=ROOT,
                         env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 2, out.stderr
    assert ("no CUDA device" in out.stderr) or ("not yet ported" in out.stderr)


def test_chip_smoke_refuses_without_card():
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
                         env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_kernel_wrappers_check_arguments():
    p = tcv.jac_identity((4,))
    with pytest.raises(ValueError, match="int64"):
        kernels.g1_add(tcv.G1Jac(*(c.to(torch.int32) for c in p)), p)
    with pytest.raises(ValueError, match="batch shapes differ"):
        kernels.g1_add(p, tcv.jac_identity((5,)))
    with pytest.raises(ValueError, match="repeat"):
        kernels.g1_dbl(p, -1)
    with pytest.raises(ValueError, match="multiple of width"):
        kernels.horner_2k(p, 3)
    lanes = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="table must be int32"):
        kernels.accumulate(torch.zeros((4, 24), dtype=torch.int64), lanes, lanes, lanes)
    with pytest.raises(ValueError, match="index must be"):
        kernels.accumulate(torch.zeros((4, 24), dtype=torch.int32), lanes.long(), lanes, lanes)
    meta = tcv.G1Jac(*(c.to("meta") for c in p))
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.g1_add(meta, meta)
    assert kernels.COUNTERS.launches == dict.fromkeys(kernels.KERNELS, 0)
