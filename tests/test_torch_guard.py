"""The port stays free of JAX and of the JAX package, and refuses what it
cannot do.

- A fresh interpreter imports every fourier_tpu_torch module (the client,
  bipoly, univariate, fp2 and the parallel package too), commits a
  scale-4 row and a constant univariate polynomial on the CPU and finds no
  jax and no fourier_tpu module loaded.
- No port source (parallel/ included; nor chip_smoke.py, kernel_probe.py,
  sharded_msm_probe.py, trace_probe.py, the card-only kernel and tracer
  tests, the quotient's CPU tests, the kernel tests' redundant-form models, the gloo tests, whose
  ranks import their module, or the in-process shards' tests) imports jax
  or any fourier_tpu module other than fourier_tpu_torch.
- `run` refuses a CUDA device when none is visible, and MSM shards that
  cannot split the tables (exit code 2); `setup` refuses what the
  reference's can_proceed refuses, with exit code 1.
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
import fourier_tpu_torch, fourier_tpu_torch.convert, fourier_tpu_torch.ops.serialize
import fourier_tpu_torch.runtime.cli, fourier_tpu_torch.runtime.server, fourier_tpu_torch.runtime.io
import fourier_tpu_torch.runtime.client, fourier_tpu_torch.models.bipoly, fourier_tpu_torch.ops.fp2
import fourier_tpu_torch.parallel.mesh, fourier_tpu_torch.parallel.prove_sharded
import fourier_tpu_torch.parallel.msm_fused_sharded, fourier_tpu_torch.parallel.multihost
import fourier_tpu_torch.parallel.msm_sharded
from fourier_tpu_torch.models.univariate import UnivariateKZG
from fourier_tpu_torch.models.piano import (PianoBackend, PianoFFTSettings,
                                            PianoPrecompute, generate_trusted_setup)
fft = PianoFFTSettings(4, 1, "cpu")
settings = generate_trusted_setup(fft, (b"\\x2a" * 32, b"\\x2b" * 32))
settings.precompute = PianoPrecompute.generate(settings)
com = PianoBackend(fft, settings).worker_commit(0, [1, 4, 7, 10, 13, 16, 19, 22])
assert UnivariateKZG(settings, fft).commit_to_poly([1]) == settings.g
loaded = sorted(m for m in sys.modules if m in ("jax", "fourier_tpu")
                or m.startswith(("jax.", "jaxlib", "fourier_tpu.")))
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
    # fourier_tpu\b does not match fourier_tpu_torch: no word boundary before "_"
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|fourier_tpu)\b", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "kernel_probe.py"),
             os.path.join(ROOT, "sharded_msm_probe.py"), os.path.join(ROOT, "trace_probe.py"),
             os.path.join(ROOT, "tests", "test_torch_kernels.py"),
             os.path.join(ROOT, "tests", "test_torch_trace.py"),
             os.path.join(ROOT, "tests", "test_torch_quotient.py"),
             os.path.join(ROOT, "tests", "torch_redundant.py"),
             os.path.join(ROOT, "tests", "test_torch_parallel.py"),
             os.path.join(ROOT, "tests", "test_torch_multihost.py"),
             os.path.join(ROOT, "tests", "test_torch_local_mesh.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert os.path.join(PKG, "parallel", "prove_sharded.py") in files
    assert os.path.join(PKG, "parallel", "msm_sharded.py") in files
    for path in files:
        with open(path) as fh:
            hit = pattern.search(fh.read())
        assert hit is None, f"{path} names {hit.group(0)!r}"


@pytest.mark.parametrize("args,code,message", [
    (["run", "--scale", "4", "--machines-scale", "1"], 2, "no CUDA device"),
    (["setup", "--setup-path", "{existing}", "--generate-setup", "--device", "cpu"], 1,
     "already exists, use --overwrite"),
    (["setup", "--compress-existing", "--decompress-existing", "--uncompressed"], 1,
     "Cannot compress and decompress at the same time"),
    (["setup", "--compress-existing", "--device", "cpu"], 1,
     "Cannot compress an already compressed file"),
    (["run", "--device", "cpu", "--scale", "4", "--machines-scale", "1", "--host",
      "127.0.0.1", "--port", "0", "--msm-devices", "cpu,cpu,cpu"], 2,
     "3 ranks do not divide the 256 buckets of c = 8"),
], ids=["args0", "args1", "args2", "args3", "args4"])
def test_cli_refuses_what_it_does_not_serve(args, code, message, tmp_path):
    existing = tmp_path / "setup"
    existing.write_bytes(b"keep")
    args = [a.replace("{existing}", str(existing)) for a in args]
    out = subprocess.run([sys.executable, "-m", "fourier_tpu_torch", *args], cwd=ROOT,
                         env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == code, out.stderr
    assert message in out.stderr
    assert existing.read_bytes() == b"keep"


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
    with pytest.raises(ValueError, match="not a batch axis"):
        kernels.g1_tree_reduce([(p, 0, 1)])
    with pytest.raises(ValueError, match="to must be"):
        kernels.g1_tree_reduce([(p, -1, 0)])
    meta = tcv.G1Jac(*(c.to("meta") for c in p))
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.g1_add(meta, meta)
    assert kernels.COUNTERS.launches == dict.fromkeys(kernels.KERNELS, 0)
