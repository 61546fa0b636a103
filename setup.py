"""Packaging (reference setup.py:1-13, package `fourier` v0.1).

Two packages: `fourier_tpu` (JAX, the reference) and `fourier_tpu_torch`
(the PyTorch + CUDA port, whose kernel sources ship as package data and
are built with nvcc at first use; `pip install .[torch]` adds torch).
"""

from setuptools import find_packages, setup

setup(
    name="fourier-tpu",
    version="0.1.0",
    description="TPU-native distributed KZG commitment framework (Pianist/PIANO)",
    packages=find_packages(include=["fourier_tpu", "fourier_tpu.*", "fourier_tpu_torch*"]),
    package_data={"fourier_tpu_torch": ["csrc/*.cu", "csrc/*.cuh", "native/*.cpp"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "requests"],
    extras_require={"torch": ["torch"]},
    entry_points={
        "console_scripts": [
            "fourier-tpu=fourier_tpu.runtime.cli:main",
            "fourier-tpu-torch=fourier_tpu_torch.runtime.cli:main",
        ],
    },
)
