"""The yardstick for kernel rooflines: work counts, bytes, the card's peaks
and the bound.  A frozen copy of chip_smoke.py's arithmetic, so that a
change to the program cannot move it.

Work: a Montgomery product of 12-word Fp values (CIOS) is 2 * 12 * 12 + 12
= 300 32-bit multiply-adds; a mixed add spends 11 products (its doubling
branch 4 + 7 as well).  Bytes count
each input read once and each output written once, at what the function
needs: 48 bytes an Fp coordinate, 4 a 32-bit word.

The int32 multiply-add peak is 64 a clock and SM on compute capability
9.0 (the arithmetic-instruction throughput table of the CUDA C++
Programming Guide) times the card's SMs times its maximum SM clock, both
read in the run; memory 3.35 TB/s (H100 SXM, NVIDIA's data sheet).
"""

from __future__ import annotations

import subprocess

import numpy as np

MADS_PER_PRODUCT = 300
MADD_PRODUCTS = 11
COORD_BYTES = 48
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_CLOCK_PER_SM = 64
SCALAR_BITS = 256
# the BGMW bucket layout (ops/msm_fused.py: heavy buckets are split at 64x
# the mean load, into a spare region of at least 128 slots)
SPLIT_FACTOR = 64
MIN_SPARE = 128


def card_peak(device_index: int = 0) -> dict:
    """{'imad_per_s', 'sms', 'max_sm_mhz', 'power_limit_w', 'name'} of a card."""
    import torch

    def smi(field):
        out = subprocess.run(["nvidia-smi", f"--query-gpu={field}",
                              "--format=csv,noheader,nounits", "-i", str(device_index)],
                             capture_output=True, text=True, check=True)
        return out.stdout.strip().splitlines()[0].strip()

    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    mhz = float(smi("clocks.max.sm"))
    return {"imad_per_s": IMAD_PER_CLOCK_PER_SM * sms * mhz * 1e6, "sms": sms,
            "max_sm_mhz": mhz, "power_limit_w": smi("power.limit"),
            "name": torch.cuda.get_device_name(device_index)}


def bound_s(mads: float, nbytes: float, imad_per_s: float) -> tuple[float, str]:
    """(least seconds, what sets it): the larger of the operations at the
    int32 peak and the bytes at the memory rate."""
    t_ops, t_bytes = mads / imad_per_s, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def window_digits(limbs: np.ndarray, c: int, windows: int) -> np.ndarray:
    """[16, n] 16-bit limbs of scalars -> [windows, n] unsigned c-bit digits
    (window w holds bits c*w .. c*w + c - 1)."""
    words = np.zeros((18, limbs.shape[1]), np.uint64)
    words[:16] = np.asarray(limbs).astype(np.uint64)
    out = np.empty((windows, limbs.shape[1]), np.int64)
    for w in range(windows):
        lo, sh = divmod(c * w, 16)
        v = words[lo] >> np.uint64(sh)
        v |= words[lo + 1] << np.uint64(16 - sh)
        v |= words[lo + 2] << np.uint64(32 - sh)
        out[w] = (v & np.uint64((1 << c) - 1)).astype(np.int64)
    return out


def bucket_loads(limbs: np.ndarray, c: int, windows: int) -> tuple[np.ndarray, int]:
    """(rows a bucket over the shared buckets of a BGMW table of `windows`
    windows, the bucket count that sets the mean): signed digits where the
    windows cover them (windows * c >= SCALAR_BITS + 1 exactly as
    ops/msm_fused.py decides), else unsigned.  Digit 0 adds nothing."""
    digits = window_digits(limbs, c, windows)
    if windows == -(-(SCALAR_BITS + 1) // c):
        half, full = 1 << (c - 1), 1 << c
        carry = np.zeros(digits.shape[1], np.int64)
        for w in range(windows):
            d = digits[w] + carry
            neg = d > half
            digits[w] = np.where(neg, full - d, d)
            carry = neg.astype(np.int64)
        buckets, mean_over = half + 1, half
    else:
        buckets = mean_over = 1 << c
    return np.bincount(digits.ravel(), minlength=buckets), mean_over


def accumulate_work(limbs: np.ndarray, c: int, windows: int) -> tuple[float, float]:
    """(multiply-adds, bytes) of K1 (`accumulate`) for one BGMW MSM of these
    scalars over a table of `windows` * n rows, no row at infinity: a slot
    of k rows needs k - 1 mixed adds, a bucket of k rows fills ceil(k /
    cap) slots.  Bytes: the table's rows (24 words), the index (one word a
    row), start and count (one word a slot each), and the slots' Jacobian
    sums out."""
    loads, mean_over = bucket_loads(limbs, c, windows)
    rows = windows * limbs.shape[1]
    cap = SPLIT_FACTOR * max(1, -(-rows // mean_over))
    k = loads[1:].astype(np.int64)
    adds = int((k - (k + cap - 1) // cap).sum())
    slots = len(loads) + max(MIN_SPARE, -(-rows // cap))
    nbytes = (rows * 24 + rows + 2 * slots) * 4 + 3 * COORD_BYTES * slots
    return float(adds * MADD_PRODUCTS * MADS_PER_PRODUCT), float(nbytes)
