"""The open's evaluation-form quotient on the CPU (jax-free).

`_eval_form_open` on CPU tensors runs the plain twin of the card's
kernels (ops/kernels.py fr_quotient_plain) and launches nothing; its limbs
equal the quotient computed with Python integers: alpha off the domain,
on it (the flag), 0, rows of zeros and of r - 1, and batches of rows.  A
Python-int model of the card's inversion plan (csrc/fr_quotient.cu: runs
of a few lanes a thread, the block's two product scans, one Fermat
inversion a block, the way back down) returns the inverses of
batch_inverse_host at several T and block shapes, zeros among the
values; the wrapper refuses malformed operands; the Fr constants the
kernels are compiled with are the Python ones; and a workerOpen reads the
kernels' launch counters only while tracing is on.
"""

import os
import random
import re

import pytest
import torch

from fourier_tpu_torch.constants import FR_LIMBS, R, root_of_unity
from fourier_tpu_torch.models import piano as tpiano
from fourier_tpu_torch.ops import kernels
from fourier_tpu_torch.ops.field import FR, batch_inverse_host
from fourier_tpu_torch.ops.limbs import ints_to_vec, vec_to_ints
from fourier_tpu_torch.utils import trace

torch.set_num_threads(1)

MONT = (1 << 256) % R
MONT_INV = pow(MONT, -1, R)


def _mont(vals):
    return torch.as_tensor(ints_to_vec([v * MONT % R for v in vals], FR_LIMBS).astype("int64"))


def _plain(t):
    """Montgomery limbs [16, ...] -> the values they hold, in order."""
    return [v * MONT_INV % R for v in vec_to_ints(t.reshape(FR_LIMBS, -1).numpy())]


def quotient_ints(roots, rows, alpha):
    """(y of each row, q of each row, any_zero) with Python integers."""
    T = len(roots)
    inv = batch_inverse_host([(alpha - w) % R for w in roots], R)
    factor = (pow(alpha, T, R) - 1) * pow(T, -1, R) % R
    ys = [factor * sum(f * w * d for f, w, d in zip(row, roots, inv)) % R for row in rows]
    qs = [[(y - f) * d % R for f, d in zip(row, inv)] for y, row in zip(ys, rows)]
    return ys, qs, any((alpha - w) % R == 0 for w in roots)


def _case(kind, log_t, batch, rng):
    T = 1 << log_t
    w = root_of_unity(log_t)
    roots = [pow(w, j, R) for j in range(T)]
    n_rows = 1
    for b in batch:
        n_rows *= b
    rows = [[rng.randrange(R) for _ in range(T)] for _ in range(n_rows)]
    alpha = rng.randrange(R)
    if kind == "alpha on the domain":
        alpha = roots[T // 3]
    elif kind == "alpha 0":
        alpha = 0
    elif kind == "f zeros":
        rows = [[0] * T for _ in rows]
    elif kind == "f at r - 1":
        rows = [[R - 1 if j % 3 else f for j, f in enumerate(row)] for row in rows]
    return roots, rows, alpha


@pytest.mark.parametrize("kind,log_t,batch", [
    ("random", 4, ()), ("random", 8, ()), ("alpha on the domain", 4, ()),
    ("alpha 0", 4, ()), ("f zeros", 4, ()), ("f at r - 1", 5, ()),
    ("random", 3, (3,)), ("alpha on the domain", 3, (2, 2)),
])
def test_eval_form_open_on_cpu_is_the_plain_twin(kind, log_t, batch, monkeypatch):
    rng = random.Random(f"{kind} {log_t} {batch}")
    roots, rows, alpha = _case(kind, log_t, batch, rng)
    T = len(roots)
    f = _mont([v for row in rows for v in row]).reshape((FR_LIMBS,) + batch + (T,)) \
        if batch else _mont(rows[0])
    calls = []
    twin = kernels.fr_quotient_plain
    monkeypatch.setattr(kernels, "fr_quotient_plain",
                        lambda *a: calls.append(1) or twin(*a))
    launched = kernels.COUNTERS.total()
    y, q, any_zero = tpiano._eval_form_open(_mont(roots), f, _mont([alpha]),
                                            _mont([pow(T, -1, R)]))
    assert calls == [1] and kernels.COUNTERS.total() == launched
    assert y.shape == (FR_LIMBS,) + batch + (1,) and q.shape == (FR_LIMBS,) + batch + (T,)
    ys, qs, want_zero = quotient_ints(roots, rows, alpha)
    assert any_zero is want_zero is (kind == "alpha on the domain")
    assert _plain(y) == ys
    assert _plain(q) == [v for row in qs for v in row]


def test_fr_quotient_checks_arguments():
    roots, f, one = _mont(range(1, 9)), _mont(range(8)), _mont([1])
    bad = [((roots.to(torch.int32), f, one, one), "roots must be"),
           ((roots, f[:, :4], one, one), "f must be"),
           ((roots, f, _mont([1, 2]), one), "alpha must be"),
           ((roots, f, one, one.to("meta")), "different devices")]
    for args, message in bad:
        with pytest.raises(ValueError, match=message):
            kernels.fr_quotient(*args)
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.fr_quotient(*(t.to("meta") for t in (roots, f, one, one)))


# -- the card's inversion plan, in Python integers ---------------------------------

def _mul(a, b):
    return a * b % R


def _fermat(a):
    """a^(r - 2) as the kernel's fr_inv: square and multiply from bit 253."""
    acc = a
    for bit in range(253, -1, -1):
        acc = _mul(acc, acc)
        if (R - 2) >> bit & 1:
            acc = _mul(acc, a)
    return acc


def inversion_plan(d, alpha, threads, run):
    """(inverses, w^j / d_j, block flags) of d_j = alpha - w^j by the loops of
    fr_quotient_inv_kernel: lane j = block * threads * run + i * threads + t."""
    T = len(d)
    inv, wi = [None] * T, [None] * T
    flags = []
    for blk in range(-(-T // (threads * run))):
        pre, acc, zero = {}, [1] * threads, [False] * threads
        for t in range(threads):            # the way up, a run a thread
            for i in range(run):
                j = blk * threads * run + i * threads + t
                if j >= T:
                    break
                pre[j] = acc[t]
                if d[j] == 0:
                    zero[t] = True
                else:
                    acc[t] = _mul(acc[t], d[j])
        lo, hi = list(acc), list(acc)       # Hillis-Steele scans, each way
        off = 1
        while off < threads:
            lo = [_mul(lo[t - off], lo[t]) if t >= off else lo[t] for t in range(threads)]
            hi = [_mul(hi[t], hi[t + off]) if t + off < threads else hi[t]
                  for t in range(threads)]
            off <<= 1
        inv_total = _fermat(lo[threads - 1])
        flags.append(any(zero))
        for t in range(threads):            # the way down
            inv_acc = inv_total
            if t > 0:
                inv_acc = _mul(inv_acc, lo[t - 1])
            if t + 1 < threads:
                inv_acc = _mul(inv_acc, hi[t + 1])
            for i in reversed(range(run)):
                j = blk * threads * run + i * threads + t
                if j >= T:
                    continue
                if d[j] == 0:
                    inv[j] = wi[j] = 0
                else:
                    inv[j] = _mul(inv_acc, pre[j])
                    inv_acc = _mul(inv_acc, d[j])
                    wi[j] = _mul((alpha - d[j]) % R, inv[j])
    return inv, wi, flags


# (T, lanes that hit alpha, threads a block, lanes a thread's run): the
# card's shape, 256 x 16, and small ones whose blocks and runs end early
@pytest.mark.parametrize("T,zeros,threads,run", [
    (1, [], 256, 16), (16, [5], 256, 16), (256, [], 256, 16), (4096, [0, 4095], 256, 16),
    (5000, [4096, 4999], 256, 16), (8195, [1, 300, 8194], 256, 16),
    (37, [0, 36], 4, 3), (100, [50], 8, 2), (9, [], 1, 5)])
def test_inversion_plan_matches_batch_inverse_host(T, zeros, threads, run):
    rng = random.Random(T)
    roots = [rng.randrange(R) for _ in range(T)]
    alpha = rng.randrange(R)
    for j in zeros:
        roots[j] = alpha
    d = [(alpha - w) % R for w in roots]
    inv, wi, flags = inversion_plan(d, alpha, threads, run)
    assert inv == batch_inverse_host(d, R)
    assert wi == [w * v % R for w, v in zip(roots, inv)]
    lanes = threads * run
    assert len(flags) == -(-T // lanes)
    assert flags == [any(j // lanes == b for j in zeros) for b in range(len(flags))]


def test_fr_header_constants():
    """csrc/fr.cuh's r, Montgomery one, r - 2 and -r^-1 mod 2^32."""
    with open(os.path.join(kernels.CSRC, "fr.cuh")) as fh:
        src = fh.read()

    def words(name):
        body = re.search(name + r"\[FR_WORDS\] = \{([^}]*)\}", src).group(1)
        vals = [int(w.strip().rstrip("u"), 16) for w in body.split(",") if w.strip()]
        assert len(vals) == 8
        return sum(v << (32 * i) for i, v in enumerate(vals))

    assert words("FR_P") == R
    assert words("FR_ONE") == MONT == FR.mont_r
    assert words("FR_EXP_INV") == R - 2
    ninv = int(re.search(r"#define FR_NINV (0x[0-9a-f]+)u", src).group(1), 16)
    assert ninv == (-pow(R, -1, 1 << 32)) % (1 << 32)


@pytest.fixture(scope="module")
def backend():
    fft = tpiano.PianoFFTSettings(4, 1, "cpu")
    settings = tpiano.generate_trusted_setup(fft, (b"\x05" * 32, b"\x06" * 32))
    settings.precompute = tpiano.PianoPrecompute.generate(settings)
    return tpiano.PianoBackend(fft, settings)


def test_open_reads_launch_counters_only_while_tracing(backend, monkeypatch):
    """Off, a workerOpen never reads the kernels' counters; on, its
    open.quotient span carries the launches inside it (none on the CPU)."""
    row = [(7 + 13 * k) ** 5 % R for k in range(backend.fft.T)]
    total = kernels.COUNTERS.total

    def refuse():
        raise AssertionError("counters read")

    monkeypatch.setattr(kernels.COUNTERS, "total", refuse)
    assert not trace.TRACER.on
    want = backend.worker_open(0, row, 12345)
    monkeypatch.setattr(kernels.COUNTERS, "total", total)
    trace.TRACER.drain()
    trace.TRACER.enable()
    try:
        assert backend.worker_open(0, row, 12345) == want
        spans = {s["name"]: s for s in trace.TRACER.drain()}
    finally:
        trace.TRACER.disable()
        trace.TRACER.drain()
    assert spans["open.quotient"]["launches"] == 0
