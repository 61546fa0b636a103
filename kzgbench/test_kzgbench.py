"""CPU tests of the benchmark harness (python -m pytest kzgbench/): every cell
resolves its files, every traffic mix runs end to end at a small scale and
agrees with the reference, each fault of the timed path makes `correct`
false, a worker's MSM over four shards runs through the harness, the
yardstick's pieces agree with the port's own, and nothing here imports
JAX or the JAX package.  A cell's small size and window follow from its
configuration and mix, so a new configuration or cell is new files.  The test marked
`cuda` runs one cell on a card and skips elsewhere."""

from __future__ import annotations

import ast
import base64
import json
import os
import random
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from kzgbench import data, faults, harness, reference, roofline, spec, trace  # noqa: E402

SEED = 2**31 + 977
CELLS = [w["name"] for w in spec.Spec().bench["workloads"]]


def small(cell: str) -> dict:
    """The cell's configuration at T = 2^7 values a row, where the rows
    still have tables, whatever its workers and cards."""
    sp = spec.Spec()
    return {"scale": 7 + sp.config(sp.cell(cell))["machines_scale"]}


def window_s(cell: str) -> float:
    """A window that completes a step of the cell's mix on the CPU."""
    sp = spec.Spec()
    return 45.0 if sp.traffic(sp.cell(cell))["unit"] == "round" else 3.0


def run_small(cell, trace_=False, fault=None, overrides=None):
    return harness.run_cell(cell, SEED, window_s(cell), trace_, device="cpu",
                            overrides={**small(cell), **(overrides or {})}, fault=fault)


def test_cells_resolve():
    sp = spec.Spec()
    bench = sp.bench
    for cell in bench["workloads"]:
        config = sp.config(cell)
        assert config["name"] == cell["config"]
        for key in ("scale", "machines_scale", "cards"):
            assert isinstance(config[key], int)
        mix = sp.traffic(cell)
        gen = spec.module("generators", mix["generator"])
        assert callable(gen.make) and callable(gen.compare)
        assert hasattr(spec.module("transports", mix["transport"]), "Transport")
        assert callable(spec.module("setups", config["setup"]).build)
        e2e = {m["name"] for m in sp.end_to_end(cell)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = sp.per_layer(cell)
        assert layer
        for m in layer:
            assert m["moves"] in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
        for w in m.get("workloads", []):
            sp.cell(w)
    for target in spec.trace_needs(bench["per_layer"])["spans"]:
        assert callable(getattr(*trace.resolve(target)))



def _split_metrics() -> list[str]:
    names = {m["name"] for m in spec.Spec().bench["per_layer"]}
    return sorted(n for n in names if "." in n and
                  os.path.exists(os.path.join(HERE, "metrics", n.rsplit(".", 1)[0] + ".py")))


@pytest.mark.parametrize("name", _split_metrics())
def test_a_split_metric_reads_as_its_base(name):
    """A metric split by cell (`<base>.<suffix>`, moving another end-to-end
    metric there) reads and traces exactly what its base does."""
    of, base = spec.module("metrics", name), spec.module("metrics", name.rsplit(".", 1)[0])
    assert of.read is base.read
    for key in ("SPANS", "KERNELS"):
        assert getattr(of, key, None) == getattr(base, key, None)

@pytest.mark.parametrize("cell", CELLS)
def test_traffic_end_to_end(cell, capsys):
    out = run_small(cell)
    assert set(out) >= {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(out)[-1] == "checks"
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {m["name"] for m in spec.Spec().end_to_end(spec.Spec().cell(cell))}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    json.dumps(out)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_spans(cell):
    """Every metric that the cell reads from spans is there on the CPU (the
    device trace's are not)."""
    out = run_small(cell, trace_=True)
    assert out["correct"]
    sp = spec.Spec()
    spanned = {m["name"] for m in sp.per_layer(sp.cell(cell)) if m["source"] == "program_span"}
    assert spanned <= set(out["metrics"])


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(cell, fault):
    out = run_small(cell, fault=fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [None, "control"])
@pytest.mark.parametrize("cell", ["s20m1.worker.inproc", "s20m1.worker.http"])
def test_four_shards(cell, fault):
    """A worker's MSM over four shards, as a four-card cell runs it: correct,
    and the control is caught."""
    out = run_small(cell, fault=fault, overrides={"cards": 4})
    assert out["correct"] == (fault is None), out["checks"]


def test_reference_agrees_with_the_port():
    from fourier_tpu_torch.constants import R
    from fourier_tpu_torch.refimpl import curve as rc
    from fourier_tpu_torch.refimpl import poly

    rnd = random.Random(5)
    vals = [rnd.randrange(R) for _ in range(64)]
    assert reference.intt(vals, 6) == poly.ntt(vals, 6, inverse=True)
    for k in (0, 1, 7, R - 1, rnd.randrange(R)):
        pt = reference.g1_mul(reference.G1, k)
        assert reference.g1_bytes(pt) == rc.g1_to_bytes(rc.g1_mul(rc.G1_GEN, k))
    assert reference.R == R


def test_wire_forms():
    from fourier_tpu_torch.ops.limbs import ints_to_vec

    rng = data._rng(3, "t")
    be = data.words_to_be(data.random_fr(rng, 257))
    ints = data.be_to_ints(be)
    assert all(v < reference.R for v in ints)
    assert data.b64_strings(be) == [base64.b64encode(v.to_bytes(32, "big")).decode().rstrip("=")
                                    for v in ints]
    assert (data.be_to_limbs(be) == ints_to_vec(ints, 16)).all()
    assert (data.ints_to_be(ints) == be).all()
    assert faults._ints(data.be_to_limbs(be)) == ints
    assert (data.limbs_to_be(data.be_to_limbs(be)) == be).all()
    assert (data.strings_to_be(data.b64_strings(be)) == be).all()


def test_pool_rows_are_distinct_and_seeded():
    a, b = data.Pool(9, 64, strings=True), data.Pool(9, 64, strings=True)
    rows = [tuple(a.row(k)) for k in range(200)]
    assert len(set(rows)) == 200
    assert rows == [tuple(b.row(k)) for k in range(200)]
    assert data.b64_strings(a.row_be(17)) == list(rows[17])
    assert data.secrets(9) == data.secrets(9) != data.secrets(10)


@pytest.mark.parametrize("c,windows", [(16, 16), (8, 32), (13, 20)])
def test_accumulate_work_counts_the_programs_buckets(c, windows):
    """The yardstick's count of K1's mixed adds equals what the port's
    bucket runs give K1 for the same scalars."""
    from fourier_tpu_torch.ops import msm_fused as mf

    n = 512
    limbs = data.be_to_limbs(data.words_to_be(data.random_fr(data._rng(1, "k1"), n)))
    sc = torch.as_tensor(limbs.astype(np.int64))
    digits, neg = mf.bgmw_digits_for(sc, c, windows)
    inf = torch.zeros(windows * n, dtype=torch.bool)
    _, start, count, _ = mf.bucket_runs(inf, digits, c, neg)
    adds = int((count.to(torch.int64).clamp(min=1) - 1).sum())
    mads, nbytes = roofline.accumulate_work(limbs, c, windows)
    assert mads == adds * roofline.MADD_PRODUCTS * roofline.MADS_PER_PRODUCT
    slots = start.shape[0]
    assert nbytes == (windows * n * 25 + 2 * slots) * 4 + 3 * roofline.COORD_BYTES * slots


def _fake_trace(events):
    dt = trace.DeviceTrace.__new__(trace.DeviceTrace)
    dt.devices, dt.t0_ns, dt.t1_ns = [0], 0, 1000
    dt.kernels = ("accumulate",)
    dt.prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    return dt


def _ev(name, start, dur, dev=torch.autograd.DeviceType.CUDA):
    return types.SimpleNamespace(name=lambda: name, start_ns=lambda: start,
                                 duration_ns=lambda: dur, device_type=lambda: dev,
                                 device_index=lambda: 0, activity_type=lambda: "kernel")


def test_trace_analysis():
    """Busy time is the union of the card's work; idle gaps are named by
    the span around them; the named kernels' events are kept."""
    events = [_ev("accumulate_pieces_kernel", 100, 50), _ev("other", 120, 60),
              _ev("accumulate_slots_kernel", 400, 10), _ev("Memcpy DtoH", 600, 100),
              _ev("cudaLaunchKernel", 100, 900, torch.autograd.DeviceType.CPU)]
    records = [{"w0": 50, "w1": 450, "name": "msm"}, {"w0": 460, "w1": 580, "name": "msm"},
               {"w0": 0, "w1": 1000, "name": "worker_commit"}]
    out = _fake_trace(events).analyse(1e-6, records)
    assert out["busy_s"] == pytest.approx((80 + 10 + 100) * 1e-9)
    assert out["window_s"] == 1e-6
    assert out["kernels"] == [["accumulate_pieces_kernel", 100, pytest.approx(50e-9)],
                              ["accumulate_slots_kernel", 400, pytest.approx(10e-9)]]
    gaps = dict(out["idle_gaps"])
    # (0, 100) and (180, 400) by the first msm, (410, 600) by the second,
    # (700, 1000) by worker_commit alone
    assert gaps == pytest.approx({"idle in msm": 510e-9, "idle in worker_commit": 300e-9})


def test_accumulate_roofline_pairs_commits_with_their_kernels():
    """K1's share: each commit's bound, counted from the scalars it sent,
    over the K1 time inside its MSM span; an MSM without both K1 kernels
    is left out of both sums."""
    n, c, windows = 256, 8, 32
    be = [data.words_to_be(data.random_fr(data._rng(k, "r"), n)) for k in range(2)]
    spans = [{"name": "worker_commit", "parent": None, "w0": 0, "w1": 500},
             {"name": "msm", "parent": "worker_commit", "w0": 10, "w1": 400},
             {"name": "worker_commit", "parent": None, "w0": 600, "w1": 900},
             {"name": "msm", "parent": "worker_commit", "w0": 610, "w1": 800}]
    kernels = [["accumulate_pieces_kernel", 100, 2e-3], ["accumulate_slots_kernel", 300, 1e-3],
               ["accumulate_pieces_kernel", 700, 5e-3]]
    run = {"trace": {"kernels": kernels}, "peak": {"imad_per_s": 1e13}, "spans": spans,
           "msm_layout": {"c": c, "windows": windows, "shards": 1},
           "commits": [lambda: be[0], lambda: be[1]]}
    mads, nbytes = roofline.accumulate_work(data.be_to_limbs(be[0]), c, windows)
    want = 100 * roofline.bound_s(mads, nbytes, 1e13)[0] / 3e-3
    assert spec.reader("accumulate_roofline")(run) == pytest.approx(want)
    assert spec.reader("accumulate_roofline")({**run, "commits": run["commits"][:1]}) is None
    assert spec.reader("accumulate_roofline")(
        {**run, "msm_layout": {"c": c, "windows": windows, "shards": 4}}) is None


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_and_a_plain_reference():
    files = [os.path.join(d, f) for d, _, fs in os.walk(HERE) for f in fs if f.endswith(".py")]
    for path in files:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "fourier_tpu"}, path
    for name in ("reference.py", "data.py", "check.py"):
        tops = {n.split(".")[0] for n in _imports(os.path.join(HERE, name))}
        assert "fourier_tpu_torch" not in tops and "torch" not in tops, name


def test_without_a_card_the_run_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run([sys.executable, os.path.join(HERE, "run.py"), "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_cuda_inproc_cell_runs(card):
    res = subprocess.run([sys.executable, os.path.join(HERE, "run.py"), "--workload",
                          "s20m1.worker.inproc", "--seed", "7", "--seconds", "5", "--trace", "0"],
                         capture_output=True, text=True, timeout=900)
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert res.returncode == 0 and out["correct"]
