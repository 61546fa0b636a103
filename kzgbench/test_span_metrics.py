"""CPU tests of the per-layer metrics that read the boundaries the port
marks as its `commit.upload` and `server.request` spans: a traced run of
each cell that lists the upload's metric reports them, and the server's
share of a commit pairs each commit with the HTTP request that holds it."""

from __future__ import annotations

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from kzgbench import harness, spec  # noqa: E402
from kzgbench.test_kzgbench import small, window_s  # noqa: E402

SEED = 2**31 + 1013


def reading(cell: dict, metric: str) -> str | None:
    """The name under which the cell reads `metric`: itself, or the
    metric split by cell (`<metric>.<suffix>`)."""
    names = {m["name"] for m in spec.Spec().per_layer(cell)}
    return next((n for n in sorted(names) if n == metric or n.startswith(metric + ".")), None)


def cells_reading(metric: str) -> list[str]:
    return [w["name"] for w in spec.Spec().bench["workloads"] if reading(w, metric)]


@pytest.mark.parametrize("cell", cells_reading("upload_ms.commit"))
def test_traced_run_reports_the_new_metrics(cell):
    out = harness.run_cell(cell, SEED, window_s(cell), True, device="cpu",
                           overrides=small(cell))
    assert out["correct"]
    names = set(out["metrics"])
    sp = spec.Spec()
    upload = reading(sp.cell(cell), "upload_ms.commit")
    assert upload in names
    http = sp.traffic(sp.cell(cell))["transport"] == "http"
    assert ("server_codec_ms.commit" in names) == http
    assert all(out["metrics"][n]["value"] > 0 for n in names & {upload, "server_codec_ms.commit"})


def _span(name, parent, t0, t1):
    return {"name": name, "parent": parent, "t0": t0, "t1": t1}


def test_server_codec_pairs_each_commit_with_its_request():
    """A commit's server share is its request's span less its own; requests
    that hold no commit (an open, a verify) are not read."""
    spans = [_span("server.request", None, 0.0, 1.0),
             _span("worker_commit", "server.request", 0.2, 0.9),
             _span("server.request", None, 2.0, 5.0),
             _span("worker_open", "server.request", 2.5, 4.0),
             _span("server.request", None, 6.0, 6.5),
             _span("worker_commit", "server.request", 6.1, 6.2)]
    read = spec.reader("server_codec_ms.commit")
    # (1.0 - 0.7) and (0.5 - 0.1): median 0.35 s
    assert read({"transport": "http", "spans": spans}) == pytest.approx(350.0)
    assert read({"transport": "inproc", "spans": spans}) is None
    assert read({"transport": "http", "spans": spans[2:4]}) is None


def test_upload_reads_the_commits_uploads_alone():
    spans = [_span("upload", "worker_commit", 0.0, 0.02), _span("upload", "worker_open", 1.0, 1.5),
             _span("upload", "worker_commit", 2.0, 2.04)]
    assert spec.reader("upload_ms.commit")({"spans": spans}) == pytest.approx(30.0)
    assert spec.reader("upload_ms.commit")({"spans": []}) is None
