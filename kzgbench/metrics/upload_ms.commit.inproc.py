"""upload_ms.commit.inproc: upload_ms.commit
(kzgbench/metrics/upload_ms.commit.py) in the in-process cell, which
reports no commit or open latency end to end (their runs spread wider
than the largest bound): there it moves rows_per_s."""

from kzgbench import spec

_OF = spec.module("metrics", "upload_ms.commit")
SPANS, read = _OF.SPANS, _OF.read
