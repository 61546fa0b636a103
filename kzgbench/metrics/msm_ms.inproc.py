"""msm_ms.inproc: msm_ms (kzgbench/metrics/msm_ms.py) in the in-process
cell, which reports no commit or open latency end to end (their runs
spread wider than the largest bound): there it moves rows_per_s."""

from kzgbench import spec

_OF = spec.module("metrics", "msm_ms")
SPANS, read = _OF.SPANS, _OF.read
