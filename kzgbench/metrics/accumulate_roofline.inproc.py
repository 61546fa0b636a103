"""accumulate_roofline.inproc: accumulate_roofline
(kzgbench/metrics/accumulate_roofline.py) in the in-process cell, which
reports no commit or open latency end to end (their runs spread wider
than the largest bound): there it moves rows_per_s."""

from kzgbench import spec

_OF = spec.module("metrics", "accumulate_roofline")
SPANS, KERNELS, read = _OF.SPANS, _OF.KERNELS, _OF.read
