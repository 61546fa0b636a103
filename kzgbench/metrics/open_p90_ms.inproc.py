"""open_p90_ms.inproc: open_p90_ms (kzgbench/metrics/open_p90_ms.py) in the
in-process cell, which reports no commit or open latency end to end
(their runs spread wider than the largest bound): there it moves
rows_per_s."""

from kzgbench import spec

_OF = spec.module("metrics", "open_p90_ms")
read = _OF.read
