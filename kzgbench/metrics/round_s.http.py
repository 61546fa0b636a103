"""round_s.http: round_s (kzgbench/metrics/round_s.py), seconds a Pianist
round over the Client, as a per-layer reading: its runs spread wider than
the largest bound an end-to-end metric may have (s)."""

from kzgbench import spec

_OF = spec.module("metrics", "round_s")
read = _OF.read
