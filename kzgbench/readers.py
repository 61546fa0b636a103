"""What the metric readers (kzgbench/metrics/) share: a run's request
latencies, its spans and its device trace.  A reader that finds nothing
to read returns None."""

from __future__ import annotations

import statistics


def latencies(run: dict, method: str) -> list[float]:
    """Seconds of every request of `method` in the window, in order."""
    return [t1 - t0 for m, t0, t1, _ in run["requests"] if m == method]


def p90_ms(run: dict, method: str):
    """The 90th percentile, interpolated between the order statistics
    (one sample: itself)."""
    xs = latencies(run, method)
    if len(xs) < 2:
        return xs[0] * 1e3 if xs else None
    return statistics.quantiles(xs, n=10, method="inclusive")[8] * 1e3


def spans(run: dict, name: str, parent: str | None = "*") -> list[float]:
    """Seconds of each span of `name` (inside a span of `parent`, where
    given), in the order they began."""
    return [r["t1"] - r["t0"] for r in run.get("spans") or []
            if r["name"] == name and (parent == "*" or r["parent"] == parent)]


def spread(n: int, k: int) -> list[int]:
    """At most k indices of range(n), evenly spread, the first and last
    among them."""
    if n <= k:
        return list(range(n))
    return sorted({round(j * (n - 1) / (k - 1)) for j in range(k)})


def median_ms(xs):
    return statistics.median(xs) * 1e3 if xs else None


def paired_median_ms(a: list[float], b: list[float]):
    """Median of a[k] - b[k]: two series of one request each, in order."""
    if not a or len(a) != len(b):
        return None
    return median_ms([x - y for x, y in zip(a, b)])


def idle_pct(run: dict):
    tr = run.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
