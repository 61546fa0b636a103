"""open_p90_ms: 90th percentile of every workerOpen's latency in the
window, from the call to its parsed answer (ms)."""

from kzgbench import readers


def read(run):
    return readers.p90_ms(run, "workerOpen")
