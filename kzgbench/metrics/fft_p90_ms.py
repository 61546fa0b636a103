"""fft_p90_ms: 90th percentile of every fft request's latency in the
window (the row's inverse left NTT, which the row's commit and open then
carry), from the call to its parsed answer (ms)."""

from kzgbench import readers


def read(run):
    return readers.p90_ms(run, "fft")
