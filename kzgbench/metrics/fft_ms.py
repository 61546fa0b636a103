"""fft_ms: the median span of the server's fft_limbs in an fft request:
conversions, upload, the NTT and the read-back (ms)."""

from kzgbench import readers

SPANS = [("fourier_tpu_torch.models.piano:PianoFFTSettings.fft_limbs", "fft")]


def read(run):
    return readers.median_ms(readers.spans(run, "fft"))
