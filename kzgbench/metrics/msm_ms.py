"""msm_ms: the median _msm_dispatch span of a worker_commit (ms)."""

from kzgbench import readers

SPANS = [("fourier_tpu_torch.models.piano:PianoBackend.worker_commit", "worker_commit"),
         ("fourier_tpu_torch.models.piano:_msm_dispatch", "msm")]


def read(run):
    return readers.median_ms(readers.spans(run, "msm", "worker_commit"))
