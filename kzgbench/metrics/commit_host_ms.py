"""commit_host_ms: per worker_commit, its span less its MSM's
(_msm_dispatch) span: the coefficients' upload, the limb conversions, the
lift and the point's return to the host; the median (ms)."""

from kzgbench import readers

SPANS = [("fourier_tpu_torch.models.piano:PianoBackend.worker_commit", "worker_commit"),
         ("fourier_tpu_torch.models.piano:_msm_dispatch", "msm")]


def read(run):
    return readers.paired_median_ms(readers.spans(run, "worker_commit"),
                                    readers.spans(run, "msm", "worker_commit"))
