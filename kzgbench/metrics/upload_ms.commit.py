"""upload_ms.commit: per worker_commit, the span of its coefficients'
upload (PianoBackend._coeffs_to_device: the limbs widened to int64 on the
host and copied to the card from pageable memory, to a synchronize); the
median (ms).  The port marks the same call as its `commit.upload` span."""

from kzgbench import readers

SPANS = [("fourier_tpu_torch.models.piano:PianoBackend.worker_commit", "worker_commit"),
         ("fourier_tpu_torch.models.piano:PianoBackend._coeffs_to_device", "upload")]


def read(run):
    return readers.median_ms(readers.spans(run, "upload", "worker_commit"))
