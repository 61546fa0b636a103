"""idle_pct.worker: share of the traced window in which no kernel, copy or
fill ran on the card (on several cards, their mean) (%).  The spans name
the trace's idle gaps by the backend call the host was in."""

from kzgbench import readers

SPANS = [("fourier_tpu_torch.models.piano:PianoBackend.worker_commit", "worker_commit"),
         ("fourier_tpu_torch.models.piano:PianoBackend.worker_open", "worker_open")]


def read(run):
    return readers.idle_pct(run)
