"""wire_ms.commit: per workerCommit, the client's latency less the
server's worker_commit span: the client, the wire codec, HTTP and the
server's parse and encode; the median (ms)."""

from kzgbench import readers

SPANS = [("fourier_tpu_torch.models.piano:PianoBackend.worker_commit", "worker_commit")]


def read(run):
    if run["transport"] != "http":
        return None
    return readers.paired_median_ms(readers.latencies(run, "workerCommit"),
                                    readers.spans(run, "worker_commit"))
