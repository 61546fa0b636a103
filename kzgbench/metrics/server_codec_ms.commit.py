"""server_codec_ms.commit: per workerCommit, the server's handling of the
HTTP request (_HTTPHandler.do_POST: the body's read, the parse, the wait
for the device lock, the decode, the encode and the reply's write) less
its worker_commit span; the median (ms).  The port marks the same
intervals as its `server.request` and `server.call` spans."""

import bisect

from kzgbench import readers

SPANS = [("fourier_tpu_torch.runtime.server:_HTTPHandler.do_POST", "server.request"),
         ("fourier_tpu_torch.models.piano:PianoBackend.worker_commit", "worker_commit")]


def read(run):
    if run["transport"] != "http":
        return None
    recs = run.get("spans") or []
    reqs = sorted((r for r in recs if r["name"] == "server.request"), key=lambda r: r["t0"])
    starts = [r["t0"] for r in reqs]
    out = []
    for c in recs:
        if c["name"] != "worker_commit" or c["parent"] != "server.request":
            continue
        j = bisect.bisect_right(starts, c["t0"]) - 1
        if j >= 0 and c["t1"] <= reqs[j]["t1"]:
            out.append((reqs[j]["t1"] - reqs[j]["t0"]) - (c["t1"] - c["t0"]))
    return readers.median_ms(out)
