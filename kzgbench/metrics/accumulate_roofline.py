"""accumulate_roofline: K1 (ops/kernels.py `accumulate`, both of its
kernels) in the window's commits, as a share of its roofline: the sum of
the bounds over the sum of the K1 kernels' device seconds inside each
commit's MSM span (profiler), over at most SAMPLE commits spread over the
window (%).

A commit's bound (kzgbench/roofline.py, at the peak of the card read in
the run) is counted after the window from the scalars that commit sent,
at the tables' window c and windows a row.  An MSM over several cards, or
one whose K1 kernels the trace does not hold, is left out of both sums."""

import bisect

from kzgbench import data, readers, roofline

SPANS = [("fourier_tpu_torch.models.piano:PianoBackend.worker_commit", "worker_commit"),
         ("fourier_tpu_torch.models.piano:_msm_dispatch", "msm")]
KERNELS = ("accumulate_pieces_kernel", "accumulate_slots_kernel")
SAMPLE = 16


def read(run):
    tr, peak, layout = run.get("trace"), run.get("peak"), run.get("msm_layout")
    if not tr or not peak or not layout or layout["shards"] != 1 or not layout["windows"]:
        return None
    msms = [r for r in run.get("spans") or []
            if r["name"] == "msm" and r["parent"] == "worker_commit"]
    commits = run.get("commits") or []
    if not msms or len(msms) != len(commits):
        return None
    k1 = [k for k in tr["kernels"] if any(n in k[0] for n in KERNELS)]
    starts = [k[1] for k in k1]
    bound = seconds = 0.0
    for j in readers.spread(len(msms), SAMPLE):
        inside = k1[bisect.bisect_left(starts, msms[j]["w0"]):
                    bisect.bisect_right(starts, msms[j]["w1"])]
        if not all(any(n in k[0] for k in inside) for n in KERNELS):
            continue
        limbs = data.be_to_limbs(commits[j]())
        mads, nbytes = roofline.accumulate_work(limbs, layout["c"], layout["windows"])
        bound += roofline.bound_s(mads, nbytes, peak["imad_per_s"])[0]
        seconds += sum(k[2] for k in inside)
    return 100.0 * bound / seconds if seconds else None
