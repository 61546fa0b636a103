"""Several cards or processes: process groups, the sharded MSMs, the whole
Pianist round as one call, and the process wiring.

Port of ``fourier_tpu.parallel``.  Where the reference maps workers and
table shards onto a device mesh and runs one SPMD program, the port runs
one process a card (or a CPU process) in a ``torch.distributed`` group:
each rank holds its share of the workers or of the table rows, and
collectives (``all_gather``, ``all_to_all_single``) move the per-worker
results and the bucket slices between ranks.  On one device every entry
runs in process with no collective.  See ``mesh`` (groups and the
collectives), ``msm_fused_sharded`` (one MSM split over ranks),
``prove_sharded`` (the round as one call) and ``multihost`` (process
groups over TCP; the multi-process dryrun).  The reference's test-only
``msm_sharded`` has no counterpart.
"""
