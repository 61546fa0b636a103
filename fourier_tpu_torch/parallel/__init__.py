"""Several cards or processes: groups of shards, the sharded MSMs, the
whole Pianist round as one call, and the process wiring.

Port of ``fourier_tpu.parallel``.  Where the reference maps workers and
table shards onto a device mesh and runs one SPMD program, the port runs
the same per-rank code over a group of one of two kinds: one process a
card (or a CPU process) in a ``torch.distributed`` group, or one thread a
device in one process (``mesh.LocalMesh``, the server's intra-worker
split, the counterpart of the reference's local mesh).  Each rank holds
its share of the workers or of the table rows, and collectives
(``all_gather_last``, ``all_to_all_last``) move the per-worker results and
the bucket slices between ranks.  On one device every entry runs with no
collective.  See ``mesh`` (groups and the collectives),
``msm_fused_sharded`` (one BGMW or tableless MSM split over ranks),
``msm_sharded`` (the tableless MSM split along its points),
``prove_sharded`` (the round as one call) and ``multihost`` (process
groups over TCP; the multi-process dryrun).
"""
