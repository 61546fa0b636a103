"""tables_s: set-up's PianoPrecompute.generate and the tables' placement
on the MSM's shards, to a synchronize of the cards (s)."""


def read(run):
    return (run.get("setup") or {}).get("tables_s")
