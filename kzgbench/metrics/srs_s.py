"""srs_s: set-up's generate_trusted_setup from the seed's secrets, to a
synchronize of the cards (s)."""


def read(run):
    return (run.get("setup") or {}).get("srs_s")
