"""round_s: seconds a Pianist round, over the rounds completed in the
window: from its start to the end of the last round that completed within
--seconds (s)."""


def read(run):
    w = run["window"]
    if run["unit"] != "round" or w["steps"] == 0:
        return None
    return (w["done"] - w["start"]) / w["steps"]
