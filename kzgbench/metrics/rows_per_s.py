"""rows_per_s: rows committed and opened over the window, which ends with
the last row's last answer (rows/s)."""


def read(run):
    w = run["window"]
    if run["unit"] != "row" or w["done"] <= w["start"]:
        return None
    return w["steps"] / (w["done"] - w["start"])
