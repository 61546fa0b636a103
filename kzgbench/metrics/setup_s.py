"""setup_s: process start to the window's first request (s)."""


def read(run):
    return run["setup_s"]
