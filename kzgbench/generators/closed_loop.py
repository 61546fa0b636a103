"""One prover in a closed loop: kzgbench/loop.py's generator, run by rows or
by rounds as the mix says."""

from kzgbench import check, loop


def make(mix: dict, tr, pool, M: int) -> loop.Loop:
    return loop.Loop(mix, tr, pool, M)


compare = check.compare
