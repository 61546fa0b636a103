"""Phase timing (the port's copy of ``fourier_tpu.utils.timing``), mirroring the reference's utils::timed wrapper
(reference src/utils.rs:1-8): wall-clock every setup/IO phase at debug level.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, TypeVar

logger = logging.getLogger("fourier_tpu")

T = TypeVar("T")


def timed(name: str, f: Callable[[], T]) -> T:
    start = time.perf_counter()
    out = f()
    logger.debug("%s took %.3fs", name, time.perf_counter() - start)
    return out
