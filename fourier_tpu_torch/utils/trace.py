"""The port's spans and phase timing: one tracer a process, off by default.

A span is a named interval of one thread, on the host's Unix-epoch clock
(``time.time_ns()``, the clock ``torch.profiler`` stamps its kineto events
with, in every process of a host), so spans taken in a client and a
server name the gaps of either's device trace.  Each span records its
name, the span open around it on its thread (``parent``), the request it
serves (``request``, set at the request's boundary: the client makes an
id and sends it in the ``X-Fourier-Request`` header, the server takes it
from there or numbers the request itself) and its counts, the keyword
arguments and what ``add`` gives it before it closes::

    with TRACER.request("server.request", rid=header):
        with span("server.parse"):
            ...
        with span("msm", sync=True):      # ends in a synchronize of the cards
            ...

``TRACER.enable()`` turns it on; ``TRACER.drain()`` takes the spans kept
so far (kept in memory, under a lock, and written nowhere).  Off, a span
is one flag test and a shared null context: no clock read, no synchronize
and no record.

``timed`` is the reference's utils::timed wrapper (reference
src/utils.rs:1-8): a span that ends in a synchronize, and a debug line of
the phase's wall-clock seconds, which then include its device work.
"""

from __future__ import annotations

import contextvars
import itertools
import logging
import os
import sys
import threading
import time
from typing import Callable, TypeVar

logger = logging.getLogger("fourier_tpu")

T = TypeVar("T")

# the HTTP header that carries a request's id from the client to the
# server, sent only while the client's tracer is on
REQUEST_HEADER = "X-Fourier-Request"


def sync_cards() -> None:
    """Wait for the work queued on every card this process has used."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)


class _Null:
    """The span of a tracer that is off."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **counts) -> None:
        pass


_NULL = _Null()


class _Span:
    def __init__(self, tracer: "Tracer", name: str, sync: bool, counts: dict, rid=None):
        self.tracer, self.sync, self.rid = tracer, sync, rid
        self.rec = {"name": name, **counts}

    def __enter__(self):
        tr = self.tracer
        if self.rid is not None:
            self.token = tr._request.set(self.rid)
        stack = tr._stack()
        self.rec["parent"] = stack[-1].rec["name"] if stack else None
        self.rec["request"] = tr._request.get()
        stack.append(self)
        self.rec["t0"] = time.time_ns()
        return self

    def __exit__(self, *exc):
        try:
            if self.sync:
                sync_cards()
        finally:
            self.rec["t1"] = time.time_ns()
            tr = self.tracer
            tr._stack().pop()
            if self.rid is not None:
                tr._request.reset(self.token)
            with tr._lock:
                tr._records.append(self.rec)
        return False

    def add(self, **counts) -> None:
        self.rec.update(counts)


class Tracer:
    """Spans of this process, kept until drained."""

    def __init__(self):
        self.on = False
        self._lock = threading.Lock()
        self._records: list[dict] = []
        self._local = threading.local()
        self._request = contextvars.ContextVar("fourier_request", default=None)
        self._ids = itertools.count(1)

    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, sync: bool = False, **counts):
        """A span of `name`; `sync`: its end waits for the cards (only
        while tracing is on; for spans that end with device work queued)."""
        if not self.on:
            return _NULL
        return _Span(self, name, sync, counts)

    def request(self, name: str, rid: str | None = None, **counts):
        """A span that opens a request: it and the spans inside it on this
        thread carry `rid`, or a new id of this process."""
        if not self.on:
            return _NULL
        return _Span(self, name, False, counts, rid or f"{os.getpid()}-{next(self._ids)}")

    def current_request(self) -> str | None:
        return self._request.get()

    def add(self, **counts) -> None:
        """Add counts to the innermost span open on this thread."""
        if self.on:
            stack = self._stack()
            if stack:
                stack[-1].add(**counts)

    def drain(self, request: str | None = None) -> list[dict]:
        """The spans closed so far (those of one request, where given), in
        the order they closed; they are no longer kept."""
        with self._lock:
            if request is None:
                out, self._records = self._records, []
            else:
                out = [r for r in self._records if r["request"] == request]
                self._records = [r for r in self._records if r["request"] != request]
        return out


TRACER = Tracer()
span = TRACER.span


def timed(name: str, f: Callable[[], T]) -> T:
    start = time.perf_counter()
    with span(name, sync=True):
        out = f()
    if logger.isEnabledFor(logging.DEBUG):
        sync_cards()
        logger.debug("%s took %.3fs", name, time.perf_counter() - start)
    return out
