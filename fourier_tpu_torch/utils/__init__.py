"""Shared utilities: spans and phase timing."""

from .trace import TRACER, span, timed  # noqa: F401
