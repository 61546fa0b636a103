"""Shared utilities: phase timing, base64 wire encoding."""

from .timing import timed  # noqa: F401
