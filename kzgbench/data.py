"""Everything a run sends, made from its seed: the setup secrets, the rows,
alpha and beta.

A row is T canonical Fr values, uniform below r.  A run makes a pool of
BASE_ROWS base rows at set-up; request k sends base row k mod BASE_ROWS
rotated left by an offset drawn from the seed, and no (base, offset) pair repeats, so no two
rows of a run are equal and building one costs a copy.  Values travel in
three forms: 32-byte big-endian rows (the reference's), the wire's base64
strings, and the program's [16, T] 16-bit limbs.
"""

from __future__ import annotations

import base64
import random

import numpy as np

from .reference import R

BASE_ROWS = 4
_R_WORDS = [(R >> (64 * k)) & (2**64 - 1) for k in range(4)]  # least significant first
_B64 = np.frombuffer(b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/",
                     np.uint8)


def _rng(seed: int, stream: str) -> np.random.Generator:
    words = [seed % 2**64] + list(stream.encode())
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence(words)))


def secrets(seed: int) -> tuple[bytes, bytes]:
    raw = _rng(seed, "secrets").bytes(64)
    return raw[:32], raw[32:]


def random_fr(rng: np.random.Generator, n: int) -> np.ndarray:
    """[n, 4] uint64 words, least significant first, uniform below r."""
    out = np.empty((n, 4), np.uint64)
    todo = np.arange(n)
    while todo.size:
        w = rng.integers(0, 2**64, size=(todo.size, 4), dtype=np.uint64)
        w[:, 3] &= np.uint64(2**63 - 1)
        below = np.zeros(todo.size, bool)
        decided = np.zeros(todo.size, bool)
        for k in (3, 2, 1, 0):
            lt = ~decided & (w[:, k] < np.uint64(_R_WORDS[k]))
            gt = ~decided & (w[:, k] > np.uint64(_R_WORDS[k]))
            below |= lt
            decided |= lt | gt
        out[todo[below]] = w[below]
        todo = todo[~below]
    return out


def words_to_be(words: np.ndarray) -> np.ndarray:
    """[n, 4] uint64 words -> [n, 32] uint8, big-endian."""
    return np.ascontiguousarray(words[:, ::-1]).astype(">u8").view(np.uint8).reshape(-1, 32)


def be_to_limbs(be: np.ndarray) -> np.ndarray:
    """[n, 32] big-endian bytes -> [16, n] uint32 16-bit limbs, least
    significant first."""
    le = be[:, ::-1].astype(np.uint32)
    return np.ascontiguousarray((le[:, 0::2] | (le[:, 1::2] << 8)).T)


def limbs_to_be(limbs) -> np.ndarray:
    """[16, n] 16-bit limbs -> [n, 32] big-endian bytes."""
    a = np.asarray(limbs, dtype=np.uint32)
    le = np.empty((a.shape[1], 32), np.uint8)
    le[:, 0::2] = (a.T & 0xFF).astype(np.uint8)
    le[:, 1::2] = (a.T >> 8).astype(np.uint8)
    return np.ascontiguousarray(le[:, ::-1])


def strings_to_be(strings) -> np.ndarray:
    """The wire's base64 strings, one a value -> [n, 32] big-endian bytes."""
    raw = b"".join(base64.b64decode(s + "=") for s in strings)
    return np.frombuffer(raw, np.uint8).reshape(-1, 32)


def be_to_ints(be: np.ndarray) -> list[int]:
    raw = be.tobytes()
    return [int.from_bytes(raw[k:k + 32], "big") for k in range(0, len(raw), 32)]


def ints_to_be(values) -> np.ndarray:
    return np.frombuffer(b"".join(v.to_bytes(32, "big") for v in values),
                         np.uint8).reshape(-1, 32)


def b64_strings(be: np.ndarray) -> list[str]:
    """[n, 32] bytes -> the wire's unpadded standard base64, one string a
    value (43 characters): the 33-byte zero-extended value's 44 characters
    less the last."""
    n = be.shape[0]
    ext = np.zeros((n, 33), np.uint8)
    ext[:, :32] = be
    g = ext.reshape(n, 11, 3).astype(np.uint32)
    v = (g[..., 0] << 16) | (g[..., 1] << 8) | g[..., 2]
    six = np.stack([(v >> 18) & 63, (v >> 12) & 63, (v >> 6) & 63, v & 63], axis=-1)
    text = _B64[six.reshape(n, 44)[:, :43]].tobytes().decode("ascii")
    return [text[k:k + 43] for k in range(0, len(text), 43)]


def b64(raw: bytes) -> str:
    return base64.b64encode(raw).decode().rstrip("=")


class Pool:
    """The rows and points of one run.  `row(k)` is the k-th row sent;
    `point(k)` the k-th fresh alpha or beta; `warm` rows serve the warm-up
    only."""

    def __init__(self, seed: int, T: int, strings: bool):
        rng = _rng(seed, "rows")
        self.T = T
        self.base_be = [words_to_be(random_fr(rng, T)) for _ in range(BASE_ROWS)]
        self.warm_be = words_to_be(random_fr(rng, T))
        self.base_str = [b64_strings(b) for b in self.base_be] if strings else None
        self.base_limbs = None if strings else [be_to_limbs(b) for b in self.base_be]
        self._offsets = random.Random(seed * 2 + 1)
        self._used: set = set()
        self._schedule: list = []
        self._points = _rng(seed, "points")
        self._point_list: list[bytes] = []
        self.warm_points = [words_to_be(random_fr(_rng(seed, "warm"), 2))[j].tobytes()
                            for j in range(2)]

    def key(self, k: int) -> tuple[int, int]:
        """(base, offset) of row k."""
        while len(self._schedule) <= k:
            if len(self._used) == len(self.base_be) * self.T:
                raise ValueError("every row of the pool has been sent")
            base = len(self._schedule) % len(self.base_be)
            off = self._offsets.randrange(self.T)
            while (base, off) in self._used:
                off = self._offsets.randrange(self.T)
            self._used.add((base, off))
            self._schedule.append((base, off))
        return self._schedule[k]

    def row(self, k: int):
        """Row k in the transport's form: strings or limbs."""
        base, off = self.key(k)
        if self.base_str is not None:
            s = self.base_str[base]
            return s[off:] + s[:off]
        a = self.base_limbs[base]
        return np.concatenate([a[:, off:], a[:, :off]], axis=1)

    def row_be(self, k: int) -> np.ndarray:
        base, off = self.key(k)
        return np.roll(self.base_be[base], -off, axis=0)

    def warm_row(self):
        if self.base_str is not None:
            return b64_strings(self.warm_be)
        return be_to_limbs(self.warm_be)

    def point(self, k: int) -> bytes:
        while len(self._point_list) <= k:
            self._point_list.append(words_to_be(random_fr(self._points, 1)).tobytes())
        return self._point_list[k]
