"""YCSB's Zipfian generators, vectorized.

:class:`Zipfian` is YCSB's bounded ``ZipfianGenerator``: Gray et al.,
"Quickly generating billion-record synthetic databases" (SIGMOD 1994),
over ``n`` items with constant ``theta`` (YCSB's default 0.99), item 0
the most popular.  ``P(0) = 1 / zeta(n)``, ``P(1) = 0.5**theta /
zeta(n)``, and the rest follow ``n * (eta * u - eta + 1) ** alpha``.

:class:`ScrambledZipfian` is ``ScrambledZipfianGenerator``, what YCSB's
core workloads draw keys with under ``requestdistribution=zipfian``: a
Zipfian item over ``ITEM_COUNT`` items (with YCSB's precomputed
``ZETAN``), hashed by :func:`fnv64` onto the ``n`` records, so that the
popular records lie scattered over the key space.
"""

from __future__ import annotations

import numpy as np


def zeta(n: int, theta: float) -> float:
    """The generalized harmonic number ``sum_{i=1..n} 1 / i**theta``."""
    return float(np.sum(1.0 / np.arange(1, n + 1, dtype=np.float64)
                        ** theta))


def fnv64(x) -> np.ndarray:
    """YCSB's ``Utils.fnvhash64`` of each int64 in ``x``: FNV-1a over the
    value's 8 bytes, low byte first, as a non-negative int64."""
    v = np.asarray(x, dtype=np.int64).astype(np.uint64)
    h = np.full(v.shape, 0xCBF29CE484222325, dtype=np.uint64)
    prime = np.uint64(1099511628211)
    with np.errstate(over="ignore"):
        for _ in range(8):
            h ^= v & np.uint64(0xFF)
            v >>= np.uint64(8)
            h *= prime
    return np.abs(h.view(np.int64))


class Zipfian:
    """Items ``0 .. n - 1`` drawn as YCSB's bounded Zipfian draws them
    (``zetan``: ``zeta(n, theta)`` where YCSB gives it precomputed)."""

    def __init__(self, n: int, theta: float = 0.99,
                 zetan: float = 0.0) -> None:
        if n < 1:
            raise ValueError(f"Zipfian over {n} items")
        if not 0.0 < theta < 1.0:
            raise ValueError(f"theta must lie in (0, 1), got {theta}")
        self.n, self.theta = int(n), float(theta)
        self.zetan = zetan or zeta(self.n, theta)
        zeta2 = zeta(2, theta)
        self.alpha = 1.0 / (1.0 - theta)
        self.eta = ((1.0 - (2.0 / self.n) ** (1.0 - theta))
                    / (1.0 - zeta2 / self.zetan)) if self.n > 2 else 0.0
        self.half_pow = 0.5 ** theta

    def draw(self, rng: np.random.Generator, shape) -> np.ndarray:
        """Int64 items of ``shape`` from ``rng``."""
        u = rng.random(shape)
        uz = u * self.zetan
        out = (self.n * np.power(self.eta * u - self.eta + 1.0, self.alpha)
               ).astype(np.int64)
        out = np.where(uz < 1.0 + self.half_pow, 1, out)
        out = np.where(uz < 1.0, 0, out)
        return np.minimum(out, self.n - 1)


class ScrambledZipfian:
    """Records ``0 .. n - 1`` drawn as YCSB's ``ScrambledZipfianGenerator``
    draws them with its default constant: an item of a Zipfian over
    ``ITEM_COUNT + 1`` items (``ZipfianGenerator(0, ITEM_COUNT)``), then
    ``fnv64(item) % n``."""

    #: YCSB's ``ScrambledZipfianGenerator.ITEM_COUNT`` and ``ZETAN``
    #: (``zeta(ITEM_COUNT, 0.99)``, precomputed there)
    ITEM_COUNT = 10_000_000_000
    ZETAN = 26.46902820178302
    THETA = 0.99

    def __init__(self, n: int) -> None:
        if n < 1:
            raise ValueError(f"Zipfian over {n} items")
        self.n = int(n)
        self.gen = Zipfian(self.ITEM_COUNT + 1, self.THETA, self.ZETAN)

    def draw(self, rng: np.random.Generator, shape) -> np.ndarray:
        return fnv64(self.gen.draw(rng, shape)) % self.n
