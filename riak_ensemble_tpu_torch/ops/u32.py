"""uint32 lanes carried as int32 bit patterns.

The reference computes its Merkle hashes on ``uint32`` arrays.  Torch
on the CPU implements neither ``>>`` nor ``+`` for ``torch.uint32``
(``NotImplementedError``), so the port stores every uint32 plane as the
int32 tensor with the same bits and does the arithmetic that is
sign-sensitive by hand:

- ``+``, ``*``, ``^``, ``|``, ``&`` and ``<<`` give the same bits on
  int32 as on uint32 (two's-complement wraparound), so they are used
  directly;
- a right shift must be LOGICAL: int32 ``>>`` is arithmetic, so the
  sign-extended high bits are masked off (:func:`shr`);
- sums mod 2^32 pass ``dtype=torch.int32`` (torch would otherwise widen
  an int32 sum to int64);
- uint32 constants such as ``0xCC9E2D51`` are passed as their int32
  value (:func:`i32`).
"""

from __future__ import annotations

import numpy as np
import torch


def i32(c: int) -> int:
    """The int32 value with the bits of uint32 constant ``c``."""
    c &= 0xFFFFFFFF
    return c - (1 << 32) if c >= (1 << 31) else c


def shr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of uint32 bit patterns: the arithmetic
    shift's sign-extended top ``r`` bits are masked off."""
    return (x >> r) & ((1 << (32 - r)) - 1)


def rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    """Rotate left by ``r`` (0 < r < 32)."""
    return (x << r) | shr(x, 32 - r)


def mul(x: torch.Tensor, c: int) -> torch.Tensor:
    """Wraparound multiply by a uint32 constant ``c`` (int32 products
    wrap mod 2^32 exactly as uint32 ones do)."""
    return x * i32(c)


def sum32(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum mod 2^32 along ``dim``, kept int32 (the reference's
    ``sum(dtype=uint32)``)."""
    return x.sum(dim=dim, dtype=torch.int32)


def from_uint32(a: np.ndarray) -> np.ndarray:
    """numpy uint32 → the int32 view with the same bits."""
    return np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)


def to_uint32(a: np.ndarray) -> np.ndarray:
    """numpy int32 bit patterns → the uint32 view."""
    return np.ascontiguousarray(a, dtype=np.int32).view(np.uint32)
