"""Monotonic clock backing the leader lease.

Copied from ``riak_ensemble_tpu/utils/clock.py``.  The C++ source
(``csrc/host/clock.cc``, a copy of the reference's ``native/clock.cc``)
is one of the sources of the port's host library, which
:func:`..ops.build.load_host` builds at first use — the role of the
reference's only C NIF (c_src/riak_ensemble_clock.c):
CLOCK_BOOTTIME-preferred readings immune to wall-clock jumps and
suspend/resume gaps, consumed by the lease check
(riak_ensemble_lease.erl:76-88).  Falls back to Python's
``time.clock_gettime(CLOCK_BOOTTIME)`` / ``time.monotonic_ns`` when
the host library can't be built, as the reference does.
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Optional

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def load() -> Optional[ctypes.CDLL]:
    """The host library with the clock's C interface typed, building it
    if needed; None when it cannot be built."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        from riak_ensemble_tpu_torch.ops import build
        try:
            lib = build.load_host()
        except (RuntimeError, OSError):
            return None
        lib.retpu_monotonic_time_ns.restype = ctypes.c_int64
        lib.retpu_monotonic_time_ms.restype = ctypes.c_int64
        lib.retpu_clock_is_boottime.restype = ctypes.c_int
        _lib = lib
        return _lib


def _py_monotonic_ns() -> int:
    try:
        return time.clock_gettime_ns(time.CLOCK_BOOTTIME)  # type: ignore[attr-defined]
    except (AttributeError, OSError):
        return time.monotonic_ns()


def monotonic_time_ns() -> int:
    lib = load()
    if lib is not None:
        t = lib.retpu_monotonic_time_ns()
        if t >= 0:
            return t
    return _py_monotonic_ns()


def monotonic_time_ms() -> int:
    """riak_ensemble_clock:monotonic_time_ms/0."""
    return monotonic_time_ns() // 1_000_000


def monotonic_time() -> float:
    """Seconds as float — the host runtime's clock interface (inject
    into :class:`riak_ensemble_tpu_torch.lease.Lease` in production; the
    virtual runtime injects simulated time instead)."""
    return monotonic_time_ns() / 1e9


def is_boottime() -> bool:
    lib = load()
    if lib is not None:
        return bool(lib.retpu_clock_is_boottime())
    return hasattr(time, "CLOCK_BOOTTIME")
