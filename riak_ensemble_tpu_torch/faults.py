"""Storage-fault and crash-point plane of the port.

Copied from ``riak_ensemble_tpu/faults.py``, its storage and crash half:
:class:`FaultPlan`'s storage rules and counters (``:120-466``),
``_parse_storage`` (``:523``) and ``_parse_class_values`` (``:547``),
:func:`from_env` (``:569``, limited to the storage knobs),
:func:`install` / :func:`clear` / :func:`plan` / :func:`active_plan`
(``:622-664``), and the seams the stores call: :func:`fsync_sleep`,
:func:`storage_raise`, :func:`torn_limit`, :func:`read_filter` and
:func:`crashpoint` (``:665-745``).  The environment knobs keep the
reference's names, so one environment drives both packages:
``RETPU_CRASHPOINT``, ``RETPU_FAULT_STORAGE``, ``RETPU_FAULT_TORN``,
``RETPU_FAULT_CORRUPT``, ``RETPU_FAULT_FSYNC_MS``, ``RETPU_FAULT_SEED``
and ``RETPU_FAULT_SILENT``.

The link-fault half of the reference module (directional drops,
injected RTT, reorder, the standing soak) waits for the port of
``netruntime`` and the replication links; this module has none of it.

- **storage errors** — ``EIO`` / ``ENOSPC`` raised on ``write`` or
  ``fsync`` for a path class (``wal`` / ``ckpt`` / ``tree``);
- **torn writes** — the next write of a class is cut at a byte offset
  and fails;
- **bit-flip read corruption** — store reads flip one seeded bit with a
  per-class probability;
- **fsync delay** — a slow disk under the WAL's ack barrier;
- **crash points** — ``RETPU_CRASHPOINT=<barrier>[:<nth>]`` ends the
  process with ``os._exit(CRASH_EXIT)`` at the nth hit of a named
  durability barrier (``wal_append``, ``wal_fsync_pre`` / ``post``,
  ``ckpt_tmp_write``, ``ckpt_rename``, ``tree_save``).
"""

from __future__ import annotations

import errno as _errno
import os
import random
import sys
import threading
import time
from typing import Any, Dict, Optional, Tuple

__all__ = ["FaultPlan", "install", "clear", "plan", "active_plan",
           "from_env", "fsync_sleep", "storage_raise", "torn_limit",
           "read_filter", "crashpoint", "CRASH_EXIT", "STORAGE_ERRNOS"]

#: exit status of a process killed at an injected crash point
CRASH_EXIT = 86

#: the storage errno names an injected storage error may carry
STORAGE_ERRNOS = {"EIO": _errno.EIO, "ENOSPC": _errno.ENOSPC}

#: the path classes / ops the storage seams consult
STORAGE_CLASSES = ("wal", "ckpt", "tree")
STORAGE_OPS = ("write", "fsync")


def _check_class(path_class: str, wild: bool = False) -> None:
    """Reject unknown storage path classes when a rule is set: a typo
    would arm a rule no seam consults."""
    ok = STORAGE_CLASSES + (("*",) if wild else ())
    if str(path_class) not in ok:
        raise ValueError(
            f"storage path class must be one of {ok}, "
            f"not {path_class!r}")


class FaultPlan:
    """One storage nemesis schedule: rules plus injection counters.

    Thread-safe; the seeded RNG makes a fixed schedule reproducible.
    Counters only grow (``heal()`` clears the rules, not the
    evidence).  ``silent`` is kept for the link half's drop semantics
    (the reference's ``RETPU_FAULT_SILENT``); no storage rule reads it.
    """

    def __init__(self, seed: int = 0, silent: bool = False) -> None:
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        self.seed = int(seed)
        self.silent = bool(silent)
        self.fsync_ms = 0.0
        self.fsync_jitter_ms = 0.0
        #: (path_class, op) -> [errno, remaining count or None]
        self._storage_err: Dict[Tuple[str, str], list] = {}
        #: path_class -> byte offset; one shot
        self._torn: Dict[str, int] = {}
        #: path_class -> probability a store read flips one bit
        self._corrupt: Dict[str, float] = {}
        self.fsync_delays = 0
        self.fsync_delay_injected_ms = 0.0
        self.storage_errors_injected = 0
        self.torn_writes_injected = 0
        self.corrupt_reads_injected = 0

    # -- rule surface ------------------------------------------------------

    def set_fsync_delay(self, ms: float,
                        jitter_ms: float = 0.0) -> "FaultPlan":
        """Delay every WAL fsync barrier by ``ms`` (± jitter)."""
        with self._lock:
            self.fsync_ms = max(float(ms), 0.0)
            self.fsync_jitter_ms = max(float(jitter_ms), 0.0)
        return self

    def set_storage_error(self, path_class: str, op: str,
                          err: str = "EIO",
                          count: Optional[int] = None) -> "FaultPlan":
        """Raise ``err`` (a name in :data:`STORAGE_ERRNOS`) on every
        ``op`` ("write" / "fsync", ``"*"`` = both) touching
        ``path_class`` ("wal" / "ckpt" / "tree", ``"*"`` = all).
        ``count`` bounds the injections (None = until healed)."""
        code = STORAGE_ERRNOS.get(str(err).upper())
        if code is None:
            raise ValueError(
                f"storage fault errno must be one of "
                f"{sorted(STORAGE_ERRNOS)}, not {err!r}")
        _check_class(path_class, wild=True)
        if str(op) not in STORAGE_OPS + ("*",):
            raise ValueError(
                f"storage fault op must be one of "
                f"{STORAGE_OPS + ('*',)}, not {op!r}")
        if count is not None and int(count) < 1:
            raise ValueError(
                f"storage fault count must be >= 1, not {count!r}")
        with self._lock:
            self._storage_err[(str(path_class), str(op))] = [
                code, None if count is None else int(count)]
        return self

    def set_torn_write(self, path_class: str,
                       offset: int) -> "FaultPlan":
        """Tear the NEXT write of ``path_class`` at byte ``offset``
        (the prefix lands on disk, the writer sees EIO) — one shot."""
        _check_class(path_class)
        with self._lock:
            self._torn[str(path_class)] = max(0, int(offset))
        return self

    def set_read_corruption(self, path_class: str,
                            prob: float) -> "FaultPlan":
        """Flip one seeded-random bit in each ``path_class`` store read
        with probability ``prob`` (0 removes the rule)."""
        _check_class(path_class)
        with self._lock:
            if prob <= 0.0:
                self._corrupt.pop(str(path_class), None)
            else:
                self._corrupt[str(path_class)] = min(float(prob), 1.0)
        return self

    def heal(self) -> None:
        """Clear every rule; counters (the evidence) survive."""
        with self._lock:
            self.fsync_ms = 0.0
            self.fsync_jitter_ms = 0.0
            self._storage_err.clear()
            self._torn.clear()
            self._corrupt.clear()

    def active(self) -> bool:
        with self._lock:
            return bool(self.fsync_ms > 0.0 or self.fsync_jitter_ms > 0.0
                        or self._storage_err or self._torn
                        or self._corrupt)

    # -- query surface (the stores call these per access) ---------------------

    def fsync_delay_s(self) -> float:
        """Sampled fsync delay in seconds (counted when nonzero)."""
        with self._lock:
            ms = self.fsync_ms
            if self.fsync_jitter_ms > 0.0:
                ms += self._rng.uniform(-self.fsync_jitter_ms,
                                        self.fsync_jitter_ms)
            ms = max(ms, 0.0)
            if ms <= 0.0:
                return 0.0
            self.fsync_delays += 1
            self.fsync_delay_injected_ms += ms
            return ms / 1000.0

    def sleep_fsync(self) -> None:
        d = self.fsync_delay_s()
        if d > 0.0:
            time.sleep(d)

    def storage_error(self, path_class: str,
                      op: str) -> Optional[OSError]:
        """The OSError an armed rule injects for this access (None =
        clean).  Counted; a bounded rule decrements and removes itself
        at zero."""
        with self._lock:
            for k in ((path_class, op), (path_class, "*"),
                      ("*", op), ("*", "*")):
                rule = self._storage_err.get(k)
                if rule is None:
                    continue
                code, remaining = rule
                if remaining is not None:
                    if remaining <= 0:
                        continue
                    rule[1] = remaining - 1
                    if rule[1] <= 0:
                        self._storage_err.pop(k, None)
                self.storage_errors_injected += 1
                return OSError(
                    code, f"injected {_errno.errorcode[code]} on "
                          f"{path_class} {op}")
        return None

    def torn_limit(self, path_class: str) -> Optional[int]:
        """Byte offset the next write of ``path_class`` tears at (None
        = no rule).  One shot: consumes the rule, counts."""
        with self._lock:
            off = self._torn.pop(str(path_class), None)
            if off is not None:
                self.torn_writes_injected += 1
            return off

    def corrupt_read(self, path_class: str, data: bytes) -> bytes:
        """Maybe flip one seeded-random bit of ``data``; counted when it
        fires."""
        with self._lock:
            prob = self._corrupt.get(str(path_class))
            if not data or prob is None or self._rng.random() >= prob:
                return data
            i = self._rng.randrange(len(data))
            bit = 1 << self._rng.randrange(8)
            self.corrupt_reads_injected += 1
        out = bytearray(data)
        out[i] ^= bit
        return bytes(out)

    def describe(self) -> Dict[str, Any]:
        """Plain-data snapshot of the storage rules and counters."""
        with self._lock:
            return {
                "silent": self.silent,
                "seed": self.seed,
                "fsync_ms": self.fsync_ms,
                "fsync_jitter_ms": self.fsync_jitter_ms,
                "storage": {
                    f"{c}.{o}": [_errno.errorcode.get(code, code), n]
                    for (c, o), (code, n)
                    in sorted(self._storage_err.items())},
                "torn": dict(sorted(self._torn.items())),
                "corrupt": dict(sorted(self._corrupt.items())),
                "counters": {
                    "fsync_delays": self.fsync_delays,
                    "fsync_delay_injected_ms": round(
                        self.fsync_delay_injected_ms, 3),
                    "storage_errors_injected":
                        self.storage_errors_injected,
                    "torn_writes_injected": self.torn_writes_injected,
                    "corrupt_reads_injected":
                        self.corrupt_reads_injected,
                },
            }


# -- the process-global plan (env-armed) --------------------------------------

def _parse_storage(spec: str):
    """``"wal.fsync=ENOSPC,ckpt.write=EIO:2"`` →
    [("wal", "fsync", "ENOSPC", None), ("ckpt", "write", "EIO", 2)].
    A malformed entry raises."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        pc_op, sep, err = part.partition("=")
        cls, dot, op = pc_op.partition(".")
        count = None
        if ":" in err:
            err, _, n = err.partition(":")
            count = int(n)
        if not sep or not dot or err.upper() not in STORAGE_ERRNOS:
            raise ValueError(
                f"RETPU_FAULT_STORAGE: entry {part!r} must be "
                f"<class>.<op>=<{'|'.join(sorted(STORAGE_ERRNOS))}>"
                f"[:count]")
        out.append((cls.strip() or "*", op.strip() or "*",
                    err.upper(), count))
    return out


def _parse_class_values(spec: str, knob: str, conv):
    """``"wal:100,tree:0.5"`` → [("wal", conv("100")), ...]."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        cls, sep, v = part.partition(":")
        try:
            val = conv(v) if sep else None
        except ValueError:
            val = None
        if val is None:
            raise ValueError(
                f"{knob}: entry {part!r} needs <class>:<value>")
        out.append((cls.strip(), val))
    return out


def from_env(environ=None) -> Optional[FaultPlan]:
    """A plan from the storage fault knobs; None when none is set."""
    env = os.environ if environ is None else environ
    keys = ("RETPU_FAULT_FSYNC_MS", "RETPU_FAULT_STORAGE",
            "RETPU_FAULT_TORN", "RETPU_FAULT_CORRUPT")
    if not any(env.get(k) for k in keys):
        return None
    p = FaultPlan(seed=int(env.get("RETPU_FAULT_SEED", "0") or 0),
                  silent=env.get("RETPU_FAULT_SILENT", "") == "1")
    fs = env.get("RETPU_FAULT_FSYNC_MS", "").strip()
    if fs:
        p.set_fsync_delay(float(fs))
    for cls, op, err, count in _parse_storage(
            env.get("RETPU_FAULT_STORAGE", "")):
        p.set_storage_error(cls, op, err, count)
    for cls, off in _parse_class_values(
            env.get("RETPU_FAULT_TORN", ""), "RETPU_FAULT_TORN", int):
        p.set_torn_write(cls, off)
    for cls, prob in _parse_class_values(
            env.get("RETPU_FAULT_CORRUPT", ""), "RETPU_FAULT_CORRUPT",
            float):
        p.set_read_corruption(cls, prob)
    return p


_global: Optional[FaultPlan] = None
_armed = False
_arm_lock = threading.Lock()


def install(p: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install ``p`` as the process-global plan (None = disarm; the
    environment knobs are not read again after an install or clear)."""
    global _global, _armed
    with _arm_lock:
        _global = p
        _armed = True
    return p


def clear() -> None:
    install(None)


def plan() -> Optional[FaultPlan]:
    """The process-global plan: an explicit :func:`install` wins;
    otherwise the environment knobs arm one, once.  A malformed knob
    disarms the plane and says so on stderr."""
    global _global, _armed
    if not _armed:
        with _arm_lock:
            if not _armed:
                try:
                    _global = from_env()
                except ValueError as exc:
                    print("riak_ensemble_tpu_torch.faults: IGNORING "
                          f"malformed fault-injection knobs: {exc}",
                          file=sys.stderr, flush=True)
                    _global = None
                _armed = True
    return _global


def active_plan() -> Optional[FaultPlan]:
    """The global plan iff it has a live rule (None short-circuits
    every seam)."""
    p = plan()
    return p if p is not None and p.active() else None


def fsync_sleep() -> None:
    """The WAL sync hook's default: sleep the injected fsync delay of
    the active plan (no-op otherwise)."""
    p = active_plan()
    if p is not None:
        p.sleep_fsync()


# -- storage seams (the stores call these; no-ops without a plan) -------------

def storage_raise(path_class: str, op: str) -> None:
    """Raise the active plan's injected storage error for this access,
    if any."""
    p = active_plan()
    if p is not None:
        err = p.storage_error(path_class, op)
        if err is not None:
            raise err


def torn_limit(path_class: str) -> Optional[int]:
    """Byte offset the next write must tear at (None = whole write)."""
    p = active_plan()
    return p.torn_limit(path_class) if p is not None else None


def read_filter(path_class: str, data: bytes) -> bytes:
    """Store-read bytes through the active plan's bit-flip rule."""
    p = active_plan()
    return data if p is None else p.corrupt_read(path_class, data)


# -- crash points -------------------------------------------------------------

#: hits per barrier name this process has seen
CRASHPOINT_HITS: Dict[str, int] = {}


def crashpoint(name: str) -> None:
    """A named durability barrier: when ``RETPU_CRASHPOINT`` names it
    (``<name>`` or ``<name>:<nth>``), the nth hit ends the process with
    ``os._exit(CRASH_EXIT)`` — no atexit, no flushes beyond the std
    streams: the kill -9 a recovery test aims at the barrier."""
    spec = os.environ.get("RETPU_CRASHPOINT", "")
    if not spec:
        return
    target, _, nth = spec.partition(":")
    if target != name:
        return
    try:
        need = int(nth) if nth else 1
    except ValueError:
        print("riak_ensemble_tpu_torch.faults: IGNORING malformed "
              f"RETPU_CRASHPOINT={spec!r} (bad :nth)",
              file=sys.stderr, flush=True)
        os.environ.pop("RETPU_CRASHPOINT", None)
        return
    hits = CRASHPOINT_HITS.get(name, 0) + 1
    CRASHPOINT_HITS[name] = hits
    if hits >= need:
        try:
            sys.stdout.flush()
            sys.stderr.flush()
        except (OSError, ValueError):   # dying anyway
            pass
        os._exit(CRASH_EXIT)
