"""Adversarial fault-injection plane: links, storage and crash points.

Copied from ``riak_ensemble_tpu/faults.py`` (the whole module), so the
port imports nothing of the JAX package; the environment knobs keep the
reference's names, so one environment drives both packages, and
``describe()`` / ``counters()`` answer the same for the same knobs.

One :class:`FaultPlan` is shared by every transport the port runs — the
asyncio runtime (:mod:`.netruntime`), the deterministic simulator
(:class:`.runtime.Network`) and the WAL's fsync barrier
(:class:`.parallel.wal.ServiceWAL`):

- **directional drop** ``A→B`` — the one-directional link failure
  (A's frames to B vanish; B→A still delivers);
- **per-link one-way delay with jitter** — injected RTT;
- **bounded reorder** — adjacent-frame swaps on a link;
- **fsync delay** — a slow disk under the WAL's ack barrier.

Round 15 extends the plane below the transports into the STORAGE
stack (docs/ARCHITECTURE.md §15) — the reference's headline safety
property is surviving a bad disk (synctree.erl:21-73), so the disk
gets the same injection discipline as the network:

- **per-path-class storage errors** — ``EIO``/``ENOSPC`` raised on
  ``write`` or ``fsync`` for a path class (``wal`` / ``ckpt`` /
  ``tree``), consulted by :mod:`..parallel.wal`, the checkpoint blob
  writer (:mod:`..save`) and the synctree/treestore backends;
- **torn writes** — the next write of a class is truncated at an
  injected byte offset (then fails), leaving a genuinely torn
  record for replay to detect;
- **bit-flip read corruption** — store reads flip a seeded random
  bit with a per-class probability, exercising every CRC gate;
- **crash points** — ``RETPU_CRASHPOINT=<barrier>[:<nth>]``
  terminates the process (``os._exit(CRASH_EXIT)``) at the nth hit
  of a named durability barrier (``wal_append``,
  ``wal_fsync_pre``/``post``, ``ckpt_tmp_write``, ``ckpt_rename``,
  ``replica_apply_pre_ack``, ``tree_save``) — the kill -9 analog
  aimed exactly at the protocol's recovery contract.

Rules are keyed by ``(src, dst)`` endpoint names with ``"*"``
wildcards.  The runtimes use node names; a replication link is
addressed as ``"host:port"`` with :data:`LOCAL` as the leader-side
name.  Faults are installed programmatically (:func:`install`, or a
plan handed directly to a ``Network``) or via environment knobs —
``RETPU_FAULT_DROP``, ``RETPU_FAULT_RTT_MS``,
``RETPU_FAULT_RTT_JITTER_MS``, ``RETPU_FAULT_REORDER``,
``RETPU_FAULT_FSYNC_MS``, ``RETPU_FAULT_STORAGE``,
``RETPU_FAULT_TORN``, ``RETPU_FAULT_CORRUPT``, ``RETPU_FAULT_SEED``,
``RETPU_FAULT_SILENT`` (see the README knob table) — so a subprocess
replica host can run under the same nemesis as its in-process leader.

Every active fault is observable: injected-fault gauges ride each
service's metrics registry, ``svc.health()`` carries an ``injected``
section while a plan is active, and flight-recorder dumps embed the
plan + its counters (an operator can always distinguish a running
nemesis from a real outage).

Drop semantics: by default a dropped frame FAILS FAST at the
injection point (a ``PeerLink`` ticket fires unresolved — a missed
ack; the quorum consequences are identical to a silent blackhole,
the timing is compressed so nemesis sweeps stay cheap).
``silent=True`` (``RETPU_FAULT_SILENT=1``) keeps the true blackhole
timing: nothing fires, callers ride their own deadlines.
"""

from __future__ import annotations

import errno as _errno
import os
import random
import sys
import threading
import time
from typing import Any, Dict, Optional, Tuple

__all__ = ["FaultPlan", "LOCAL", "install", "clear", "plan",
           "active_plan", "from_env", "fsync_sleep", "SoakSchedule",
           "wedge_soak", "storage_raise", "torn_limit", "read_filter",
           "crashpoint", "CRASH_EXIT", "STORAGE_ERRNOS"]

#: the local endpoint name a PeerLink uses for its own (leader) side
LOCAL = "local"

#: exit status of a process killed at an injected crash point — a
#: parent driving a recovery sweep distinguishes "died exactly at the
#: barrier" from any ordinary failure
CRASH_EXIT = 86

#: the storage errno names an injected storage error may carry (the
#: two real bad-disk signals the degradation machinery reacts to)
STORAGE_ERRNOS = {"EIO": _errno.EIO, "ENOSPC": _errno.ENOSPC}

#: the path classes / ops the storage seams consult — rule setters
#: validate against these so a typo'd class can never arm an
#: injecting-nothing nemesis (worse than a crash at arm time)
STORAGE_CLASSES = ("wal", "ckpt", "tree")
STORAGE_OPS = ("write", "fsync")


def _key(src: Optional[str], dst: Optional[str]) -> Tuple[str, str]:
    return (str(src) if src is not None else "*",
            str(dst) if dst is not None else "*")


def _check_class(path_class: str, wild: bool = False) -> None:
    """Reject unknown storage path classes at RULE-SET time — the
    seams look classes up exactly (torn/corrupt) or by candidate
    list (errors), so a typo would arm a rule nothing consults."""
    ok = STORAGE_CLASSES + (("*",) if wild else ())
    if str(path_class) not in ok:
        raise ValueError(
            f"storage path class must be one of {ok}, "
            f"not {path_class!r}")


class FaultPlan:
    """One nemesis schedule: directional rules + injection counters.

    Thread-safe: rule mutation and rule queries take one lock; the
    seeded RNG makes a fixed schedule reproducible.  Counters only
    ever grow (``heal()`` clears the rules, not the evidence).
    """

    def __init__(self, seed: int = 0, silent: bool = False) -> None:
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        self.seed = int(seed)
        #: drops surface as immediately-failed sends (False) or as a
        #: true silent blackhole (True: nothing fires, callers hit
        #: their own deadlines)
        self.silent = bool(silent)
        self._drop: set = set()
        self._rtt: Dict[Tuple[str, str], Tuple[float, float]] = {}
        self._reorder: Dict[Tuple[str, str], float] = {}
        self.fsync_ms = 0.0
        self.fsync_jitter_ms = 0.0
        # -- storage rules (docs/ARCHITECTURE.md §15) ----------------
        #: (path_class, op) -> [errno, remaining count or None];
        #: op in ("write", "fsync"), "*" wildcards on either field
        self._storage_err: Dict[Tuple[str, str], list] = {}
        #: path_class -> byte offset; ONE-SHOT: the next write of the
        #: class truncates there (a torn record) and fails
        self._torn: Dict[str, int] = {}
        #: path_class -> probability a store read flips one bit
        self._corrupt: Dict[str, float] = {}
        # -- counters (monotonic; per-link under the same keys) ------
        self.dropped_frames = 0
        self.delayed_frames = 0
        self.delay_injected_ms = 0.0
        self.reordered_frames = 0
        self.fsync_delays = 0
        self.fsync_delay_injected_ms = 0.0
        self.storage_errors_injected = 0
        self.torn_writes_injected = 0
        self.corrupt_reads_injected = 0
        self._per_link: Dict[Tuple[str, str], Dict[str, Any]] = {}

    # -- rule surface ------------------------------------------------------

    def drop(self, src: Optional[str], dst: Optional[str]) -> "FaultPlan":
        """Blackhole frames ``src→dst`` (one direction only)."""
        with self._lock:
            self._drop.add(_key(src, dst))
        return self

    def undrop(self, src: Optional[str], dst: Optional[str]) -> None:
        with self._lock:
            self._drop.discard(_key(src, dst))

    def set_rtt(self, src: Optional[str], dst: Optional[str],
                ms: float, jitter_ms: float = 0.0) -> "FaultPlan":
        """Inject ``ms`` of ONE-WAY delay (± uniform jitter) on every
        frame ``src→dst``.  ``ms=0`` removes the rule."""
        with self._lock:
            if ms <= 0.0 and jitter_ms <= 0.0:
                self._rtt.pop(_key(src, dst), None)
            else:
                self._rtt[_key(src, dst)] = (float(ms),
                                             float(jitter_ms))
        return self

    def set_link_rtt(self, a: Optional[str], b: Optional[str],
                     rtt_ms: float,
                     jitter_ms: float = 0.0) -> "FaultPlan":
        """Convenience: a full round trip of ``rtt_ms`` on the
        ``a↔b`` link, split evenly across the two directions."""
        self.set_rtt(a, b, rtt_ms / 2.0, jitter_ms / 2.0)
        self.set_rtt(b, a, rtt_ms / 2.0, jitter_ms / 2.0)
        return self

    def set_reorder(self, src: Optional[str], dst: Optional[str],
                    prob: float) -> "FaultPlan":
        """Swap adjacent frames ``src→dst`` with probability
        ``prob`` (bounded reorder: a window of exactly two)."""
        with self._lock:
            if prob <= 0.0:
                self._reorder.pop(_key(src, dst), None)
            else:
                self._reorder[_key(src, dst)] = min(float(prob), 1.0)
        return self

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
        """Raise ``err`` (an errno name from :data:`STORAGE_ERRNOS`)
        on every ``op`` ("write"/"fsync", ``"*"`` = both) touching
        ``path_class`` ("wal"/"ckpt"/"tree", ``"*"`` = all).
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
                f"storage fault count must be >= 1, not {count!r} "
                "(a zero-count rule would arm an armed-but-"
                "injecting-nothing nemesis forever)")
        with self._lock:
            self._storage_err[(str(path_class), str(op))] = [
                code, None if count is None else int(count)]
        return self

    def set_torn_write(self, path_class: str,
                       offset: int) -> "FaultPlan":
        """Tear the NEXT write of ``path_class`` at byte ``offset``
        (the prefix lands on disk, the rest vanishes, the writer sees
        EIO) — one shot, consumed by the write it hits."""
        _check_class(path_class)
        with self._lock:
            self._torn[str(path_class)] = max(0, int(offset))
        return self

    def set_read_corruption(self, path_class: str,
                            prob: float) -> "FaultPlan":
        """Flip one seeded-random bit in each ``path_class`` store
        read with probability ``prob`` (0 removes the rule) — the
        silent-disk-corruption mode every CRC/synctree gate must
        catch, never serve."""
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
            self._drop.clear()
            self._rtt.clear()
            self._reorder.clear()
            self.fsync_ms = 0.0
            self.fsync_jitter_ms = 0.0
            self._storage_err.clear()
            self._torn.clear()
            self._corrupt.clear()

    def active(self) -> bool:
        with self._lock:
            return self._active_locked()

    def _active_locked(self) -> bool:
        return bool(self._drop or self._rtt or self._reorder
                    or self.fsync_ms > 0.0
                    or self.fsync_jitter_ms > 0.0
                    or self._storage_err or self._torn
                    or self._corrupt)

    # -- query surface (the transports call these per frame) ---------------

    @staticmethod
    def _candidates(src: str, dst: str):
        return ((src, dst), (src, "*"), ("*", dst), ("*", "*"))

    def _link_counters(self, src: str, dst: str) -> Dict[str, Any]:
        return self._per_link.setdefault(
            (src, dst), {"drops": 0, "delayed": 0, "delay_ms": 0.0,
                         "reorders": 0})

    def should_drop(self, src: str, dst: str) -> bool:
        """True = drop the frame (counted against the link)."""
        with self._lock:
            for k in self._candidates(src, dst):
                if k in self._drop:
                    self.dropped_frames += 1
                    self._link_counters(src, dst)["drops"] += 1
                    return True
        return False

    def dropping(self, src: str, dst: str) -> bool:
        """Rule check WITHOUT counting (planning/health queries)."""
        with self._lock:
            return any(k in self._drop
                       for k in self._candidates(src, dst))

    def delay_s(self, src: str, dst: str) -> float:
        """Sampled injected one-way delay in SECONDS (0.0 = no rule);
        counts every nonzero sample against the link."""
        with self._lock:
            for k in self._candidates(src, dst):
                rule = self._rtt.get(k)
                if rule is None:
                    continue
                ms, jitter = rule
                if jitter > 0.0:
                    ms += self._rng.uniform(-jitter, jitter)
                ms = max(ms, 0.0)
                if ms <= 0.0:
                    return 0.0
                self.delayed_frames += 1
                self.delay_injected_ms += ms
                lc = self._link_counters(src, dst)
                lc["delayed"] += 1
                lc["delay_ms"] += ms
                return ms / 1000.0
        return 0.0

    def should_swap(self, src: str, dst: str) -> bool:
        """True = TRY to swap this frame with the next one on the
        link.  Not counted here: a swap only really happens when a
        second frame is queued — the sender calls
        :meth:`count_reorder` at the moment it actually reorders."""
        with self._lock:
            for k in self._candidates(src, dst):
                prob = self._reorder.get(k)
                if prob is None:
                    continue
                return self._rng.random() < prob
        return False

    def count_reorder(self, src: str, dst: str) -> None:
        """Record one REAL adjacent-frame swap (wire order changed)."""
        with self._lock:
            self.reordered_frames += 1
            self._link_counters(src, dst)["reorders"] += 1

    def fsync_delay_s(self) -> float:
        """Sampled fsync delay in seconds (counts when nonzero)."""
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

    # -- storage query surface (the stores call these per access) -----------

    def storage_error(self, path_class: str,
                      op: str) -> Optional[OSError]:
        """The OSError an armed storage rule injects for this access
        (None = clean).  Counted; a bounded rule decrements and
        self-removes at zero."""
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
        """Byte offset the next write of ``path_class`` must tear at
        (None = no rule).  One-shot: consumes the rule, counts."""
        with self._lock:
            off = self._torn.pop(str(path_class), None)
            if off is not None:
                self.torn_writes_injected += 1
            return off

    def corrupt_read(self, path_class: str, data: bytes) -> bytes:
        """Maybe flip one seeded-random bit of ``data`` (per the
        class's read-corruption probability); counted when it fires."""
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

    # -- observability -----------------------------------------------------

    def describe(self) -> Dict[str, Any]:
        """Plain-data (wire-encodable) snapshot of rules + counters —
        the health verb's ``injected`` section, the flight-recorder
        dump section, and the bench's embedded fault config."""
        with self._lock:
            return {
                "active": self._active_locked(),
                "silent": self.silent,
                "seed": self.seed,
                "drop": sorted(f"{s}>{d}" for s, d in self._drop),
                "rtt_ms": {f"{s}>{d}": [ms, jit] for (s, d), (ms, jit)
                           in sorted(self._rtt.items())},
                "reorder": {f"{s}>{d}": p for (s, d), p
                            in sorted(self._reorder.items())},
                "fsync_ms": self.fsync_ms,
                "fsync_jitter_ms": self.fsync_jitter_ms,
                "storage": {
                    f"{c}.{o}": [_errno.errorcode.get(code, code), n]
                    for (c, o), (code, n)
                    in sorted(self._storage_err.items())},
                "torn": dict(sorted(self._torn.items())),
                "corrupt": dict(sorted(self._corrupt.items())),
                "counters": self.counters(),
            }

    def counters(self) -> Dict[str, Any]:
        return {
            "dropped_frames": self.dropped_frames,
            "delayed_frames": self.delayed_frames,
            "delay_injected_ms": round(self.delay_injected_ms, 3),
            "reordered_frames": self.reordered_frames,
            "fsync_delays": self.fsync_delays,
            "fsync_delay_injected_ms": round(
                self.fsync_delay_injected_ms, 3),
            "storage_errors_injected": self.storage_errors_injected,
            "torn_writes_injected": self.torn_writes_injected,
            "corrupt_reads_injected": self.corrupt_reads_injected,
        }

    def link_injected(self, src: str, dst: str) -> Dict[str, Any]:
        """One link's injected-fault view (per-link health section):
        whether rules target it right now, plus its counters."""
        with self._lock:
            cand = self._candidates(src, dst)
            rtt = next((self._rtt[k] for k in cand if k in self._rtt),
                       None)
            reorder = next((self._reorder[k] for k in cand
                            if k in self._reorder), None)
            counts = self._per_link.get((src, dst), {})
            return {
                "dropping": any(k in self._drop for k in cand),
                "rtt_ms": (0.0 if rtt is None else rtt[0]),
                "rtt_jitter_ms": (0.0 if rtt is None else rtt[1]),
                "reorder": (0.0 if reorder is None else reorder),
                "drops": int(counts.get("drops", 0)),
                "delayed": int(counts.get("delayed", 0)),
                "delay_ms": round(float(counts.get("delay_ms", 0.0)),
                                  3),
                "reorders": int(counts.get("reorders", 0)),
            }


# -- the process-global plan (env-armed) --------------------------------------

def _parse_links(spec: str, with_value: bool = False,
                 knob: str = "fault knob"):
    """``"a>b,b>*"`` → [("a", "b"), ("b", "*")].  With
    ``with_value=True`` each entry MUST carry a trailing ``=value``
    suffix → [("a", "b", 2.0)] — ``=`` (not ``:``) precisely so a
    ``host:port`` endpoint can never have its port consumed as the
    value; an entry without a parseable value raises loudly (a
    silently-ignored rule would report an armed nemesis that injects
    nothing)."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        val = None
        if with_value:
            part, sep, v = part.rpartition("=")
            try:
                val = float(v) if sep else None
            except ValueError:
                val = None
            if val is None:
                raise ValueError(
                    f"{knob}: per-link entry {part + sep + v!r} "
                    f"needs a trailing =value (e.g. 'a>b=2.5')")
        if ">" not in part:
            src, dst = "*", part
        else:
            src, _, dst = part.partition(">")
        entry = (src.strip() or "*", dst.strip() or "*")
        out.append(entry + ((val,) if val is not None else ()))
    return out


def _parse_storage(spec: str):
    """``"wal.fsync=ENOSPC,ckpt.write=EIO:2"`` →
    [("wal", "fsync", "ENOSPC", None), ("ckpt", "write", "EIO", 2)].
    A malformed entry raises loudly (same contract as
    :func:`_parse_links`: an armed-but-injecting-nothing nemesis is
    worse than a crash at arm time)."""
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
    """Build a plan from the environment fault knobs; None when no
    knob is set (the common case costs one dict scan at arm time)."""
    env = os.environ if environ is None else environ
    keys = ("RETPU_FAULT_DROP", "RETPU_FAULT_RTT_MS",
            "RETPU_FAULT_RTT_JITTER_MS", "RETPU_FAULT_REORDER",
            "RETPU_FAULT_FSYNC_MS", "RETPU_FAULT_STORAGE",
            "RETPU_FAULT_TORN", "RETPU_FAULT_CORRUPT")
    if not any(env.get(k) for k in keys):
        return None
    p = FaultPlan(seed=int(env.get("RETPU_FAULT_SEED", "0") or 0),
                  silent=env.get("RETPU_FAULT_SILENT", "") == "1")
    jitter = float(env.get("RETPU_FAULT_RTT_JITTER_MS", "0") or 0.0)
    for entry in _parse_links(env.get("RETPU_FAULT_DROP", "")):
        p.drop(entry[0], entry[1])
    rtt_spec = env.get("RETPU_FAULT_RTT_MS", "").strip()
    if rtt_spec:
        try:
            # global form: one number, every link both directions
            p.set_rtt("*", "*", float(rtt_spec), jitter)
        except ValueError:
            for entry in _parse_links(rtt_spec, with_value=True,
                                      knob="RETPU_FAULT_RTT_MS"):
                p.set_rtt(entry[0], entry[1], entry[2], jitter)
    ro_spec = env.get("RETPU_FAULT_REORDER", "").strip()
    if ro_spec:
        try:
            p.set_reorder("*", "*", float(ro_spec))
        except ValueError:
            for entry in _parse_links(ro_spec, with_value=True,
                                      knob="RETPU_FAULT_REORDER"):
                p.set_reorder(entry[0], entry[1], entry[2])
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
    env knobs are NOT re-read after an explicit install/clear)."""
    global _global, _armed
    with _arm_lock:
        _global = p
        _armed = True
    return p


def clear() -> None:
    install(None)


def plan() -> Optional[FaultPlan]:
    """The process-global plan: an explicit :func:`install` wins;
    otherwise the environment fault knobs arm one lazily (once).
    A malformed knob spec disarms the plane and shouts to stderr —
    the first consumer may be a transport worker thread, and an
    exception there would kill the thread and wedge its link, which
    is worse than running without the nemesis."""
    global _global, _armed
    if not _armed:
        with _arm_lock:
            if not _armed:
                try:
                    _global = from_env()
                except Exception as exc:
                    print("riak_ensemble_tpu_torch.faults: IGNORING "
                          f"malformed fault-injection knobs: {exc}",
                          file=sys.stderr, flush=True)
                    _global = None
                _armed = True
    return _global


def active_plan() -> Optional[FaultPlan]:
    """The global plan iff it has at least one live rule — the ONE
    call every hot path makes (None short-circuits everything)."""
    p = plan()
    return p if p is not None and p.active() else None


def fsync_sleep() -> None:
    """The ServiceWAL sync hook's default: sleep the injected fsync
    delay of the active global plan (no-op otherwise)."""
    p = active_plan()
    if p is not None:
        p.sleep_fsync()


# -- storage seams (stores call these; no-ops without an armed plan) ----------

def storage_raise(path_class: str, op: str) -> None:
    """Raise the active plan's injected storage error for this
    access, if any — the one call every store write/fsync path makes
    (None plan short-circuits to a single function call)."""
    p = active_plan()
    if p is not None:
        err = p.storage_error(path_class, op)
        if err is not None:
            raise err


def torn_limit(path_class: str) -> Optional[int]:
    """Byte offset the next write must tear at (None = whole write).
    One-shot against the active plan."""
    p = active_plan()
    return p.torn_limit(path_class) if p is not None else None


def read_filter(path_class: str, data: bytes) -> bytes:
    """Pass store-read bytes through the active plan's bit-flip
    corruption rule (identity without one)."""
    p = active_plan()
    return data if p is None else p.corrupt_read(path_class, data)


# -- crash-point scheduler (docs/ARCHITECTURE.md §15) -------------------------

#: hits per barrier name this process has seen (the nth selector's
#: state; reading it from a test is fine, the process usually dies
#: before anyone can)
CRASHPOINT_HITS: Dict[str, int] = {}


def crashpoint(name: str) -> None:
    """A named durability barrier: when ``RETPU_CRASHPOINT`` names
    this barrier (``<name>`` or ``<name>:<nth>``), the nth hit
    terminates the process via ``os._exit(CRASH_EXIT)`` — no atexit,
    no flushes, no cleanup beyond draining std streams, exactly the
    kill -9 a recovery sweep aims at the barrier.  Unarmed (the
    normal case) this is one env read per barrier crossing, orders
    of magnitude under the fsync it sits next to."""
    spec = os.environ.get("RETPU_CRASHPOINT", "")
    if not spec:
        return
    target, _, nth = spec.partition(":")
    if target != name:
        return
    try:
        need = int(nth) if nth else 1
    except ValueError:
        # malformed nth: the first consumer is a durability barrier
        # inside the serving loop (WAL lock held) — shout and disarm
        # rather than raise there, the plan()-knob discipline
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
        except Exception:  # noqa: BLE001 — dying anyway
            pass
        os._exit(CRASH_EXIT)


# -- standing chaos: scheduled nemesis soaks ----------------------------------

class SoakSchedule:
    """Run a nemesis soak on a time schedule — chaos as a STANDING
    gate, not a one-off test run.

    The runtime controller's chaos actuator owns one of these: every
    ``interval_s`` of clock time, ``maybe_run(now)`` invokes the
    runner (default :func:`wedge_soak`) and retains its verdict.
    ``interval_s <= 0`` disarms the schedule entirely (the default —
    a soak injects real faults into a serving system, so it is armed
    explicitly, never inherited).  The clock is injectable so tests
    drive the schedule on virtual time."""

    def __init__(self, interval_s: float,
                 runner: Optional[Any] = None,
                 clock: Optional[Any] = None) -> None:
        self.interval_s = float(interval_s)
        self.runner = runner if runner is not None else wedge_soak
        self._clock = clock if clock is not None else time.monotonic
        self._next_due = (self._clock() + self.interval_s
                          if self.interval_s > 0 else float("inf"))
        self.runs = 0
        self.failures = 0
        self.last: Optional[Dict[str, Any]] = None

    def due(self, now: Optional[float] = None) -> bool:
        if self.interval_s <= 0:
            return False
        return (self._clock() if now is None else now) >= self._next_due

    def maybe_run(self, target: Any,
                  now: Optional[float] = None
                  ) -> Optional[Dict[str, Any]]:
        """Run the soak against ``target`` if it is due; returns the
        soak result dict (``ok``/``detect_s``/``bound_s``/...) or
        None when not due.  A raising runner records a failed soak
        instead of propagating — the soak gate must never take down
        the serving loop it polices."""
        now = self._clock() if now is None else now
        if not self.due(now):
            return None
        self._next_due = now + self.interval_s
        self.runs += 1
        try:
            result = self.runner(target)
        except Exception as exc:  # noqa: BLE001 — verdict, not crash
            result = {"ok": False, "error": repr(exc)}
        if not result.get("ok"):
            self.failures += 1
        self.last = result
        return result


def wedge_soak(svc: Any) -> Dict[str, Any]:
    """The default standing soak: a SILENT ack blackhole on every
    replication link (``FaultPlan(silent=True)`` — true half-open
    timing, nothing fails fast; the same mode the ``slow``-marked
    nemesis sweeps run under via ``RETPU_FAULT_SILENT=1``), then one
    :meth:`heartbeat` round.  The assertion is WEDGE DETECTION, the
    PR 9 half-open bound: a leader whose acks silently vanish must
    observe the lost quorum within ``2 x PeerLink.IO_TIMEOUT``, never
    ride a dead link forever.  The previously-armed plan (an outer
    nemesis) is restored afterward, rules healed, quorum re-confirmed
    with a second heartbeat so the soak leaves the group exactly as
    it found it.  Services without links (no group, or a replica
    lane) report ``skipped`` — there is no ack path to wedge."""
    links = getattr(svc, "_links", None)
    if not links:
        return {"ok": True, "skipped": "no replication links"}
    bound_s = 2.0 * max(type(l).IO_TIMEOUT for l in links)
    prev = plan()
    soak = FaultPlan(silent=True)
    for link in links:
        # acks vanish, applies deliver: src = the peer's label, dst
        # wildcard so a custom leader-side fault_label still matches
        soak.drop(link.label, None)
    install(soak)
    t0 = time.monotonic()
    try:
        quorum_ok = bool(svc.heartbeat())
        detect_s = time.monotonic() - t0
    finally:
        soak.heal()
        install(prev)
    healed_ok = bool(svc.heartbeat())
    return {
        "ok": (not quorum_ok) and detect_s <= bound_s and healed_ok,
        "detect_s": round(detect_s, 6),
        "bound_s": round(bound_s, 3),
        "quorum_ok_under_blackhole": quorum_ok,
        "healed_quorum_ok": healed_ok,
        "dropped_frames": soak.dropped_frames,
    }
