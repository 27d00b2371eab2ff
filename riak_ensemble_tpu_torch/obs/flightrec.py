"""Flight recorder: a bounded ring of complete per-flush records with
an anomaly trigger.

Copied from ``riak_ensemble_tpu/obs/flightrec.py``, so the port imports
nothing of the JAX package.

Every settled launch appends one record — its latency marks, flush
id, batch shape, active-set occupancy, payload bytes and queue
depths.  The ring answers "what were the last N flushes doing" at any
moment; the TRIGGER makes it useful after the fact: any flush slower
than ``trigger_ratio`` × the rolling p50 (default 5×, over the last
``window`` records, armed only past ``min_samples``) snapshots the
whole ring plus a box fingerprint.  With ``RETPU_OBS_DUMP_DIR`` set
the snapshot is also written to a JSON dump file (atomic rename);
either way it is retained in memory (``dumps``, bounded).

This is what turns the next mixed-rung anomaly (r4→r5: −32% ops/s,
p99 11×, cause never established) from a shrug into a diagnosis: the
dump names the slow flush's dominating mark, shows the flushes
around it, and pins the box state it happened on.
"""

from __future__ import annotations

import json
import os
import time
from bisect import bisect_left, insort
from collections import deque
from typing import Any, Dict, List, Optional

from riak_ensemble_tpu_torch.obs.fingerprint import box_fingerprint

__all__ = ["FlightRecorder", "DUMP_SCHEMA", "META_FIELDS",
           "DERIVED_MARKS", "dump_keep"]


def dump_keep(default: int = 64) -> int:
    """How many dump FILES a dump directory retains
    (``RETPU_OBS_DUMP_KEEP``; <= 0 disables rotation).  Read per
    dump, not cached: rotation is cold-path by construction (behind
    the trigger's rate limit), and a soak harness lowering the cap
    mid-run should win immediately.  Without this cap a long wedge
    soak with a flapping trigger fills the disk — one dump file every
    ``min_dump_interval_s`` forever."""
    try:
        return int(os.environ.get("RETPU_OBS_DUMP_KEEP", default))
    except ValueError:
        return default

#: v2 added the per-op SLO ring tail (``slow_ops``: the slowest acked
#: ops with their stage splits), the service's recent
#: ``compile_events``, and the active fault-injection plan
#: (``injected_faults`` — so an anomaly captured mid-nemesis indicts
#: the nemesis); v3 added the runtime controller's recent
#: ``controller_decisions`` (so a dump captured while the controller
#: was moving knobs shows WHICH knob moved and why); v4 adds the
#: FLEET sections — ``hosts`` (each replica's matching span records
#: for the fids in this ring, pulled by the leader at trigger time),
#: ``clock_offsets`` (the per-link offset estimates those records
#: align under) and ``watchdog_findings`` — turning "the ack was
#: slow" into "replica B's wal_sync held the quorum" in ONE file.
#: All sections come from the recorder's ``extras`` callback (empty
#: when no extras provider is attached / the service is standalone).
DUMP_SCHEMA = "retpu-flight-dump-v4"

#: DERIVED latency marks — sums/subdivisions of other marks
#: ('enqueue' = h2d + dispatch; resolve_native/resolve_fallback =
#: the resolve half's per-arm share; enqueue_native/enqueue_fallback
#: = the ENQUEUE half's lane-build + op-plane-pack share attributed
#: to whichever pack arm ran, already inside queue_wait).  THE
#: canonical list: the service's total sums
#: (batched_host.DERIVED_MARKS) and the flight recorder's
#: dominant-mark argmax both derive from it, so a new derived mark
#: can never be additive in one place and excluded in the other (it
#: would dominate every tail attribution).
DERIVED_MARKS = ("enqueue", "resolve_native", "resolve_fallback",
                 "enqueue_native", "enqueue_fallback")

#: per-flush record fields that are shape/identity metadata or
#: derived marks, not additive latency components — shared with
#: bench's tail attribution so the two dominant-mark argmaxes can
#: never drift apart
META_FIELDS = ("k", "total") + DERIVED_MARKS + (
    "flush_id", "t", "a_width", "payload_bytes", "queued_rounds",
    "in_flight")


class FlightRecorder:
    """Per-service flush ring + anomaly dumps.

    ``record`` cost: one deque append, one bisect-maintained sorted
    window update (O(window) list shift worst case, window = 128),
    one comparison.  The trigger baseline is the EXACT median of the
    last ``window`` totals — recomputed per record, not on a
    ``refresh_every`` cadence: the old cached p50 lagged a load shift
    by up to a full refresh period, so the quiet stretch after a
    slow-flush spike kept comparing against the spike's inflated
    baseline and real 5x anomalies in that window never armed.  With
    the windowed median the threshold re-arms as fast as the window
    slides (``refresh_every`` is accepted for constructor
    compatibility and ignored).
    """

    def __init__(self, capacity: int = 256, window: int = 128,
                 trigger_ratio: float = 5.0, min_samples: int = 32,
                 refresh_every: int = 16,
                 min_dump_interval_s: float = 5.0,
                 max_dumps: int = 8,
                 dump_dir: Optional[str] = None,
                 name: str = "svc",
                 extras: Optional[Any] = None) -> None:
        self.records: "deque[Dict[str, Any]]" = deque(maxlen=capacity)
        self.trigger_ratio = float(trigger_ratio)
        self.min_samples = int(min_samples)
        self.min_dump_interval_s = float(min_dump_interval_s)
        self.name = name
        self._dump_dir = dump_dir
        #: optional zero-arg callback returning extra dump sections
        #: (the service supplies its per-op ring tail + compile-event
        #: log); attached post-construction by the owning service so
        #: a test-replaced recorder still gets the sections
        self.extras = extras
        self._totals: "deque[float]" = deque(maxlen=window)
        #: the same window, sorted (bisect-maintained) — the median
        #: read is one index access
        self._sorted: List[float] = []
        #: anomaly observability: trigger count and the retained
        #: snapshots (bounded; a pathological box must not hoard
        #: rings), newest last
        self.anomalies = 0
        self.dumps: "deque[Dict[str, Any]]" = deque(maxlen=max_dumps)
        self._last_dump_t = -1e9

    def dump_dir(self) -> Optional[str]:
        if self._dump_dir is not None:
            return self._dump_dir
        return os.environ.get("RETPU_OBS_DUMP_DIR") or None

    def record(self, rec: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Append one per-flush record (must carry ``total`` seconds;
        ``flush_id`` and the marks ride along verbatim).  Returns the
        anomaly snapshot if this flush tripped the trigger, else
        None."""
        total = float(rec.get("total", 0.0))
        self.records.append(rec)
        p50 = self._p50
        armed = (len(self._totals) >= self.min_samples
                 and p50 > 0.0
                 and total > self.trigger_ratio * p50)
        # the slow flush itself joins the window AFTER the check, so
        # a burst of slow flushes keeps triggering against the
        # still-windowed baseline rather than instantly normalizing
        # itself away
        if len(self._totals) == self._totals.maxlen:
            old = self._totals[0]
            del self._sorted[bisect_left(self._sorted, old)]
        self._totals.append(total)
        insort(self._sorted, total)
        if not armed:
            return None
        # count EVERY trigger firing (the anomaly metric's contract);
        # the rate limit below only bounds how often a firing also
        # snapshots the ring — during a sustained incident the
        # counter keeps telling the truth while dumps stay bounded
        self.anomalies += 1
        now = time.monotonic()
        if now - self._last_dump_t < self.min_dump_interval_s:
            return None
        self._last_dump_t = now
        return self._dump(rec, total)

    @property
    def _p50(self) -> float:
        """Exact median of the current window (index access into the
        bisect-maintained sorted copy)."""
        s = self._sorted
        return s[len(s) // 2] if s else 0.0

    def _dump(self, rec: Dict[str, Any],
              total: float) -> Dict[str, Any]:
        marks = {k: v for k, v in rec.items()
                 if isinstance(v, (int, float))}
        cause = max((k for k in marks if k not in META_FIELDS),
                    key=lambda k: marks[k], default=None)
        snap = {
            "schema": DUMP_SCHEMA,
            "name": self.name,
            "t_unix": time.time(),
            "trigger": {
                "flush_id": rec.get("flush_id"),
                "total_s": total,
                "rolling_p50_s": self._p50,
                "ratio": round(total / self._p50, 2),
                "threshold": self.trigger_ratio,
                "dominant_mark": cause,
            },
            "ring": [dict(r) for r in self.records],
            "box": box_fingerprint(),
            # per-op tail + compile-event + injected-fault +
            # controller-decision + fleet sections (schema v4): empty
            # when no extras provider is attached
            "slow_ops": [],
            "compile_events": [],
            "injected_faults": {},
            "controller_decisions": [],
            "hosts": {},
            "clock_offsets": {},
            "watchdog_findings": [],
        }
        if self.extras is not None:
            try:
                snap.update(self.extras())
            except Exception:
                pass  # a broken extras hook must not fail the dump
        self.dumps.append(snap)
        d = self.dump_dir()
        if d:
            try:
                os.makedirs(d, exist_ok=True)
                # pid in the name: leader and subprocess-replica
                # services share dump dirs and restart their
                # flush-id/anomaly ordinals, and a colliding name
                # would os.replace the very evidence a dump preserves
                path = os.path.join(
                    d, f"flight_{self.name}_{os.getpid()}_"
                       f"{rec.get('flush_id', 0)}_{self.anomalies}"
                       ".json")
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(snap, f)
                os.replace(tmp, path)  # atomic: a killed process
                snap["path"] = path    # never leaves a torn dump
                self._rotate(d)
            except OSError:
                pass  # a full/readonly disk must not fail the flush
        return snap

    @staticmethod
    def _rotate(d: str) -> None:
        """Oldest-first dump rotation: keep at most
        :func:`dump_keep` ``flight_*.json`` files in the dump dir
        (atomic per-file unlink — a reader holding an open fd keeps
        its data; a concurrent writer's ``.tmp`` never matches).
        Shared dirs rotate COLLECTIVELY: leader + subprocess-replica
        recorders pointing at one directory enforce one cap, which is
        exactly what bounds the disk."""
        keep = dump_keep()
        if keep <= 0:
            return
        try:
            paths = [os.path.join(d, f) for f in os.listdir(d)
                     if f.startswith("flight_") and f.endswith(".json")]
        except OSError:
            return
        if len(paths) <= keep:
            return

        def age(p):
            try:
                return os.path.getmtime(p)
            except OSError:
                return 0.0  # racing unlink: treat as oldest

        paths.sort(key=lambda p: (age(p), p))
        for p in paths[:-keep]:
            try:
                os.unlink(p)
            except OSError:
                pass  # a racing rotator already took it

    def marks_tail(self, n: int) -> List[Dict[str, Any]]:
        """The newest ``n`` records (oldest first) — the bench's
        tail-attribution source."""
        recs = list(self.records)
        return recs[-n:] if n else []
