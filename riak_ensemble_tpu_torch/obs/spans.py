"""Cross-process flush tracing: flush ids + the span store.

Copied from ``riak_ensemble_tpu/obs/spans.py``, so the port imports
nothing of the JAX package.

Every device launch is stamped with a process-monotonic ``flush_id``
at enqueue.  The id propagates through the two-phase launch pipeline
(enqueue half → resolve half ride the same ``_InFlightLaunch``) and
over the replication wire (a trailing field of every ``abatch``
entry), so one id names the SAME flush on the leader and on every
replica — the Dapper trace-id discipline, scoped to the flush (the
unit of causality in this system: one flush = one device round = one
replicated entry).

The store is append-cheap and bounded: per flush id, a dict of
``role -> [(span_name, seconds), ...]`` plus whatever shape metadata
the recorder attached.  Roles are ``"leader"`` and ``"replica"``
(replica spans carry the recording service's lane tag when several
share the process).  :func:`timeline` answers the joined record —
the obs API a test or bench asks "where did flush N's time go,
end to end?".

Per-process scope: in-process replica servers (tests, the bench
smoke shape) share this store with their leader, so the join is
immediate.  Subprocess replicas record into their own process's
store; the leader's id still names their spans, and the join happens
wherever both exports land.
"""

from __future__ import annotations

import itertools
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Tuple

__all__ = ["next_flush_id", "SpanStore", "SPANS", "timeline"]

#: process-wide monotonic flush ids — shared by every service in the
#: process so leader and in-process replica launches never collide
_flush_ids = itertools.count(1)


def next_flush_id() -> int:
    return next(_flush_ids)


class SpanStore:
    """Bounded per-process store of per-flush span timelines."""

    def __init__(self, max_flushes: int = 4096) -> None:
        self.max_flushes = max_flushes
        self._lock = threading.Lock()
        self._flushes: "OrderedDict[int, Dict[str, Any]]" = OrderedDict()
        #: highest flush id the ring has ever evicted — the
        #: evicted/unknown miss boundary (a fid at or below it that
        #: is absent ROLLED OFF; above it, it was never recorded
        #: here — "the replica hasn't seen it yet" vs "too late")
        self._evict_high = 0
        #: lookup misses by reason (exported as
        #: ``retpu_span_misses_total{reason=...}``) — the fleet
        #: puller's signal for distinguishing lag from loss
        self.misses: Dict[str, int] = {"evicted": 0, "unknown": 0}

    def record(self, flush_id: int, role: str,
               spans: List[Tuple[str, float]],
               **info: Any) -> None:
        """Append one side's spans for a flush.  ``spans`` is a list
        of ``(name, seconds)``; ``info`` (batch shape, seq, lane, ...)
        merges into the role's metadata.  Thread-safe: replica server
        threads and the leader's flush loop share the store."""
        if not flush_id:
            return
        with self._lock:
            rec = self._flushes.get(flush_id)
            if rec is None:
                rec = self._flushes[flush_id] = {}
                while len(self._flushes) > self.max_flushes:
                    old_fid, _old = self._flushes.popitem(last=False)
                    if old_fid > self._evict_high:
                        self._evict_high = old_fid
            side = rec.setdefault(role, {"spans": []})
            side["spans"].extend(
                (str(n), float(d)) for n, d in spans)
            for k, v in info.items():
                side[k] = v

    def _miss_reason(self, flush_id: int) -> str:
        """Why a lookup missed (call under the lock): ``evicted`` for
        ids at or below the ring's eviction high-water (recorded once,
        rolled off — includes never-recorded ids in that range, the
        honest limit of a bounded ring), ``unknown`` above it (never
        seen HERE — on a replica that usually means "hasn't arrived
        yet")."""
        reason = ("evicted" if 0 < flush_id <= self._evict_high
                  else "unknown")
        self.misses[reason] += 1
        return reason

    def timeline(self, flush_id: int) -> Dict[str, Any]:
        """The joined per-flush record: ``{"flush_id": N, "leader":
        {...}, "replica": {...}}`` with per-role span lists.  A flush
        the store cannot answer returns a STRUCTURED miss —
        ``{"flush_id": N, "miss": "evicted"|"unknown"}`` — instead of
        bare None, and counts into :attr:`misses`: the fleet puller
        must distinguish "rolled off the ring" from "this host never
        saw it"."""
        with self._lock:
            rec = self._flushes.get(flush_id)
            if rec is None:
                return {"flush_id": int(flush_id),
                        "miss": self._miss_reason(flush_id)}
            out: Dict[str, Any] = {"flush_id": flush_id}
            for role, side in rec.items():
                out[role] = {"spans": list(side["spans"]),
                             **{k: v for k, v in side.items()
                                if k != "spans"}}
            return out

    def flush_ids(self) -> List[int]:
        with self._lock:
            return list(self._flushes)

    def span_values(self, flush_ids, role: str,
                    name: str) -> List[float]:
        """Every recorded duration (seconds) of span ``name`` under
        ``role`` across ``flush_ids``, one lock acquisition for the
        whole batch — the runtime controller's bulk read (e.g. the
        ``repl_ack`` samples of the last cadence window's flushes).
        Missing roles/spans contribute nothing: a flush whose ack is
        still pending simply isn't a sample yet.  A flush id entirely
        absent from the store counts a structured miss (evicted vs
        unknown) like :meth:`timeline` — and still contributes no
        sample."""
        out: List[float] = []
        with self._lock:
            for fid in flush_ids:
                rec = self._flushes.get(fid)
                if rec is None:
                    self._miss_reason(fid)
                    continue
                side = rec.get(role)
                if side is None:
                    continue
                out.extend(d for n, d in side["spans"] if n == name)
        return out


#: the process-global store every service records into
SPANS = SpanStore()


def timeline(flush_id: int) -> Dict[str, Any]:
    """Module-level convenience over the global store (misses come
    back structured — check ``tl.get("miss")``, not ``is None``)."""
    return SPANS.timeline(flush_id)
