"""Per-op SLO tracing: client-perceived latency in bounded numpy
slab rings.

Copied from ``riak_ensemble_tpu/obs/opslo.py``, so the port imports
nothing of the JAX package.

PR 6's spans answer "where did FLUSH N's time go"; the north star is
judged by what a *client* sees, which is a per-OP quantity: an op's
life is submit (the API call starts assigning slots/handles) →
enqueue (it entered the service queue) → flush-join (a flush took it
and stamped it with the launch's ``flush_id``) → settle (the launch's
result planes — and, on a replicated leader, the host quorum — are
in) → ack (its future resolved).  The queue wait before the join and
the quorum wait after the settle are exactly the components the
flush-granular record cannot attribute to a caller.

The representation keeps the tenant-ledger discipline: NO per-op
dicts.  One ring row per taken ENTRY (a ``kput_many`` batch is one
row weighted by its op count — every op in it shares the same five
stamps by construction), parallel numpy arrays for the five
timestamps plus kind/ensemble/weight/flush_id, capacity a power of
two, old rows silently overwritten.  Rows materialize at FLUSH-JOIN
time in one vectorized pass per flush (:meth:`OpSloRing.open_rows`
— the submit/enqueue timestamps ride the pending entry itself, so
the enqueue hot path pays zero ring work), and every later stage is
one fancy-index assignment.  The ring itself holds no histograms —
the service folds the latencies :meth:`OpSloRing.settle_ack` returns
into its registry's ``retpu_op_latency_ms`` (labeled by kind) and
its per-tenant ``[E, B]`` plane, so there is exactly ONE fold target
per dimension and the surfaces cannot drift.

Joins: rows carry the PR 6 ``flush_id``, so ``obs.timeline(fid)``
resolves an op's client-perceived tail down to its stage split
("this op's 80 ms was 60 ms queue_wait + 15 ms device") next to the
flush's own span record — the service attaches each flush's slowest
rows to the span store under ``slow_ops``.

``RETPU_SLO_RING`` sizes the ring (default 4096 rows; rounded up to
a power of two).  ``RETPU_OBS=0`` disables stamping entirely (the
service never constructs record calls).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["OpSloRing", "KIND_NAMES", "KIND_FAST_READ", "STAGES",
           "ring_capacity"]

#: ring kind codes: 0..4 are the engine op codes verbatim
#: (noop/get/put/cas/rmw — see ops/engine.py); 5 is the synthetic
#: mirror-served leased read, which never rides a flush.
KIND_NAMES: Tuple[str, ...] = ("noop", "get", "put", "cas", "rmw",
                               "get_fast")
KIND_FAST_READ = 5

#: the stage-split names, in life order (durations between adjacent
#: stamps): assign = submit→enqueue (slot/handle allocation),
#: queue_wait = enqueue→join, flush = join→settle (device round +
#: pipeline + host-quorum wait), ack = settle→ack (future fan-out).
STAGES: Tuple[str, ...] = ("assign", "queue_wait", "flush", "ack")


def ring_capacity(default: int = 4096) -> int:
    """``RETPU_SLO_RING`` rounded up to a power of two (floor 64).
    ``0`` disables per-op tracing alone (the rest of the obs plane
    stays live — the bench's op-trace A/B arm) and returns 0."""
    try:
        n = int(os.environ.get("RETPU_SLO_RING", default))
    except ValueError:
        n = default
    if n <= 0:
        return 0
    n = max(64, n)
    cap = 1
    while cap < n:
        cap <<= 1
    return cap


class OpSloRing:
    """Bounded per-service ring of per-entry SLO stamps.

    Rows are identified by a monotonically increasing id; the
    physical slot is ``id & (cap - 1)``.  A row overwritten before
    its ack is simply lost (bounded-ring semantics); the ack-side
    fold guards against reading a recycled row by requiring its
    stamps to be monotone.
    """

    def __init__(self, capacity: Optional[int] = None) -> None:
        cap = ring_capacity() if capacity is None else int(capacity)
        assert cap & (cap - 1) == 0, "ring capacity must be pow2"
        self.cap = cap
        self.mask = cap - 1
        z = lambda dt: np.zeros((cap,), dt)  # noqa: E731
        self.t_submit = z(np.float64)
        self.t_enq = z(np.float64)
        self.t_join = z(np.float64)
        self.t_settle = z(np.float64)
        self.t_ack = z(np.float64)
        self.kind = z(np.int16)
        self.ens = z(np.int32)
        self.n = z(np.int32)
        self.fid = z(np.int64)
        self._next = 0

    # -- flush side ---------------------------------------------------------

    def record_flush(self, kinds, enss, ns, t_subs, t_enqs, fid: int,
                     t_join: float, t_settle: float, t_ack: float
                     ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Record one settled flush's taken entries in ONE vectorized
        pass: rows open, all five stamps land, and the per-row
        client-perceived latency comes back as ``(physical_rows,
        latency_ms)`` for the service to fold into its per-kind /
        per-tenant histograms.

        Rows materialize at SETTLE time, not at enqueue or join: the
        per-entry timestamps ride the pending entry itself (``t_sub``
        at the API call, ``t_enq`` at push — both already there for
        the queue-wait mark) and the flush-level join/settle/ack
        times are shared by every entry of the flush, so the enqueue
        and flush hot paths pay ZERO ring work and the whole flush
        costs nine fancy-index assignments (the measured difference
        between ~0 and a real keyed-rung overhead).  Entries that
        never settle (failed at enqueue, abandoned launches) never
        occupy a row; a batch split across flushes is two entries
        recording under their own flush ids, weights conserved.

        The column inputs accept plain sequences OR the service's
        enqueue-time pending-slab columns verbatim (the slab enqueue
        path collects kind/ens/weight/t_sub/t_enq per entry while
        building its op lanes — docs/ARCHITECTURE.md §12): stamps
        keep riding even though the entries' futures resolve from
        completion-slab rows rather than per-op fan-out."""
        n = len(kinds)
        if not n:
            return None
        base = self._next
        self._next = base + n
        rows = np.arange(base, base + n, dtype=np.int64) & self.mask
        te = np.asarray(t_enqs)
        ts = np.asarray(t_subs)
        ts = np.where(ts > 0.0, ts, te)  # scalar ops: submit = enqueue
        self.t_submit[rows] = ts
        self.t_enq[rows] = te
        self.t_join[rows] = t_join
        self.t_settle[rows] = t_settle
        self.t_ack[rows] = t_ack
        self.kind[rows] = kinds
        self.ens[rows] = enss
        self.n[rows] = ns
        self.fid[rows] = fid
        return rows, (t_ack - ts) * 1e3

    # -- query side ---------------------------------------------------------

    def row_view(self, row_id: int) -> Dict[str, Any]:
        """One row's stamps + derived stage split (test/debug
        surface)."""
        return self._row_dict(row_id & self.mask)

    def _row_dict(self, r: int) -> Dict[str, Any]:
        sub, enq = self.t_submit[r], self.t_enq[r]
        joi, stl, ack = self.t_join[r], self.t_settle[r], self.t_ack[r]
        stages = {
            "assign": max(0.0, (enq - sub) * 1e3),
            "queue_wait": max(0.0, (joi - enq) * 1e3) if joi else 0.0,
            "flush": max(0.0, (stl - joi) * 1e3) if stl else 0.0,
            "ack": max(0.0, (ack - stl) * 1e3) if ack else 0.0,
        }
        return {  # plain Python scalars: rides the wire codec / JSON
            "kind": KIND_NAMES[int(self.kind[r])],
            "ens": int(self.ens[r]),
            "n": int(self.n[r]),
            "flush_id": int(self.fid[r]),
            "ms": (round(max(0.0, float(ack - sub)) * 1e3, 3)
                   if ack else None),
            "stages_ms": {k: round(float(v), 3)
                          for k, v in stages.items()},
        }

    def slowest(self, top: int = 5) -> List[Dict[str, Any]]:
        """The ``top`` slowest ACKED rows still in the ring (slowest
        first), each with its stage split and flush id — the flight
        dump's per-op tail section.  One O(cap) numpy scan; export
        time only."""
        lat = np.where(self.t_ack > 0.0,
                       self.t_ack - self.t_submit, -1.0)
        if not (lat > 0.0).any():
            return []
        order = np.argsort(lat)[::-1][:top]
        return [self._row_dict(int(r)) for r in order
                if lat[r] > 0.0]
