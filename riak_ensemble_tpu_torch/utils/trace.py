"""Tracing: the structured event recorder the runtime's trace hook feeds.

Copied from ``riak_ensemble_tpu/utils/trace.py``, so the port imports
nothing of the JAX package:

- :class:`Tracer` — structured event recorder hooked into the
  runtime's trace callback: per-op spans (kind, ensemble, key,
  start/end, outcome), message-delivery events, and counters; ring-
  buffered so long runs stay bounded.  With a ``registry`` it folds
  into the service's metrics registry.
- :func:`dump_ensemble` — per-ensemble state dump across the port's
  scalar peers (:mod:`..peer`): fsm state, epoch/seq, leader, views,
  tree trust/readiness — the get_info surface (peer.erl:183-206)
  aggregated cluster-wide; :func:`peer_info` is one peer's row.
"""

from __future__ import annotations

import collections
import itertools
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

_span_ids = itertools.count(1)


@dataclass
class Span:
    span_id: int
    kind: str
    ensemble: Any
    detail: Any
    start: float
    end: Optional[float] = None
    outcome: Any = None

    @property
    def duration(self) -> Optional[float]:
        return None if self.end is None else self.end - self.start


@dataclass
class Tracer:
    """Attach with ``Tracer(runtime).install()``.

    Both rings are BOUNDED: ``events`` at ``max_events`` and
    ``finished`` spans at ``max_finished`` (the finished list used to
    grow forever on long runs — a tracer left installed on a serving
    node leaked a Span per op).  Counters are exact over the whole
    run either way; percentile reports cover the retained window.

    Pass ``registry`` (an :class:`riak_ensemble_tpu_torch.obs.registry.
    MetricsRegistry`) to fold the tracer into the unified obs plane:
    event counts mirror into ``retpu_trace_events_total`` (labeled by
    kind) and finished span durations feed the
    ``retpu_trace_span_ms`` histogram, so `metrics` consumers see
    tracer activity without touching this object."""

    runtime: Any
    max_events: int = 100_000
    events: Deque[Tuple[float, str, Any]] = field(default_factory=collections.deque)
    counters: Dict[str, int] = field(default_factory=dict)
    spans: Dict[int, Span] = field(default_factory=dict)
    finished: Deque[Span] = field(default_factory=collections.deque)
    max_finished: int = 10_000
    registry: Any = None

    def __post_init__(self) -> None:
        self.finished = collections.deque(self.finished,
                                          maxlen=self.max_finished)

    def install(self) -> "Tracer":
        self.runtime.trace = self._on_event
        return self

    def uninstall(self) -> None:
        if self.runtime.trace == self._on_event:
            self.runtime.trace = None

    # -- runtime hook ------------------------------------------------------

    def _on_event(self, kind: str, payload: Any) -> None:
        self.counters[kind] = self.counters.get(kind, 0) + 1
        self.events.append((self.runtime.now, kind, payload))
        while len(self.events) > self.max_events:
            self.events.popleft()
        if self.registry is not None:
            self.registry.counter(
                "retpu_trace_events_total",
                "runtime trace events by kind",
                label_name="kind").labels(kind).inc()

    # -- spans -------------------------------------------------------------

    def begin(self, kind: str, ensemble: Any, detail: Any = None) -> int:
        sid = next(_span_ids)
        self.spans[sid] = Span(sid, kind, ensemble, detail,
                               self.runtime.now)
        return sid

    def finish(self, span_id: int, outcome: Any) -> Optional[Span]:
        span = self.spans.pop(span_id, None)
        if span is None:
            return None
        span.end = self.runtime.now
        span.outcome = outcome
        self.finished.append(span)
        self.counters[f"span:{span.kind}"] = \
            self.counters.get(f"span:{span.kind}", 0) + 1
        if self.registry is not None and span.duration is not None:
            self.registry.histogram(
                "retpu_trace_span_ms",
                "tracer span durations by kind",
                label_name="kind").labels(
                    span.kind).record(span.duration * 1e3)
        return span

    # -- reports -----------------------------------------------------------

    def percentiles(self, kind: str, qs=(0.5, 0.99)) -> Dict[float, float]:
        durations = sorted(s.duration for s in self.finished
                           if s.kind == kind and s.duration is not None)
        if not durations:
            return {}
        out = {}
        for q in qs:
            idx = min(len(durations) - 1, int(q * len(durations)))
            out[q] = durations[idx]
        return out

    def summary(self) -> Dict[str, Any]:
        by_kind: Dict[str, int] = {}
        for s in self.finished:
            by_kind[s.kind] = by_kind.get(s.kind, 0) + 1
        return {"counters": dict(self.counters),
                "finished_spans": by_kind,
                "open_spans": len(self.spans)}


def peer_info(peer) -> Dict[str, Any]:
    """get_info analog (peer.erl:183-189,1905-1910)."""
    return {
        "id": peer.id,
        "state": peer.fsm_state,
        "epoch": peer.epoch,
        "seq": peer.seq,
        "leader": peer.leader,
        "views": peer.views,
        "members": peer.members,
        "tree_trust": peer.tree_trust,
        "tree_ready": peer.tree_ready,
        "suspended": peer.suspended,
    }


def dump_ensemble(runtime, ensemble) -> List[Dict[str, Any]]:
    """Cluster-wide state dump for one ensemble — every live peer's
    info, leader-first."""
    from riak_ensemble_tpu_torch.peer import Peer

    infos = [peer_info(a) for a in list(runtime.actors.values())
             if isinstance(a, Peer) and a.ensemble == ensemble]
    infos.sort(key=lambda i: (i["state"] != "leading", repr(i["id"])))
    return infos
