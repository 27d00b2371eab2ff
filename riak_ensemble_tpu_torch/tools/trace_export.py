"""Chrome-trace / Perfetto export of flush timelines + controller
decisions, over the port's observability plane (:mod:`..obs`).

Port of the repository's ``tools/trace_export.py``: for the same span
records, flight-recorder dumps and fleet timelines it writes the same
JSON, apart from the ``source`` strings, which name this module.

``obs.timeline(fid)`` answers one flush's joined leader + replica
span record as a dict; this tool renders MANY of them — plus the
runtime controller's decision journal — as a Chrome trace-event JSON
(the ``chrome://tracing`` / Perfetto ``traceEvents`` array format),
so "where did the last N flushes' time go, and when did the
controller move a knob" becomes a picture instead of a dict-reading
exercise.

Timeline semantics: span records carry DURATIONS, not absolute start
stamps — the store is allocation-free on the hot path by design.  The
export therefore lays each flush's spans out SEQUENTIALLY per role
from a per-flush base tick, and advances the base by the flush's
widest role before the next flush: within a flush, every span's
extent is measurement-accurate and roles align at the flush base;
ACROSS flushes the spacing is ordinal (flush order), not wall-clock.
Controller journal events render as instant events on a
``controller`` track at the base tick of the flush they were
journaled against.

Two entry points:

- In-process API (tests, bench, a REPL next to a live service):
  ``trace_events(fids)`` / ``export(path, fids, decisions=...)``
  read the process-global span store directly.
- CLI over a flight-recorder dump (the cross-process path — dumps
  are JSON files, the span store is not)::

      python -m riak_ensemble_tpu_torch.tools.trace_export \
          --flight-dump dump.json -o trace.json

  renders the dump's per-flush ring records (their latency marks
  are the same spans, minus replica sides) and its
  ``controller_decisions`` section; a correlated (schema v4) dump's
  per-host fleet sections render as additional per-host tracks.

The FLEET path: :func:`fleet_trace_events` (and the
``--fleet-timelines`` CLI input) renders clock-ALIGNED fleet
timelines — ``svc.fleet_timeline(fid)`` answers — as one merged
trace with per-HOST tracks placed at their aligned leader-axis
times (the one case where cross-track positions ARE wall-clock,
honest to each role's ``bound_ms``).

Load the output in Perfetto (ui.perfetto.dev) or chrome://tracing.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, Iterable, List, Optional

from riak_ensemble_tpu_torch import obs
from riak_ensemble_tpu_torch.obs import flightrec

__all__ = ["trace_events", "flight_dump_events", "fleet_trace_events",
           "export", "main"]

#: ``otherData.source`` of an exported document
SOURCE = "riak_ensemble_tpu_torch.tools.trace_export"

_US = 1e6  # seconds -> trace microseconds


def _span_events(role: str, spans, base_us: float, fid: int,
                 pid: str) -> List[Dict[str, Any]]:
    """One role's spans as complete ("X") events stacked
    sequentially from the flush base."""
    out: List[Dict[str, Any]] = []
    t = base_us
    for name, dur_s in spans:
        dur_us = max(float(dur_s), 0.0) * _US
        out.append({"name": str(name), "ph": "X", "ts": t,
                    "dur": dur_us, "pid": pid, "tid": str(role),
                    "args": {"flush_id": fid}})
        t += dur_us
    return out


def trace_events(flush_ids: Iterable[int],
                 decisions: Iterable[Dict[str, Any]] = (),
                 store: Optional[Any] = None,
                 pid: str = "retpu") -> List[Dict[str, Any]]:
    """Render ``obs.timeline(fid)`` records for ``flush_ids`` (plus
    controller journal ``decisions``) as a trace-event list.  Flushes
    missing from the store are skipped; decisions whose flush never
    recorded a timeline anchor at the end of the rendered range."""
    store = store if store is not None else obs.SPANS
    events: List[Dict[str, Any]] = []
    base_of: Dict[int, float] = {}
    base = 0.0
    for fid in sorted(set(int(f) for f in flush_ids)):
        tl = store.timeline(fid)
        if not tl or tl.get("miss"):
            continue  # evicted/unknown fid: a structured miss, not
            #           a record (the store counted it)
        base_of[fid] = base
        widest = 0.0
        for role, side in tl.items():
            if role == "flush_id":
                continue
            spans = side.get("spans", [])
            events.extend(_span_events(role, spans, base, fid, pid))
            widest = max(widest,
                         sum(max(float(d), 0.0) for _n, d in spans))
        # one metadata marker per flush so the viewer can jump by id
        events.append({"name": f"flush {fid}", "ph": "i", "s": "t",
                       "ts": base, "pid": pid, "tid": "flush",
                       "args": {k: v for k, v in
                                (tl.get("leader") or {}).items()
                                if k != "spans"}})
        # next flush starts past this one's widest role (µs), with
        # breathing room — the ordinal cross-flush spacing
        base += max(widest * _US, 1.0) * 1.25
    for ev in decisions:
        ts = base_of.get(int(ev.get("flush_id", 0)), base)
        knob = ev.get("knob") or ev.get("actuator", "decision")
        events.append({"name": f"autotune {knob}", "ph": "i",
                       "s": "g", "ts": ts, "pid": pid,
                       "tid": "controller", "args": dict(ev)})
    return events


def flight_dump_events(dump: Dict[str, Any],
                       pid: str = "retpu") -> List[Dict[str, Any]]:
    """The cross-process path: render a flight-recorder dump's ring
    records (their latency marks, leader-side only — a dump has no
    replica store) + its ``controller_decisions`` section."""
    events: List[Dict[str, Any]] = []
    base_of: Dict[int, float] = {}
    base = 0.0
    for rec in dump.get("ring", []):
        fid = int(rec.get("flush_id", 0))
        spans = [(c, v) for c, v in rec.items()
                 if isinstance(v, (int, float))
                 and c not in flightrec.META_FIELDS]
        base_of[fid] = base
        events.extend(_span_events("leader", spans, base, fid, pid))
        events.append({"name": f"flush {fid}", "ph": "i", "s": "t",
                       "ts": base, "pid": pid, "tid": "flush",
                       "args": {k: rec.get(k) for k in
                                ("k", "a_width", "payload_bytes",
                                 "queued_rounds", "in_flight")}})
        base += max(sum(max(float(d), 0.0) for _n, d in spans),
                    1e-6) * _US * 1.25
    for ev in dump.get("controller_decisions", []):
        ts = base_of.get(int(ev.get("flush_id", 0)), base)
        knob = ev.get("knob") or ev.get("actuator", "decision")
        events.append({"name": f"autotune {knob}", "ph": "i",
                       "s": "g", "ts": ts, "pid": pid,
                       "tid": "controller", "args": dict(ev)})
    return events


def fleet_trace_events(timelines: Iterable[Dict[str, Any]],
                       pid_prefix: str = "") -> List[Dict[str, Any]]:
    """Render ALIGNED fleet timelines (``svc.fleet_timeline(fid)``
    dicts — the ``retpu-fleet-timeline-v1`` shape) as ONE merged
    Chrome/Perfetto trace with per-HOST tracks.

    Unlike :func:`trace_events`' ordinal layout, fleet timelines
    carry absolute starts on the leader's clock (each role's spans
    aligned through its link's offset estimate), so events here are
    placed at their ALIGNED times: ``pid`` = host label (one Perfetto
    track group per host), ``tid`` = role, and each role carries its
    ``bound_ms`` in args so a reader knows how much to trust a
    cross-track comparison.  Timelines of several flushes merge onto
    one axis by their own ``base_s`` deltas (all bases are
    leader-clock seconds)."""
    events: List[Dict[str, Any]] = []
    tls = [t for t in timelines
           if isinstance(t, dict) and t.get("roles")]
    if not tls:
        return events
    base0 = min(float(t.get("base_s", 0.0)) for t in tls)
    for tl in tls:
        fid = int(tl.get("flush_id", 0))
        shift = (float(tl.get("base_s", 0.0)) - base0) * _US
        for role, info in tl["roles"].items():
            host = info.get("host") or "?"
            pid = f"{pid_prefix}{host}"
            for name, start_s, dur_s in info.get("spans", []):
                events.append({
                    "name": str(name), "ph": "X",
                    "ts": shift + max(float(start_s), 0.0) * _US,
                    "dur": max(float(dur_s), 0.0) * _US,
                    "pid": pid, "tid": str(role),
                    "args": {"flush_id": fid,
                             "aligned": bool(info.get("aligned")),
                             "bound_ms": info.get("bound_ms", 0.0)}})
    return events


def export(path: str, flush_ids: Iterable[int],
           decisions: Iterable[Dict[str, Any]] = (),
           store: Optional[Any] = None) -> Dict[str, Any]:
    """Write the Chrome-trace JSON for ``flush_ids`` (+ journal
    ``decisions``) to ``path``; returns the written document."""
    doc = {
        "traceEvents": trace_events(flush_ids, decisions, store),
        "displayTimeUnit": "ms",
        "otherData": {
            "source": SOURCE,
            "timeline_semantics":
                "per-flush spans sequential from a per-flush base; "
                "cross-flush spacing is ordinal, not wall-clock",
        },
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)
    return doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--flight-dump",
                     help="a flight-recorder dump JSON "
                          "(RETPU_OBS_DUMP_DIR file) to render; a "
                          "schema-v4 dump's per-host fleet sections "
                          "render as additional per-host tracks")
    src.add_argument("--fleet-timelines",
                     help="a JSON file holding one (or a list of) "
                          "clock-ALIGNED fleet timeline dict(s) — "
                          "the ('fleet','timeline',fid) verb's "
                          "answer — rendered with per-host tracks "
                          "at aligned times")
    ap.add_argument("-o", "--out", default="trace.json",
                    help="output trace path (default trace.json)")
    args = ap.parse_args(argv)
    path = args.flight_dump or args.fleet_timelines
    try:
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
    except (OSError, json.JSONDecodeError) as exc:
        print(f"trace_export: unreadable input: {exc}",
              file=sys.stderr)
        return 1
    if args.fleet_timelines:
        tls = data if isinstance(data, list) else [data]
        doc = {
            "traceEvents": fleet_trace_events(tls),
            "displayTimeUnit": "ms",
            "otherData": {
                "source": SOURCE,
                "timeline_semantics":
                    "per-host tracks at clock-aligned leader-axis "
                    "times; trust cross-track deltas to each role's "
                    "bound_ms",
            },
        }
    else:
        events = flight_dump_events(data)
        # a correlated (schema v4) dump carries per-host span
        # sections: render them as their own host tracks next to the
        # leader ring (ordinal layout — a dump has no aligned axis,
        # only the clock_offsets section to read them against)
        for host, section in (data.get("hosts") or {}).items():
            if not isinstance(section, dict):
                continue
            hbase = 0.0
            # JSON stringified the flush-id keys: order numerically
            # (lexicographic would put fid 9 after 10); roles of one
            # flush share its base like trace_events, and the base
            # advances once per flush by its widest role
            for fid, tl in sorted(
                    (section.get("spans") or {}).items(),
                    key=lambda kv: int(kv[0])):
                if not isinstance(tl, dict) or tl.get("miss"):
                    continue
                widest = 0.0
                for role, side in tl.items():
                    if role == "flush_id" or not isinstance(side,
                                                            dict):
                        continue
                    spans = side.get("spans", [])
                    events.extend(_span_events(
                        role, spans, hbase, int(fid), str(host)))
                    widest = max(widest,
                                 sum(max(float(d), 0.0)
                                     for _n, d in spans))
                hbase += max(widest * _US, 1.0) * 1.25
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"source_dump_schema": data.get("schema"),
                          "clock_offsets":
                              data.get("clock_offsets") or {}},
        }
    with open(args.out, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)
    print(f"trace_export: {len(doc['traceEvents'])} events -> "
          f"{args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
