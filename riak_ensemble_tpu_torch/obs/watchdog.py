"""Standing anomaly watchdog over the fleet obs plane.

Copied from ``riak_ensemble_tpu/obs/watchdog.py`` onto the port's own
``obs`` modules, so the ``retpu_watchdog_*`` and clock-offset families
register under the reference's names and the port imports nothing of
the JAX package.

The fleet surfaces (``obs/fleet.py``) make cross-host evidence
pullable; this module is the leader-side consumer that WALKS it on a
cadence, looking for the three anomaly classes a human would
otherwise only find in a post-mortem:

- **ack-before-apply skew**: a flush whose host quorum settled on
  the leader measurably BEFORE any replica's aligned apply/WAL work
  could have finished — beyond the link's offset bound plus slack.
  Either the clock estimate is broken or an ack path is lying;
  both deserve a journal entry, not silence.
- **persistently slow replica span**: one host's window-median for a
  replica span (``wal_sync``, ``apply``, ``scatter``, ``validate``)
  exceeding ``slow_ratio`` × its own long-run EWMA for
  ``slow_windows`` consecutive evaluations — "replica B's wal_sync
  held the quorum" as a standing detection instead of a dump-reading
  exercise.
- **clock-offset drift**: a link's offset estimate moving more than
  ``drift_ms`` between evaluations (beyond the two bounds) — the
  box-level smell (VM migration, clock step, thermal throttle) that
  silently invalidates every cross-host comparison.

The watchdog NEVER blocks the flush path: each evaluation first
harvests whatever ``obsq`` timeline pulls completed since the last
one, then posts the next round of pulls and returns — responses ride
the PeerLink receiver threads and are consumed a cadence later.
Findings journal through the PR 12 :class:`DecisionJournal` export
discipline: ``retpu_watchdog_*`` gauges (always registered), a
``health()`` ``watchdog`` section, and the flight-dump
``watchdog_findings`` section.  ``RETPU_WATCHDOG=0`` disarms the
standing pull entirely (the fleet A/B's off arm); the verbs stay
available either way.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

from riak_ensemble_tpu_torch.obs import controller as obs_controller
from riak_ensemble_tpu_torch.obs import fleet as obs_fleet
from riak_ensemble_tpu_torch.obs import spans as obs_spans
from riak_ensemble_tpu_torch.obs import registry as obs_registry

__all__ = ["AnomalyWatchdog", "enabled", "REPLICA_SPANS"]

#: replica-side spans the slow-host detector tracks
REPLICA_SPANS = ("validate", "apply", "scatter", "rebuild", "wal_sync")


def enabled() -> bool:
    """Whether the standing fleet pull + anomaly walk is armed
    (``RETPU_WATCHDOG``, default on; leader-with-links only either
    way).  Services cache the answer at construction — the bench's
    ``fleet_obs_overhead`` off arm."""
    return os.environ.get("RETPU_WATCHDOG", "1") != "0"


class AnomalyWatchdog:
    """Leader-side fleet anomaly walker (one per ReplicatedService;
    constructed always so its gauge family registers, ticking only
    while armed AND leading with links)."""

    def __init__(self, svc: Any, cadence: Optional[int] = None,
                 slow_ratio: float = 3.0, slow_windows: int = 3,
                 drift_ms: float = 50.0, skew_slack_ms: float = 1.0,
                 max_fids: int = 8,
                 journal_capacity: int = 128) -> None:
        self.svc = svc
        self.enabled = enabled()
        #: evaluation cadence in settled flushes — deliberately the
        #: controller's knob (`RETPU_AUTOTUNE_CADENCE`): the watchdog
        #: is the observe-only sibling of the control loop and shares
        #: its notion of "a window"
        self.cadence = (int(cadence) if cadence is not None
                        else obs_controller.cadence())
        self.slow_ratio = float(slow_ratio)
        self.slow_windows = int(slow_windows)
        self.drift_ms = float(drift_ms)
        self.skew_slack_ms = float(skew_slack_ms)
        self.max_fids = int(max_fids)
        self.journal = obs_controller.DecisionJournal(journal_capacity)
        self.evals = 0
        #: STANDING-pull bookkeeping (exported under
        #: ``source="watchdog"``): timeline pulls this walker posted,
        #: and pulls that completed (or expired) without a usable
        #: payload.  One-off verb/dump pulls count on the service
        #: (``fleet_verb_pulls``, ``source="verb"``) — conflating
        #: them would let a triggered dump on a RETPU_WATCHDOG=0
        #: service look like a standing pull
        self.pulls = 0
        self.pull_failures = 0
        #: finding counts by kind (the labeled counter family)
        self.findings: Dict[str, int] = {
            "ack_apply_skew": 0, "replica_slow_span": 0,
            "clock_drift": 0}
        self._since = 0
        self._window_fids: List[int] = []
        #: in-flight pulls: (link, fids, ticket, posted_mono) —
        #: harvested next evaluation; bounded (one per link per
        #: window) and EXPIRED after ``PULL_EXPIRE_S``: a silent
        #: fault plan discards frames without ever firing their
        #: tickets, and un-expiring orphans would hit the pending
        #: cap and wedge the standing pull past the heal
        self._pending: List[Any] = []
        #: per-(host, span) long-run EWMA seconds + consecutive slow
        #: window streaks
        self._ewma: Dict[Any, float] = {}
        self._streak: Dict[Any, int] = {}
        #: last evaluation's offset estimate per host (drift check)
        self._last_offset: Dict[str, Dict[str, Any]] = {}

    # -- cadence -------------------------------------------------------------

    def tick(self, flush_id: int) -> None:
        """Per-settled-flush hook (leader-side; the service gates on
        armed + leading + links): count the flush, evaluate every
        ``cadence`` flushes.  Never blocks — pulls are posted, their
        responses harvested a window later."""
        if flush_id:
            self._window_fids.append(int(flush_id))
        self._since += 1
        if self._since >= self.cadence:
            self.evaluate()

    #: an in-flight pull older than this is an orphan (a silent
    #: blackhole consumed the frame and the ticket will never fire):
    #: dropped as a failure so the pending cap can't wedge the
    #: standing pull past the heal
    PULL_EXPIRE_S = 60.0

    def evaluate(self) -> List[Dict[str, Any]]:
        svc = self.svc
        self.evals += 1
        self._since = 0
        fids = self._window_fids[-self.max_fids:]
        self._window_fids = []
        out: List[Dict[str, Any]] = []
        # 1) harvest completed pulls from the PREVIOUS window;
        # expire orphans (silent drops never fire their tickets)
        now = time.monotonic()
        still: List[Any] = []
        window: Dict[str, Dict[int, Any]] = {}
        for link, pfids, ticket, posted in self._pending:
            if not ticket.event.is_set():
                if now - posted > self.PULL_EXPIRE_S:
                    self.pull_failures += 1
                    continue
                still.append((link, pfids, ticket, posted))
                continue
            payload = svc._obsq_result(link, ticket)
            if not isinstance(payload, dict):
                self.pull_failures += 1
                continue
            window.setdefault(link.label, {}).update(
                {int(f): tl for f, tl in payload.items()})
        self._pending = still
        if window:
            out += self._analyze(window)
        out += self._check_drift()
        # 2) post this window's pulls (one per connected link; an
        # unanswered pull simply stays pending — next harvest)
        if fids and len(self._pending) < 4 * max(
                len(getattr(svc, "_links", ())), 1):
            for link in getattr(svc, "_links", ()):
                if not link.connected:
                    continue
                t = link.post(("obsq", "timeline", list(fids)))
                self.pulls += 1
                self._pending.append((link, list(fids), t, now))
        return out

    # -- detectors -----------------------------------------------------------

    def _offsets(self) -> Dict[str, Dict[str, Any]]:
        # ONE implementation of the clock section — the service's
        # (fleet answers and these gauges must never drift apart)
        fn = getattr(self.svc, "_clock_section", None)
        return fn() if fn is not None else {}

    def _analyze(self, window: Dict[str, Dict[int, Any]]
                 ) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        offsets = self._offsets()
        span_samples: Dict[Any, List[float]] = {}
        #: per-fid {host: (skew_ms, allowance_ms)} — aggregated
        #: ACROSS hosts before the causality verdict
        skews: Dict[int, Dict[str, Any]] = {}
        for host, by_fid in window.items():
            est = offsets.get(host) or {}
            for fid, tl in by_fid.items():
                if not isinstance(tl, dict) or tl.get("miss"):
                    continue
                s = self._host_skew(fid, tl, est, host)
                if s is not None:
                    skews.setdefault(fid, {})[host] = s
                for role, side in tl.items():
                    if not isinstance(side, dict):
                        continue
                    # only THIS host's own lane counts toward its
                    # samples: in-process replicas answer the shared
                    # process-global store, so a pulled timeline can
                    # carry OTHER lanes' roles too — attributing
                    # those here would dilute a slow host into its
                    # healthy neighbors' baselines
                    if obs_fleet.role_host(str(role), "") != host:
                        continue
                    for name, dur in side.get("spans", ()):
                        if name in REPLICA_SPANS:
                            span_samples.setdefault(
                                (host, name), []).append(float(dur))
        out += self._check_skew(skews)
        out += self._check_slow(span_samples)
        return out

    def _host_skew(self, fid: int, tl: Dict[str, Any],
                   est: Dict[str, Any], host: str):
        """One host's (skew_ms, allowance_ms) for a quorum-confirmed
        flush: its OWN lane's earliest aligned apply anchor minus the
        leader's settle anchor, against the link's offset bound +
        slack; None when either side has no anchor (or the flush
        never confirmed a quorum — an unconfirmed flush has no ack
        to audit).  Roles belonging to other lanes (shared-store
        in-process replicas) are ignored — their anchors live on
        other links' clocks."""
        if "offset_ms" not in est:
            return None
        leader = obs_spans.SPANS.timeline(fid)
        if not isinstance(leader, dict) or leader.get("miss"):
            return None
        lside = leader.get("leader") or {}
        if not lside.get("quorum_ok") or lside.get("t_mono") is None:
            return None
        worst = None
        for role, side in tl.items():
            if not (isinstance(side, dict)
                    and str(role).startswith("replica")):
                continue
            if obs_fleet.role_host(str(role), "") != host:
                continue
            t_r = side.get("t_mono")
            if t_r is None:
                continue
            aligned = float(t_r) - est["offset_ms"] / 1e3
            skew_ms = (aligned - float(lside["t_mono"])) * 1e3
            if worst is None or skew_ms < worst:
                worst = skew_ms
        if worst is None:
            return None
        return (worst, est.get("bound_ms", 0.0) + self.skew_slack_ms)

    def _check_skew(self, skews: Dict[int, Dict[str, Any]]
                    ) -> List[Dict[str, Any]]:
        """Causality verdict per flush, over ALL hosts: a finding
        only when EVERY link contributed an anchored skew and every
        one exceeds its allowance — the quorum ack arrived before ANY
        apply could have finished.  A single late host is a healthy
        non-quorum straggler (majority settles don't wait for it),
        never a finding."""
        out: List[Dict[str, Any]] = []
        n_links = len(getattr(self.svc, "_links", ()))
        for fid, per_host in skews.items():
            if len(per_host) < max(n_links, 1):
                continue  # a host we couldn't read may hold the alibi
            if not all(s > a for s, a in per_host.values()):
                continue
            least = min(s for s, _a in per_host.values())
            self.findings["ack_apply_skew"] += 1
            out.append(self.journal.note(
                "watchdog", "ack_apply_skew_ms", least, flush_id=fid,
                hosts={h: {"skew_ms": round(s, 3),
                           "allowance_ms": round(a, 3)}
                       for h, (s, a) in per_host.items()},
                kind="ack_apply_skew"))
        return out

    def _check_slow(self, span_samples: Dict[Any, List[float]]
                    ) -> List[Dict[str, Any]]:
        """Per-(host, span) window median vs the pair's own long-run
        EWMA; ``slow_windows`` consecutive violations journal."""
        out: List[Dict[str, Any]] = []
        for key, vals in span_samples.items():
            vals.sort()
            med = vals[len(vals) // 2]
            base = self._ewma.get(key)
            if base is None:
                self._ewma[key] = med
                continue
            if base > 0.0 and med > self.slow_ratio * base:
                streak = self._streak.get(key, 0) + 1
                self._streak[key] = streak
                # a persistent offender re-journals once per streak
                # crossing, then every slow_windows windows — bounded
                # noise during a long incident, never silence
                if streak % self.slow_windows == 0:
                    self.findings["replica_slow_span"] += 1
                    host, span = key
                    out.append(self.journal.note(
                        "watchdog", "span_slow_ratio",
                        med / base, host=host, span=span,
                        window_p50_ms=round(med * 1e3, 3),
                        baseline_ms=round(base * 1e3, 3),
                        streak=streak, kind="replica_slow_span"))
            else:
                self._streak.pop(key, None)
                # only HEALTHY windows update the baseline: folding a
                # slow window in would normalize the very regression
                # being detected
                self._ewma[key] = 0.8 * base + 0.2 * med
        return out

    def _check_drift(self) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        current = self._offsets()
        for host, est in current.items():
            prev = self._last_offset.get(host)
            if (prev and "offset_ms" in prev
                    and "offset_ms" in est):
                delta = abs(est["offset_ms"] - prev["offset_ms"])
                allowance = max(
                    self.drift_ms,
                    est.get("bound_ms", 0.0)
                    + prev.get("bound_ms", 0.0))
                if delta > allowance:
                    self.findings["clock_drift"] += 1
                    out.append(self.journal.note(
                        "watchdog", "clock_offset_drift_ms", delta,
                        host=host, kind="clock_drift",
                        offset_ms=est["offset_ms"],
                        prev_offset_ms=prev["offset_ms"]))
        self._last_offset = current
        return out

    # -- export surfaces -----------------------------------------------------

    def collect(self) -> Dict[str, Any]:
        """Registry collector: the ``retpu_watchdog_*`` + per-link
        clock families — always registered (empty/zero while the
        group has no links), the fault-gauge discipline."""
        offs = self._offsets()
        return {
            "retpu_watchdog_evals_total": obs_registry.family(
                "counter", "fleet watchdog evaluations run",
                {None: self.evals}),
            "retpu_watchdog_findings_total": obs_registry.family(
                "counter", "journaled watchdog anomaly findings",
                dict(self.findings), label="kind"),
            "retpu_fleet_pulls_total": obs_registry.family(
                "counter", "obsq sideband pulls posted to replica "
                "links (watchdog = the standing walker; verb = "
                "one-off fleet verbs and correlated dumps)",
                {"watchdog": self.pulls,
                 "verb": getattr(self.svc, "fleet_verb_pulls", 0)},
                label="source"),
            "retpu_fleet_pull_failures_total": obs_registry.family(
                "counter", "obsq pulls that completed (or expired) "
                "without a usable payload",
                {"watchdog": self.pull_failures,
                 "verb": getattr(self.svc,
                                 "fleet_verb_pull_failures", 0)},
                label="source"),
            # label "peer", NOT "host": the fleet scrape injects a
            # host="<answering process>" label into every sample,
            # and a second label under the same name would make
            # Prometheus reject the whole merged document
            "retpu_clock_offset_ms": obs_registry.family(
                "gauge", "estimated per-link clock offset (replica "
                "monotonic minus leader monotonic)",
                {h: e["offset_ms"] for h, e in offs.items()
                 if "offset_ms" in e}, label="peer"),
            "retpu_clock_offset_bound_ms": obs_registry.family(
                "gauge", "uncertainty bound the offset estimate is "
                "honest to (half best round-trip + drift allowance)",
                {h: e["bound_ms"] for h, e in offs.items()
                 if "bound_ms" in e}, label="peer"),
        }

    def health_section(self) -> Dict[str, Any]:
        evs = self.journal.tail(1)
        return {
            "enabled": bool(self.enabled),
            "cadence_flushes": int(self.cadence),
            "evals": int(self.evals),
            "pulls": int(self.pulls),
            "pull_failures": int(self.pull_failures),
            "findings": dict(self.findings),
            "clock": self._offsets(),
            "last_finding": evs[0] if evs else None,
        }

    def flight_section(self) -> List[Dict[str, Any]]:
        """The flight-dump ``watchdog_findings`` section."""
        return self.journal.tail(16)
