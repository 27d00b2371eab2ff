"""Obs-actuated runtime controller (docs/ARCHITECTURE.md §14).

Copied from ``riak_ensemble_tpu/obs/controller.py``, so the port imports
nothing of the JAX package.

PRs 6-9 built the senses — per-flush spans, per-op SLO rings,
per-tenant attribution, compile events, fault gauges — and this
module is the first thing that ACTS on them.  The PR 9 faultsweep
proved the optimal ``pipeline_depth``/``repl_window`` is
link-dependent (depth 2 worth 1.222x at 5 ms injected ack RTT, noise
at 1 ms), so any static default is wrong somewhere; the noisy-tenant
rung proved a hot tenant's row share is what a quiet tenant's p99
pays for.  Three actuators close those loops:

- :class:`AckRttTuner` — auto-tunes ``pipeline_depth``/``repl_window``
  from the measured ``repl_ack`` spans in the span store (the SAME
  samples ``obs.timeline(fid)`` shows a human), with hysteresis (a
  dead band between the up/down thresholds), a bounded step (one
  depth unit per evaluation), a flush-count cadence, and a
  leader-only gate (a replica lane has no ack path to tune).
- :class:`TenantGuard` — a per-tenant flush-admission token bucket
  fed by the PR 6 attribution plane: when one tenant's share of the
  window's ops crosses the guard threshold, its rows get a per-flush
  round cap (the service's token bucket), shrinking the batch depth
  its queue can force on everyone else — the quiet tenants' p99 is
  the SLO being defended.  Released with hysteresis when the share
  drops back.
- :class:`faults.SoakSchedule` (the chaos gate) — runs the silent
  wedge soak (:func:`riak_ensemble_tpu_torch.faults.wedge_soak`, the same
  blackhole mode the ``slow``-marked nemesis sweeps exercise) on a
  clock schedule and asserts wedge detection stays within
  2 x ``PeerLink.IO_TIMEOUT`` — chaos as a standing regression gate.

Every decision is itself observable through the plane that triggered
it: the bounded :class:`DecisionJournal` records (cause metric,
observed value, old -> new knob, flush id) per decision, exported as
the ``retpu_autotune_*`` gauge family, the ``health()``
``controller`` section, the flight-dump ``controller_decisions``
section, and Chrome-trace instants via ``tools/trace_export.py``.
:func:`replay` reconstructs the final knob state from the journal
alone — the bench ASSERTS that reconstruction against the live knobs,
so "the journal explains every knob change" is a tested property,
not a hope.

Knobs: ``RETPU_AUTOTUNE`` (default ``0`` — off for one release; the
off arm is the bit-identical oracle, the native-kernel discipline),
``RETPU_AUTOTUNE_CADENCE`` (flushes between evaluations),
``RETPU_TENANT_GUARD`` (``0`` disarms the admission actuator alone).
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Any, Dict, List, Optional

from riak_ensemble_tpu_torch.obs import registry as obs_registry
from riak_ensemble_tpu_torch.obs import spans as obs_spans

__all__ = ["DecisionJournal", "AckRttTuner", "TenantGuard",
           "RuntimeController", "replay", "enabled", "cadence",
           "tenant_guard_enabled"]


def enabled() -> bool:
    """Whether the controller actuates (``RETPU_AUTOTUNE=1``).  OFF
    by default for one release: the off arm must stay bit-identical
    to the pre-controller service (results, mirror slabs, wire
    bytes) — the same oracle discipline as the native kernels.
    Services cache the answer at construction."""
    return os.environ.get("RETPU_AUTOTUNE", "0") == "1"


def cadence(default: int = 64) -> int:
    """Flushes between controller evaluations
    (``RETPU_AUTOTUNE_CADENCE``, floor 1)."""
    try:
        return max(1, int(os.environ.get("RETPU_AUTOTUNE_CADENCE",
                                         str(default))))
    except ValueError:
        return default


def tenant_guard_enabled() -> bool:
    """Whether the tenant-admission actuator is armed alongside the
    controller (``RETPU_TENANT_GUARD``, default on; only meaningful
    while ``RETPU_AUTOTUNE=1`` arms the controller itself)."""
    return os.environ.get("RETPU_TENANT_GUARD", "1") != "0"


class DecisionJournal:
    """Bounded ring of controller decisions — the system's self-tuning
    made as observable as its flushes.

    One entry per decision: a monotonically increasing ``seq`` (so a
    consumer can detect ring overflow), wall time, the flush id the
    triggering evaluation ran at, the actuator, the CAUSE metric and
    its observed value, and the knob's ``old -> new`` transition.
    ``seq`` survives ring eviction; :func:`replay` folds entries into
    the final knob map."""

    def __init__(self, capacity: int = 256) -> None:
        self.capacity = int(capacity)
        self._ring: "deque[Dict[str, Any]]" = deque(maxlen=capacity)
        self.total = 0
        self.by_actuator: Dict[str, int] = {}

    def note(self, actuator: str, cause: str, observed: float,
             knob: Optional[str] = None, old: Any = None,
             new: Any = None, flush_id: int = 0,
             **info: Any) -> Dict[str, Any]:
        self.total += 1
        self.by_actuator[actuator] = \
            self.by_actuator.get(actuator, 0) + 1
        ev = {
            "seq": self.total,
            "t": time.time(),
            "flush_id": int(flush_id),
            "actuator": str(actuator),
            "cause": str(cause),
            "observed": (round(float(observed), 6)
                         if observed is not None else None),
            "knob": knob,
            "old": old,
            "new": new,
        }
        ev.update(info)
        self._ring.append(ev)
        return ev

    def snapshot(self) -> List[Dict[str, Any]]:
        """Oldest-first copies of the retained entries (plain
        containers — wire/JSON encodable)."""
        return [dict(ev) for ev in self._ring]

    def tail(self, n: int) -> List[Dict[str, Any]]:
        evs = list(self._ring)
        return [dict(ev) for ev in (evs[-n:] if n else [])]


def replay(events, initial: Dict[str, Any]) -> Dict[str, Any]:
    """Reconstruct the knob state from journal events alone: fold
    every knob-bearing decision's ``old -> new`` over ``initial``,
    checking each transition's ``old`` against the folded state (a
    mismatch means the journal does NOT explain the knob history —
    the bench's reconstruction assertion fails loudly, not softly).
    """
    state = dict(initial)
    for ev in events:
        knob = ev.get("knob")
        if knob is None:
            continue
        if knob in state and state[knob] != ev.get("old"):
            raise ValueError(
                f"journal replay mismatch: decision seq "
                f"{ev.get('seq')} claims {knob} was {ev.get('old')!r} "
                f"but the folded state holds {state[knob]!r}")
        state[knob] = ev.get("new")
    return state


class AckRttTuner:
    """Hysteresis + bounded-step tuner for the replication pipeline
    knobs, driven by measured ``repl_ack`` span p50.

    Decision table (evaluated once per cadence window, leader-only):

    - p50 >= ``up_ms`` and depth < ``max_depth``: step depth +1 and
      widen ``repl_window`` to ``2 x depth`` — the link is slow
      enough that overlapping ship N with flush N+1 pays (the PR 9
      faultsweep's measured regime).
    - depth above its baseline AND the link healed: step depth -1
      (window shrinks toward its own baseline).  "Healed" is
      ``p50 <= down_ms`` OR ``p50 <= down_frac x`` the p50 that
      triggered the last up-step — the RELATIVE clause matters
      because ``repl_ack`` includes the replica's apply cost, which
      never goes to zero: on a box whose loopback ack floor is
      ~2 ms, an absolute 1 ms threshold would pin an elevated depth
      forever after the injected delay vanished.
    - between the heal condition and ``up_ms``: HOLD.  The dead band
      is the hysteresis: a link hovering at one threshold cannot
      flap the knob every window.

    One bounded step per evaluation; ``min_samples`` acks required
    before any move (a quiet window is not evidence).  Baselines are
    the knob values observed at arm time, so the tuner converges back
    to the operator's configuration on heal instead of inventing its
    own floor."""

    CAUSE = "repl_ack_ms_p50"

    def __init__(self, up_ms: float = 4.0, down_ms: float = 1.0,
                 down_frac: float = 0.5,
                 max_depth: int = 4, min_samples: int = 4) -> None:
        assert down_ms < up_ms, "hysteresis needs down_ms < up_ms"
        assert 0.0 < down_frac < 1.0
        self.up_ms = float(up_ms)
        self.down_ms = float(down_ms)
        self.down_frac = float(down_frac)
        self.max_depth = int(max_depth)
        self.min_samples = int(min_samples)
        self.last_p50_ms: Optional[float] = None
        #: the windowed p50 that justified the most recent up-step —
        #: the relative heal condition's reference
        self._up_p50_ms: Optional[float] = None

    def evaluate(self, svc: Any, samples_s: List[float],
                 journal: DecisionJournal,
                 flush_id: int) -> List[Dict[str, Any]]:
        if len(samples_s) < self.min_samples:
            return []
        ms = sorted(samples_s)
        p50 = ms[len(ms) // 2] * 1e3
        self.last_p50_ms = p50
        depth = int(svc.pipeline_depth)
        base_depth = getattr(svc, "_autotune_base_depth", depth)
        base_window = getattr(svc, "_autotune_base_window",
                              int(getattr(svc, "repl_window", 1)))
        healed = p50 <= self.down_ms or (
            self._up_p50_ms is not None
            and p50 <= self.down_frac * self._up_p50_ms)
        out: List[Dict[str, Any]] = []
        if p50 >= self.up_ms and depth < self.max_depth:
            self._up_p50_ms = p50
            new_depth = depth + 1
            svc.set_pipeline_depth(new_depth)
            out.append(journal.note(
                "ack_rtt", self.CAUSE, p50, knob="pipeline_depth",
                old=depth, new=new_depth, flush_id=flush_id,
                direction="up"))
            want_w = max(base_window, 2 * new_depth)
            old_w = int(svc.repl_window)
            if want_w != old_w and hasattr(svc, "set_repl_window"):
                svc.set_repl_window(want_w)
                out.append(journal.note(
                    "ack_rtt", self.CAUSE, p50, knob="repl_window",
                    old=old_w, new=want_w, flush_id=flush_id,
                    direction="up"))
        elif healed and depth > base_depth:
            new_depth = depth - 1
            svc.set_pipeline_depth(new_depth)
            out.append(journal.note(
                "ack_rtt", self.CAUSE, p50, knob="pipeline_depth",
                old=depth, new=new_depth, flush_id=flush_id,
                direction="down"))
            want_w = (base_window if new_depth <= base_depth
                      else max(base_window, 2 * new_depth))
            old_w = int(svc.repl_window)
            if want_w != old_w and hasattr(svc, "set_repl_window"):
                svc.set_repl_window(want_w)
                out.append(journal.note(
                    "ack_rtt", self.CAUSE, p50, knob="repl_window",
                    old=old_w, new=want_w, flush_id=flush_id,
                    direction="down"))
        return out


class TenantGuard:
    """Flush-admission guard: cap a noisy tenant's per-flush row
    share via the service's token bucket.

    Fed by the attribution plane's op counters (``tenant_ops`` deltas
    over the cadence window).  When one tenant's share of the
    window's ops reaches ``share_high`` — and other tenants were
    active, so there is someone to defend — its rows get a per-flush
    admission cap of ``cap_frac x max_k`` rounds (floor 1).  The cap
    is a TOKEN BUCKET on the service (refilled per flush, burst
    2x), so a capped tenant still gets steady throughput — it just
    can't force every flush to its own max batch depth.  Released
    when the share falls to ``share_low`` (hysteresis band again).
    """

    CAUSE = "tenant_ops_share"

    def __init__(self, share_high: float = 0.7,
                 share_low: float = 0.45,
                 cap_frac: float = 0.5,
                 min_ops: int = 64) -> None:
        assert share_low < share_high
        self.share_high = float(share_high)
        self.share_low = float(share_low)
        self.cap_frac = float(cap_frac)
        self.min_ops = int(min_ops)
        #: rows currently capped, keyed by tenant label
        self.throttled: Dict[str, List[int]] = {}
        self.last_top_share: Optional[float] = None

    def evaluate(self, svc: Any, window_ops,
                 journal: DecisionJournal,
                 flush_id: int) -> List[Dict[str, Any]]:
        import numpy as np

        total = int(window_ops.sum())
        out: List[Dict[str, Any]] = []
        if total < self.min_ops:
            return out
        # group rows by tenant label exactly the way the attribution
        # exports do — a multi-row tenant is ONE tenant here too
        shares: Dict[str, float] = {}
        rows_of: Dict[str, List[int]] = {}
        for e in np.nonzero(window_ops)[0].tolist():
            lbl = svc.tenant_label(e)
            shares[lbl] = shares.get(lbl, 0.0) \
                + float(window_ops[e]) / total
            rows_of.setdefault(lbl, []).append(e)
        if not shares:
            return out
        top = max(shares, key=shares.get)
        self.last_top_share = round(shares[top], 4)
        cap = max(1, int(svc.max_k * self.cap_frac))
        if (shares[top] >= self.share_high
                and len(shares) > 1 and top not in self.throttled):
            self.throttled[top] = rows_of[top]
            out.append(journal.note(
                "tenant_guard", self.CAUSE, shares[top],
                knob=f"admission_cap[{top}]", old=None, new=cap,
                flush_id=flush_id, tenant=top, rows=rows_of[top]))
        for lbl in list(self.throttled):
            if shares.get(lbl, 0.0) <= self.share_low:
                rows = self.throttled.pop(lbl)
                out.append(journal.note(
                    "tenant_guard", self.CAUSE,
                    shares.get(lbl, 0.0),
                    knob=f"admission_cap[{lbl}]", old=cap, new=None,
                    flush_id=flush_id, tenant=lbl, rows=rows))
        if out:
            caps: Dict[int, int] = {}
            for rows in self.throttled.values():
                for e in rows:
                    caps[e] = cap
            svc.set_admission_caps(caps or None)
        return out


class RuntimeController:
    """The per-service control loop: consumes the service's own obs
    surfaces on a flush-count cadence and drives the knobs, with
    every decision journaled.

    Constructed by EVERY service (so the ``retpu_autotune_*`` gauge
    family is always registered — zeros when off, the fault-gauge
    discipline); it only ACTS while ``enabled`` is True.  The hot
    path pays one attribute test per flush when off and one integer
    compare per flush when on; evaluations run at most every
    ``cadence`` flushes."""

    def __init__(self, svc: Any,
                 tuner: Optional[AckRttTuner] = None,
                 guard: Optional[TenantGuard] = None,
                 soak_interval_s: float = 0.0,
                 journal_capacity: int = 256) -> None:
        from riak_ensemble_tpu_torch import faults  # no import cycle at top

        self.svc = svc
        self.enabled = enabled()
        self.cadence = cadence()
        self.guard_enabled = tenant_guard_enabled()
        self.tuner = tuner if tuner is not None else AckRttTuner()
        self.guard = guard if guard is not None else TenantGuard()
        #: the standing chaos gate; disarmed by default (interval 0)
        #: — armed explicitly via :meth:`arm_soak` or the soak
        #: constructor arg, never inherited from the environment
        self.soak = faults.SoakSchedule(soak_interval_s)
        self.journal = DecisionJournal(journal_capacity)
        self.evals = 0
        self._since_eval = 0
        self._in_eval = False
        self._last_ops = None  # per-row op counts at last evaluation
        self._window_fids: List[int] = []
        # remember the operator's configuration as the heal target
        # (re-anchored by the service's set_autotune on every arm, so
        # knobs moved after construction become the new floor)
        svc._autotune_base_depth = int(svc.pipeline_depth)
        svc._autotune_base_window = int(getattr(svc, "repl_window", 1))

    # -- cadence ------------------------------------------------------------

    def tick(self, flush_id: int = 0) -> None:
        """Per-settled-flush hook (the service calls this only while
        the controller is enabled): count the flush into the window
        and evaluate every ``cadence`` flushes."""
        if flush_id:
            self._window_fids.append(int(flush_id))
        self._since_eval += 1
        if self._since_eval >= self.cadence:
            self.evaluate()

    def arm_soak(self, interval_s: float, runner: Any = None,
                 clock: Any = None) -> None:
        """Arm (or re-arm) the standing chaos gate."""
        from riak_ensemble_tpu_torch import faults

        self.soak = faults.SoakSchedule(interval_s, runner=runner,
                                        clock=clock)

    def evaluate(self) -> List[Dict[str, Any]]:
        """One control-loop evaluation over the window since the last
        one.  Returns the decisions taken (possibly empty).

        Re-entrancy: actuation (a depth change, a soak heartbeat)
        settles in-flight launches, whose settle hooks tick the
        cadence — a nested tick must never start a second evaluation
        under the first one's feet."""
        if self._in_eval:
            return []
        self._in_eval = True
        try:
            return self._evaluate()
        finally:
            self._in_eval = False

    def _evaluate(self) -> List[Dict[str, Any]]:
        import numpy as np

        svc = self.svc
        self.evals += 1
        self._since_eval = 0
        fids, self._window_fids = self._window_fids, []
        fid = fids[-1] if fids else 0
        decisions: List[Dict[str, Any]] = []
        # (a) ack-RTT depth/window tuning — leader-only (a deposed or
        # replica lane must not grow in-flight state), and only where
        # an ack path exists at all
        is_leader = getattr(svc, "is_leader", True)
        if is_leader and getattr(svc, "_links", None):
            samples = obs_spans.SPANS.span_values(
                fids, "leader", "repl_ack")
            decisions += self.tuner.evaluate(svc, samples,
                                             self.journal, fid)
        # (b) tenant-admission guard, off the attribution plane
        if self.guard_enabled:
            ops = np.asarray(svc.tenant_ops, dtype=np.int64)
            if self._last_ops is None or len(self._last_ops) != len(ops):
                window = ops.copy()
            else:
                window = np.maximum(ops - self._last_ops, 0)
            self._last_ops = ops.copy()
            decisions += self.guard.evaluate(svc, window,
                                             self.journal, fid)
        # (c) the standing chaos gate (disarmed unless an interval
        # was set): the soak result is a journaled decision too
        result = self.soak.maybe_run(svc)
        if result is not None:
            decisions.append(self.journal.note(
                "chaos", "wedge_soak_detect_s",
                result.get("detect_s", 0.0) or 0.0,
                flush_id=fid, ok=bool(result.get("ok")),
                result=result))
        return decisions

    # -- export surfaces ----------------------------------------------------

    def collect(self) -> Dict[str, Any]:
        """Registry collector: the ``retpu_autotune_*`` family —
        ALWAYS registered (zeros while off), so a dashboard's queries
        keep their shape when the controller arms."""
        def fam(typ, help, val):
            return obs_registry.family(typ, help, {None: val})

        throttled_rows = sum(len(r) for r in
                             self.guard.throttled.values())
        return {
            "retpu_autotune_enabled": fam(
                "gauge", "1 while the runtime controller actuates "
                "(RETPU_AUTOTUNE)", int(self.enabled)),
            "retpu_autotune_evals_total": fam(
                "counter", "controller evaluations run", self.evals),
            "retpu_autotune_decisions_total": fam(
                "counter", "journaled controller decisions",
                self.journal.total),
            "retpu_autotune_pipeline_depth": fam(
                "gauge", "current launch pipeline depth (the "
                "controller's depth actuator target)",
                int(self.svc.pipeline_depth)),
            "retpu_autotune_repl_window": fam(
                "gauge", "current replication ack window",
                int(getattr(self.svc, "repl_window", 1))),
            "retpu_autotune_ack_rtt_ms": fam(
                "gauge", "last evaluated repl-ack p50 (ms; 0 before "
                "any ack-bearing window)",
                round(self.tuner.last_p50_ms or 0.0, 3)),
            "retpu_autotune_tenant_throttled_rows": fam(
                "gauge", "ensemble rows currently under a "
                "tenant-guard admission cap", throttled_rows),
            "retpu_autotune_soak_runs_total": fam(
                "counter", "standing chaos-gate soaks run",
                self.soak.runs),
            "retpu_autotune_soak_failures_total": fam(
                "counter", "soaks whose wedge-detection assertion "
                "failed", self.soak.failures),
        }

    def health_section(self) -> Dict[str, Any]:
        """The ``health()`` verb's ``controller`` section — the same
        numbers the gauges export, plus the last decision, in one
        poll-safe dict."""
        evs = self.journal.tail(1)
        return {
            "enabled": bool(self.enabled),
            "cadence_flushes": int(self.cadence),
            "evals": int(self.evals),
            "decisions": int(self.journal.total),
            "pipeline_depth": int(self.svc.pipeline_depth),
            "repl_window": int(getattr(self.svc, "repl_window", 1)),
            "ack_rtt_ms": (round(self.tuner.last_p50_ms, 3)
                           if self.tuner.last_p50_ms is not None
                           else None),
            "tenant_throttled": {lbl: list(rows) for lbl, rows
                                 in self.guard.throttled.items()},
            "soak": {
                "interval_s": self.soak.interval_s,
                "runs": self.soak.runs,
                "failures": self.soak.failures,
                "last_ok": (None if self.soak.last is None
                            else bool(self.soak.last.get("ok"))),
            },
            "last_decision": evs[0] if evs else None,
        }

    def flight_section(self) -> List[Dict[str, Any]]:
        """The flight-dump ``controller_decisions`` section: the
        newest journaled decisions, oldest first."""
        return self.journal.tail(16)
