"""Fleet-scope observability: clock offsets, merged scrapes, aligned
cross-host timelines.

Copied from ``riak_ensemble_tpu/obs/fleet.py``, so the port imports
nothing of the JAX package.

PRs 6/8/11 built a complete obs plane — metrics, health,
``obs.timeline(fid)``, flight dumps, the controller journal — but
every surface is PER PROCESS: diagnosing a 3-host replicated group
meant ssh-ing each host and eyeballing three unaligned monotonic
clocks.  This module is the host-joining half:

- :class:`ClockOffset` — per-link offset estimation in the NTP
  style: every ``obsq`` sideband round-trip over a
  :class:`~riak_ensemble_tpu_torch.parallel.repgroup.PeerLink` yields
  ``(t0, t_remote, t1)`` monotonic stamps (send, remote handle,
  response arrival); the midpoint estimate ``t_remote - (t0+t1)/2``
  is correct to within ``(t1-t0)/2`` REGARDLESS of path asymmetry —
  the classic bound — so span alignment can always be read against
  an honest uncertainty.  A bounded sample window smooths over
  queue-dwell outliers (the best sample is the one with the smallest
  bound, widened by a drift allowance as it ages).
- :func:`merge_prometheus` — fold several hosts' Prometheus text
  renders into ONE scrape document: families grouped (one
  ``# TYPE`` per family, the exposition-format requirement), every
  sample gaining a ``host="..."`` label, so one leader scrape
  answers for the whole group.
- :func:`align_timeline` — the cross-host ``obs.timeline(fid)``:
  each role's span list is anchored at its recorder's monotonic
  stamp (``t_mono``, stamped at record time — spans lay out
  sequentially ENDING there, the same ordinal-within-role layout
  ``tools/trace_export.py`` documents), replica anchors are mapped
  onto the LEADER's clock through the link offsets, and the result
  is one axis with per-role ``(name, start_s, dur_s)`` triples plus
  the offset bounds the alignment is honest to.

Nothing here touches the wire or a service directly — repgroup owns
the ``obsq`` request plumbing and svcnode the client verbs; this
module is pure data plumbing so every piece is unit-testable without
a socket.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["ClockOffset", "merge_prometheus", "inject_host_label",
           "align_timeline", "role_host"]


class ClockOffset:
    """NTP-midpoint offset estimator for one leader→replica link.

    ``update(t0, t_remote, t1)`` feeds one sideband round-trip: the
    request's wire-send monotonic stamp, the remote's monotonic stamp
    while handling it, and the response's arrival stamp (all three
    already exist on the PeerLink ticket path).  The offset estimate
    ``t_remote - (t0 + t1) / 2`` assumes a symmetric path; its error
    is bounded by ``(t1 - t0) / 2`` for ANY asymmetry (the remote
    stamp provably lies inside the [t0, t1] window), which is the
    bound every consumer gets alongside the estimate.

    Smoothing is drift-window best-sample: keep the last ``window``
    samples, widen each sample's bound by ``drift * age`` (monotonic
    clocks on distinct hosts drift apart — NTP-disciplined boxes stay
    under ~50 ppm; the default allowance is generous), and answer the
    sample with the smallest widened bound.  A burst of queue-dwell
    outliers (big ``t1 - t0``) therefore never displaces a recent
    tight sample, and a link that stops being pulled honestly reports
    a growing bound instead of a stale certainty.
    """

    #: drift allowance applied per second of sample age (200 ppm —
    #: an order of magnitude above NTP-disciplined reality, so the
    #: widened bound errs toward honesty)
    DRIFT = 200e-6

    def __init__(self, window: int = 64) -> None:
        #: (t_mid_local, offset_s, half_rtt_s), newest last.
        #: Lock-guarded: updates land from settle/harvest/executor
        #: threads while scrape threads iterate for estimates — an
        #: unguarded deque raises "mutated during iteration" exactly
        #: when the system is busy (both paths are cold)
        self._samples: "deque[Tuple[float, float, float]]" = \
            deque(maxlen=window)
        self._lock = threading.Lock()
        #: total round-trips folded in (monotone; survives windowing)
        self.samples = 0

    def update(self, t0: float, t_remote: float, t1: float) -> None:
        """Fold one round-trip's stamps; nonsensical windows
        (``t1 < t0``) are dropped rather than poisoning the window."""
        if t1 < t0:
            return
        with self._lock:
            self._samples.append(((t0 + t1) / 2.0,
                                  t_remote - (t0 + t1) / 2.0,
                                  (t1 - t0) / 2.0))
            self.samples += 1

    def estimate(self, now: Optional[float] = None
                 ) -> Optional[Tuple[float, float]]:
        """``(offset_s, bound_s)`` — remote_clock − local_clock, and
        the uncertainty the estimate is honest to — or None before
        any sample.  The winning sample is the one with the smallest
        age-widened bound."""
        with self._lock:
            samples = list(self._samples)
        if not samples:
            return None
        now = time.monotonic() if now is None else now
        best: Optional[Tuple[float, float]] = None
        for t_mid, off, half in samples:
            bound = half + max(0.0, now - t_mid) * self.DRIFT
            if best is None or bound < best[1]:
                best = (off, bound)
        return best

    def section(self) -> Dict[str, Any]:
        """Wire-encodable summary (the ``clock`` section of fleet
        answers): offset/bound in ms + sample count, or a bare
        ``{"samples": 0}`` before any round-trip."""
        est = self.estimate()
        if est is None:
            return {"samples": 0}
        return {"offset_ms": round(est[0] * 1e3, 4),
                "bound_ms": round(est[1] * 1e3, 4),
                "samples": int(self.samples)}


# -- Prometheus merge --------------------------------------------------------

def _label_end(line: str, start: int) -> int:
    """Index of the ``}`` closing the labelset opened at ``start``
    (which must point at ``{``), honoring quoted label values with
    escapes — a tenant label may legally contain ``}``."""
    i = start + 1
    in_q = False
    while i < len(line):
        c = line[i]
        if in_q:
            if c == "\\":
                i += 2
                continue
            if c == '"':
                in_q = False
        elif c == '"':
            in_q = True
        elif c == "}":
            return i
        i += 1
    raise ValueError(f"unterminated labelset: {line!r}")


def _esc(label: Any) -> str:
    return (str(label).replace("\\", "\\\\")
            .replace('"', '\\"').replace("\n", "\\n"))


def inject_host_label(line: str, host: str) -> str:
    """One sample line with ``host="..."`` prepended to its labelset
    (created when absent).  Header/comment lines — and samples
    ALREADY carrying a ``host`` label (a re-merged fleet section) —
    pass through: duplicate label names make Prometheus reject the
    whole document.  (The check is exact: a label VALUE can never
    contain an unescaped quote, so the raw substring ``host="`` only
    ever matches the label NAME.)"""
    if not line or line.startswith("#"):
        return line
    brace = line.find("{")
    space = line.find(" ")
    hsel = f'host="{_esc(host)}"'
    if brace != -1 and (space == -1 or brace < space):
        end = _label_end(line, brace)
        inner = line[brace + 1:end]
        if inner.startswith('host="') or ',host="' in inner:
            return line  # already host-labeled: idempotent merge
        sep = "," if inner else ""
        return f"{line[:brace + 1]}{hsel}{sep}{line[brace + 1:]}"
    if space == -1:
        raise ValueError(f"not a sample line: {line!r}")
    return f"{line[:space]}{{{hsel}}}{line[space:]}"


def _family_of(sample_name: str) -> str:
    """The family a sample line's metric name belongs to (histogram
    series render as ``<fam>_bucket``/``_sum``/``_count``)."""
    for suffix in ("_bucket", "_sum", "_count"):
        if sample_name.endswith(suffix):
            return sample_name[:-len(suffix)]
    return sample_name


def merge_prometheus(sections: Dict[str, Optional[str]]) -> str:
    """Fold per-host Prometheus text renders (``{host_label: text}``;
    None values — unreachable hosts — are skipped) into one
    exposition document: every sample gains its host's ``host=``
    label, and families sharing a name across hosts merge under ONE
    ``# HELP``/``# TYPE`` header (first writer wins — the format
    forbids repeated TYPE lines), ordered by first appearance."""
    order: List[str] = []
    fams: Dict[str, Dict[str, Any]] = {}

    def fam_for(name: str) -> Dict[str, Any]:
        fam = fams.get(name)
        if fam is None:
            fam = fams[name] = {"headers": [], "hdr_host": None,
                                "samples": []}
            order.append(name)
        return fam

    for host in sorted(sections):
        text = sections[host]
        if not text:
            continue
        for line in text.splitlines():
            if not line.strip():
                continue
            if line.startswith("# HELP ") or line.startswith("# TYPE "):
                fam = fam_for(line.split(None, 3)[2])
                # one header set per family: first contributing host
                # wins (repeated # TYPE lines are format violations)
                if fam["hdr_host"] in (None, host):
                    fam["hdr_host"] = host
                    fam["headers"].append(line)
                continue
            name = _family_of(line.split("{", 1)[0].split(" ", 1)[0])
            fam_for(name)["samples"].append(
                inject_host_label(line, host))
    out: List[str] = []
    for name in order:
        fam = fams[name]
        out.extend(fam["headers"])
        out.extend(fam["samples"])
    return "\n".join(out) + "\n"


# -- cross-host timeline alignment -------------------------------------------

def role_host(role: str, self_label: str) -> Optional[str]:
    """The host label a span-store role records under: the leader's
    own label for ``"leader"``, the lane tag for
    ``"replica@host:port"``, None for an untagged ``"replica"`` (a
    single-lane test store — alignment then has no offset to apply)."""
    if role == "leader":
        return self_label
    if role.startswith("replica@"):
        return role[len("replica@"):]
    return None


def align_timeline(flush_id: int, sides: Dict[str, Any],
                   offsets: Dict[str, Dict[str, Any]],
                   self_label: str) -> Dict[str, Any]:
    """One flush's merged role records on ONE (leader-clock) axis.

    ``sides`` is the merged ``SpanStore.timeline`` shape
    (``role -> {"spans": [...], ...info}``) with replica roles pulled
    from their own hosts' stores; ``offsets`` maps host label to a
    :meth:`ClockOffset.section` dict.  Each role's spans lay out
    sequentially ENDING at its ``t_mono`` anchor (the record-time
    stamp both record sites attach) mapped onto the leader clock;
    roles without an anchor (legacy records) report ``aligned:
    False`` and anchor at the axis origin.  Starts are re-based so
    the earliest aligned span starts at 0 (``base_s`` carries the
    subtracted leader-clock value)."""
    roles: Dict[str, Any] = {}
    ends: Dict[str, Optional[float]] = {}
    for role, side in sides.items():
        if role == "flush_id" or not isinstance(side, dict):
            continue
        host = role_host(role, self_label)
        t_mono = side.get("t_mono")
        aligned_end: Optional[float] = None
        bound_ms = 0.0
        if t_mono is not None:
            aligned_end = float(t_mono)
            if role != "leader":
                est = offsets.get(host) if host else None
                if est and "offset_ms" in est:
                    aligned_end -= est["offset_ms"] / 1e3
                    bound_ms = float(est.get("bound_ms", 0.0))
                else:
                    aligned_end = None  # no offset: can't place it
        ends[role] = aligned_end
        roles[role] = {"host": host, "bound_ms": bound_ms,
                       "aligned": aligned_end is not None,
                       "side": side}
    # axis origin: earliest aligned span start (end − role total)
    starts = []
    for role, info in roles.items():
        if ends[role] is None:
            continue
        total = sum(max(float(d), 0.0)
                    for _n, d in info["side"].get("spans", []))
        starts.append(ends[role] - total)
    base = min(starts) if starts else 0.0
    out_roles: Dict[str, Any] = {}
    for role, info in roles.items():
        side = info.pop("side")
        spans = side.get("spans", [])
        total = sum(max(float(d), 0.0) for _n, d in spans)
        t = (ends[role] - base - total) if ends[role] is not None \
            else 0.0
        laid: List[List[Any]] = []
        for name, dur in spans:
            d = max(float(dur), 0.0)
            laid.append([str(name), round(t, 6), round(d, 6)])
            t += d
        info["spans"] = laid
        info["end_s"] = (round(ends[role] - base, 6)
                         if ends[role] is not None else None)
        info.update({k: v for k, v in side.items()
                     if k not in ("spans", "t_mono")})
        out_roles[role] = info
    return {
        "flush_id": int(flush_id),
        "schema": "retpu-fleet-timeline-v1",
        "base_s": round(base, 6),
        "clock": dict(offsets),
        "roles": out_roles,
    }
