"""Metrics registry: counters, gauges, fixed-bucket histograms.

Copied from ``riak_ensemble_tpu/obs/registry.py``, so the port imports
nothing of the JAX package.

Design constraints, in order:

1. **Cheap to record.**  A counter inc is one attribute add; a
   histogram record is one bisect into a FIXED bucket ladder plus two
   adds — no allocation, no locking on the hot path (CPython's GIL
   makes the single adds atomic enough for monitoring counters; the
   flush path is single-threaded per service anyway).
2. **Cheap when off.**  Instruments exist either way; callers gate
   their record calls on a cached ``enabled()`` bool, so the
   ``RETPU_OBS=0`` arm pays one attribute test per flush.
3. **Pull, don't push.**  Most service counters already live as plain
   attributes on the hot path (``flushes``, ``ops_served``, ...).
   Rather than double-writing them, the registry supports CALLBACK
   instruments (a gauge/counter whose value is read at export time)
   and COLLECTORS (a function contributing whole labeled metric
   families at export time — the per-tenant arrays export this way,
   so the hot path touches numpy, never dicts of label children).

Exports: :meth:`MetricsRegistry.snapshot` (plain JSON-able dict —
the svcnode ``metrics`` verb's default) and
:meth:`MetricsRegistry.render_prometheus` (text exposition format).
"""

from __future__ import annotations

from bisect import bisect_left
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "MS_BUCKETS", "percentile_from_counts", "family"]

#: default latency ladder (milliseconds): log-spaced upper bounds
#: from 50 µs to 30 s — wide enough for a leased read and a wedged
#: d2h alike; 18 buckets keeps a [E, B] per-tenant plane small.
MS_BUCKETS: Tuple[float, ...] = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0)


def percentile_from_counts(counts, edges, q: float) -> float:
    """Bucket-resolution quantile estimate over fixed-bucket counts
    (``len(counts) == len(edges) + 1``; the final count is the +Inf
    overflow): linear interpolation inside the landing bucket, with
    the overflow bucket reported as its lower bound (there is no
    honest upper edge past the ladder).  The ONE estimator behind
    both :meth:`Histogram.percentile` and the per-tenant latency
    planes — two copies would silently diverge."""
    total = 0
    for c in counts:
        total += c
    if not total:
        return 0.0
    target = q * total
    acc = 0
    lo = 0.0
    for i, c in enumerate(counts):
        if i >= len(edges):
            return lo  # overflow bucket: no upper edge to lerp to
        hi = float(edges[i])
        if acc + c >= target:
            if not c:
                return hi
            return lo + (hi - lo) * (target - acc) / c
        acc += c
        lo = hi
    return lo


def family(typ: str, help: str, values: Dict[Any, Any],
           label: str = "tenant") -> Dict[str, Any]:
    """Build one collector-family dict in the shape
    :meth:`MetricsRegistry.collect` requires — the ONE place that
    shape lives, so the collectors in batched_host/repgroup can't
    drift from it.  ``values`` maps label value (or None for the
    unlabeled sample) to the metric value; ``label`` names the label
    dimension in the Prometheus exposition."""
    return {"type": typ, "help": help, "values": values,
            "label": label}


class Counter:
    """Monotonic counter; optionally labeled via :meth:`labels`
    (``label_name`` names the dimension in the exposition — "tenant"
    for the per-tenant families, "kind" for the tracer fold)."""

    __slots__ = ("name", "help", "value", "label_name", "_children")

    def __init__(self, name: str, help: str = "",
                 label_name: str = "tenant") -> None:
        self.name = name
        self.help = help
        self.value = 0
        self.label_name = label_name
        self._children: Optional[Dict[str, "Counter"]] = None

    def inc(self, n: float = 1) -> None:
        self.value += n

    def labels(self, label: str) -> "Counter":
        if self._children is None:
            self._children = {}
        child = self._children.get(label)
        if child is None:
            child = self._children[label] = Counter(
                self.name, self.help, self.label_name)
        return child

    def remove_label(self, label: str) -> bool:
        """Drop one labeled child series (tenant recycle: the label's
        owner is gone, and a retained child would keep exporting a
        dead tenant's counts forever)."""
        if self._children is None:
            return False
        return self._children.pop(label, None) is not None

    def _samples(self):
        if self._children:
            for label, child in self._children.items():
                yield label, child.value
        if self.value or not self._children:
            yield None, self.value


class Gauge:
    """Point-in-time value: set directly, or backed by a callback
    read at export time (the pull discipline — hot-path attributes
    stay plain attributes)."""

    __slots__ = ("name", "help", "value", "fn")

    def __init__(self, name: str, help: str = "",
                 fn: Optional[Callable[[], float]] = None) -> None:
        self.name = name
        self.help = help
        self.value = 0.0
        self.fn = fn

    def set(self, v: float) -> None:
        self.value = v

    def read(self) -> float:
        if self.fn is not None:
            try:
                return float(self.fn())
            except Exception:
                return float("nan")
        return self.value


class Histogram:
    """Fixed-bucket histogram: ``record`` is a bisect into the
    precomputed upper-bound ladder plus two adds.  ``+Inf`` overflow
    rides an implicit final bucket.  Percentiles are bucket-resolution
    estimates (linear interpolation inside the landing bucket) —
    exactly what a fixed-bucket design can honestly claim."""

    __slots__ = ("name", "help", "buckets", "counts", "count", "sum",
                 "label_name", "_children")

    def __init__(self, name: str, help: str = "",
                 buckets: Tuple[float, ...] = MS_BUCKETS,
                 label_name: str = "tenant") -> None:
        self.name = name
        self.help = help
        self.buckets = tuple(float(b) for b in buckets)
        assert list(self.buckets) == sorted(set(self.buckets)), \
            "histogram buckets must be strictly increasing"
        self.counts = [0] * (len(self.buckets) + 1)
        self.count = 0
        self.sum = 0.0
        self.label_name = label_name
        self._children: Optional[Dict[str, "Histogram"]] = None

    def record(self, v: float) -> None:
        self.counts[bisect_left(self.buckets, v)] += 1
        self.count += 1
        self.sum += v

    def labels(self, label: str) -> "Histogram":
        if self._children is None:
            self._children = {}
        child = self._children.get(label)
        if child is None:
            child = self._children[label] = Histogram(
                self.name, self.help, self.buckets, self.label_name)
        return child

    def remove_label(self, label: str) -> bool:
        """Drop one labeled child series (see Counter.remove_label)."""
        if self._children is None:
            return False
        return self._children.pop(label, None) is not None

    def percentile(self, q: float) -> float:
        """Bucket-resolution estimate of the q-quantile (0 < q <= 1);
        see :func:`percentile_from_counts`."""
        return percentile_from_counts(self.counts, self.buckets, q)

    def _snapshot(self) -> Dict[str, Any]:
        return {"count": self.count, "sum": round(self.sum, 6),
                "buckets": dict(zip(
                    [*map(str, self.buckets), "+Inf"], self.counts)),
                "p50": round(self.percentile(0.5), 6),
                "p99": round(self.percentile(0.99), 6)}


class MetricsRegistry:
    """One process-or-service-scoped family of instruments.

    Get-or-create accessors keep wiring idempotent; :meth:`collect`
    registers an export-time contributor for labeled families whose
    hot-path representation is something cheaper than label children
    (the per-tenant numpy planes).  Collector functions return
    ``{name: {"type": t, "help": h, "values": {label_or_None: v}}}``.
    """

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        self._collectors: List[Callable[[], Dict[str, Any]]] = []

    # -- get-or-create accessors -------------------------------------------

    def counter(self, name: str, help: str = "",
                label_name: str = "tenant") -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name, help, label_name)
        return c

    def gauge(self, name: str, help: str = "",
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name, help, fn)
        elif fn is not None:
            g.fn = fn
        return g

    def histogram(self, name: str, help: str = "",
                  buckets: Tuple[float, ...] = MS_BUCKETS,
                  label_name: str = "tenant") -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(name, help, buckets,
                                              label_name)
        return h

    def collect(self, fn: Callable[[], Dict[str, Any]]) -> None:
        self._collectors.append(fn)

    def remove_labeled(self, label: str) -> int:
        """Drop every labeled child series recorded under ``label``
        across all counters and histograms — the ensemble-row recycle
        hook: a recycled tenant's ledger row is zeroed, and any
        labeled series created under its label must go with it, or
        the registry keeps exporting (and a successor tenant reusing
        the label inherits) a dead tenant's samples.  Collector
        families are untouched — they re-derive their label sets at
        export time.  Returns how many series were dropped."""
        dropped = 0
        for c in self._counters.values():
            dropped += c.remove_label(label)
        for h in self._hists.values():
            dropped += h.remove_label(label)
        return dropped

    # -- export -------------------------------------------------------------

    def _collected(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for fn in self._collectors:
            try:
                out.update(fn())
            except Exception:
                continue  # a broken collector must not kill export
        return out

    def names(self) -> List[str]:
        """Every registered metric name (collector families included)
        — the docs ratchet's source of truth."""
        return sorted({*self._counters, *self._gauges, *self._hists,
                       *self._collected()})

    def snapshot(self) -> Dict[str, Any]:
        """Plain-container snapshot (wire- and JSON-encodable).  The
        unlabeled sample of a labeled family exports under the empty
        label ``""`` — ``str(None)`` would forge a tenant literally
        named "None", indistinguishable from a real one."""

        def by_label(samples: Dict[Any, Any]) -> Any:
            if list(samples) == [None]:
                return samples[None]
            return {("" if k is None else str(k)): v
                    for k, v in samples.items()}

        out: Dict[str, Any] = {}
        for name, c in self._counters.items():
            out[name] = by_label(dict(c._samples()))
        for name, g in self._gauges.items():
            v = g.read()
            # non-finite reads (a broken callback returns NaN) map to
            # None: the snapshot must stay strict-JSON-serializable
            out[name] = v if v == v and abs(v) != float("inf") \
                else None
        for name, h in self._hists.items():
            snap = h._snapshot()
            if h._children:
                snap["by_label"] = {label: ch._snapshot()
                                    for label, ch in h._children.items()}
            out[name] = snap
        for name, fam in self._collected().items():
            out[name] = by_label(fam["values"])
        return out

    def render_prometheus(self, host: Optional[str] = None) -> str:
        """Prometheus text exposition format, version 0.0.4.

        ``host`` labels every sample with ``host="..."`` (the
        fleet-scrape dimension: one leader scrape answering for the
        whole group tells its hosts apart by this label —
        ``obs.fleet.merge_prometheus`` applies the same injection to
        replica-rendered texts, so local and pulled sections agree)."""
        lines: List[str] = []
        if host is not None:
            from riak_ensemble_tpu_torch.obs import fleet as _fleet
            plain = self.render_prometheus()
            return "\n".join(
                _fleet.inject_host_label(ln, host)
                for ln in plain.splitlines()) + "\n"

        def head(name: str, typ: str, help: str) -> None:
            if help:
                lines.append(f"# HELP {name} {help}")
            lines.append(f"# TYPE {name} {typ}")

        def fmt(v: Any) -> str:
            f = float(v)
            if f != f:
                return "NaN"  # a broken callback gauge reads NaN —
            if f in (float("inf"), float("-inf")):  # the scrape must
                return "+Inf" if f > 0 else "-Inf"  # survive it
            return repr(int(f)) if f == int(f) else repr(f)

        def esc(label: Any) -> str:
            # exposition-format label escaping: tenant labels are
            # arbitrary user strings, and one unescaped quote would
            # make Prometheus reject the WHOLE scrape
            return (str(label).replace("\\", "\\\\")
                    .replace('"', '\\"').replace("\n", "\\n"))

        for name, c in self._counters.items():
            head(name, "counter", c.help)
            for label, v in c._samples():
                lines.append(
                    f'{name}{{{c.label_name}="{esc(label)}"}} {fmt(v)}'
                    if label is not None else f"{name} {fmt(v)}")
        for name, g in self._gauges.items():
            head(name, "gauge", g.help)
            lines.append(f"{name} {fmt(g.read())}")
        for name, h in self._hists.items():
            head(name, "histogram", h.help)
            # the parent's own series renders whenever it holds
            # direct records, even alongside labeled children —
            # snapshot() exports both, and the two surfaces must
            # never disagree about what was recorded
            series = ([(None, h)] if not h._children or h.count
                      else [])
            series += list(h._children.items()) if h._children else []
            for label, hh in series:
                sel = (f'{h.label_name}="{esc(label)}",'
                       if label is not None else "")
                acc = 0
                for edge, cnt in zip([*h.buckets, "+Inf"], hh.counts):
                    acc += cnt
                    lines.append(
                        f'{name}_bucket{{{sel}le="{edge}"}} {acc}')
                lines.append(f"{name}_sum{{{sel[:-1]}}} {fmt(hh.sum)}"
                             if sel else f"{name}_sum {fmt(hh.sum)}")
                lines.append(
                    f"{name}_count{{{sel[:-1]}}} {hh.count}"
                    if sel else f"{name}_count {hh.count}")
        for name, fam in self._collected().items():
            head(name, fam.get("type", "gauge"), fam.get("help", ""))
            lname = fam.get("label", "tenant")
            for label, v in fam["values"].items():
                lines.append(
                    f'{name}{{{lname}="{esc(label)}"}} {fmt(v)}'
                    if label is not None else f"{name} {fmt(v)}")
        return "\n".join(lines) + "\n"
