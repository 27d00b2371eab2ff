"""The port's observability plane against the JAX package's.

Mirrors ``tests/test_obs.py`` (all but its replication-group cases),
``tests/test_opslo.py`` and ``tests/test_prometheus_format.py``:

- the registry (counters, gauges, histograms, labels, collectors) fed
  the same records gives the same snapshot and byte-equal Prometheus
  text in both packages; so do the span store, the flight recorder's
  trigger and the op-SLO ring;
- the JAX service and the port's (``device="cpu"``), both on their
  package's simulator ``Runtime`` with obs ON (``RETPU_OBS`` unset, the
  reference's default), serve one seeded op stream (bursts, a trickle,
  CAS / delete batches, kmodify, dynamic rows with names, a destroy
  and a recreate) and then answer equal ``stats()``, ``health()``,
  ``health(ens)``, ``tenant_stats()`` and registry counters.  Timings
  (``*_ms`` values, histogram sums, ``latency_breakdown``) are compared
  by key set and sample count only;
- ``RETPU_OBS=0``: the port records no latency sample, span, flight
  record, SLO row or tenant ledger entry.

Tolerance: exact equality for everything that is a function of the op
stream; key sets and counts for timings.
"""

import math

import numpy as np
import pytest

from riak_ensemble_tpu_torch import obs as tobs
from riak_ensemble_tpu_torch.parallel import batched_host as tb
from riak_ensemble_tpu_torch.runtime import Runtime
from test_torch_native_enqueue import JAX_ENV
from test_torch_runtime import Twin, _workload
from test_torch_reference_natives import reference_natives  # noqa: F401 (autouse)

def _ref_obs():
    pytest.importorskip("jax")
    from riak_ensemble_tpu import obs as jobs_
    return jobs_


TIMED = ("p50_ms", "p99_ms", "last_ms", "total_ms", "lease_remaining_s",
         "lease_valid_fraction")


def _strip_times(x):
    """``x`` with every timing leaf replaced by a marker (the key stays,
    the value goes)."""
    if isinstance(x, dict):
        return {k: ("<t>" if k in TIMED else _strip_times(v))
                for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_strip_times(v) for v in x)
    return x


def _feed(reg_mod):
    """The same records into a fresh registry of either package."""
    r = reg_mod.MetricsRegistry()
    c = r.counter("retpu_x_total", "a counter")
    c.inc()
    c.inc(4)
    g = r.gauge("retpu_y", "a gauge")
    g.set(2.5)
    h = r.histogram("retpu_lat_ms", "a histogram", label_name="kind")
    for i, v in enumerate((0.01, 0.3, 7.0, 99.0, 1e5, 3.3)):
        h.labels("put" if i % 2 else "get").record(v)
    lab = r.counter("retpu_ops_total", "labelled", label_name="tenant")
    lab.labels("a").inc(3)
    lab.labels('we"ird\\name').inc()
    r.gauge("retpu_fn", "from a function", fn=lambda: 7)
    r.gauge("retpu_nan", "a NaN gauge", fn=lambda: float("nan"))
    r.collect(lambda: {"retpu_coll_total": reg_mod.registry.family(
        "counter", "collected", {None: 11}),
        "retpu_coll_lab": reg_mod.registry.family(
            "gauge", "collected labelled", {"x": 1.5, "y": 2},
            label="host")})
    return r


def test_registry_snapshot_and_prometheus_equal_reference():
    jo = _ref_obs()
    ref, got = _feed(jo), _feed(tobs)
    assert got.render_prometheus() == ref.render_prometheus()
    a, b = ref.snapshot(), got.snapshot()
    assert _nan_eq(a, b)
    h = got.histogram("retpu_lat_ms", "a histogram", label_name="kind")
    assert h.labels("put").count == 3


def _nan_eq(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_nan_eq(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_nan_eq, a, b))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


def test_prometheus_merge_and_percentiles_equal_reference():
    jo = _ref_obs()
    texts = {"h1:1": _feed(jo).render_prometheus(),
             "h2:2": _feed(jo).render_prometheus()}
    assert tobs.merge_prometheus(texts) == jo.merge_prometheus(texts)
    counts = [0, 3, 1, 0, 5] + [0] * (len(tobs.MS_BUCKETS) - 4)
    edges = np.asarray(tobs.MS_BUCKETS)
    for q in (0.01, 0.5, 0.9, 0.99, 1.0):
        assert tobs.registry.percentile_from_counts(counts, edges, q) == \
            jo.registry.percentile_from_counts(counts, edges, q)


def test_spans_and_flight_trigger_equal_reference(tmp_path):
    jo = _ref_obs()
    out = []
    for mod in (jo, tobs):
        store = mod.SpanStore(max_flushes=4)
        for fid in range(1, 7):
            store.record(fid, "leader", [("h2d", 0.001 * fid),
                                         ("dispatch", 0.002)], k=fid)
        tl = [store.timeline(f) for f in (1, 3, 6, 99)]
        fr = mod.FlightRecorder(min_samples=8, min_dump_interval_s=0,
                                dump_dir=str(tmp_path / mod.__name__))
        fired = []
        for i in range(12):
            total = 0.002 if i != 10 else 0.5
            fired.append(fr.record({"flush_id": i, "total": total,
                                    "h2d": total / 2, "wal": total / 2}))
        out.append((tl, [f is not None for f in fired], fr.anomalies,
                    dict(store.misses)))
    assert out[1] == out[0]
    assert out[1][2] == 1


def test_opslo_ring_equal_reference():
    jo = _ref_obs()
    res = []
    for mod in (jo, tobs):
        ring = mod.OpSloRing(capacity=64)
        kinds, ens, ns = (0, 1, 2, 3), (5, 6, 5, 7), (4, 1, 2, 3)
        ts = (1.0, 0.0, 1.5, 2.0)
        te = (1.1, 1.2, 1.6, 2.05)
        phys, lat = ring.record_flush(kinds, ens, ns, ts, te, 9, 2.1, 2.3,
                                      2.4)
        res.append((np.asarray(phys).tolist(), np.round(lat, 9).tolist(),
                    ring.slowest(2),
                    [ring.row_view(int(r)) for r in np.asarray(phys)]))
    assert res[1] == res[0]


# -- the service, JAX against the port, obs on ------------------------------

def _obs_twin(monkeypatch, **kw):
    monkeypatch.setitem(JAX_ENV, "default", {})
    monkeypatch.delenv("RETPU_OBS", raising=False)
    # each package's span store is process-global, and so are its miss
    # counts (``retpu_span_misses_total``): start both from zero, so the
    # registries compare this twin's lookups and not those of whatever
    # ran earlier in the process
    for spans in (_ref_obs().SPANS, tobs.SPANS):
        monkeypatch.setattr(spans, "misses", {"evicted": 0, "unknown": 0})
    tw = Twin(monkeypatch, 6, 3, 16, max_ops_per_tick=4, **kw)
    assert tw.js._obs and tw.ts._obs
    return tw


def _registry_counters(svc):
    """The registry's counters and gauges that are functions of the op
    stream: the build / compile counters (XLA compiles against library
    builds), device memory and every timing left out; a histogram by its
    sample counts (per label too)."""
    out = {}
    for name, v in svc.obs_registry.snapshot().items():
        if "compile" in name or name.startswith("retpu_backend_mem"):
            continue
        if isinstance(v, dict) and "buckets" in v:
            out[name] = (v["count"], {k: c["count"] for k, c in
                                      v.get("by_label", {}).items()})
        elif (name.endswith("_ms") or "_p50_" in name or "_p99_" in name
              or name == "retpu_lease_valid_fraction"):
            out[name] = "<t>"
        else:
            out[name] = v
    return out


def test_service_obs_equal_reference(monkeypatch):
    tw = _obs_twin(monkeypatch, dynamic=True)
    rows = tw.same(lambda s: [s.create_ensemble(f"t{i}") for i in range(5)])
    tw.call(lambda s: s.set_tenant_label(rows[4], "quiet"))
    orders = ([], [])
    for rt, svc, order in zip(tw.rts, tw.svcs, orders):
        end = _workload(rt, svc, 11, order)
    tw.run_for(end + 1.0)
    assert orders[1] == orders[0] and len(orders[1]) > 40
    assert tw.same(lambda s: s.destroy_ensemble("t2"))
    assert tw.same(lambda s: s.create_ensemble("t9")) == rows[2]
    tw.op(lambda s: s.kput_many(rows[2], ["x", "y"], [b"1", b"2"]))
    tw.op(lambda s: s.kget_many(rows[2], ["x", "y", "z"]))
    tw.run_for(0.05)
    tw.stop()
    js, ts = tw.svcs
    for fn in (lambda s: s.stats(), lambda s: s.health(),
               lambda s: s.tenant_stats(top=16),
               lambda s: [s.health(e) for e in range(s.n_ens)]):
        a, b = tw.call(fn)
        assert _strip_times(b) == _strip_times(a)
    assert _nan_eq(_registry_counters(js), _registry_counters(ts))
    for name in ("tenant_ops", "tenant_commits", "tenant_bytes",
                 "tenant_rounds"):
        assert np.array_equal(getattr(js, name), getattr(ts, name)), name
    assert int(ts._tenant_lat.sum()) == int(js._tenant_lat.sum()) > 0
    # timings: the same marks, one record per launch
    assert ts.latency_breakdown().keys() == js.latency_breakdown().keys()
    assert len(ts.lat_records) == len(js.lat_records) > 0
    assert ts.flight.records and len(ts.flight.records) == \
        len(js.flight.records)
    tw.check()


def test_trace_events_equal_reference(monkeypatch):
    """The runtime's trace hook hears the same service events, in the
    same order, with the same payloads."""
    from riak_ensemble_tpu.utils.trace import Tracer as JTracer
    from riak_ensemble_tpu_torch.utils.trace import Tracer
    tw = _obs_twin(monkeypatch, dynamic=True)
    trs = (JTracer(tw.rts[0]).install(), Tracer(tw.rts[1]).install())
    rows = tw.same(lambda s: [s.create_ensemble(f"t{i}") for i in range(3)])

    def bad_watcher(*a):
        raise RuntimeError("watcher bug")
    tw.call(lambda s: s.watch_leader(rows[0], bad_watcher))
    tw.op(lambda s: s.kput_many(rows[0], ["a", "b"], [b"1", b"2"]))
    tw.call(lambda s: s.set_admission_caps({rows[0]: 2}))
    tw.op(lambda s: s.kput_many(rows[0], ["c"] * 5, [b"3"] * 5))
    tw.call(lambda s: s.set_admission_caps(None))
    tw.call(lambda s: s.set_autotune(True))
    tw.call(lambda s: s.set_pipeline_depth(2))
    tw.call(lambda s: s.set_autotune(False))
    assert tw.same(lambda s: s.destroy_ensemble("t1"))
    tw.stop()
    ev = [[(kind, p) for _t, kind, p in tr.events
           if kind.startswith("svc_")] for tr in trs]
    kinds = {k for k, _p in ev[1]}
    assert {"svc_create_ensemble", "svc_destroy_ensemble", "svc_launch",
            "svc_watcher_error", "svc_autotune"} <= kinds
    strip = [[(k, {kk: vv for kk, vv in p.items() if kk != "error"})
              for k, p in e] for e in ev]
    assert strip[1] == strip[0]
    assert trs[1].counters == trs[0].counters


def test_obs_off_records_nothing(monkeypatch):
    monkeypatch.setenv("RETPU_OBS", "0")
    rt = Runtime(seed=3)
    svc = tb.BatchedEnsembleService(rt, 4, 3, 8, device="cpu",
                                    dynamic=True)
    fid0 = next(iter(tobs.SPANS.flush_ids()), None)
    row = svc.create_ensemble("a")
    for i in range(6):
        assert rt.await_future(svc.kput_many(row, [f"k{i}"], [b"v"]))[0][0] \
            == "ok"
    assert rt.await_future(svc.kget(row, "k0")) == ("ok", b"v")
    svc.stop()
    assert not svc._obs and svc._slo is None
    assert not svc.tenant_ops.any() and not svc.tenant_rounds.any()
    assert not svc._tenant_lat.any() and not svc.tenant_bytes.any()
    assert not svc.flight.records
    assert svc._h_flush.count == 0
    assert next(iter(tobs.SPANS.flush_ids()), None) == fid0
    # the launch records stay (always on, as in the reference)
    assert svc.lat_records and svc.stats()["obs_enabled"] is False


def test_warmup_counts_and_costs():
    """warmup launches every (K, A) bucket on a throwaway state: the
    live state is untouched, the cost gauges carry F1's counts."""
    from riak_ensemble_tpu_torch.ops import cuda_engine
    svc = tb.BatchedEnsembleService(tb.WallRuntime(), 256, 3, 8, tick=None,
                                    device="cpu", max_ops_per_tick=4)
    before = [t.clone() for t in svc.state]
    svc.warmup(capture_costs=True)
    for a, b in zip(before, svc.state):
        assert bool((a == b).all())
    keys = set(svc._step_costs)
    assert {"k0", "k1", "k2", "k4", "k4_a8", "k4_a64"} <= keys
    nb, ops = cuda_engine.step_work(256, 3, 8, 2, 4, 256)
    assert svc._step_costs["k4"] == {"flops": float(ops),
                                     "bytes_accessed": float(nb)}
    text = svc.obs_registry.render_prometheus()
    assert 'retpu_step_cost_flops{bucket="k4"}' in text
    f = svc.kput_many(3, ["a"], [b"1"])
    svc.flush()
    assert f.value[0][0] == "ok"
