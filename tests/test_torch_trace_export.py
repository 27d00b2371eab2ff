"""The port's Chrome-trace export (``riak_ensemble_tpu_torch.tools.
trace_export``) — the mirror of ``tests/test_trace_export.py``:

- the unit round trip on a canned span store, with the documented
  timeline semantics (per-flush spans sequential, cross-flush ordinal);
- the flight-dump CLI path;
- the live round trip: a timeline recorded on the port's 3-host group
  (the leader and two in-process replica lanes on the CPU) exports to a
  JSON every span of which equals the store's record.

Against the reference tool (``tools/trace_export.py``, which reads the
reference's obs plane): the same span records in each package's
``SpanStore``, the same flight dumps (schema v3, and v4 with per-host
sections) and the same fleet timelines export to equal JSON, apart from
the ``source`` strings, which name each tool.
"""

import json
import os
import subprocess
import sys

import pytest

from riak_ensemble_tpu_torch import obs
from riak_ensemble_tpu_torch.config import fast_test_config
from riak_ensemble_tpu_torch.parallel.batched_host import WallRuntime
from riak_ensemble_tpu_torch.tools import trace_export

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _events_by_tid(events):
    out = {}
    for ev in events:
        out.setdefault(ev["tid"], []).append(ev)
    return out


def _canned(store_cls):
    store = store_cls()
    store.record(7, "leader", [("queue_wait", 0.001),
                               ("device_d2h", 0.004),
                               ("repl_ack", 0.002)], k=4)
    store.record(7, "replica@h:1", [("validate", 0.0005),
                                    ("apply", 0.003)], kind="delta")
    store.record(9, "leader", [("queue_wait", 0.002)])
    return store


DECISIONS = [{"seq": 1, "flush_id": 7, "actuator": "ack_rtt",
              "cause": "repl_ack_ms_p50", "observed": 5.0,
              "knob": "pipeline_depth", "old": 1, "new": 2}]


def _dump(schema="retpu-flight-dump-v3"):
    return {
        "schema": schema,
        "ring": [{"flush_id": 3, "t": 1700000000.5, "k": 2,
                  "queue_wait": 0.001, "device_d2h": 0.002,
                  "total": 0.003, "a_width": 8,
                  "payload_bytes": 64, "queued_rounds": 0,
                  "in_flight": 0}],
        "controller_decisions": [
            {"seq": 4, "flush_id": 3, "actuator": "tenant_guard",
             "cause": "tenant_ops_share", "observed": 0.9,
             "knob": "admission_cap[hot]", "old": None, "new": 4}],
    }


def _dump_v4():
    d = _dump("retpu-flight-dump-v4")
    d["hosts"] = {
        "127.0.0.1:7001": {"spans": {
            "10": {"flush_id": 10, "replica@127.0.0.1:7001": {
                "spans": [["validate", 0.0002], ["apply", 0.001]]}},
            "9": {"flush_id": 9, "replica@127.0.0.1:7001": {
                "spans": [["apply", 0.002]]}},
            "11": {"miss": "evicted"}}},
        "127.0.0.1:7002": "unreachable"}
    d["clock_offsets"] = {"127.0.0.1:7001": {"offset_ms": 0.1}}
    return d


FLEET = [{"flush_id": 5, "base_s": 100.0, "roles": {
              "leader": {"host": "leader", "aligned": True, "bound_ms": 0.0,
                         "spans": [["queue_wait", 0.0, 0.001],
                                   ["repl_ack", 0.001, 0.002]]},
              "replica@h:1": {"host": "h:1", "aligned": True,
                              "bound_ms": 0.2,
                              "spans": [["apply", 0.0012, 0.0005]]}}},
         {"flush_id": 6, "base_s": 100.01, "roles": {
              "leader": {"host": "leader", "aligned": False,
                         "spans": [["queue_wait", 0.0, 0.0007]]}}}]


def test_unit_round_trip_canned_store(tmp_path):
    store = _canned(obs.SpanStore)
    path = str(tmp_path / "trace.json")
    doc = trace_export.export(path, [7, 9, 12345], DECISIONS, store=store)
    with open(path, encoding="utf-8") as fh:
        loaded = json.load(fh)
    assert loaded == doc  # the written JSON round-trips exactly
    assert loaded["otherData"]["source"] == trace_export.SOURCE
    evs = loaded["traceEvents"]
    by_tid = _events_by_tid(evs)
    # every span in the store is an "X" event with its measured duration
    # (microseconds), under its role track
    leader = [e for e in by_tid["leader"] if e["ph"] == "X"]
    assert [(e["name"], e["dur"]) for e in leader
            if e["args"]["flush_id"] == 7] == [
        ("queue_wait", 1000.0), ("device_d2h", 4000.0),
        ("repl_ack", 2000.0)]
    # within a flush the spans stack sequentially from the base
    assert leader[1]["ts"] == leader[0]["ts"] + leader[0]["dur"]
    rep = [e for e in by_tid["replica@h:1"] if e["ph"] == "X"]
    assert [e["name"] for e in rep] == ["validate", "apply"]
    # roles of one flush share the base tick
    assert rep[0]["ts"] == leader[0]["ts"]
    # cross-flush: flush 9 starts after flush 7's widest role ends
    f7 = [e for e in leader if e["args"]["flush_id"] == 7]
    f9 = [e for e in leader if e["args"]["flush_id"] == 9]
    assert f9 and f9[0]["ts"] > f7[-1]["ts"] + f7[-1]["dur"]
    # the controller decision is an instant event on its own track,
    # anchored at its flush's base, carrying the full journal entry
    ctrl = by_tid["controller"]
    assert len(ctrl) == 1 and ctrl[0]["ph"] == "i"
    assert ctrl[0]["ts"] == leader[0]["ts"]
    assert ctrl[0]["args"]["new"] == 2
    # the never-recorded fid contributed nothing (skipped, not fake)
    assert not [e for e in evs
                if e.get("args", {}).get("flush_id") == 12345]


def test_flight_dump_cli_path(tmp_path):
    src = tmp_path / "dump.json"
    src.write_text(json.dumps(_dump()))
    out = tmp_path / "trace.json"
    assert trace_export.main(["--flight-dump", str(src),
                              "-o", str(out)]) == 0
    doc = json.loads(out.read_text())
    names = {e["name"] for e in doc["traceEvents"]}
    # marks render as spans (derived/meta fields excluded), the journal
    # entry as an autotune instant
    assert {"queue_wait", "device_d2h",
            "autotune admission_cap[hot]"} <= names
    assert "total" not in names  # META field, not a span
    assert doc["otherData"]["source_dump_schema"] \
        == "retpu-flight-dump-v3"


def test_module_runs_as_a_command(tmp_path):
    """``python -m riak_ensemble_tpu_torch.tools.trace_export`` over a
    schema-v4 dump: its per-host sections render as host tracks."""
    src = tmp_path / "dump.json"
    src.write_text(json.dumps(_dump_v4()))
    out = tmp_path / "trace.json"
    proc = subprocess.run(
        [sys.executable, "-m", "riak_ensemble_tpu_torch.tools.trace_export",
         "--flight-dump", str(src), "-o", str(out)], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(out.read_text())
    assert proc.stdout.strip() == (f"trace_export: "
                                   f"{len(doc['traceEvents'])} events -> "
                                   f"{out}")
    host = [e for e in doc["traceEvents"] if e["pid"] == "127.0.0.1:7001"]
    # flush ids ordered numerically (9 before 10), the miss skipped
    assert [(e["args"]["flush_id"], e["name"]) for e in host] == [
        (9, "apply"), (10, "validate"), (10, "apply")]
    bad = tmp_path / "bad.json"
    bad.write_text("{")
    assert trace_export.main(["--flight-dump", str(bad)]) == 1


def _reference_tool():
    pytest.importorskip("jax")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from riak_ensemble_tpu import obs as ref_obs
    from tools import trace_export as ref_tool
    return ref_obs, ref_tool


def _without_source(doc):
    doc = json.loads(json.dumps(doc))
    doc.get("otherData", {}).pop("source", None)
    return doc


def test_export_equals_reference_tool(tmp_path):
    """The same span records in each package's store, and the same
    journal, export to equal JSON but for ``source``."""
    ref_obs, ref_tool = _reference_tool()
    ref = ref_tool.export(str(tmp_path / "ref.json"), [7, 9, 12345],
                          DECISIONS, store=_canned(ref_obs.SpanStore))
    port = trace_export.export(str(tmp_path / "port.json"), [7, 9, 12345],
                               DECISIONS, store=_canned(obs.SpanStore))
    assert ref["otherData"]["source"] != port["otherData"]["source"]
    assert _without_source(port) == _without_source(ref)
    assert (tmp_path / "ref.json").read_text().replace(
        json.dumps(ref["otherData"]["source"]),
        json.dumps(port["otherData"]["source"])) \
        == (tmp_path / "port.json").read_text()


@pytest.mark.parametrize("kind", ["dump-v3", "dump-v4", "fleet"])
def test_cli_equals_reference_tool(tmp_path, kind):
    """Both tools' CLI over one input file write equal JSON but for
    ``source`` (only the fleet path has one)."""
    _ref_obs, ref_tool = _reference_tool()
    data, flag = {"dump-v3": (_dump(), "--flight-dump"),
                  "dump-v4": (_dump_v4(), "--flight-dump"),
                  "fleet": (FLEET, "--fleet-timelines")}[kind]
    src = tmp_path / "in.json"
    src.write_text(json.dumps(data))
    docs = []
    for tool in (ref_tool, trace_export):
        out = tmp_path / f"{tool.__name__}.json"
        assert tool.main([flag, str(src), "-o", str(out)]) == 0
        docs.append(json.loads(out.read_text()))
    ref, port = docs
    assert ref["traceEvents"]
    assert _without_source(port) == _without_source(ref)
    assert ("source" in port["otherData"]) == (kind == "fleet")


def test_live_3host_recorded_timeline_round_trip(tmp_path):
    """A real 3-host flush timeline (the leader and two in-process replica
    lanes over the delta wire) exports to a JSON every span of which
    equals the store's record."""
    from riak_ensemble_tpu_torch.parallel import repgroup

    before = set(obs.SPANS.flush_ids())
    servers = [repgroup.ReplicaServer(4, 3, 8,
                                      data_dir=str(tmp_path / f"r{i}"),
                                      config=fast_test_config(),
                                      device="cpu")
               for i in (1, 2)]
    svc = repgroup.ReplicatedService(
        WallRuntime(), 4, 1, 8, group_size=3,
        peers=[("127.0.0.1", s.repl_port) for s in servers],
        ack_timeout=30.0, max_ops_per_tick=4,
        config=fast_test_config(),
        data_dir=str(tmp_path / "leader"), device="cpu")
    try:
        assert svc.takeover()
        futs = [svc.kput_many(e, ["a", "b"], [b"1", b"2"])
                for e in range(4)]
        while any(svc.queues):
            svc.flush()
        svc._drain_pending(block_all=True)
        assert all(f.done for f in futs)
        # the span store is process-global: this run's flushes only
        fids = [f for f in obs.SPANS.flush_ids() if f not in before]
        assert fids
        ev = svc.controller.journal.note(
            "ack_rtt", "repl_ack_ms_p50", 5.0,
            knob="pipeline_depth", old=1, new=2, flush_id=fids[-1])
        path = str(tmp_path / "trace.json")
        doc = trace_export.export(path, fids,
                                  svc.controller.journal.snapshot())
        with open(path, encoding="utf-8") as fh:
            loaded = json.load(fh)
        assert loaded == doc
        evs = loaded["traceEvents"]
        spans = [e for e in evs if e["ph"] == "X"]
        assert spans, "no spans exported from a live run"
        # every exported span re-finds its (name, duration) in the
        # store's timeline for its flush and role
        for e in spans:
            side = obs.timeline(e["args"]["flush_id"])[e["tid"]]
            assert [d for n, d in side["spans"]
                    if n == e["name"] and abs(d * 1e6 - e["dur"]) < 0.5], \
                (e, side["spans"])
        # at least one flush exported both the leader and a replica lane
        by_fid = {}
        for e in spans:
            by_fid.setdefault(e["args"]["flush_id"], set()).add(e["tid"])
        assert any("leader" in roles
                   and any(t.startswith("replica") for t in roles)
                   for roles in by_fid.values()), by_fid
        ctrl = [e for e in evs if e["tid"] == "controller"]
        assert len(ctrl) == 1
        assert ctrl[0]["args"]["seq"] == ev["seq"]
    finally:
        svc.stop()
        for s in servers:
            s.stop()
