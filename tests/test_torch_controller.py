"""The port's runtime controller against the JAX package's (the
standalone cases of ``tests/test_controller.py``).

- the decision journal (bounded ring, replay, loud mismatch);
- the ack-RTT tuner and the tenant guard, fed the same synthetic
  windows through each package's span store and op counters, take the
  same decisions in the same order (flush ids and wall times aside);
- the admission-capped flush: with the same caps and the same queued
  ops, the port's service takes the same rounds per flush, resolves the
  same results and refills the same token buckets as the JAX service;
- a live armed controller on each service, fed the same noisy-tenant
  stream, journals the same tenant-guard decisions and installs the
  same caps;
- the knob setters (depth mid-stream, arm-time baseline), the
  registry's label recycle, and ``RETPU_AUTOTUNE=0`` against an armed
  controller with unreachable thresholds: identical results and slabs.

Tolerance: exact equality.
"""

import numpy as np
import pytest

from riak_ensemble_tpu_torch import faults as tfaults
from riak_ensemble_tpu_torch import funref, obs
from riak_ensemble_tpu_torch.obs import controller as ctl
from riak_ensemble_tpu_torch.parallel.batched_host import (
    BatchedEnsembleService, WallRuntime)
from test_torch_compaction import norm
from test_torch_native_enqueue import _jax_env
from test_torch_reference_natives import reference_natives  # noqa: F401 (autouse)


def _ref():
    pytest.importorskip("jax")
    from riak_ensemble_tpu import obs as jobs
    from riak_ensemble_tpu.obs import controller as jctl
    return jobs, jctl


def _strip(events):
    return [{k: v for k, v in e.items() if k not in ("t", "flush_id")}
            for e in events]


def test_journal_ring_replay_equal_reference():
    _, jctl = _ref()
    out = []
    for mod in (jctl, ctl):
        j = mod.DecisionJournal(capacity=4)
        for i in range(10):
            j.note("ack_rtt", "repl_ack_ms_p50", float(i),
                   knob="pipeline_depth", old=i, new=i + 1, flush_id=i)
        full = mod.DecisionJournal()
        for i in range(3):
            full.note("ack_rtt", "repl_ack_ms_p50", 5.0,
                      knob="pipeline_depth", old=1 + i, new=2 + i)
        out.append((j.total, _strip(j.snapshot()),
                    mod.replay(full.snapshot(), {"pipeline_depth": 1})))
        bad = mod.DecisionJournal()
        bad.note("a", "c", 5.0, knob="pipeline_depth", old=2, new=3)
        with pytest.raises(ValueError, match="replay mismatch"):
            mod.replay(bad.snapshot(), {"pipeline_depth": 1})
    assert out[1] == out[0]
    assert out[1][2] == {"pipeline_depth": 4}


class _Stub:
    """The surface the controller reads and actuates (a replicated
    leader's, duck-typed)."""

    class _Link:
        label = "stub:1"

    def __init__(self):
        self.pipeline_depth = 1
        self.repl_window = 1
        self.max_k = 8
        self.is_leader = True
        self._links = [self._Link()]
        self.tenant_ops = np.zeros((4,), np.int64)
        self.caps = "unset"

    def tenant_label(self, e):
        return f"ens{e}"

    def set_pipeline_depth(self, d):
        old, self.pipeline_depth = self.pipeline_depth, max(1, int(d))
        return old

    def set_repl_window(self, w):
        old, self.repl_window = self.repl_window, max(1, int(w))
        return old

    def set_admission_caps(self, caps):
        self.caps = caps


def _drive(obs_mod, ctl_mod, acks, shares):
    stub = _Stub()
    c = ctl_mod.RuntimeController(stub)
    c.enabled, c.cadence = True, 4
    c.guard.min_ops = 10
    trail = []
    for ack_ms, share in zip(acks, shares):
        stub.tenant_ops += np.asarray(share, np.int64)
        for _ in range(c.cadence):
            fid = obs_mod.next_flush_id()
            if ack_ms is not None:
                obs_mod.SPANS.record(fid, "leader",
                                     [("repl_ack", ack_ms / 1e3)])
            c.tick(fid)
        fam = c.collect()
        trail.append((stub.pipeline_depth, stub.repl_window, stub.caps,
                      {k: v["values"][None] for k, v in fam.items()},
                      {k: v for k, v in c.health_section().items()
                       if k != "last_decision"}))
    return _strip(c.journal.snapshot()), trail


def test_tuner_and_guard_decide_as_reference():
    jobs, jctl = _ref()
    acks = [5.0, 5.0, 3.0, 3.0, 0.5, 0.5, 4.5, None, 0.2, 9.0]
    shares = [[90, 5, 5, 0], [60, 20, 20, 0], [10, 45, 45, 0],
              [0, 0, 0, 0], [80, 10, 10, 0], [5, 5, 5, 85],
              [1, 1, 1, 1], [50, 50, 0, 0], [0, 9, 0, 0], [30, 30, 30, 30]]
    ref = _drive(jobs, jctl, acks, shares)
    got = _drive(obs, ctl, acks, shares)
    assert got == ref
    assert any(e["actuator"] == "ack_rtt" for e in got[0])
    assert any(e["actuator"] == "tenant_guard" for e in got[0])


def _svc_pair(monkeypatch, e, m, s, **kw):
    _jax_env(monkeypatch, "default", True, True)
    monkeypatch.delenv("RETPU_OBS", raising=False)
    from riak_ensemble_tpu.parallel import batched_host as jb
    kw.setdefault("max_ops_per_tick", 8)
    return (jb.BatchedEnsembleService(jb.WallRuntime(), e, m, s, tick=None,
                                      **kw),
            BatchedEnsembleService(WallRuntime(), e, m, s, tick=None,
                                   device="cpu", **kw))


def test_admission_capped_flush_grouping_equal_reference(monkeypatch):
    pytest.importorskip("jax")
    svcs = _svc_pair(monkeypatch, 4, 3, 32)
    trail = ([], [])
    futs = ([], [])
    for svc, tr, fs in zip(svcs, trail, futs):
        svc.set_admission_caps({0: 2, 2: 1})
        fs.append(svc.kput_many(0, [f"k{i}" for i in range(8)],
                                [b"v"] * 8))
        fs.append(svc.kput(1, "q", b"qv"))
        fs.append(svc.kput_many(2, [f"h{i}" for i in range(5)],
                                [b"w"] * 5))
        n = 0
        while any(svc.queues):
            svc.flush()
            n += 1
            assert n < 30
            tr.append((list(svc._queue_rounds),
                       dict(svc._admission_tokens)))
        svc.set_admission_caps(None)
        fs.append(svc.kput_many(0, [f"n{i}" for i in range(8)],
                                [b"x"] * 8))
        svc.flush()
        tr.append(list(svc._queue_rounds))
    assert trail[1] == trail[0] and len(trail[1]) >= 4
    assert [norm(f.value) for f in futs[1]] == \
        [norm(f.value) for f in futs[0]]
    for svc in svcs:
        svc.stop()


def test_live_armed_controller_equal_reference(monkeypatch):
    """Both services armed (cadence 2): a hot tenant's stream trips the
    guard in both, with the same decision and the same caps."""
    pytest.importorskip("jax")
    svcs = _svc_pair(monkeypatch, 4, 3, 64)
    for svc in svcs:
        svc.set_autotune(True)
        svc.controller.cadence = 2
        svc.controller.guard.min_ops = 8
        for r in range(8):
            svc.kput_many(0, [f"k{r}.{i}" for i in range(6)], [b"v"] * 6)
            svc.kput(1 + r % 3, f"q{r}", b"q")
            svc.flush()
        while any(svc.queues):
            svc.flush()
    js, ts = svcs
    assert ts.controller.evals == js.controller.evals > 0
    assert _strip(ts.controller.journal.snapshot()) == \
        _strip(js.controller.journal.snapshot())
    assert ts._admission_caps == js._admission_caps == {0: 4}
    assert ts.controller.guard.throttled == {"ens0": [0]}
    h = [{k: v for k, v in s.health()["controller"].items()
          if k != "last_decision"} for s in svcs]
    assert h[1] == h[0]
    for svc in svcs:
        svc.set_autotune(False)
        assert svc._admission_caps is None
        svc.stop()


def test_set_pipeline_depth_mid_stream_and_arm_baseline():
    svc = BatchedEnsembleService(WallRuntime(), 4, 1, 8, tick=None,
                                 max_ops_per_tick=4, device="cpu")
    futs = [svc.kput(e, "a", b"1") for e in range(4)]
    assert svc.set_pipeline_depth(2) == 1
    futs += [svc.kput(e, "b", b"2") for e in range(4)]
    while any(svc.queues):
        svc.flush()
    svc.flush()
    assert all(f.done for f in futs)
    assert svc.set_pipeline_depth(1) == 2 and not svc._inflight
    got = svc.kget(0, "b")
    while not got.done:
        svc.flush()
    assert got.value == ("ok", b"2")
    assert svc._autotune_base_depth == 1
    svc.set_pipeline_depth(3)
    svc.set_autotune(True)
    assert svc._autotune_base_depth == 3
    assert ctl.AckRttTuner().evaluate(svc, [0.0001] * 8,
                                      ctl.DecisionJournal(), 1) == []
    assert svc.pipeline_depth == 3
    svc.set_autotune(False)


def test_row_recycle_drops_tenant_series_but_not_siblings():
    svc = BatchedEnsembleService(WallRuntime(), 4, 1, 8, tick=None,
                                 max_ops_per_tick=4, dynamic=True,
                                 device="cpu")
    row = svc.create_ensemble("acme")
    f = svc.kput(row, "k", b"v")
    while not f.done:
        svc.flush()
    h = svc.obs_registry.histogram("retpu_op_latency_ms")
    h.labels("acme").record(1.0)
    assert svc.destroy_ensemble("acme")
    snap = svc.obs_registry.snapshot()
    assert "acme" not in snap["retpu_op_latency_ms"].get("by_label", {})
    r1, r2 = svc.create_ensemble("t1"), svc.create_ensemble("t2")
    svc.set_tenant_label(r1, "multi")
    svc.set_tenant_label(r2, "multi")
    h.labels("multi").record(1.0)
    assert svc.destroy_ensemble("t1")
    assert "multi" in svc.obs_registry.snapshot()[
        "retpu_op_latency_ms"].get("by_label", {})
    assert svc.destroy_ensemble("t2")
    assert "multi" not in svc.obs_registry.snapshot()[
        "retpu_op_latency_ms"].get("by_label", {})


def _equiv_run(monkeypatch, tmp_path, tag, armed):
    monkeypatch.setenv("RETPU_AUTOTUNE", "1" if armed else "0")
    svc = BatchedEnsembleService(WallRuntime(), 8, 1, 16, tick=None,
                                 max_ops_per_tick=8, device="cpu",
                                 data_dir=str(tmp_path / tag))
    if armed:
        c = svc.controller
        c.cadence = 2
        c.tuner.up_ms, c.tuner.down_ms = 1e12, -1.0
        c.guard.share_high, c.guard.share_low = 2.0, 1.5
    futs = [svc.kput_many(e, [f"k{j}" for j in range(6)],
                          [b"v%d" % j for j in range(6)]) for e in range(8)]
    while any(svc.queues):
        svc.flush()
    futs.append(svc.kmodify(0, "ctr", funref.ref("rmw:add", 7), 0))
    futs.append(svc.kdelete(1, "k3"))
    futs.append(svc.kget_many(2, [f"k{j}" for j in range(6)]))
    while any(svc.queues) or not all(f.done for f in futs):
        svc.flush()
    if armed:
        assert svc.controller.evals > 0
        assert svc.controller.journal.total == 0
    out = ([f.value for f in futs], svc._slot_vsn_np.copy(),
           svc._slot_vsn_ok.copy(), svc._inline_np.copy())
    svc.stop()
    return out


def test_autotune_off_equals_unreachable_thresholds(monkeypatch, tmp_path):
    off = _equiv_run(monkeypatch, tmp_path, "off", False)
    on = _equiv_run(monkeypatch, tmp_path, "on", True)
    assert off[0] == on[0]
    for a, b in zip(off[1:], on[1:]):
        assert np.array_equal(a, b)


def test_soak_schedule_equal_reference():
    pytest.importorskip("jax")
    from riak_ensemble_tpu import faults as jfaults
    out = []
    for mod in (jfaults, tfaults):
        now, ran = [0.0], []

        def runner(target, ran=ran):
            ran.append(target)
            if len(ran) == 3:
                raise RuntimeError("soak crashed")
            return {"ok": len(ran) != 2, "detect_s": 0.1}
        s = mod.SoakSchedule(10.0, runner=runner, clock=lambda: now[0])
        seen = []
        for t in (0.0, 10.5, 11.0, 21.0, 31.5):
            now[0] = t
            r = s.maybe_run("svc")
            seen.append(None if r is None else (r.get("ok"),
                                                "error" in r))
        out.append((seen, s.runs, s.failures,
                    mod.SoakSchedule(0.0).due()))
    assert out[1] == out[0]
