"""The port's ``service_manager``: the tenant registry, rendezvous
placement, the reconciler and the versioned handoff, on the CPU.

- The six cases of ``tests/test_service_manager.py`` (``:44``, ``:129``,
  ``:146``, ``:212``, ``:241``, ``:308``), the two ``service_manager``
  cases of ``tests/test_rmw.py`` (``:575``, ``:624``) and the reconciler
  case of ``tests/test_repgroup_tenants.py:115`` (here on an in-process
  group of threaded replica hosts) on the port.  Every service's traced
  events are watched, and any ``svc_reconcile_error`` or
  ``svc_reconcile_tenant_error`` fails the case: the reconciler contains
  its own failures, so an error inside an export or an install would
  otherwise show only as a tenant that never moves.
- On the card (``cuda`` marker): the export's device gather
  (:func:`service_manager.gather_obj_planes`) equals the CPU's on random
  planes.

``place`` against the reference's and the lockstep with the reference are
in ``tests/test_torch_service_manager_lockstep.py``; :class:`Script` is
its script.
"""

import importlib
import os
import time
import types

import numpy as np
import pytest
import torch

from riak_ensemble_tpu_torch import funref
from riak_ensemble_tpu_torch import service_directory as sd
from riak_ensemble_tpu_torch import service_manager as sm
from riak_ensemble_tpu_torch.config import fast_test_config
from riak_ensemble_tpu_torch.ops import engine as eng
from riak_ensemble_tpu_torch.parallel.batched_host import (
    BatchedEnsembleService)
from riak_ensemble_tpu_torch.runtime import Runtime
from riak_ensemble_tpu_torch.testing import ManagedCluster

N_ENS, N_PEERS, N_SLOTS = 16, 3, 8
TENANTS = [f"tenant{i}" for i in range(10)]
ERRORS = ("svc_reconcile_error", "svc_reconcile_tenant_error")


def watch(svc, kinds=("svc_",)):
    """Record every traced event of ``svc`` whose kind starts with one of
    ``kinds`` (the service still feeds its runtime's tracer)."""
    events = []
    emit = svc._emit

    def recorded(kind, payload):
        if kind.startswith(kinds):
            events.append((kind, payload))
        emit(kind, payload)
    svc._emit = recorded
    return events


def no_errors(*event_lists):
    bad = [e for ev in event_lists for e in ev if e[0] in ERRORS]
    assert not bad, bad


def _service(runtime, n_ens=N_ENS, **kw):
    kw.setdefault("tick", 0.05)
    return BatchedEnsembleService(runtime, n_ens, N_PEERS, N_SLOTS,
                                  config=fast_test_config(), dynamic=True,
                                  device="cpu", **kw)


def _bring_up(mc, node, name, registry):
    svc = _service(mc.runtime)
    events = watch(svc)
    rec = sm.ServiceReconciler(mc.runtime, mc.mgr(node), svc, name,
                               registry.get, poll=0.2)
    registry[name] = rec
    r = sd.register_service(mc.mgr(node), mc.runtime, name, "127.0.0.1",
                            7000 + len(registry), (N_ENS, N_PEERS, N_SLOTS))
    assert r == "ok", r
    return svc, rec, events


def _settle_fut(mc, fut, t=60.0):
    assert mc.runtime.run_until(lambda: fut.done, t), "future never resolved"
    return fut.value


def _two_node_cluster(seed):
    mc = ManagedCluster(seed=seed, nodes=("node0", "node1"))
    mc.enable("node0")
    mc.join("node1", "node0")
    return mc


def test_join_rebalances_tenants_via_gossip_alone():
    mc = _two_node_cluster(5)
    registry = {}
    svc0, rec0, ev0 = _bring_up(mc, "node0", "svc@node0", registry)
    for t in TENANTS:
        assert sm.create_tenant(mc.mgr("node0"), mc.runtime, t) == "ok"
    assert mc.runtime.run_until(
        lambda: all(svc0.resolve_ensemble(t) is not None for t in TENANTS),
        60.0), "tenants never reconciled onto the only svcnode"

    written = {}
    futs = []
    for i, t in enumerate(TENANTS):
        val = b"payload-%d" % i
        futs.append(svc0.kput(svc0.resolve_ensemble(t), "k", val))
        written[t] = val
    for f in futs:
        assert _settle_fut(mc, f)[0] == "ok"

    svc1, rec1, ev1 = _bring_up(mc, "node1", "svc@node1", registry)
    both = ["svc@node0", "svc@node1"]
    moved = [t for t in TENANTS if sm.place(t, both) == "svc@node1"]
    stayed = [t for t in TENANTS if t not in moved]
    assert moved and stayed, "rendezvous should split the tenants"

    def converged():
        return (all(svc1.resolve_ensemble(t) is not None
                    and svc0.resolve_ensemble(t) is None for t in moved)
                and all(svc0.resolve_ensemble(t) is not None
                        and svc1.resolve_ensemble(t) is None
                        for t in stayed)
                and not rec1._importing)
    assert mc.runtime.run_until(converged, 120.0), "rebalance never converged"

    for t, svc in [(t, svc1) for t in moved] + [(t, svc0) for t in stayed]:
        f = svc.kget(svc.resolve_ensemble(t), "k")
        assert _settle_fut(mc, f) == ("ok", written[t]), t

    target = stayed[0]
    r = sm.set_tenant_view(mc.mgr("node0"), mc.runtime, target,
                           [True, True, False])
    assert r == "ok", r
    ens = svc0.resolve_ensemble(target)
    assert mc.runtime.run_until(
        lambda: (svc0.member_np[ens] == [True, True, False]).all(), 60.0), \
        "registry view change never reconciled into the device"
    f = svc0.kget(ens, "k")
    assert _settle_fut(mc, f) == ("ok", written[target])

    r = sm.retire_tenant(mc.mgr("node0"), mc.runtime, moved[0])
    assert r == "ok", r
    assert mc.runtime.run_until(
        lambda: (svc1.resolve_ensemble(moved[0]) is None
                 and svc0.resolve_ensemble(moved[0]) is None), 60.0), \
        "retired tenant still running somewhere"
    assert any(k == "svc_tenant_adopt" and p["imported"] == 1
               for k, p in ev1)
    no_errors(ev0, ev1)
    for x in (rec0, rec1, svc0, svc1):
        x.stop()


def test_tenant_placement_is_stable_and_minimal():
    one = ["a"]
    two = ["a", "b"]
    owners_one = {t: sm.place(t, one) for t in TENANTS}
    owners_two = {t: sm.place(t, two) for t in TENANTS}
    assert all(o == "a" for o in owners_one.values())
    for t in TENANTS:
        assert owners_two[t] in ("a", "b")
        if owners_two[t] != owners_one[t]:
            assert owners_two[t] == "b"
    assert {t: sm.place(t, ["b", "a"]) for t in TENANTS} == owners_two
    assert sm.place("t", []) is None


def test_handoff_survives_capacity_pressure_and_late_offers():
    mc = ManagedCluster(seed=6, nodes=("node0",))
    mc.enable("node0")
    registry = {}
    svc = _service(mc.runtime, n_ens=2)
    events = watch(svc)
    rec = sm.ServiceReconciler(mc.runtime, mc.mgr("node0"), svc,
                               "svc@node0", registry.get, poll=0.2)
    registry["svc@node0"] = rec
    r = sd.register_service(mc.mgr("node0"), mc.runtime, "svc@node0",
                            "127.0.0.1", 7100, (2, N_PEERS, N_SLOTS))
    assert r == "ok", r

    for b in ("blocker0", "blocker1"):
        assert sm.create_tenant(mc.mgr("node0"), mc.runtime, b) == "ok"
    assert mc.runtime.run_until(
        lambda: all(svc.resolve_ensemble(b) is not None
                    for b in ("blocker0", "blocker1")), 60.0)
    assert sm.create_tenant(mc.mgr("node0"), mc.runtime, "t-cap") == "ok"
    rec.offer_handoff("t-cap", [("k", b"precious")])
    mc.runtime.run_for(5.0)
    assert svc.resolve_ensemble("t-cap") is None  # no capacity yet
    assert rec._inbox.get("t-cap"), "payload dropped under capacity"

    assert sm.retire_tenant(mc.mgr("node0"), mc.runtime, "blocker0") == "ok"
    assert mc.runtime.run_until(
        lambda: (svc.resolve_ensemble("t-cap") is not None
                 and not rec._importing), 60.0)
    f = svc.kget(svc.resolve_ensemble("t-cap"), "k")
    assert _settle_fut(mc, f) == ("ok", b"precious")

    ens = svc.resolve_ensemble("t-cap")
    f = svc.kput(ens, "local", b"newer")
    assert _settle_fut(mc, f)[0] == "ok"
    rec.offer_handoff("t-cap", [("local", b"stale"), ("extra", b"carried")])
    assert mc.runtime.run_until(
        lambda: "t-cap" not in rec._inbox and not rec._importing, 60.0)
    f1 = svc.kget(ens, "local")
    f2 = svc.kget(ens, "extra")
    assert _settle_fut(mc, f1) == ("ok", b"newer")
    assert _settle_fut(mc, f2) == ("ok", b"carried")
    no_errors(events)
    rec.stop()
    svc.stop()


def test_all_false_views_rejected_and_contained():
    mc = ManagedCluster(seed=7, nodes=("node0",))
    mc.enable("node0")
    with pytest.raises(ValueError):
        sm.create_tenant(mc.mgr("node0"), mc.runtime, "bad",
                         view=[False, False, False])
    with pytest.raises(ValueError):
        sm.set_tenant_view(mc.mgr("node0"), mc.runtime, "bad",
                           [False, False, False])

    registry = {}
    svc, rec, events = _bring_up(mc, "node0", "svc@node0", registry)
    fut = mc.mgr("node0").create_ensemble(
        sm.tenant_id("sneaky"), None, [], sm.TENANT_MOD,
        ([False, False, False],), 30.0)
    assert mc.runtime.await_future(fut, 35.0) == "ok"
    assert sm.create_tenant(mc.mgr("node0"), mc.runtime, "good") == "ok"
    assert mc.runtime.run_until(
        lambda: svc.resolve_ensemble("good") is not None, 60.0), \
        "reconciler died on a malformed view"
    assert svc.resolve_ensemble("sneaky") is None
    assert any(k == "svc_tenant_bad_view" and p["name"] == "sneaky"
               for k, p in events)
    no_errors(events)
    rec.stop()
    svc.stop()


def test_versions_survive_tenant_handoff():
    mc = _two_node_cluster(11)
    registry = {}
    svc0, rec0, ev0 = _bring_up(mc, "node0", "svc@node0", registry)
    for t in TENANTS:
        assert sm.create_tenant(mc.mgr("node0"), mc.runtime, t) == "ok"
    assert mc.runtime.run_until(
        lambda: all(svc0.resolve_ensemble(t) is not None for t in TENANTS),
        60.0)

    tokens = {}
    for i, t in enumerate(TENANTS):
        ens = svc0.resolve_ensemble(t)
        assert _settle_fut(mc, svc0.kput(ens, "k", b"v%d" % i))[0] == "ok"
        r = _settle_fut(mc, svc0.kget_vsn(ens, "k"))
        assert r[0] == "ok" and r[1] == b"v%d" % i, r
        tokens[t] = r[2]
        assert tokens[t] != (0, 0)

    svc1, rec1, ev1 = _bring_up(mc, "node1", "svc@node1", registry)
    both = ["svc@node0", "svc@node1"]
    moved = [t for t in TENANTS if sm.place(t, both) == "svc@node1"]
    assert moved
    assert mc.runtime.run_until(
        lambda: all(svc1.resolve_ensemble(t) is not None
                    and svc0.resolve_ensemble(t) is None
                    for t in moved) and not rec1._importing, 120.0), \
        "rebalance never converged"

    for t in moved:
        i = TENANTS.index(t)
        ens = svc1.resolve_ensemble(t)
        r = _settle_fut(mc, svc1.kget_vsn(ens, "k"))
        assert r == ("ok", b"v%d" % i, tokens[t]), (t, r, tokens[t])
        r = _settle_fut(mc, svc1.kupdate(ens, "k", tokens[t],
                                         b"updated-%d" % i))
        assert r[0] == "ok", (t, r)
        assert tuple(r[1]) > tuple(tokens[t]), (r[1], tokens[t])
        r = _settle_fut(mc, svc1.kupdate(ens, "k", tokens[t], b"stale"))
        assert r == "failed", r
        r = _settle_fut(mc, svc1.kget(ens, "k"))
        assert r == ("ok", b"updated-%d" % i), r
    no_errors(ev0, ev1)
    for x in (rec0, rec1, svc0, svc1):
        x.stop()


def test_leaderless_export_pairs_payload_with_committed_version():
    """The export of a leaderless row carries the per-slot max (epoch,
    seq) over the up member lanes, not lane 0's copy, which can lag a
    quorum-committed write."""
    runtime = Runtime(seed=42)
    svc = _service(runtime, n_ens=4, tick=0.005)
    ens = svc.create_ensemble("t0")
    assert ens is not None

    def settle(fut, t=30.0):
        return runtime.await_future(fut, t)

    assert settle(svc.kput(ens, "k", b"v1"))[0] == "ok"
    svc.set_peer_up(ens, 0, False)
    r = settle(svc.kput(ens, "k", b"v2"))
    assert r[0] == "ok", r
    token = settle(svc.kget_vsn(ens, "k"))
    assert token[0] == "ok" and token[1] == b"v2"
    vsn = token[2]
    # lane 0 really holds the stale version the export must not read
    slot = svc.key_slot[ens]["k"]
    lane0 = (int(svc.state.obj_epoch[ens, 0, slot]),
             int(svc.state.obj_seq[ens, 0, slot]))
    assert lane0 != tuple(vsn)

    svc.leader_np[ens] = -1
    rec = sm.ServiceReconciler(runtime, None, svc, "svc@x",
                               lambda _n: None, poll=None)
    data = rec._export(ens)
    by_key = {e[0]: e for e in data}
    assert by_key["k"][1] == b"v2"
    assert tuple(by_key["k"][2]) == tuple(vsn), (by_key["k"], vsn)

    svc2 = _service(runtime, n_ens=4, tick=0.005)
    row = svc2.create_ensemble("t0")
    res = svc2.install_objs(row, [(key, ver, payload)
                                  for key, payload, ver in data])
    assert all(r[0] == "ok" for r in res)
    r = settle(svc2.kupdate(row, "k", vsn, b"v3"))
    assert r[0] == "ok", r
    assert settle(svc2.kget(row, "k")) == ("ok", b"v3")
    svc.stop()
    svc2.stop()


def _drive(svc, futs, bound=50):
    for _ in range(bound):
        if all(f.done for f in futs):
            return
        svc.flush()
    svc.flush()
    assert all(f.done for f in futs), "futures never settled"


def test_tenant_export_settles_pipeline_first():
    """At ``pipeline_depth=2`` the export settles the in-flight launch
    first, so destroy's drain cannot ack a write the export left out."""
    runtime = Runtime(seed=12)
    svc = _service(runtime, n_ens=2, tick=None, pipeline_depth=2,
                   max_ops_per_tick=1)
    ens = svc.create_ensemble("t")
    p1 = svc.kput(ens, "a", b"v1")
    p2 = svc.kput(ens, "b", b"v2")
    svc.flush()  # takes p1; its launch stays in flight at depth 2
    assert not p1.done
    rec = sm.ServiceReconciler(runtime, None, svc, "svc@x",
                               lambda _n: None, poll=None)
    by_key = {e[0]: e for e in rec._export(ens)}
    assert p1.done and p1.value[0] == "ok"
    assert by_key["a"][1] == b"v1"
    _drive(svc, [p2])


def test_tenant_export_carries_inline_values():
    """A device-native (inline RMW) slot exports its engine-array value,
    not the handle store's -1 sentinel."""
    runtime = Runtime(seed=11)
    svc = _service(runtime, n_ens=2, tick=None)
    ens = svc.create_ensemble("t1")
    f = svc.kmodify(ens, "ctr", funref.ref("rmw:add", 41), 0)
    p = svc.kput(ens, "blob", b"bytes")
    _drive(svc, [f, p])
    assert f.value[0] == "ok" and p.value[0] == "ok"
    rec = sm.ServiceReconciler(runtime, None, svc, "svc@x",
                               lambda _n: None, poll=None)
    by_key = {e[0]: e for e in rec._export(ens)}
    assert by_key["ctr"][1] == 41
    assert tuple(by_key["ctr"][2]) == tuple(f.value[1])
    assert by_key["blob"][1] == b"bytes"
    ens2 = svc.create_ensemble("t2")
    res = svc.install_objs(ens2, [(k, v[2], v[1]) for k, v in by_key.items()])
    assert all(r[0] == "ok" for r in res)
    g = svc.kget(ens2, "ctr")
    _drive(svc, [g])
    assert g.value == ("ok", 41)


def test_reconciler_places_tenants_on_a_replication_group(tmp_path):
    """A consensus-managed tenant reconciled onto an owner that is itself
    a replication group (the port's in-process group of threaded replica
    hosts): the reconciler is caller-driven (``poll=None``) since the
    group runs on wall time; adoption, a write at the host quorum, and a
    retire through the root that destroys the row on every lane."""
    from test_torch_repgroup_paths import _lanes_equal, _leader, _replica
    from test_torch_repgroup_paths import _settle as settle_group

    mc = ManagedCluster(seed=8, nodes=("node0",))
    mc.enable("node0")
    root = str(tmp_path)
    srvs = [_replica(root, n, dynamic=True) for n in ("r1", "r2")]
    svc = _leader(root, srvs, dynamic=True)
    events = watch(svc)
    try:
        registry = {}
        rec = sm.ServiceReconciler(mc.runtime, mc.mgr("node0"), svc,
                                   "grp@node0", registry.get, poll=None)
        registry["grp@node0"] = rec
        assert sd.register_service(mc.mgr("node0"), mc.runtime, "grp@node0",
                                   "127.0.0.1", 1, (4, 1, 16)) == "ok"
        assert sm.create_tenant(mc.mgr("node0"), mc.runtime,
                                "orders") == "ok"
        deadline = time.monotonic() + 60.0
        while svc.resolve_ensemble("orders") is None:
            mc.runtime.run_for(0.5)
            rec.tick()
            assert time.monotonic() < deadline, \
                "tenant never reconciled onto the group"
        ens = svc.resolve_ensemble("orders")
        r = settle_group(svc, [svc.kput(ens, "k", b"v")])
        assert r[0][0] == "ok"
        assert svc.stats()["group"]["quorum_failures"] == 0
        _lanes_equal(svc, srvs)
        for s in srvs:
            assert s.svc._ens_names == {"orders": ens}

        assert sm.retire_tenant(mc.mgr("node0"), mc.runtime,
                                "orders") == "ok"
        deadline = time.monotonic() + 60.0
        while svc.resolve_ensemble("orders") is not None:
            mc.runtime.run_for(0.5)
            rec.tick()
            assert time.monotonic() < deadline, \
                "retired tenant never destroyed on the group"
        _lanes_equal(svc, srvs)
        for s in srvs:
            assert s.svc._ens_names == {}
        no_errors(events)
    finally:
        svc.stop()
        for s in srvs:
            s.stop()


# -- lockstep with the reference -------------------------------------------


LS_TENANTS = [f"t{i}" for i in range(6)]
LS_KEYS = ["a", "b", "c"]
EVENT_KINDS = ("svc_tenant", "svc_reconcile", "svc_create_ensemble",
               "svc_destroy_ensemble")


def _pkg(name):
    ns = types.SimpleNamespace(name=name)
    for attr, mod in (("sm", "service_manager"), ("sd", "service_directory"),
                      ("testing", "testing"), ("config", "config"),
                      ("bh", "parallel.batched_host"),
                      ("funref", "funref")):
        setattr(ns, attr, importlib.import_module(f"{name}.{mod}"))
    return ns


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Script:
    """One package's run of the lockstep script; :attr:`log` holds a
    snapshot after every step."""

    def __init__(self, ns, root):
        from test_torch_compaction import norm
        from test_torch_scalar_plane import _reset_counters
        from test_torch_wal import _tree
        self.ns, self.root, self.norm, self.tree = ns, root, norm, _tree
        _reset_counters(types.SimpleNamespace(
            msg=importlib.import_module(f"{ns.name}.msg"),
            router=importlib.import_module(f"{ns.name}.router")))
        self.mc = ns.testing.ManagedCluster(seed=41, nodes=("node0", "node1"))
        self.rt = self.mc.runtime
        self.mc.enable("node0")
        self.mc.join("node1", "node0")
        self.registry, self.svcs, self.events = {}, {}, {}
        self.log = []

    def bring_up(self, node, name):
        ns = self.ns
        kw = {"device": "cpu"} if ns.name.endswith("_torch") else {}
        svc = ns.bh.BatchedEnsembleService(
            self.rt, N_ENS, N_PEERS, N_SLOTS, tick=0.05,
            config=ns.config.fast_test_config(), dynamic=True,
            data_dir=os.path.join(self.root, name), **kw)
        self.events[name] = watch(svc, EVENT_KINDS)
        self.registry[name] = ns.sm.ServiceReconciler(
            self.rt, self.mc.mgr(node), svc, name, self.registry.get,
            poll=0.2)
        self.svcs[name] = svc
        return ns.sd.register_service(self.mc.mgr(node), self.rt, name,
                                      "127.0.0.1", 7000 + len(self.svcs),
                                      (N_ENS, N_PEERS, N_SLOTS))

    def snap(self, label, value=None):
        ns, norm = self.ns, self.norm
        mgr = self.mc.mgr("node0")
        nodes = sorted(ns.sd.list_services(mgr), key=repr)
        reg = ns.sm.tenants(mgr)
        out = {"now": self.rt.now, "value": norm(value),
               "registry": sorted(reg.items(), key=repr),
               "placement": {t: ns.sm.place(t, nodes) for t in LS_TENANTS}}
        for name, svc in sorted(self.svcs.items()):
            rec = self.registry[name]
            rows = {}
            for t, row in sorted(svc._ens_names.items(), key=repr):
                rows[t] = {
                    "row": row, "export": norm(rec._export(row)),
                    "members": svc.member_np[row].tolist(),
                    "planes": [_np(getattr(svc.state, f))[row].tolist()
                               for f in ("obj_epoch", "obj_seq",
                                         "obj_val")]}
            out[name] = {"rows": rows, "events": norm(self.events[name]),
                         "importing": sorted(rec._importing, key=repr),
                         "wal": self.tree(os.path.join(self.root, name))}
        self.log.append((label, out))

    def settle(self, futs, t=60.0):
        assert self.rt.run_until(lambda: all(f.done for f in futs), t)
        return [f.value for f in futs]

    def run(self):
        ns, mc, rt = self.ns, self.mc, self.rt
        mgr = mc.mgr("node0")
        self.snap("svc@node0", self.bring_up("node0", "svc@node0"))
        for i, t in enumerate(LS_TENANTS):
            view = [True, True, False] if i == 4 else None
            self.snap(f"create {t}", ns.sm.create_tenant(mgr, rt, t, view))
        svc0 = self.svcs["svc@node0"]
        assert rt.run_until(lambda: all(svc0.resolve_ensemble(t) is not None
                                        for t in LS_TENANTS), 60.0)
        self.snap("adopted")
        futs = []
        for i, t in enumerate(LS_TENANTS):
            row = svc0.resolve_ensemble(t)
            futs.append(svc0.kput_many(row, LS_KEYS,
                                       [b"%s-%d" % (k.encode(), i)
                                        for k in LS_KEYS]))
            futs.append(svc0.kmodify(row, "ctr",
                                     ns.funref.ref("rmw:add", 10 + i), 0))
        self.snap("written", self.settle(futs))
        tokens = self.settle([svc0.kget_vsn(svc0.resolve_ensemble(t), "a")
                              for t in LS_TENANTS])
        self.snap("tokens", tokens)
        self.snap("svc@node1", self.bring_up("node1", "svc@node1"))
        svc1 = self.svcs["svc@node1"]
        both = sorted(self.svcs)

        def converged():
            return all(
                (self.svcs[ns.sm.place(t, both)].resolve_ensemble(t)
                 is not None)
                and all(s.resolve_ensemble(t) is None
                        for n, s in self.svcs.items()
                        if n != ns.sm.place(t, both))
                for t in LS_TENANTS) and not any(
                    r._importing for r in self.registry.values())
        assert rt.run_until(converged, 120.0)
        self.snap("joined")
        reads = []
        for t, tok in zip(LS_TENANTS, tokens):
            svc = self.svcs[ns.sm.place(t, both)]
            row = svc.resolve_ensemble(t)
            reads.append(svc.kget_many(row, LS_KEYS + ["ctr"]))
            reads.append(svc.kupdate(row, "a", tok[2], b"cas-" + t.encode()))
        self.snap("read back", self.settle(reads))
        view_t = [t for t in LS_TENANTS if t != "t4"][:2]
        for t in view_t:
            self.snap(f"view {t}", ns.sm.set_tenant_view(
                mgr, rt, t, [True, False, True]))

        def viewed():
            for t in view_t:
                svc = self.svcs[ns.sm.place(t, both)]
                row = svc.resolve_ensemble(t)
                if list(svc.member_np[row]) != [True, False, True]:
                    return False
            return True
        assert rt.run_until(viewed, 60.0)
        self.snap("viewed")
        gone = LS_TENANTS[-2:]
        for t in gone:
            self.snap(f"retire {t}", ns.sm.retire_tenant(mgr, rt, t))
        assert rt.run_until(lambda: all(
            s.resolve_ensemble(t) is None for s in self.svcs.values()
            for t in gone), 60.0)
        self.snap("retired")
        assert svc1._ens_names
        for rec in self.registry.values():
            rec.stop()
        for svc in self.svcs.values():
            svc.stop()
        return self


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="needs a CUDA device: the export's device gather "
                           "runs on the card")
def test_export_gather_on_the_card_equals_the_cpu():
    g = torch.Generator().manual_seed(1402)
    for e, m, s, n in ((10_000, 5, 128, 64), (7, 3, 33, 33), (1, 7, 8, 1)):
        st = eng.init_state(e, m, s, device="cpu")
        planes = {f: torch.randint(-2 ** 31, 2 ** 31 - 1, (e, m, s),
                                   generator=g, dtype=torch.int32)
                  for f in ("obj_epoch", "obj_seq", "obj_val")}
        st = st._replace(**planes)
        dev = st._replace(**{f: p.cuda() for f, p in planes.items()})
        slots = np.random.default_rng(e).choice(s, n, replace=False)
        for ens in (0, e - 1, e // 2):
            want = sm.gather_obj_planes(st, ens, slots)
            got = sm.gather_obj_planes(dev, ens, slots)
            assert got.dtype == np.int32 and got.shape == (3, m, n)
            assert np.array_equal(got, want)
