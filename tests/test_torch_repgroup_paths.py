"""The port's replication group on its other paths — the mirror of
``tests/test_replace_hosts.py``, ``test_tree_resync.py``,
``test_follower_reads.py``, the watchdog cases of ``test_fleet_obs.py``
and ``test_proxy.py``, at 4 ensembles x 8-16 slots, on the CPU, with
threaded replica hosts in one process:

- host membership: grow 3 -> 5 under load and replace a dead host with a
  blank one, no failed ack and no acked write lost, the joiners proven
  to carry the quorum; the per-ensemble view form refused on a group;
- tree catch-up: a restarted replica heals by a tree patch whose bytes
  scale with the diff; a wiped one falls back to the full install;
- follower reads: every read verb served from a replica's mirrors under
  its grant, the window lapsing after the lease and dying at a higher
  promise (the test waits for the grants to land, rather than reading
  the grant table at a moment that depends on which ack came first);
- the fleet watchdog's ``retpu_watchdog_*`` and clock-offset families
  under the reference's names, and a fleet scrape of three hosts;
- the proxy tier discovering the leader and riding out a handoff;
- linearizability under a link nemesis (directional cuts of requests
  and acks, a lost quorum, heals), checked by the port's
  ``KeyModel``; a replicated lifecycle surviving the leader's death.

These cases hold the port to its own invariants (acked writes read
back, lanes equal to their leader, the patch's share of the snapshot);
``test_torch_repgroup_lockstep.py`` holds the same catch-up, membership
and follower-read paths against the JAX package, frame by frame.

The OS-process case (kill -9 a replica process, restart it, promote it)
runs the port's ``python -m riak_ensemble_tpu_torch.parallel.repgroup
--device cpu``.  The ``cuda``-marked case holds a replica's full-plane
re-execution through F1 against the same entry applied through the
plain step on the CPU.
"""

import asyncio
import errno
import os
import select
import shutil
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from riak_ensemble_tpu_torch import faults, funref, obs, svcnode, wire
from riak_ensemble_tpu_torch import proxy as proxy_mod
from riak_ensemble_tpu_torch.config import Config, fast_test_config
from riak_ensemble_tpu_torch.linearizability import KeyModel
from riak_ensemble_tpu_torch.ops import cuda_engine
from riak_ensemble_tpu_torch.ops import engine as eng
from riak_ensemble_tpu_torch.parallel import repgroup
from riak_ensemble_tpu_torch.parallel.batched_host import (
    BatchedEnsembleService, WallRuntime)

E = 4
S = 16
LEADER_ADDR = ("leader.test", 1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _replica(root, name, cfg=None, **kw):
    return repgroup.ReplicaServer(E, 3, S, data_dir=os.path.join(root, name),
                                  config=cfg or fast_test_config(),
                                  device="cpu", **kw)


def _restart(root, name, repl_port, wait=10.0):
    """Restart replica ``name`` from its data dir on its old repl port.
    The port can stay taken for a moment after a kill: a closed
    listener whose accept thread has not woken yet, or an outgoing
    connection of another process that drew the same number as its
    ephemeral port.  So the bind is retried on EADDRINUSE (after one
    connection that wakes a lingering accept thread) for at most
    ``wait`` seconds, and the test fails if the port stays taken."""
    end = time.monotonic() + wait
    while True:
        probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            probe.bind(("127.0.0.1", repl_port))
            break
        except OSError as exc:
            if exc.errno != errno.EADDRINUSE:
                raise
        finally:
            probe.close()
        if time.monotonic() >= end:
            pytest.fail(f"replica {name}'s repl port {repl_port} stayed "
                        f"in use for {wait} s after its kill")
        try:
            socket.create_connection(("127.0.0.1", repl_port),
                                     timeout=0.5).close()
        except OSError:
            pass
        time.sleep(0.1)
    return _replica(root, name, repl_port=repl_port)


def _leader(root, srvs, cfg=None, **kw):
    svc = repgroup.ReplicatedService(
        WallRuntime(), E, 1, S, group_size=3,
        peers=[("127.0.0.1", s.repl_port) for s in srvs], ack_timeout=15.0,
        config=cfg or fast_test_config(),
        data_dir=os.path.join(root, "leader"), device="cpu", **kw)
    assert svc.takeover(), "takeover needs a replica majority"
    return svc


def _addr(srv):
    return ("127.0.0.1", srv.repl_port)


def _kill(svc, srv):
    """An in-process host death: it stops answering (a frame already in
    its socket buffer gets an error, never its lane), its ports close,
    the leader's connection to it drops, and its lane and WAL go."""
    with srv._lock:
        srv._handle_repl = lambda frame: ("error", "host down")
    srv.stop()
    for link in svc._links:
        sock = link._sock
        if link.port == srv.repl_port and sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
    with srv._lock:
        if srv.svc._wal is not None:
            srv.svc._wal.close()


def _settle(svc, futs, budget=30.0):
    end = time.monotonic() + budget
    while not all(f.done for f in futs) and time.monotonic() < end:
        svc.flush()
    assert all(f.done for f in futs), "futures never settled"
    return [f.value for f in futs]


def _drive_until(svc, cond, what, deadline=60.0):
    end = time.monotonic() + deadline
    while time.monotonic() < end:
        if cond():
            return
        try:
            svc.heartbeat()
        except repgroup.DeposedError:
            pass
        time.sleep(0.05)
    raise AssertionError(f"{what} never reached: {svc.stats()['group']}")


class Acked:
    """Every acknowledged put, and the read-back that proves none is
    lost."""

    def __init__(self, svc):
        self.svc, self.vals = svc, {}

    def put(self, phase, n=8, size=0):
        futs = []
        for i in range(n):
            e, key = i % E, f"{phase}-{i}"
            val = (b"%s/%d/" % (phase.encode(), i)).ljust(size, b"x")
            futs.append((e, key, val, self.svc.kput(e, key, val)))
        _settle(self.svc, [f for *_, f in futs])
        for e, key, val, f in futs:
            assert f.value[0] == "ok", (phase, key, f.value)
            self.vals[(e, key)] = val

    def check(self):
        futs = [(e, key, val, self.svc.kget(e, key))
                for (e, key), val in self.vals.items()]
        _settle(self.svc, [f for *_, f in futs])
        for e, key, val, f in futs:
            assert f.value == ("ok", val), f"acked write lost: {(e, key)}"


def _lanes_equal(svc, srvs):
    svc._drain_pending(block_all=True)
    want = (svc.core.applied_ge, svc.core.applied_seq)
    end = time.monotonic() + 30.0
    while time.monotonic() < end:
        if all((s.core.applied_ge, s.core.applied_seq) == want
               for s in srvs):
            break
        svc.heartbeat()
        want = (svc.core.applied_ge, svc.core.applied_seq)
        time.sleep(0.02)
    lead = repgroup.dump_state(svc)[0]
    for s in srvs:
        with s._lock:
            assert repgroup.dump_state(s.svc)[0] == lead


def _stop(svc, srvs):
    svc.stop()
    for s in srvs:
        s.stop()


# -- host membership -----------------------------------------------------------


def test_grow_three_to_five_under_load(tmp_path):
    """Grow 3 -> 5 while writes continue: no failed ack through the joint
    window, both joiners synced and counted — proven by killing both
    original replicas (leader + 2 joiners is a majority of 5 only with
    synced joiners) — and every acked write read back."""
    root = str(tmp_path)
    srvs = [_replica(root, n) for n in ("r1", "r2")]
    svc = _leader(root, srvs, self_addr=LEADER_ADDR)
    try:
        acked = Acked(svc)
        acked.put("pre")
        srvs += [_replica(root, n) for n in ("r3", "r4")]
        new = [LEADER_ADDR] + [_addr(s) for s in srvs]
        svc.update_members(new)
        for wave in range(4):
            acked.put(f"mid{wave}", n=4)
        _drive_until(svc, lambda: not svc.membership_status()["transition"]
                     and set(map(tuple, svc.membership_status()["hosts"]))
                     == set(new), "collapse to five")
        assert svc.group_size == 5
        assert svc.stats()["group"]["quorum_failures"] == 0
        _drive_until(svc, lambda: svc.stats()["group"]["peers_synced"] >= 4,
                     "four synced peers")
        _lanes_equal(svc, srvs)
        _kill(svc, srvs[0])
        _kill(svc, srvs[1])
        acked.put("final")
        acked.check()
    finally:
        _stop(svc, srvs)


def test_replace_dead_host_with_blank(tmp_path):
    """Replace a dead replica with a blank host: the joiner installs the
    full state, the collapse drops the dead address, and the joiner
    alone with the leader carries the quorum afterwards."""
    root = str(tmp_path)
    srvs = [_replica(root, n) for n in ("r1", "r2")]
    svc = _leader(root, srvs, self_addr=LEADER_ADDR)
    try:
        acked = Acked(svc)
        acked.put("pre")
        _kill(svc, srvs[1])
        acked.put("degraded")          # 2 of 3 still commit
        blank = _replica(root, "r3")
        srvs.append(blank)
        new = [LEADER_ADDR, _addr(srvs[0]), _addr(blank)]
        svc.update_members(new)
        _drive_until(svc, lambda: not svc.membership_status()["transition"],
                     "collapse")
        assert set(map(tuple, svc.membership_status()["hosts"])) == set(new)
        assert [l.port for l in svc._links] == [srvs[0].repl_port,
                                                blank.repl_port]
        _drive_until(svc, lambda: svc.stats()["group"]["peers_synced"] >= 2,
                     "joiner synced")
        _kill(svc, srvs[0])            # the joiner now carries the quorum
        acked.put("after")
        acked.check()
        _lanes_equal(svc, [blank])
    finally:
        _stop(svc, srvs)


def test_update_members_forms_and_step_out(tmp_path):
    """The per-ensemble view form is refused on a group, a leader without
    an identity cannot change members, and a leader that transitions
    itself out steps down after the collapse."""
    root = str(tmp_path)
    srvs = [_replica(root, n) for n in ("r1", "r2", "r3")]
    svc = _leader(root, srvs[:2], self_addr=LEADER_ADDR)
    try:
        with pytest.raises(TypeError):
            svc.update_members(np.ones(E, bool), np.ones((E, 1), bool))
        svc.update_members([LEADER_ADDR] + [_addr(s) for s in srvs[:2]])
        assert not svc.membership_status()["transition"]   # same set
        _settle(svc, [svc.kput(0, "k", b"v")])
        svc.update_members([_addr(s) for s in srvs])
        _drive_until(svc, lambda: not svc.is_leader, "step-out")
        assert set(map(tuple, svc.membership_status()["hosts"])) == \
            {_addr(s) for s in srvs}
        with pytest.raises(repgroup.DeposedError):
            svc.update_members([LEADER_ADDR])
    finally:
        _stop(svc, srvs)
    bare = repgroup.ReplicatedService(WallRuntime(), E, 1, S, group_size=1,
                                      config=fast_test_config(),
                                      device="cpu")
    bare._is_leader = True
    with pytest.raises(ValueError, match="identity"):
        bare.update_members([("h", 1)])
    bare.stop()


def test_replicated_lifecycle_survives_leader_death(tmp_path):
    """Dynamic tenants on a group (the mirror of
    ``test_repgroup_tenants.py``'s lifecycle case): create and destroy
    ride the stream with the host-quorum barrier, every lane keeps the
    same directory, and after the leader dies a promoted replica serves
    the tenants and their acknowledged writes."""
    root = str(tmp_path)
    srvs = [_replica(root, n, dynamic=True) for n in ("r1", "r2")]
    svc = _leader(root, srvs, dynamic=True)
    try:
        rows = {name: svc.create_ensemble(name)
                for name in ("orders", "users", "tmp")}
        assert len(set(rows.values())) == 3
        assert svc.destroy_ensemble("tmp")
        acked = [svc.kput(rows[n], "k", n.encode())
                 for n in ("orders", "users")]
        _settle(svc, acked)
        assert all(f.value[0] == "ok" for f in acked)
        _lanes_equal(svc, srvs)
        for s in srvs:
            assert s.svc._ens_names == svc._ens_names
        svc.stop()
        r = srvs[0]._promote([_addr(srvs[1])])
        assert r[0] == "ok"
        new = srvs[0].svc
        with srvs[0]._lock:
            assert new.resolve_ensemble("orders") == rows["orders"]
            assert new.resolve_ensemble("tmp") is None
            reads = [new.kget(rows[n], "k") for n in ("orders", "users")]
        end = time.monotonic() + 20
        while not all(f.done for f in reads) and time.monotonic() < end:
            time.sleep(0.05)
        assert [f.value for f in reads] == [("ok", b"orders"),
                                            ("ok", b"users")]
    finally:
        for s in srvs:
            s.stop()


@pytest.mark.parametrize("seed", [2101, 2102])
def test_linearizable_under_link_nemesis(tmp_path, seed):
    """sc.erl over the group's links (the in-process form of the
    reference's host-nemesis sweep): seeded puts and gets against the
    leader while directional link cuts come and go — requests or acks to
    either replica dropped, both at once (no quorum), healed.  Every
    acknowledged write reads back and no read is stale or resurrected,
    checked by the port's ``KeyModel``; a put that failed for want
    of a host quorum is ambiguous (it applied on the leader's lane) and
    joins the plausible set as a timed-out write."""
    rng = np.random.default_rng(seed)
    plan = faults.install(faults.FaultPlan(seed=seed))
    root = str(tmp_path)
    srvs = [_replica(root, n) for n in ("r1", "r2")]
    svc = _leader(root, srvs)
    labels = [f"127.0.0.1:{s.repl_port}" for s in srvs]
    models = {}
    vals = iter(range(1, 100000))

    def observe(m, res):
        if isinstance(res, tuple) and res[0] == "ok":
            v = res[1]
            m.ack_read(v if v is repgroup.NOTFOUND
                       else int.from_bytes(v, "big"))
    try:
        for rnd in range(10):
            r = rng.random()
            plan.heal()
            if r < 0.3:
                plan.drop(faults.LOCAL, labels[int(rng.integers(2))])
            elif r < 0.5:
                plan.drop(labels[int(rng.integers(2))], faults.LOCAL)
            elif r < 0.6:
                for lb in labels:
                    plan.drop(faults.LOCAL, lb)
            pending = []
            for _ in range(6):
                e, k = int(rng.integers(E)), int(rng.integers(3))
                m = models.setdefault((e, k), KeyModel(f"{e}/k{k}"))
                if rng.random() < 0.6:
                    v = next(vals)
                    pending.append(("put", m, m.invoke_write(v), svc.kput(
                        e, f"k{k}", v.to_bytes(4, "big"))))
                else:
                    pending.append(("get", m, None, svc.kget(e, f"k{k}")))
            _settle(svc, [f for *_, f in pending])
            for kind, m, op, f in pending:
                if kind == "get":
                    observe(m, f.value)
                elif isinstance(f.value, tuple) and f.value[0] == "ok":
                    m.ack_write(op)
                else:
                    m.timeout_write(op)
        plan.heal()
        _drive_until(svc, lambda: svc.stats()["group"]["peers_synced"] >= 2,
                     "re-synced after the nemesis")
        reads = [(m, svc.kget(e, f"k{k}")) for (e, k), m in models.items()]
        _settle(svc, [f for _m, f in reads])
        for m, f in reads:
            assert f.value[0] == "ok", f.value
            observe(m, f.value)
        _lanes_equal(svc, srvs)
        g = svc.stats()["group"]
        assert g["resyncs"] + g["tree_resyncs"] > 0, g   # the cuts bit
        assert plan.counters()["dropped_frames"], plan.counters()
    finally:
        faults.clear()
        _stop(svc, srvs)


# -- tree catch-up ---------------------------------------------------------------


def test_restarted_replica_heals_by_tree_patch(tmp_path):
    """A replica down for a few writes restarts from its data dir, is
    caught up by a tree patch a fraction of the full snapshot's bytes,
    and then carries the quorum alone with the leader."""
    root = str(tmp_path)
    srvs = [_replica(root, n) for n in ("r1", "r2")]
    svc = _leader(root, srvs)
    try:
        acked = Acked(svc)
        acked.put("base", n=32, size=200)
        _drive_until(svc, lambda: svc.stats()["group"]["peers_synced"] >= 2,
                     "synced")
        base = dict(svc.stats()["group"])
        port = srvs[0].repl_port
        _kill(svc, srvs[0])
        acked.put("gap-a", n=2)
        acked.put("gap-b", n=2)
        srvs[0] = _restart(root, "r1", port)
        _drive_until(svc, lambda: svc.stats()["group"]["peers_synced"] >= 2,
                     "re-synced")
        g = svc.stats()["group"]
        assert g["tree_resyncs"] == base["tree_resyncs"] + 1, g
        full = len(wire.encode(("install", 0, 0, repgroup.dump_state(svc),
                                svc.core.cfg)))
        patch = g["tree_resync_bytes"] - base["tree_resync_bytes"]
        assert 0 < patch < full / 3, (patch, full)
        _lanes_equal(svc, srvs)
        _kill(svc, srvs[1])
        acked.put("post", n=4)
        acked.check()
    finally:
        _stop(svc, srvs)


def test_blank_disk_falls_back_to_full_install(tmp_path):
    root = str(tmp_path)
    srvs = [_replica(root, n) for n in ("r1", "r2")]
    svc = _leader(root, srvs)
    try:
        _settle(svc, [svc.kput(e, f"k{i}", b"v%d" % i)
                      for i in range(8) for e in [i % E]])
        _drive_until(svc, lambda: svc.stats()["group"]["peers_synced"] >= 2,
                     "synced")
        before = dict(svc.stats()["group"])
        port = srvs[0].repl_port
        _kill(svc, srvs[0])
        shutil.rmtree(os.path.join(root, "r1"))
        _settle(svc, [svc.kput(0, "extra", b"x")])
        srvs[0] = _restart(root, "r1", port)
        _drive_until(svc, lambda: svc.stats()["group"]["peers_synced"] >= 2,
                     "re-synced")
        g = svc.stats()["group"]
        assert g["resyncs"] > before["resyncs"]
        assert g["tree_resyncs"] == before["tree_resyncs"]
        _lanes_equal(svc, srvs)
    finally:
        _stop(svc, srvs)


# -- follower reads --------------------------------------------------------------

LEASE = 1.5


def _lease_cfg() -> Config:
    return Config(ensemble_tick=0.05, lease_duration=LEASE,
                  probe_delay=0.1, storage_delay=0.005, storage_tick=0.5,
                  gossip_tick=0.2)


def _ask(port, *frame, timeout=30.0):
    """One svcnode-protocol round trip on a fresh socket."""
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=timeout) as s:
        repgroup.send_frame(s, frame)
        return repgroup.recv_frame(s)[1]


def test_follower_reads_serve_then_lapse_then_fence(tmp_path):
    faults.clear()
    root = str(tmp_path)
    srvs = [_replica(root, n, _lease_cfg(), follower_reads=True)
            for n in ("r1", "r2")]
    svc = _leader(root, srvs, _lease_cfg(), follower_reads=True)
    try:
        assert all(r[0] == "ok" for r in _settle(
            svc, [svc.kput(1, f"k{i}", b"v%d" % i) for i in range(4)]))
        port = srvs[0].client_port

        def granted():
            svc.heartbeat()
            svc._drain_pending(block_all=True)
            return (len(svc._flw_grants) == 2
                    and _ask(port, 0, "kget", 1, "k1") == ("ok", b"v1"))
        _drive_until(svc, granted, "both grants and a served read", 20.0)
        r = _ask(port, 2, "kget_vsn", 1, "k2")
        assert r[0] == "ok" and r[1] == b"v2" and len(r[2]) == 2
        assert _ask(port, 3, "kget_many", 1, ["k0", "k3"]) == \
            [("ok", b"v0"), ("ok", b"v3")]
        keys = ["k0", "k1"]
        lens = np.asarray([len(k) for k in keys], "<i4").tobytes()
        assert _ask(port, 4, "kget_slab", 1, lens,
                    "".join(keys).encode()) == [("ok", b"v0"), ("ok", b"v1")]
        assert _ask(port, 5, "kget", 1, "absent") == \
            ("ok", repgroup.NOTFOUND)
        assert srvs[0].svc.group_stats["follower_reads_served"] >= 5
        # idle past the lease: the window lapses, reads re-route
        time.sleep(LEASE + 0.2)
        assert _ask(port, 6, "kget", 1, "k1") == ("error", "not-leader")
        assert srvs[0].svc.group_stats["follower_reads_blocked"] >= 1
        _drive_until(svc, granted, "serving again", 20.0)
        # a higher promise fences the window at once
        with srvs[0]._lock:
            assert srvs[0].core.handle_promise(
                srvs[0].core.promised + 5)[1] is True
        assert _ask(port, 7, "kget", 1, "k1") == ("error", "not-leader")
    finally:
        faults.clear()
        _stop(svc, srvs)


# -- the fleet watchdog and the fleet verbs --------------------------------------


def test_watchdog_families_and_fleet_scrape(tmp_path, monkeypatch):
    """A grouped leader registers the watchdog's families (health carries
    its section), the standing pull runs on the controller cadence, and
    one Prometheus scrape carries all three hosts."""
    monkeypatch.setenv("RETPU_AUTOTUNE_CADENCE", "2")
    monkeypatch.delenv("RETPU_WATCHDOG", raising=False)
    monkeypatch.delenv("RETPU_OBS", raising=False)
    root = str(tmp_path)
    srvs = [_replica(root, n) for n in ("r1", "r2")]
    svc = _leader(root, srvs)
    try:
        assert svc._watchdog_armed
        for i in range(8):
            _settle(svc, [svc.kput_many(e, ["a", "b"], [b"%d" % i] * 2)
                          for e in range(E)])
        assert svc.watchdog.pulls > 0
        snap = svc.obs_registry.snapshot()
        fams = {k for k in snap if k.startswith("retpu_watchdog_")}
        assert fams, sorted(snap)[:20]
        assert "retpu_group_is_leader" in snap
        assert "retpu_repl_merge_coalesce_ratio" in snap
        assert svc.health()["watchdog"]["enabled"] is True
        txt = svc.fleet_metrics("prometheus")
        hosts = {ln.split('host="')[1].split('"')[0]
                 for ln in txt.splitlines()
                 if ln.startswith("retpu_flushes_total{")}
        assert len(hosts) == 3, hosts
        fh = svc.fleet_health()
        assert len(fh["hosts"]) == 3
        for link in svc._links:
            assert link.clock.section()["samples"] >= 1
        ref = pytest.importorskip("riak_ensemble_tpu.obs.watchdog")

        class _Svc:
            pipeline_depth = 1
            _links = ()
        assert set(ref.AnomalyWatchdog(_Svc()).collect()) == \
            set(obs.AnomalyWatchdog(_Svc()).collect())
    finally:
        _stop(svc, srvs)


def test_watchdog_expires_orphaned_pulls():
    import threading

    class _Tk:
        def __init__(self):
            self.event = threading.Event()    # never fires

    class _Svc:
        pipeline_depth = 1
        _links = ()

    wd = obs.AnomalyWatchdog(_Svc(), cadence=1)
    old = time.monotonic() - wd.PULL_EXPIRE_S - 1.0
    wd._pending = [(None, [1], _Tk(), old),
                   (None, [2], _Tk(), time.monotonic())]
    wd.evaluate()
    assert wd.pull_failures == 1
    assert len(wd._pending) == 1 and wd._pending[0][1] == [2]


# -- the proxy tier --------------------------------------------------------------


def test_proxy_discovers_the_leader_and_rides_out_a_handoff(tmp_path):
    root = str(tmp_path)
    cfg = _lease_cfg()
    srvs = [repgroup.ReplicaServer(2, 3, 8, data_dir=os.path.join(root, n),
                                   config=cfg, device="cpu")
            for n in ("r0", "r1", "r2")]
    ports = [s.repl_port for s in srvs]

    def control(port, frame):
        with socket.create_connection(("127.0.0.1", port),
                                      timeout=60) as s:
            s.settimeout(60)
            repgroup.send_frame(s, frame)
            return repgroup.recv_frame(s)

    try:
        assert control(ports[0], ("promote", [("127.0.0.1", ports[1]),
                                              ("127.0.0.1", ports[2])]))[0] \
            == "ok"

        async def scenario():
            px = await proxy_mod.serve_proxy(
                [("127.0.0.1", s.client_port) for s in srvs],
                discover_timeout=60.0)
            c = svcnode.ServiceClient(px.host, px.port)
            await c.connect()
            r = await c.kput(0, "pre", b"1", timeout=60.0)
            assert r[0] == "ok", r
            assert px.link.leader_addr == ("127.0.0.1", srvs[0].client_port)
            r2 = await asyncio.get_running_loop().run_in_executor(
                None, lambda: control(ports[1], (
                    "promote", [("127.0.0.1", ports[0]),
                                ("127.0.0.1", ports[2])])))
            assert r2[0] == "ok", r2
            deadline = time.monotonic() + 60.0
            while True:
                r = await c.kput(0, "post", b"2", timeout=60.0)
                if isinstance(r, tuple) and r[0] == "ok":
                    break
                assert r != ("error", "not-leader"), r
                assert time.monotonic() < deadline, r
                await asyncio.sleep(0.3)
            assert px.link.leader_addr == ("127.0.0.1", srvs[1].client_port)
            assert px.link.rediscoveries >= 1
            assert await c.kget(0, "pre", timeout=60.0) == ("ok", b"1")
            assert (await c.call("proxy_stats"))["not_leader_retries"] >= 1
            await c.close()
            await px.stop()

        asyncio.run(scenario())
    finally:
        for s in srvs:
            s.stop()


# -- replica processes -----------------------------------------------------------


def _spawn(data_dir, repl_port=0, client_port=0):
    """A port replica host as a fresh interpreter on the CPU; its stdout
    is drained by the caller after the banner line."""
    p = subprocess.Popen(
        [sys.executable, "-m", "riak_ensemble_tpu_torch.parallel.repgroup",
         "--device", "cpu", "--n-ens", str(E), "--group-size", "3",
         "--n-slots", str(S), "--fast", "--repl-port", str(repl_port),
         "--client-port", str(client_port), "--data-dir", data_dir],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True, env=dict(os.environ, PYTHONPATH=ROOT))
    ready, _w, _x = select.select([p.stdout], [], [], 120.0)
    if not ready:
        p.kill()
        p.wait()
        raise AssertionError("the replica process did not start in 120 s")
    line = p.stdout.readline()
    assert line.startswith("repgroup replica"), line
    parts = dict(kv.split("=") for kv in line.split()[2:])
    return p, int(parts["repl"]), int(parts["client"])


def test_process_replica_kill9_restart_and_promote(tmp_path):
    """Two replica processes: kill -9 one, commits go on at 2 of 3;
    restart it from its data dir and it catches up; promote it, and a
    ``GroupClient`` over the client ports finds it and reads back every
    acknowledged put."""
    procs = {}
    root = str(tmp_path)
    try:
        for n in ("r1", "r2"):
            procs[n] = _spawn(os.path.join(root, n))
        svc = repgroup.ReplicatedService(
            WallRuntime(), E, 1, S, group_size=3,
            peers=[("127.0.0.1", procs[n][1]) for n in ("r1", "r2")],
            ack_timeout=15.0, config=fast_test_config(),
            data_dir=os.path.join(root, "leader"), device="cpu")
        assert svc.takeover()
        acked = Acked(svc)
        acked.put("pre")
        procs["r1"][0].send_signal(signal.SIGKILL)
        procs["r1"][0].wait()
        acked.put("degraded")
        _, repl, client = procs["r1"]
        procs["r1"] = _spawn(os.path.join(root, "r1"), repl, client)
        _drive_until(svc, lambda: svc.stats()["group"]["peers_synced"] >= 2,
                     "restarted replica synced")
        acked.put("healed")
        assert svc.stats()["group"]["quorum_failures"] == 0
        svc.stop()
        with socket.create_connection(("127.0.0.1", repl), timeout=60) as s:
            s.settimeout(60)
            repgroup.send_frame(s, ("promote", [("127.0.0.1",
                                                 procs["r2"][1])]))
            assert repgroup.recv_frame(s)[0] == "ok"

        async def read_back():
            gc = repgroup.GroupClient(
                [("127.0.0.1", procs[n][2]) for n in ("r1", "r2")],
                discover_timeout=30.0)
            for (e, key), val in acked.vals.items():
                assert await gc.kget(e, key) == ("ok", val), (e, key)
            assert (await gc.kput(0, "promoted", b"y"))[0] == "ok"
            await gc.close()
        asyncio.run(read_back())
    finally:
        for p, _r, _c in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()


def test_touched_row_rebuild_equals_whole_store_rebuild():
    """The replica's rebuild of the touched rows only equals the engine's
    whole-store rebuild on those rows and leaves the others alone."""
    rng = np.random.default_rng(11)
    st = eng.init_state(37, 1, 33, device="cpu")
    for plane in (st.obj_epoch, st.obj_seq, st.obj_val):
        plane.copy_(torch.from_numpy(rng.integers(
            -2 ** 31, 2 ** 31, plane.shape, dtype=np.int64).astype(np.int32)))
    rows = rng.random((37, 1)) < 0.3
    want = eng.rebuild_trees(st, torch.from_numpy(rows))
    old_leaf, old_node = st.tree_leaf.clone(), st.tree_node.clone()
    got = repgroup._rebuild_rows(st, rows)
    r = torch.from_numpy(rows[:, 0])
    assert torch.equal(got.tree_leaf[r], want.tree_leaf[r])
    assert torch.equal(got.tree_node[r], want.tree_node[r])
    assert torch.equal(got.tree_leaf[~r], old_leaf[~r])
    assert torch.equal(got.tree_node[~r], old_node[~r])


# -- the card ------------------------------------------------------------------


@pytest.mark.cuda
def test_full_plane_entry_through_f1_matches_plain(tmp_path):
    """A replica lane on the card re-executes a full-plane entry (an
    election round plus puts, CAS and increments) through F1; the same
    entry applied to a CPU lane runs the plain step.  Both lanes end
    equal, with equal ack CRCs, and F1 launched."""
    if not torch.cuda.is_available():
        pytest.skip("F1 is a CUDA kernel: no CUDA device is visible")
    rng = np.random.default_rng(3)
    e_n, s_n, k = 257, 128, 8
    kind = rng.choice([eng.OP_NOOP, eng.OP_PUT, eng.OP_GET, eng.OP_RMW],
                      (k, e_n)).astype(np.int32)
    slot = rng.integers(0, s_n, (k, e_n)).astype(np.int32)
    val = rng.integers(1, 1000, (k, e_n)).astype(np.int32)
    exp_e = np.where(kind == eng.OP_RMW, funref.RMW_ADD, 0).astype(np.int32)
    exp_s = np.zeros_like(exp_e)
    elect = np.ones((e_n,), bool)
    lease = np.zeros((e_n,), bool)
    ent, _n = repgroup.build_full_entry(1, k, True, elect, lease, kind,
                                        slot, val, exp_e, exp_s, [])
    ent = wire.decode(b"".join(bytes(memoryview(p).cast("B"))
                               for p in wire.encode_parts(ent)))
    lanes, crcs = [], []
    for dev in ("cuda", "cpu"):
        svc = BatchedEnsembleService(WallRuntime(), e_n, 1, s_n, tick=None,
                                     config=fast_test_config(), device=dev)
        core = repgroup.ReplicaCore(svc)
        before = cuda_engine.engine_step_launches
        crcs.append(core._apply_full_entry(0, ent))
        if dev == "cuda":
            assert cuda_engine.engine_step_launches > before
        lanes.append(repgroup.dump_state(svc))
        svc.stop()
    assert crcs[0] == crcs[1]
    assert lanes[0] == lanes[1]


@pytest.mark.cuda
def test_coalesced_delta_run_on_the_card_matches_cpu(monkeypatch):
    """One ``abatch`` frame of three delta entries, each writing the same
    slot of every row in both of its rounds, applied by a replica lane on
    the card and by one on the CPU: every scatter carries an (ensemble,
    slot) once (CUDA's ``index_put_`` picks no winner among repeated
    indices), both answer alike, and the lanes end equal with the last
    write in place."""
    if not torch.cuda.is_available():
        pytest.skip("the card lane needs a CUDA device")
    e_n, s_n, k = 300, 16, 2
    calls = []
    put = repgroup._put_cells

    def record(svc, cells):
        calls.append(np.array(cells, np.int64))
        put(svc, cells)
    monkeypatch.setattr(repgroup, "_put_cells", record)
    q = np.ones((e_n,), bool)
    committed = np.ones((k, e_n), bool)
    kind = np.full((k, e_n), eng.OP_PUT, np.int32)
    slot = np.full((k, e_n), s_n - 1, np.int32)
    value = np.zeros((k, e_n), np.int32)
    ents = [repgroup.build_delta_entry(
        seq, k, committed, value, kind, slot,
        np.full((k, e_n), 10 * seq, np.int32) + np.arange(k)[:, None], q,
        [])[0] for seq in (1, 2, 3)]
    payload = b"".join(bytes(memoryview(p).cast("B"))
                       for p in wire.encode_parts(("abatch", 0, ents)))
    answers, lanes = [], []
    for dev in ("cuda", "cpu"):
        svc = BatchedEnsembleService(WallRuntime(), e_n, 1, s_n, tick=None,
                                     config=fast_test_config(), device=dev)
        answers.append(repgroup.ReplicaCore(svc).handle_abatch(
            wire.decode(payload)))
        lanes.append(repgroup.dump_state(svc))
        assert (repgroup._host(svc.state.obj_val)[:, 0, s_n - 1] == 31).all()
        svc.stop()
    assert answers[0] == answers[1] and answers[0][0] == "applied"
    assert lanes[0] == lanes[1]
    assert len(calls) == 2
    for cells in calls:
        assert len({(int(e), int(s)) for e, s in cells[:, :2]}) == \
            len(cells) == e_n
