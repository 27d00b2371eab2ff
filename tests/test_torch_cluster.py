"""The port's cluster-management plane in lockstep with the JAX package's.

The scenarios of the reference's ``test_cluster``, ``test_corrupt`` and
``test_schedule_sweep`` (every seed it sweeps) run through
``tests/test_torch_scalar_plane.py``'s :func:`lockstep`: the same
``ManagedCluster`` / ``Cluster`` calls on each package, from the same
seed, with the results, ``runtime.now``, leaders, facts, synctree top
hashes, storage tables and every manager's cluster state (its vsn-guarded
members and ensembles) held equal after each call.  The pure
cluster-state functions (``state.py``'s vsn guards and gossip merge) are
held equal on the same inputs.
"""

import pytest

pytest.importorskip("jax")

from test_torch_scalar_plane import PORT, REF, lockstep, norm  # noqa: E402


# ---------------------------------------------------------------------------
# pure cluster-state functions (riak_ensemble_state.erl semantics)


def _both(fn):
    """``fn(ns)`` on both packages; the normalised results are equal."""
    ref, port = fn(REF), fn(PORT)
    assert norm(ref) == norm(port)
    return port


def test_state_vsn_guards():
    def run(ns):
        st = ns.state
        cs = st.new_state("cid")
        a = st.add_member((0, 0), "n1", cs)
        b = st.add_member((0, 0), "n2", a)
        c = st.add_member((0, 1), "n2", a)
        d = st.del_member((1, 0), "n1", c)
        return [cs, a, b, c, d]

    cs, a, b, c, d = _both(run)
    assert a.members == {"n1"} and b is None
    assert c.members == {"n1", "n2"} and d.members == {"n2"}


def test_state_ensemble_guards():
    def run(ns):
        st, T = ns.state, ns.types
        cs = st.new_state("cid")
        info = T.EnsembleInfo(vsn=(0, 0), leader=None, views=(),
                              seq=(0, 0))
        cs = st.set_ensemble("e1", info, cs)
        p = T.PeerId(0, "n1")
        return [cs, st.update_ensemble((1, 0), "nope", None, (), cs),
                st.update_ensemble((1, 0), "e1", p, ((p,),), cs),
                st.update_ensemble((0, 5), "e1", None, (),
                                   st.update_ensemble((1, 0), "e1", p,
                                                      ((p,),), cs))]

    cs, missing, cs2, stale = _both(run)
    assert cs is not None and missing is None and stale is None
    assert cs2.ensembles["e1"].leader == PORT.types.PeerId(0, "n1")


def test_state_merge_newest_wins():
    def run(ns):
        st = ns.state
        a = st.add_member((0, 0), "n1", st.enable(st.new_state("cid")))
        b = st.add_member((0, 1), "n2", a)
        foreign = st.add_member((9, 9), "evil", st.new_state("x"))
        return [st.merge(a, b), st.merge(a, foreign), st.merge(b, a),
                st.enable(a)]

    merged, foreign, back, again = _both(run)
    assert merged.members == {"n1", "n2"} and back.members == merged.members
    assert foreign.members == {"n1"} and again is None


# ---------------------------------------------------------------------------
# full-stack manager scenarios (test_cluster.py)


def _three_nodes(t, seed):
    mc = t.wrap(t.ns.testing.ManagedCluster(
        seed=seed, nodes=("node0", "node1", "node2")))
    mc.enable("node0")
    mc.join("node1", "node0")
    mc.join("node2", "node0")
    return mc


def sc_enable_creates_root_ensemble(t):
    mc = t.wrap(t.ns.testing.ManagedCluster(seed=10, nodes=("node0",)))
    mc.enable("node0")
    assert mc.leader_id("root") == t.ns.types.PeerId("root", "node0")
    assert mc.mgr("node0").enabled()
    assert mc.mgr("node0").enable() == "error"


def sc_client_kv_through_root(t):
    mc = t.wrap(t.ns.testing.ManagedCluster(seed=11, nodes=("node0",)))
    mc.enable("node0")
    c = mc.client("node0")
    assert c.kover("root", "k", b"v")[0] == "ok"
    r = c.kget("root", "k")
    assert r[0] == "ok" and r[1].value == b"v"


def sc_client_unavailable_when_disabled(t):
    mc = t.wrap(t.ns.testing.ManagedCluster(seed=12, nodes=("node0",)))
    assert mc.client("node0").kget("root", "k") == ("error", "unavailable")


def sc_join_and_gossip_convergence(t):
    mc = _three_nodes(t, 13)
    for n in ("node0", "node1", "node2"):
        assert mc.mgr(n).cluster() == ["node0", "node1", "node2"]


def sc_join_guards(t):
    mc = t.wrap(t.ns.testing.ManagedCluster(seed=14,
                                            nodes=("node0", "node1")))
    fut = mc.mgr("node1").join_async("node0", timeout=5.0)
    assert mc.runtime.await_future(fut, timeout=10.0) == \
        ("error", "remote_not_enabled")
    mc.enable("node0")
    fut = mc.mgr("node0").join_async("node0", timeout=5.0)
    assert mc.runtime.await_future(fut, 10.0) == ("error", "same_node")
    mc.enable("node1")
    fut = mc.mgr("node1").join_async("node0", timeout=5.0)
    assert mc.runtime.await_future(fut, 10.0) == ("error",
                                                  "already_enabled")


def sc_create_ensemble_starts_peers(t):
    mc = _three_nodes(t, 15)
    peers = [t.ns.types.PeerId(i, f"node{i}") for i in range(3)]
    mc.create_ensemble("ens1", peers)
    assert mc.wait_stable("ens1") in peers
    c = mc.client("node1")
    assert c.kover("ens1", "key", b"val")[0] == "ok"
    r = c.kget("ens1", "key")
    assert r[0] == "ok" and r[1].value == b"val"
    r2 = mc.client("node2").kget("ens1", "key")
    assert r2[0] == "ok" and r2[1].value == b"val"


def sc_root_expand_and_remove(t):
    PeerId = t.ns.types.PeerId
    mc = _three_nodes(t, 16)
    adds = [("add", PeerId("root", "node1")),
            ("add", PeerId("root", "node2"))]
    assert mc.update_members("root", adds) == "ok"

    def root_peers_started():
        return all(
            mc.runtime.whereis(("peer", "root", PeerId("root", n)))
            is not None or
            any(k[0] == "root" for k in mc.mgr(n).local_peers)
            for n in ("node1", "node2"))
    assert mc.runtime.run_until(root_peers_started, 60.0, poll=0.1)
    mc.wait_stable("root")
    assert mc.client("node0").kover("root", "rk", b"rv")[0] == "ok"
    mc.remove("node0", "node2")
    assert mc.runtime.run_until(
        lambda: "node2" not in mc.mgr("node0").cluster_state.members,
        30.0, poll=0.1)


def sc_failover_with_managed_cluster(t):
    mc = _three_nodes(t, 17)
    peers = [t.ns.types.PeerId(i, f"node{i}") for i in range(3)]
    mc.create_ensemble("ens1", peers)
    leader = mc.wait_stable("ens1")
    assert mc.client("node0").kover("ens1", "k", b"v1")[0] == "ok"
    mc.suspend_peer("ens1", leader)
    assert mc.runtime.run_until(
        lambda: mc.leader_id("ens1") not in (None, leader), 60.0)
    mc.wait_stable("ens1")

    def readable():
        r = mc.client("node1").kget("ens1", "k", timeout=5.0)
        return r[0] == "ok" and r[1].value == b"v1"
    assert mc.runtime.run_until(readable, 60.0, poll=0.5)


def sc_crashed_local_peer_restarted(t):
    mc = t.wrap(t.ns.testing.ManagedCluster(seed=23))
    mc.ens_start(3)
    assert mc.kput("k", b"v")[0] == "ok"
    name = t.ns.peer.peer_name("root", t.ns.types.PeerId(2, mc.node0))
    assert mc.runtime.whereis(name) is not None
    mc.runtime.stop_actor(name)
    assert mc.runtime.whereis(name) is None
    assert mc.runtime.run_until(
        lambda: mc.runtime.whereis(name) is not None, 30.0)
    mc.wait_stable("root")
    r = mc.kget("k")
    assert r[0] == "ok" and r[1].value == b"v"
    assert mc.kput("k", b"v2")[0] == "ok"


def sc_crashed_leader_restarted(t):
    mc = t.wrap(t.ns.testing.ManagedCluster(seed=29))
    mc.ens_start(3)
    assert mc.kput("k", b"v")[0] == "ok"
    name = t.ns.peer.peer_name("root", mc.wait_leader("root"))
    mc.runtime.stop_actor(name)
    assert mc.runtime.run_until(
        lambda: mc.runtime.whereis(name) is not None, 30.0)
    assert mc.wait_stable("root") is not None
    r = mc.kget("k")
    assert r[0] == "ok" and r[1].value == b"v", r
    assert mc.kput("k", b"v2")[0] == "ok"


CLUSTER = [sc_enable_creates_root_ensemble, sc_client_kv_through_root,
           sc_client_unavailable_when_disabled,
           sc_join_and_gossip_convergence, sc_join_guards,
           sc_create_ensemble_starts_peers, sc_root_expand_and_remove,
           sc_failover_with_managed_cluster,
           sc_crashed_local_peer_restarted, sc_crashed_leader_restarted]


@pytest.mark.parametrize("scenario", CLUSTER, ids=lambda f: f.__name__[3:])
def test_cluster_lockstep(scenario):
    lockstep(scenario)


# ---------------------------------------------------------------------------
# synctree corruption (test_corrupt.py)


def _kget_never_notfound(t, mc, key, max_time=60.0):
    mc.read_until(key, max_time)
    r = mc.kget(key)
    assert r[0] == "ok" and r[1].value is not t.ns.types.NOTFOUND


def _corrupt_store_hook(tree, victim_key):
    backend = tree.backend
    orig_store = backend.store
    leaf_level = tree.height + 1

    def store(loc, value):
        if isinstance(loc, tuple) and loc[-2] == leaf_level and \
                isinstance(value, dict) and victim_key in value:
            value = dict(value)
            h = value[victim_key]
            value[victim_key] = bytes([h[0] ^ 0xFF]) + h[1:]
        orig_store(loc, value)

    backend.store = store
    return lambda: setattr(backend, "store", orig_store)


def sc_corrupt_segment_on_leader(t):
    mc = t.wrap(t.ns.testing.ManagedCluster(seed=30))
    mc.ens_start(3)
    tree = mc.tree_of("root", mc.leader_id("root")).tree
    restore = _corrupt_store_hook(tree, "corrupt")
    assert mc.kput("corrupt", b"test")[0] == "ok"
    restore()
    _kget_never_notfound(t, mc, "corrupt")


def sc_corrupt_segment_posthoc(t):
    mc = t.wrap(t.ns.testing.ManagedCluster(seed=31))
    mc.ens_start(3)
    assert mc.kput("corrupt", b"test")[0] == "ok"
    mc.tree_of("root", mc.leader_id("root")).tree.corrupt("corrupt")
    _kget_never_notfound(t, mc, "corrupt")


def sc_corrupt_upper(t):
    mc = t.wrap(t.ns.testing.ManagedCluster(seed=32))
    mc.ens_start(5)
    assert mc.kput("corrupt", b"test")[0] == "ok"
    tree = mc.tree_of("root", mc.leader_id("root")).tree
    tree.corrupt_upper("corrupt", level=tree.height - 1)
    _kget_never_notfound(t, mc, "corrupt")


def sc_corrupt_follower(t):
    PeerId = t.ns.types.PeerId
    mc = t.wrap(t.ns.testing.ManagedCluster(seed=33))
    mc.ens_start(3)
    node = mc.node0
    assert mc.kput("corrupt", b"test")[0] == "ok"
    assert mc.kput("corrupt", b"test2")[0] == "ok"
    assert mc.kget("corrupt")[0] == "ok"
    leader = mc.leader_id("root")
    for m in (PeerId("root", node), PeerId(2, node), PeerId(3, node)):
        if m != leader:
            mc.tree_of("root", m).tree.corrupt("corrupt")
    mc.suspend_peer("root", leader)
    mc.runtime.run_for(2.0)
    mc.resume_peer("root", leader)
    mc.wait_stable("root")
    _kget_never_notfound(t, mc, "corrupt", max_time=120.0)
    assert mc.kget("corrupt")[1].value == b"test2"


def sc_corrupt_exchange(t):
    PeerId = t.ns.types.PeerId
    mc = t.wrap(t.ns.testing.ManagedCluster(seed=34))
    mc.ens_start(3)
    node = mc.node0
    assert mc.kput("corrupt", b"test")[0] == "ok"
    for m in (PeerId("root", node), PeerId(2, node), PeerId(3, node)):
        mc.tree_of("root", m).tree.corrupt("corrupt")
    _kget_never_notfound(t, mc, "corrupt", max_time=120.0)


CORRUPT = [sc_corrupt_segment_on_leader, sc_corrupt_segment_posthoc,
           sc_corrupt_upper, sc_corrupt_follower, sc_corrupt_exchange]


@pytest.mark.parametrize("scenario", CORRUPT, ids=lambda f: f.__name__[3:])
def test_corrupt_lockstep(scenario):
    lockstep(scenario)


# ---------------------------------------------------------------------------
# interleaving exploration (test_schedule_sweep.py), every seed it sweeps


def sc_failover_fuzz(t, seed):
    c = t.wrap(t.ns.testing.Cluster(seed=seed))
    c.runtime.net.max_latency = 5e-4 * (1 + (seed % 4) * 6)
    c.create_ensemble("ens", t.ns.testing.make_peers(3))
    leader = c.wait_stable("ens")
    c.kput_ok("ens", "k", b"v1")
    c.suspend_peer("ens", leader)
    assert c.runtime.run_until(
        lambda: c.leader_id("ens") not in (None, leader), 60.0)
    c.wait_stable("ens")
    assert c.kget_value("ens", "k") == b"v1"
    c.resume_peer("ens", leader)
    c.runtime.run_for(2.0)
    c.kput_ok("ens", "k", b"v2")
    assert c.kget_value("ens", "k") == b"v2"


def sc_failover_chaos(t, seed):
    c = t.wrap(t.ns.testing.Cluster(seed=seed))
    c.runtime.net.chaos(window=0.02, local=0.002)
    c.create_ensemble("ens", t.ns.testing.make_peers(3))
    leader = c.wait_stable("ens")
    c.kput_ok("ens", "k", b"v1")
    c.suspend_peer("ens", leader)
    assert c.runtime.run_until(
        lambda: c.leader_id("ens") not in (None, leader), 60.0)
    c.wait_stable("ens")
    assert c.kget_value("ens", "k") == b"v1"
    c.resume_peer("ens", leader)
    c.runtime.run_for(2.0)
    c.kput_ok("ens", "k", b"v2")
    assert c.kget_value("ens", "k") == b"v2"


def sc_membership_churn(t, seed):
    PeerId = t.ns.types.PeerId
    mc = t.wrap(t.ns.testing.ManagedCluster(seed=seed))
    mc.runtime.net.chaos(window=0.01, local=0.001)
    mc.ens_start(3)
    extra = PeerId(4, mc.node0)
    assert mc.kput("k", b"v0")[0] == "ok"
    base = [PeerId("root", mc.node0), PeerId(2, mc.node0),
            PeerId(3, mc.node0)]
    for i in range(2):
        assert mc.update_members("root", [("add", extra)]) == "ok"
        mc.wait_members("root", base + [extra])
        mc.wait_stable("root")
        assert mc.kput("k", b"v%d" % i)[0] == "ok"
        assert mc.update_members("root", [("del", extra)]) == "ok"
        assert mc.runtime.run_until(
            lambda: extra not in mc.mgr(mc.node0).get_members("root"),
            60.0, poll=0.1)
        mc.wait_stable("root")
        r = mc.kget("k")
        assert r[0] == "ok" and r[1].value == b"v%d" % i


def sc_corruption_chaos(t, seed):
    mc = t.wrap(t.ns.testing.ManagedCluster(seed=seed))
    mc.runtime.net.chaos(window=0.01, local=0.001)
    mc.ens_start(3)
    assert mc.kput("corrupt", b"test")[0] == "ok"
    mc.tree_of("root", mc.wait_leader("root")).tree.corrupt("corrupt")

    def never_notfound():
        r = mc.kget("corrupt")
        if r[0] == "ok":
            assert r[1].value is not t.ns.types.NOTFOUND
            return r[1].value == b"test"
        return False
    assert mc.runtime.run_until(never_notfound, 60.0)


def sc_cas_races(t, seed):
    c = t.wrap(t.ns.testing.Cluster(seed=seed))
    c.runtime.net.chaos(window=0.015, local=0.001)
    c.create_ensemble("ens", t.ns.testing.make_peers(3))
    leader = c.wait_stable("ens")
    c.kput_ok("ens", "k", b"v0")
    last = b"v0"
    for i in range(1, 6):
        if i == 3:
            c.suspend_peer("ens", leader)
            assert c.runtime.run_until(
                lambda: c.leader_id("ens") not in (None, leader), 60.0)
            c.wait_stable("ens")
        r = c.kget("ens", "k")
        assert r[0] == "ok", (seed, i, r)
        out = c.kupdate("ens", "k", r[1], b"v%d" % i)
        if isinstance(out, tuple) and out[0] == "ok":
            last = b"v%d" % i
        else:
            assert out in ("failed", "timeout") or out[0] == "error"
    c.resume_peer("ens", leader)
    c.wait_stable("ens")
    assert c.kget_value("ens", "k") == last


def sc_backend_death_chaos(t, seed):
    ns = t.ns

    class _Store(ns.runtime.Actor):
        def handle(self, msg):
            pass

    class ChaosHelperBackend(ns.backend.BasicBackend):
        def __init__(self, ensemble, peer_id, args=()):
            super().__init__(ensemble, peer_id, ())
            runtime, node = args
            self.helper_name = ("cstore", ensemble, repr(peer_id))
            if runtime.whereis(self.helper_name) is None:
                _Store(runtime, self.helper_name, node)

        def monitored(self):
            return (self.helper_name,)

        def handle_down(self, ref, pid, reason):
            if ref == self.helper_name:
                self.data = {}
                return ("reset",)
            return False

    ns.backend.register_backend("chaos-helper", ChaosHelperBackend)
    raw = ns.testing.Cluster(seed=seed)
    c = t.wrap(raw)
    c.runtime.net.chaos(window=0.015, local=0.001)
    peers = ns.testing.make_peers(3)
    c.create_ensemble("ens", peers, backend="chaos-helper",
                      backend_args=(raw.runtime, peers[0].node))
    leader = c.wait_stable("ens")
    c.kput_ok("ens", "k", b"v1")
    c.runtime.stop_actor(c.peer("ens", leader).mod.helper_name)
    c.runtime.run_for(0.5)
    c.wait_stable("ens")
    c.read_until("ens", "k", b"v1")
    c.kput_ok("ens", "k", b"v2")
    assert c.kget_value("ens", "k") == b"v2"


def sc_partition_heal(t, seed):
    c = t.wrap(t.ns.testing.Cluster(seed=seed))
    c.runtime.net.chaos(window=0.01, local=0.001)
    peers = t.ns.testing.make_peers(3)
    c.create_ensemble("ens", peers)
    leader = c.wait_stable("ens")
    c.kput_ok("ens", "k", b"v1")
    others = [p.node for p in peers if p.node != leader.node]
    c.runtime.net.partition([leader.node], others)
    assert c.runtime.run_until(
        lambda: c.leader_id("ens") not in (None, leader), 90.0)
    c.wait_stable("ens")
    c.read_until("ens", "k", b"v1")
    c.kput_ok("ens", "k", b"v2")
    c.runtime.net.heal()
    c.wait_stable("ens")
    c.read_until("ens", "k", b"v2")
    c.kput_ok("ens", "k", b"v3")
    assert c.kget_value("ens", "k") == b"v3"


SWEEP = ([(sc_failover_fuzz, s) for s in range(60, 80)]
         + [(sc_failover_chaos, s) for s in range(80, 90)]
         + [(sc_membership_churn, s) for s in range(90, 98)]
         + [(sc_corruption_chaos, s) for s in range(100, 108)]
         + [(sc_cas_races, s) for s in range(110, 118)]
         + [(sc_backend_death_chaos, s) for s in range(120, 128)]
         + [(sc_partition_heal, s) for s in range(130, 138)])


@pytest.mark.parametrize("scenario,seed", SWEEP,
                         ids=[f"{f.__name__[3:]}-{s}" for f, s in SWEEP])
def test_schedule_sweep_lockstep(scenario, seed):
    lockstep(scenario, seed)
