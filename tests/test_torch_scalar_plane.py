"""The port's scalar plane in lockstep with the JAX package's.

Each scenario of the reference's ``Cluster`` suites (``test_basic``,
``test_expand``, ``test_replace_members``, ``test_lease``,
``test_read_tombstone``, ``test_leadership_watchers``,
``test_backend_down``, ``test_drop_write``) is written once against a
package namespace and run twice in one process: on
``riak_ensemble_tpu`` and on ``riak_ensemble_tpu_torch``, from the same
seed, with each package's module-level id counters reset first.  The
scenario keeps the reference's assertions, and every call it makes on
the cluster (and on its runtime, clients and managers) is a step: the
harness records the call's result with ``NOTFOUND`` and the record
classes normalised, and a snapshot of the whole cluster after it —
``runtime.now``, the leader of each ensemble, every actor in
registration order, each peer's FSM state, fact (epoch, seq, views, ...)
and backend data, each synctree's top hash, each ``Storage``'s table
(and its file, decoded, when it has one) and each manager's cluster
state.  The two step logs must be equal, step by step.

:func:`lockstep` and :class:`Recorder` are shared with
``tests/test_torch_cluster.py``.
"""

import dataclasses
import itertools
import pickle
import types

import pytest

pytest.importorskip("jax")

_MODULES = ("testing", "types", "peer", "backend", "runtime", "config",
            "msg", "router", "state", "save", "storage", "manager")


def _namespace(pkg: str) -> types.SimpleNamespace:
    import importlib

    ns = types.SimpleNamespace(name=pkg)
    for mod in _MODULES:
        setattr(ns, mod, importlib.import_module(f"{pkg}.{mod}"))
    return ns


REF = _namespace("riak_ensemble_tpu")
PORT = _namespace("riak_ensemble_tpu_torch")
_NOTFOUNDS = (REF.types.NOTFOUND, PORT.types.NOTFOUND)


def _reset_counters(ns) -> None:
    """Module-level id counters name collectors, proxies and call refs:
    each run starts them at 1, whatever ran earlier in the process."""
    for attr in ("_reqids", "_xproxy_ids", "_xcall_refs", "_collector_ids"):
        setattr(ns.msg, attr, itertools.count(1))
    for attr in ("_proxy_ids", "_refs"):
        setattr(ns.router, attr, itertools.count(1))


def norm(x):
    """A package-neutral form of ``x``: record classes become (class
    name, fields...), ``NOTFOUND`` a marker, dict order is kept."""
    if any(x is nf for nf in _NOTFOUNDS):
        return "<NOTFOUND>"
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return (type(x).__name__,) + tuple(norm(v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            norm(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, tuple):
        return tuple(norm(v) for v in x)
    if isinstance(x, list):
        return [norm(v) for v in x]
    if isinstance(x, dict):
        return ("dict",) + tuple((norm(k), norm(v)) for k, v in x.items())
    if isinstance(x, (set, frozenset)):
        return ("set",) + tuple(sorted((norm(v) for v in x), key=repr))
    if isinstance(x, BaseException):
        return ("exc", type(x).__name__, str(x))
    if x is None or isinstance(x, (bool, int, float, str, bytes)):
        return x
    if callable(x):
        return ("fn", getattr(x, "__qualname__", type(x).__name__))
    return ("obj", type(x).__name__)


def snapshot(ns, cluster):
    """Everything the lockstep holds equal after a step."""
    rt = cluster.runtime
    actors = []
    ensembles = []
    for name, a in list(rt.actors.items()):
        kind = type(a).__name__
        item = [norm(name), kind, a.suspended]
        if isinstance(a, ns.peer.Peer):
            item += [a.fsm_state, norm(a.fact), norm(a.mod.data)]
            if a.ensemble not in ensembles:
                ensembles.append(a.ensemble)
        elif kind == "PeerTree":
            item += [a.tree.top_hash, a.corrupted]
        elif isinstance(a, ns.storage.Storage):
            item.append(norm(a.table))
            if a.path is not None:
                raw = ns.save.read(a.path)
                item.append(None if raw is None
                            else norm(pickle.loads(raw)))
        elif isinstance(a, ns.manager.Manager):
            item.append(norm(a.cluster_state))
        actors.append(tuple(item))
    leaders = [(norm(e), norm(ns.testing.Cluster.leader_id(cluster, e)))
               for e in ensembles]
    return (rt.now, tuple(leaders), tuple(actors))


class Rec:
    """Records every top-level call on the wrapped object as a step."""

    _WRAP = ("Runtime", "Client", "Manager")

    def __init__(self, obj, rec: "Recorder") -> None:
        self._obj = obj
        self._rec = rec

    def __getattr__(self, name):
        val = getattr(self._obj, name)
        if type(val).__name__ in self._WRAP:
            return Rec(val, self._rec)
        if not callable(val) or isinstance(val, type):
            return val
        rec = self._rec

        def call(*args, **kw):
            if rec.depth:
                return val(*args, **kw)
            rec.depth += 1
            try:
                out = val(*args, **kw)
            except BaseException as exc:
                rec.depth -= 1
                rec.log_step(name, ("raised", norm(exc)))
                raise
            rec.depth -= 1
            rec.log_step(name, norm(out))
            if type(out).__name__ in self._WRAP:
                return Rec(out, rec)
            return out
        return call


class Recorder:
    """The handle a scenario gets: ``ns`` is the package's modules,
    :meth:`wrap` makes a recorded cluster, ``step`` records a value."""

    def __init__(self, ns) -> None:
        self.ns = ns
        self.depth = 0
        self.log = []
        self.cluster = None

    def wrap(self, cluster):
        self.cluster = cluster
        self.log_step("start", None)
        return Rec(cluster, self)

    def log_step(self, label, value) -> None:
        snap = snapshot(self.ns, self.cluster) if self.cluster else None
        self.log.append((label, value, snap))

    def step(self, label, value):
        self.log_step(label, norm(value))
        return value


def _first_difference(a, b, path="step"):
    if type(a) is not type(b) or not isinstance(a, (tuple, list)) \
            or len(a) != len(b):
        return f"{path}: {a!r:.300} != {b!r:.300}"
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return _first_difference(x, y, f"{path}[{i}]")
    return None


def lockstep(scenario, *args, **kw):
    """Run ``scenario(recorder, *args, **kw)`` on the reference and on
    the port and hold their step logs equal; returns the port's log."""
    logs = []
    for ns in (REF, PORT):
        _reset_counters(ns)
        rec = Recorder(ns)
        scenario(rec, *args, **kw)
        logs.append(rec.log)
    ref, port = logs
    assert len(ref) > 1
    for i, (a, b) in enumerate(zip(ref, port)):
        if a != b:
            pytest.fail(f"step {i} ({a[0]} / {b[0]}) differs: "
                        + _first_difference(a, b))
    assert len(ref) == len(port), (len(ref), len(port))
    return port


# ---------------------------------------------------------------------------
# test_basic.py


def sc_singleton_ensemble(t):
    c = t.wrap(t.ns.testing.Cluster(seed=1))
    (pid,) = t.ns.testing.make_peers(1)
    c.create_ensemble("ens", [pid])
    assert c.wait_stable("ens") == pid
    c.kput_ok("ens", "k", b"v1")
    assert c.kget_value("ens", "k") == b"v1"


def sc_basic_three_peers(t):
    c = t.wrap(t.ns.testing.Cluster(seed=2))
    c.create_ensemble("ens", t.ns.testing.make_peers(3))
    leader = c.wait_stable("ens")
    c.kput_ok("ens", "test", b"current")
    assert c.kget_value("ens", "test") == b"current"
    c.suspend_peer("ens", leader)
    c.runtime.run_for(0.1)
    assert c.runtime.run_until(
        lambda: c.leader_id("ens") not in (None, leader), 60.0)
    c.wait_stable("ens")
    assert c.leader_id("ens") != leader
    assert c.kget_value("ens", "test") == b"current"
    c.resume_peer("ens", leader)
    c.runtime.run_for(2.0)
    c.kput_ok("ens", "test", b"updated")
    assert c.kget_value("ens", "test") == b"updated"


def sc_kget_notfound_skips_tombstone(t):
    c = t.wrap(t.ns.testing.Cluster(seed=3))
    c.create_ensemble("ens", t.ns.testing.make_peers(3))
    c.wait_stable("ens")
    r = c.kget("ens", "missing")
    assert r[0] == "ok" and r[1].value is t.ns.types.NOTFOUND


def sc_kput_once_and_update(t):
    c = t.wrap(t.ns.testing.Cluster(seed=4))
    c.create_ensemble("ens", t.ns.testing.make_peers(3))
    c.wait_stable("ens")
    assert c.kput_once("ens", "k", b"a")[0] == "ok"
    assert c.kput_once("ens", "k", b"b") == "failed"
    cur = c.kget("ens", "k")[1]
    assert c.kupdate("ens", "k", cur, b"c")[0] == "ok"
    assert c.kget_value("ens", "k") == b"c"
    assert c.kupdate("ens", "k", cur, b"d") == "failed"


def sc_kmodify_and_delete(t):
    c = t.wrap(t.ns.testing.Cluster(seed=5))
    c.create_ensemble("ens", t.ns.testing.make_peers(3))
    c.wait_stable("ens")
    r = c.kmodify("ens", "ctr", lambda vsn, v: v + 1, 0)
    assert r[0] == "ok" and r[1].value == 1
    r = c.kmodify("ens", "ctr", lambda vsn, v: v + 1, 0)
    assert r[0] == "ok" and r[1].value == 2
    c.kdelete("ens", "ctr")
    got = c.kget("ens", "ctr")
    assert got[0] == "ok" and got[1].value is t.ns.types.NOTFOUND
    c.kput_ok("ens", "d", b"x")
    cur = c.kget("ens", "d")[1]
    assert c.ksafe_delete("ens", "d", cur)[0] == "ok"
    assert c.kget("ens", "d")[1].value is t.ns.types.NOTFOUND


def sc_multi_worker_pool(t):
    cfg = t.ns.config.fast_test_config()
    cfg.peer_workers = 4
    c = t.wrap(t.ns.testing.Cluster(seed=8, config=cfg))
    c.create_ensemble("ens", t.ns.testing.make_peers(3))
    c.wait_stable("ens")
    for i in range(12):
        c.kput_ok("ens", f"k{i}", f"v{i}".encode())
    for i in range(12):
        assert c.kget_value("ens", f"k{i}") == f"v{i}".encode()
    assert c.kput_once("ens", "cas", b"a")[0] == "ok"
    cur = c.kget("ens", "cas")[1]
    assert c.kupdate("ens", "cas", cur, b"b")[0] == "ok"
    assert c.kupdate("ens", "cas", cur, b"c") == "failed"


def sc_forwarded_request_never_bounces(t):
    peerlib = t.ns.peer
    c = t.wrap(t.ns.testing.Cluster(seed=11))
    peers = t.ns.testing.make_peers(3)
    c.create_ensemble("ens", peers)
    leader = c.wait_stable("ens")
    follower = next(p for p in peers if p != leader)
    r = t.step("fwd-leader", peerlib.sync_send_event(
        c.runtime._obj, peerlib.peer_name("ens", leader),
        ("fwd", ("overwrite", "fk", b"fv")), timeout=10.0))
    assert r[0] == "ok", r
    assert c.kget_value("ens", "fk") == b"fv"
    r = t.step("fwd-follower", peerlib.sync_send_event(
        c.runtime._obj, peerlib.peer_name("ens", follower),
        ("fwd", ("overwrite", "fk", b"xx")), timeout=10.0))
    assert r == "nack", r
    assert c.kget_value("ens", "fk") == b"fv"


BASIC = [sc_singleton_ensemble, sc_basic_three_peers,
         sc_kget_notfound_skips_tombstone, sc_kput_once_and_update,
         sc_kmodify_and_delete, sc_multi_worker_pool,
         sc_forwarded_request_never_bounces]


@pytest.mark.parametrize("scenario", BASIC, ids=lambda f: f.__name__[3:])
def test_basic_lockstep(scenario):
    lockstep(scenario)


# ---------------------------------------------------------------------------
# test_expand.py / test_replace_members.py


def sc_expand_1_to_3(t):
    mc = t.wrap(t.ns.testing.ManagedCluster(seed=20))
    mc.ens_start(1)
    assert mc.kput("test", b"test")[0] == "ok"
    assert mc.kget("test")[0] == "ok"
    mc.ens_expand(3)
    mc.wait_stable("root")
    r = mc.kget("test", opts=("read_repair",))
    assert r[0] == "ok" and r[1].value == b"test"
    leader = mc.leader_id("root")
    mc.suspend_peer("root", leader)
    mc.wait_stable("root")

    def readable():
        r = mc.kget("test")
        return r[0] == "ok" and r[1].value == b"test"
    assert mc.runtime.run_until(readable, 60.0, poll=0.2)


def sc_read_repair_populates_new_members(t):
    PeerId = t.ns.types.PeerId
    mc = t.wrap(t.ns.testing.ManagedCluster(seed=21))
    mc.ens_start(1)
    assert mc.kput("rr", b"v")[0] == "ok"
    mc.ens_expand(3)
    mc.wait_stable("root")
    assert mc.kget("rr", opts=("read_repair",))[0] == "ok"
    node = mc.node0

    def repaired():
        mc.runtime.run_for(0.05)
        count = 0
        for i in (2, 3):
            p = mc.peer("root", PeerId(i, node))
            if p is not None and "rr" in p.mod.data and \
                    p.mod.data["rr"].value == b"v":
                count += 1
        return count == 2
    assert mc.runtime.run_until(repaired, 30.0, poll=0.1)


def sc_replace_members_root(t, data_root):
    PeerId = t.ns.types.PeerId
    mc = t.wrap(t.ns.testing.ManagedCluster(seed=22, data_root=data_root))
    mc.ens_start(3)
    node = mc.node0
    assert mc.kput("test", b"test")[0] == "ok"
    assert mc.kget("test")[0] == "ok"
    originals = [PeerId("root", node), PeerId(2, node), PeerId(3, node)]
    replacements = [PeerId(i, node) for i in (4, 5, 6)]
    changes = [("add", m) for m in replacements] + \
              [("del", m) for m in originals]
    assert mc.update_members("root", changes) == "ok"
    mc.wait_members("root", replacements)
    mc.wait_stable("root")

    def failing_get():
        r = mc.kget("test")
        assert not (r[0] == "ok" and r[1].value == b"test")
        return r == ("error", "failed")
    assert mc.runtime.run_until(failing_get, 60.0, poll=0.2)
    mc.wait_members("root", replacements)
    mc.wait_stable("root")
    changes2 = [("add", m) for m in originals] + \
               [("del", m) for m in replacements]
    assert mc.update_members("root", changes2) == "ok"
    mc.wait_members("root", originals)
    mc.wait_stable("root")

    def readable():
        r = mc.kget("test")
        return r[0] == "ok" and r[1].value == b"test"
    assert mc.runtime.run_until(readable, 60.0, poll=0.2)


@pytest.mark.parametrize("scenario", [sc_expand_1_to_3,
                                      sc_read_repair_populates_new_members],
                         ids=lambda f: f.__name__[3:])
def test_expand_lockstep(scenario):
    lockstep(scenario)


def test_replace_members_lockstep(tmp_path):
    """Both packages persist under their own data root; the decoded
    storage tables (not the pickle bytes, which name each package's
    record classes) are compared step by step."""
    roots = iter([str(tmp_path / "ref"), str(tmp_path / "port")])
    lockstep(lambda t: sc_replace_members_root(t, next(roots)))


# ---------------------------------------------------------------------------
# test_lease.py / test_read_tombstone.py / test_leadership_watchers.py


def sc_lease_matrix(t, monkeypatch):
    Peer = t.ns.peer.Peer
    mc = t.wrap(t.ns.testing.ManagedCluster(seed=24))
    mc.ens_start(3)
    assert mc.kput("test", b"test")[0] == "ok"
    assert mc.kget("test")[0] == "ok"
    mc.config.trust_lease = False
    assert mc.kget("test")[0] == "ok"
    orig_check = Peer._check_epoch
    monkeypatch.setattr(Peer, "_check_epoch",
                        lambda self, leader, epoch: False)
    assert mc.kget("test") == ("error", "timeout")
    mc.config.trust_lease = True
    mc.wait_stable("root")

    def fast_path_read():
        mc.wait_stable("root")
        return mc.kget("test")[0] == "ok"
    assert mc.runtime.run_until(fast_path_read, 60.0, poll=0.2)
    assert mc.kget("test")[0] == "ok"
    mc.config.follower_timeout = 1.0
    mc.config.lease_duration = 0.0
    mc.runtime.run_for(1.0)
    assert mc.kget("test")[0] == "error"
    monkeypatch.setattr(Peer, "_check_epoch", orig_check)
    mc.wait_stable("root")

    def quorum_read():
        mc.wait_stable("root")
        return mc.kget("test")[0] == "ok"
    assert mc.runtime.run_until(quorum_read, 60.0, poll=0.2)
    assert mc.kget("test")[0] == "ok"


def test_lease_lockstep(monkeypatch):
    lockstep(sc_lease_matrix, monkeypatch)


def sc_tombstone_avoidance(t):
    PeerId = t.ns.types.PeerId
    mc = t.wrap(t.ns.testing.ManagedCluster(seed=25))
    mc.ens_start(3)
    mc.config.notfound_read_delay = 3.0
    node = mc.node0
    leader = mc.leader_id("root")
    members = [PeerId("root", node), PeerId(2, node), PeerId(3, node)]
    followers = [m for m in members if m != leader]

    def has_tombstone(member, key):
        return key in mc.peer("root", member).mod.data

    r = mc.kget("test")
    assert r[0] == "ok" and r[1].value is t.ns.types.NOTFOUND
    mc.runtime.run_for(1.0)
    assert not any(has_tombstone(m, "test") for m in members)
    mc.config.notfound_read_delay = 0.0
    mc.suspend_peer("root", followers[1])
    r = mc.kget("test2")
    assert r[0] == "ok" and r[1].value is t.ns.types.NOTFOUND
    mc.resume_peer("root", followers[1])

    def tombstoned():
        mc.runtime.run_for(0.05)
        return has_tombstone(leader, "test2") and \
            has_tombstone(followers[0], "test2")
    assert mc.runtime.run_until(tombstoned, 30.0, poll=0.1)


def test_read_tombstone_lockstep():
    lockstep(sc_tombstone_avoidance)


def sc_leadership_watchers(t):
    class Watcher(t.ns.runtime.Actor):
        def __init__(self, runtime, name, node) -> None:
            super().__init__(runtime, name, node)
            self.statuses = []

        def handle(self, msg):
            self.statuses.append(msg)

        def last_status(self):
            return self.statuses[-1][0] if self.statuses else None

    mc = t.wrap(t.ns.testing.ManagedCluster(seed=26))
    mc.ens_start(3)
    node = mc.node0
    rt = mc.runtime._obj
    leader = mc.leader_id("root")
    lname = t.ns.peer.peer_name("root", leader)
    lpeer = mc.peer("root", leader)
    assert len(lpeer.watchers) == 0
    w1 = Watcher(rt, ("watcher", 1), node)
    mc.runtime.post(lname, ("watch_leader_status", w1.name))
    mc.runtime.run_for(0.1)
    assert len(lpeer.watchers) == 1
    assert t.step("w1", w1.last_status()) == "is_leading"
    mc.runtime.post(lname, ("stop_watching", w1.name))
    mc.runtime.run_for(0.1)
    assert len(lpeer.watchers) == 0
    mc.runtime.post(lname, ("watch_leader_status", w1.name))
    mc.runtime.run_for(0.1)
    assert len(lpeer.watchers) == 1
    mc.suspend_peer("root", leader)
    mc.wait_stable("root")
    mc.resume_peer("root", leader)

    def not_leading():
        mc.runtime.run_for(0.05)
        return w1.last_status() == "is_not_leading"
    assert mc.runtime.run_until(not_leading, 60.0, poll=0.1)
    t.step("w1-statuses", w1.statuses)
    w2 = Watcher(rt, ("watcher", 2), node)
    mc.runtime.post(lname, ("watch_leader_status", w2.name))
    mc.runtime.run_for(0.1)
    assert len(lpeer.watchers) == 2
    mc.runtime.stop_actor(w2.name)

    def pruned():
        mc.runtime.run_for(0.05)
        return len(lpeer.watchers) == 1
    assert mc.runtime.run_until(pruned, 60.0, poll=0.1)


def test_leadership_watchers_lockstep():
    lockstep(sc_leadership_watchers)


# ---------------------------------------------------------------------------
# test_backend_down.py / test_drop_write.py


def _helper_backend(ns, down_events):
    class _StoreActor(ns.runtime.Actor):
        def handle(self, msg):
            pass

    class HelperBackend(ns.backend.BasicBackend):
        def __init__(self, ensemble, peer_id, args=()):
            super().__init__(ensemble, peer_id, ())
            runtime, node = args
            self.helper_name = ("store", ensemble, repr(peer_id))
            if runtime.whereis(self.helper_name) is None:
                _StoreActor(runtime, self.helper_name, node)

        def monitored(self):
            return (self.helper_name,)

        def handle_down(self, ref, pid, reason):
            down_events.append((self.peer_id, ref))
            if ref == self.helper_name:
                self.data = {}
                return ("reset",)
            return False

    ns.backend.register_backend("helper", HelperBackend)
    return _StoreActor


def _cluster_with_helpers(t, down_events):
    store = _helper_backend(t.ns, down_events)
    raw = t.ns.testing.Cluster(seed=11)
    c = t.wrap(raw)
    peers = t.ns.testing.make_peers(3)
    c.create_ensemble("demo", peers, backend="helper",
                      backend_args=(raw.runtime, peers[0].node))
    return c, peers, store


def sc_helper_death_resets_leader(t):
    down = []
    c, _peers, _store = _cluster_with_helpers(t, down)
    leader = c.wait_stable("demo")
    c.kput_ok("demo", "k", b"v")
    lp = c.peer("demo", leader)
    c.runtime.stop_actor(lp.mod.helper_name)
    c.runtime.run_for(0.1)
    assert any(pid == leader for pid, _ in down)
    assert lp.fsm_state != "leading"
    c.wait_stable("demo")
    assert c.kget_value("demo", "k") == b"v"
    c.kput_ok("demo", "k", b"v2")
    assert c.kget_value("demo", "k") == b"v2"
    t.step("down", down)


def sc_follower_helper_death(t):
    down = []
    c, peers, _store = _cluster_with_helpers(t, down)
    leader = c.wait_stable("demo")
    c.kput_ok("demo", "k", b"v")
    follower = next(p for p in peers if p != leader)
    c.runtime.stop_actor(c.peer("demo", follower).mod.helper_name)
    c.runtime.run_for(0.1)
    assert any(pid == follower for pid, _ in down)
    assert c.leader_id("demo") == leader
    assert c.kget_value("demo", "k") == b"v"
    t.step("down", down)


def sc_unrelated_down_is_ignored(t):
    down = []
    c, peers, store = _cluster_with_helpers(t, down)
    leader = c.wait_stable("demo")
    lp = c.peer("demo", leader)
    other = ("store", "demo", "unrelated")
    store(c.runtime._obj, other, peers[0].node)
    lp.monitor_backend(other)
    c.runtime.stop_actor(other)
    c.runtime.run_for(0.1)
    assert any(ref == other for _, ref in down)
    assert lp.fsm_state == "leading"
    assert c.leader_id("demo") == leader
    t.step("down", down)


def sc_peer_stop_releases_monitors(t):
    down = []
    c, peers, _store = _cluster_with_helpers(t, down)
    c.wait_stable("demo")
    victim = peers[0]
    helper = c.peer("demo", victim).mod.helper_name
    rt = c.runtime._obj
    assert len(rt._monitors.get(helper, [])) == 1
    c.runtime.stop_actor(t.ns.peer.peer_name("demo", victim))
    c.runtime.run_for(0.5)
    assert c.runtime.whereis(helper) is not None
    assert len(rt._monitors.get(helper, [])) == 0


@pytest.mark.parametrize("scenario", [
    sc_helper_death_resets_leader, sc_follower_helper_death,
    sc_unrelated_down_is_ignored, sc_peer_stop_releases_monitors],
    ids=lambda f: f.__name__[3:])
def test_backend_down_lockstep(scenario):
    lockstep(scenario)


def sc_drop_write_healed_by_read(t, monkeypatch):
    backendlib = t.ns.backend
    orig_put = backendlib.BasicBackend.put

    def drop_put(self, key, obj, from_):
        if isinstance(key, str) and key.startswith("drop") and \
                self.peer_id.name != "root":
            backendlib.reply(from_, obj)  # ack without storing
        else:
            orig_put(self, key, obj, from_)

    monkeypatch.setattr(backendlib.BasicBackend, "put", drop_put)
    mc = t.wrap(t.ns.testing.ManagedCluster(seed=23))
    mc.ens_start(5)
    leader = mc.leader_id("root")
    assert mc.kput("drop", b"test")[0] == "ok"
    assert mc.kget("drop")[0] == "ok"
    mc.suspend_peer("root", leader)
    mc.wait_stable("root")
    mc.resume_peer("root", leader)
    mc.read_until("drop")


def test_drop_write_lockstep(monkeypatch):
    lockstep(sc_drop_write_healed_by_read, monkeypatch)


# ---------------------------------------------------------------------------
# the harness itself


def test_lockstep_sees_a_divergence():
    """A scenario that behaves differently in the two packages fails the
    lockstep at the first differing step."""
    def skewed(t):
        c = t.wrap(t.ns.testing.Cluster(seed=2))
        c.create_ensemble("ens", t.ns.testing.make_peers(3))
        c.wait_stable("ens")
        c.kput_ok("ens", "k", b"ref" if t.ns is REF else b"port")

    with pytest.raises(pytest.fail.Exception, match="kput_ok"):
        lockstep(skewed)
