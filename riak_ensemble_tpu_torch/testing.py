"""Integration-test harness: multi-peer ensembles in one host process.

Copied from ``riak_ensemble_tpu/testing.py`` with its imports pointed at
this package, so the port imports nothing of the JAX package.

The reference's central test trick (``test/ens_test.erl:31-45``) is to
run a whole ensemble on ONE Erlang node — peers are just processes.
Here peers are actors in one deterministic virtual-time runtime, so a
multi-second protocol timeline (election, lease expiry, failover) runs
in milliseconds and is reproducible from the seed.

Fault-injection surface (SURVEY §4 parity):
- ``suspend_peer``/``resume_peer``: erlang:suspend_process analog
  (test/basic_test.erl:15-21).
- ``runtime.net.drop_hook`` / ``partition``: message dropping
  (riak_ensemble_msg maybe_drop; sc.erl partitions).
- backend subclasses dropping puts; tree corruption via
  ``tree_of(...).tree.corrupt(...)`` (synctree intercepts).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from riak_ensemble_tpu_torch import peer as peerlib
from riak_ensemble_tpu_torch.config import Config, fast_test_config
from riak_ensemble_tpu_torch.directory import StaticDirectory
from riak_ensemble_tpu_torch.peer import (
    Peer, do_kmodify, do_kput_once, do_kupdate, peer_name, sync_send_event,
)
from riak_ensemble_tpu_torch.runtime import Runtime
from riak_ensemble_tpu_torch.storage import Storage
from riak_ensemble_tpu_torch.types import NOTFOUND, Obj, PeerId


class Cluster:
    def __init__(self, seed: int = 0, config: Optional[Config] = None,
                 data_root: Optional[str] = None) -> None:
        self.runtime = Runtime(seed)
        self.config = config if config is not None else fast_test_config()
        self.directory = StaticDirectory(self.runtime)
        self.data_root = data_root
        self.storages: Dict[str, Storage] = {}

    def storage(self, node: str) -> Storage:
        if node not in self.storages:
            root = (f"{self.data_root}/{node}" if self.data_root else None)
            self.storages[node] = Storage(self.runtime, node, self.config,
                                          root)
        return self.storages[node]

    # -- ensemble lifecycle ------------------------------------------------

    def create_ensemble(self, ensemble: Any, peer_ids: Sequence[PeerId],
                        backend: str = "basic", **peer_kw) -> List[Peer]:
        views = (tuple(peer_ids),)
        peers = []
        for pid in peer_ids:
            peers.append(self.start_peer(ensemble, pid, views, backend,
                                         **peer_kw))
        return peers

    def start_peer(self, ensemble, pid: PeerId, views=None,
                   backend: str = "basic", **peer_kw) -> Peer:
        p = Peer(self.runtime, ensemble, pid, self.config, self.directory,
                 self.storage(pid.node), backend=backend,
                 initial_views=views, **peer_kw)
        self.directory.register_peer(ensemble, pid, p.name)
        return p

    def peer(self, ensemble, pid: PeerId) -> Optional[Peer]:
        return self.runtime.whereis(peer_name(ensemble, pid))

    def tree_of(self, ensemble, pid: PeerId):
        return self.runtime.whereis(peerlib.tree_name(ensemble, pid))

    # -- convergence -------------------------------------------------------

    def leader_id(self, ensemble) -> Optional[PeerId]:
        """The live leader: a non-suspended peer in `leading` state.
        (A suspended ex-leader is still frozen in `leading`; among
        multiple claimants the highest epoch is the real one.)"""
        best = None
        for actor in list(self.runtime.actors.values()):
            if isinstance(actor, Peer) and actor.ensemble == ensemble \
                    and actor.fsm_state == "leading" \
                    and not actor.suspended:
                if best is None or actor.epoch > best.epoch:
                    best = actor
        return best.id if best else None

    def leader(self, ensemble) -> Optional[Peer]:
        lid = self.leader_id(ensemble)
        return self.peer(ensemble, lid) if lid else None

    def wait_leader(self, ensemble, max_time: float = 60.0) -> PeerId:
        ok = self.runtime.run_until(
            lambda: self.leader_id(ensemble) is not None, max_time)
        assert ok, f"no leader for {ensemble} in {max_time}s virtual"
        return self.leader_id(ensemble)

    def wait_stable(self, ensemble, max_time: float = 60.0) -> PeerId:
        """ens_test:wait_stable (ens_test.erl:47-66): poll until a
        leader exists, its tree is ready, and check_quorum succeeds
        (retried — a stale claimant mid-step-down may answer first)."""
        deadline = self.runtime.now + max_time
        while self.runtime.now < deadline:
            ldr = self.leader(ensemble)
            if ldr is None or not ldr.tree_ready:
                self.runtime.run_for(0.05)
                continue
            if self.check_quorum(ensemble) == "ok":
                lid = self.leader_id(ensemble)
                if lid is not None:
                    return lid
            self.runtime.run_for(0.05)
        raise AssertionError(f"{ensemble} not stable in {max_time}s virtual")

    def check_quorum(self, ensemble, timeout: float = 10.0):
        lid = self.leader_id(ensemble)
        if lid is None:
            return "timeout"
        return sync_send_event(self.runtime, peer_name(ensemble, lid),
                               ("check_quorum",), timeout)

    # -- fault injection ---------------------------------------------------

    def suspend_peer(self, ensemble, pid: PeerId) -> None:
        self.runtime.suspend(peer_name(ensemble, pid))

    def resume_peer(self, ensemble, pid: PeerId) -> None:
        self.runtime.resume(peer_name(ensemble, pid))

    # -- K/V surface (client-level ops against an ensemble) ---------------

    def _target(self, ensemble):
        lid = self.leader_id(ensemble) or self.directory.get_leader(ensemble)
        assert lid is not None, "no known leader"
        return peer_name(ensemble, lid)

    def kget(self, ensemble, key, timeout: float = 10.0, opts=()):
        return sync_send_event(self.runtime, self._target(ensemble),
                               ("get", key, tuple(opts)), timeout)

    def kover(self, ensemble, key, value, timeout: float = 10.0):
        return sync_send_event(self.runtime, self._target(ensemble),
                               ("overwrite", key, value), timeout)

    def kput_once(self, ensemble, key, value, timeout: float = 10.0):
        return sync_send_event(self.runtime, self._target(ensemble),
                               ("put", key, do_kput_once, [value]), timeout)

    def kupdate(self, ensemble, key, current: Obj, new, timeout=10.0):
        return sync_send_event(self.runtime, self._target(ensemble),
                               ("put", key, do_kupdate, [current, new]),
                               timeout)

    def kmodify(self, ensemble, key, mod_fun, default, timeout=10.0):
        return sync_send_event(self.runtime, self._target(ensemble),
                               ("put", key, do_kmodify, [mod_fun, default]),
                               timeout)

    def kdelete(self, ensemble, key, timeout: float = 10.0):
        return self.kover(ensemble, key, NOTFOUND, timeout)

    def ksafe_delete(self, ensemble, key, current: Obj, timeout=10.0):
        return self.kupdate(ensemble, key, current, NOTFOUND, timeout)

    def update_members(self, ensemble, changes, timeout: float = 20.0):
        return sync_send_event(self.runtime, self._target(ensemble),
                               ("update_members", tuple(changes)), timeout)

    # -- assertion helpers -------------------------------------------------

    def kput_ok(self, ensemble, key, value):
        result = self.kover(ensemble, key, value)
        assert isinstance(result, tuple) and result[0] == "ok", result
        return result[1]

    def kget_value(self, ensemble, key):
        result = self.kget(ensemble, key)
        assert isinstance(result, tuple) and result[0] == "ok", result
        return result[1].value

    def read_until(self, ensemble, key, expect, max_time: float = 30.0):
        """drop_write_test's read_until: retry reads until the expected
        value is visible (healed)."""
        def check():
            r = self.kget(ensemble, key)
            return isinstance(r, tuple) and r[0] == "ok" and \
                r[1].value == expect
        ok = self.runtime.run_until(check, max_time, poll=0.1)
        assert ok, f"value {expect!r} for {key!r} not visible"


def make_peers(n: int, n_nodes: Optional[int] = None) -> List[PeerId]:
    """Peer ids spread over nodes (node per peer by default)."""
    n_nodes = n_nodes if n_nodes is not None else n
    return [PeerId(i, f"node{i % n_nodes}") for i in range(n)]


class ManagedCluster:
    """Full-stack harness: per-node Manager + routers + storage, the
    root ensemble, gossip, and the client API — the analog of a real
    multi-node deployment of the reference app, driven in one
    deterministic virtual-time runtime.

    Typical bring-up (mirrors the riak_ensemble README sequence):
    ``enable(node0)`` → ``join(node1, node0)`` → expand the root
    ensemble's members → ``create_ensemble(...)`` → client K/V ops.
    """

    def __init__(self, seed: int = 0, nodes: Sequence[str] = ("node0",),
                 config: Optional[Config] = None,
                 data_root: Optional[str] = None, **peer_kw) -> None:
        from riak_ensemble_tpu_torch.manager import Manager

        self.runtime = Runtime(seed)
        self.config = config if config is not None else fast_test_config()
        self.data_root = data_root
        self.peer_kw = peer_kw
        self.managers: Dict[str, Manager] = {}
        self.storages: Dict[str, Storage] = {}
        for node in nodes:
            self.add_node(node)

    def add_node(self, node: str):
        from riak_ensemble_tpu_torch.manager import Manager

        root = (f"{self.data_root}/{node}" if self.data_root else None)
        storage = Storage(self.runtime, node, self.config, root)
        self.storages[node] = storage
        mgr = Manager(self.runtime, node, self.config, storage,
                      **self.peer_kw)
        self.managers[node] = mgr
        return mgr

    def mgr(self, node: str):
        return self.managers[node]

    def client(self, node: str):
        from riak_ensemble_tpu_torch.client import Client

        return Client(self.runtime, node)

    # -- cluster lifecycle ----------------------------------------------

    def enable(self, node: str) -> None:
        assert self.mgr(node).enable() == "ok"
        self.wait_stable("root")

    def join(self, joining: str, existing: str, timeout: float = 60.0):
        fut = self.mgr(joining).join_async(existing, timeout)
        result = self.runtime.await_future(fut, timeout=timeout + 5.0)
        assert result == "ok", f"join failed: {result!r}"
        # converged when every enabled manager lists the new member
        ok = self.runtime.run_until(
            lambda: all(joining in m.cluster_state.members
                        for m in self.managers.values()
                        if m.cluster_state.enabled), 60.0, poll=0.1)
        assert ok, "join did not converge via gossip"
        return result

    def remove(self, from_node: str, target: str, timeout: float = 60.0):
        fut = self.mgr(from_node).remove_async(target, timeout)
        result = self.runtime.await_future(fut, timeout=timeout + 5.0)
        assert result == "ok", f"remove failed: {result!r}"
        return result

    def create_ensemble(self, ensemble, peer_ids: Sequence[PeerId],
                        mod: str = "basic", args=(),
                        timeout: float = 30.0) -> None:
        leader = peer_ids[0]
        fut = self.mgr(leader.node).create_ensemble(
            ensemble, leader, list(peer_ids), mod, args, timeout)
        result = self.runtime.await_future(fut, timeout=timeout + 5.0)
        assert result == "ok", f"create_ensemble failed: {result!r}"
        # Wait until every hosting node has started its peers.
        wanted = {(p.node, ensemble) for p in peer_ids}

        def started():
            return all(
                any(k[0] == ensemble for k in self.managers[n].local_peers)
                for n, _ in wanted)
        ok = self.runtime.run_until(started, 60.0, poll=0.1)
        assert ok, f"peers for {ensemble} not started via gossip"

    def update_members(self, ensemble, changes, timeout: float = 30.0):
        """ens_test:expand analog — update_members on the leader."""
        lid = self.wait_leader(ensemble)
        return sync_send_event(self.runtime, peer_name(ensemble, lid),
                               ("update_members", tuple(changes)), timeout)

    # -- ens_test.erl-style single-node harness (ens_test.erl:24-45) -----

    @property
    def node0(self) -> str:
        return next(iter(self.managers))

    def ens_start(self, n: int = 1) -> None:
        """ens_test:start/0,1 — enable on one node, expand the root
        ensemble to n peers (all hosted on that node: the reference's
        central multi-peer-without-multi-node trick)."""
        self.enable(self.node0)
        if n > 1:
            self.ens_expand(n)

    def ens_expand(self, n: int) -> None:
        """ens_test:expand/1 — root grows by peers {2..n, node0}."""
        adds = [("add", PeerId(i, self.node0)) for i in range(2, n + 1)]
        r = self.update_members("root", adds)
        assert r == "ok", r
        expected = [PeerId("root", self.node0)] + \
            [PeerId(i, self.node0) for i in range(2, n + 1)]
        self.wait_members("root", expected)
        self.wait_stable("root")

    def wait_members(self, ensemble, expected, max_time: float = 60.0):
        """ens_test:wait_members — manager view includes expected."""
        def ok():
            members = self.mgr(self.node0).get_members(ensemble)
            return all(p in members for p in expected)
        assert self.runtime.run_until(ok, max_time, poll=0.1), \
            f"members of {ensemble} never reached {expected}"

    def kput(self, key, value, timeout: float = 5.0):
        return self.client(self.node0).kover("root", key, value, timeout)

    def kget(self, key, timeout: float = 5.0, opts=()):
        return self.client(self.node0).kget("root", key, timeout, opts)

    def read_until(self, key, max_time: float = 60.0):
        """ens_test:read_until — retry until a non-notfound value is
        readable; a successful read must never return notfound."""
        c = self.client(self.node0)

        def check():
            r = c.kget("root", key, timeout=5.0)
            if r[0] == "ok":
                assert r[1].value is not NOTFOUND, \
                    "read_until saw a notfound object (data loss)"
                return True
            return False
        assert self.runtime.run_until(check, max_time, poll=0.1), \
            f"key {key!r} never became readable"

    # -- introspection (shared logic with Cluster) -----------------------

    leader_id = Cluster.leader_id
    leader = Cluster.leader
    peer = Cluster.peer
    tree_of = Cluster.tree_of
    wait_leader = Cluster.wait_leader
    wait_stable = Cluster.wait_stable
    check_quorum = Cluster.check_quorum
    suspend_peer = Cluster.suspend_peer
    resume_peer = Cluster.resume_peer
