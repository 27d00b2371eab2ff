"""Per-node cluster manager: gossip, reconciliation, peer supervision.

Copied from ``riak_ensemble_tpu/manager.py`` with its imports pointed at
this package, so the port imports nothing of the JAX package.

Re-implementation of ``src/riak_ensemble_manager.erl`` (749 LoC) as one
actor per virtual node, folding in the peer-supervisor role
(``riak_ensemble_peer_sup.erl``) since peers here are actors rather
than supervised OS processes.

Responsibilities mirrored from the reference:

- Owns the node's :class:`~riak_ensemble_tpu_torch.state.ClusterState` and a
  read cache of per-ensemble ``(leader, (vsn, views), pending)`` data —
  the ETS table the hot paths read (manager.erl:188-245).  The
  :class:`~riak_ensemble_tpu_torch.directory.Directory` interface peers and
  routers use IS this cache.
- Cluster activation: ``enable`` creates the root ensemble with a
  single local peer and enables the state (activate,
  manager.erl:498-516).
- Join/remove forward to the root ensemble: join pulls the remote
  cluster state first and adopts it if ``join_allowed``
  (manager.erl:311-334,518-532); the consensus write happens via a
  root kmodify on the *remote* cluster (riak_ensemble_root:join).
- Gossip: every 2s tick sends the full cluster state to <=10 random
  other members and requests wanted-but-unknown remote peer addresses
  (tick/send_gossip/request_remote_peers, manager.erl:569-587,643-666);
  inbound gossip merges newest-vsn-wins (merge_gossip, :589-596).
- Reconciliation: any state change diffs wanted-vs-running local peers
  and starts/stops them, gated on the backend's ``ready_to_start``
  (state_changed/check_peers, manager.erl:610-641,697-715).
- Persistence through the coalescing storage manager under the
  ``manager`` key; saves skipped when unchanged (maybe_save_state,
  manager.erl:601-608,534-567).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from riak_ensemble_tpu_torch import state as statelib
from riak_ensemble_tpu_torch.backend import BACKENDS
from riak_ensemble_tpu_torch.config import Config
from riak_ensemble_tpu_torch.directory import Directory
from riak_ensemble_tpu_torch.peer import Peer, peer_name
from riak_ensemble_tpu_torch.router import start_routers
from riak_ensemble_tpu_torch.runtime import Actor, Future, Runtime, Timer
from riak_ensemble_tpu_torch.state import ClusterState
from riak_ensemble_tpu_torch.storage import Storage
from riak_ensemble_tpu_torch.types import EnsembleInfo, PeerId, Views, Vsn

ROOT = "root"

#: manager.erl:569-573 — gossip/reconcile tick period (seconds).
TICK = 2.0
#: manager.erl:581-587 — gossip fan-out bound per tick.
GOSSIP_FANOUT = 10


def manager_name(node: str) -> Tuple:
    return ("manager", node)


class Manager(Actor, Directory):
    def __init__(self, runtime: Runtime, node: str, config: Config,
                 storage: Storage, **peer_kw) -> None:
        super().__init__(runtime, manager_name(node), node)
        self.config = config
        self.storage = storage
        self.peer_kw = peer_kw  # plumbed into started peers (tests)

        #: ens -> (leader, (vsn, views), pending | None) — the ETS cache
        self.ensemble_data: Dict[Any, Tuple] = {}
        #: (ensemble, peer_id) -> actor name, learned via pid exchange
        self.remote_peers: Dict[Tuple[Any, PeerId], Any] = {}
        #: local running peers, the peer_sup registry
        self.local_peers: Dict[Tuple[Any, PeerId], Peer] = {}
        self._pending_calls: Dict[int, Future] = {}
        self._next_ref = 0

        start_routers(runtime, node)
        self.cluster_state = self._reload_state()
        self._tick_timer: Timer = self.send_after(TICK, ("tick",))
        # deferred initial reconciliation (gen_server:cast(self(), init))
        self.runtime.post(self.name, ("init",))

    # ------------------------------------------------------------------
    # Directory interface (the ETS read API, manager.erl:188-245)

    def enabled(self) -> bool:
        return self.cluster_state.enabled

    def get_cluster_state(self) -> ClusterState:
        return self.cluster_state

    def get_leader(self, ensemble) -> Optional[PeerId]:
        data = self.ensemble_data.get(ensemble)
        return data[0] if data else None

    def get_views(self, ensemble) -> Optional[Tuple[Vsn, Views]]:
        data = self.ensemble_data.get(ensemble)
        return data[1] if data else None

    def get_pending(self, ensemble) -> Optional[Tuple[Vsn, Views]]:
        data = self.ensemble_data.get(ensemble)
        return data[2] if data else None

    def get_members(self, ensemble) -> Tuple[PeerId, ...]:
        views = self.get_views(ensemble)
        if not views:
            return ()
        from riak_ensemble_tpu_torch.types import members_of
        return members_of(views[1])

    def cluster(self) -> List[str]:
        return sorted(self.cluster_state.members)

    def get_peer_addr(self, ensemble, peer_id: PeerId):
        if peer_id.node == self.node:
            name = peer_name(ensemble, peer_id)
            return name if self.runtime.whereis(name) is not None else None
        return self.remote_peers.get((ensemble, peer_id))

    def known_ensembles(self) -> Dict[Any, EnsembleInfo]:
        return dict(self.cluster_state.ensembles)

    # -- write-side Directory hooks called by local peers --------------

    def update_ensemble(self, ensemble, peer_id, views, vsn) -> None:
        """Leader pushes committed views (async singleton in the
        reference, peer.erl:1186-1197 → manager.erl:273-279)."""
        self.runtime.post(self.name,
                          ("update_ensemble", ensemble, peer_id,
                           tuple(tuple(v) for v in views), vsn))

    def gossip_pending(self, ensemble, vsn, views) -> None:
        self.runtime.post(self.name,
                          ("gossip_pending", ensemble, vsn,
                           tuple(tuple(v) for v in views)))

    def root_gossip(self, peer, vsn, peer_id, views) -> None:
        """Root leader pushes its views via a kmodify cast to itself
        (riak_ensemble_root:gossip/4 → root_cast {gossip,..})."""
        from riak_ensemble_tpu_torch import root as rootlib
        rootlib.gossip(self, peer, vsn, peer_id, views)

    def stop_peer(self, ensemble, peer_id) -> None:
        self._stop_peer((ensemble, peer_id))

    # ------------------------------------------------------------------
    # public ops (drive from tests/clients; sync ones via mgr_call)

    def enable(self) -> str:
        """Synchronous within the node (manager.erl:296-310)."""
        cs = self.cluster_state
        if cs.enabled:
            return "error"
        root_leader = PeerId(ROOT, self.node)
        info = EnsembleInfo(vsn=(0, 0), leader=root_leader,
                            views=((root_leader,),), seq=(0, 0),
                            mod="basic", args=())
        cs2 = statelib.enable(cs)
        cs2 = statelib.add_member((0, 0), self.node, cs2)
        cs2 = statelib.set_ensemble(ROOT, info, cs2)
        assert cs2 is not None
        self._save_state(cs2)
        self.storage.sync()
        self._state_changed()
        return "ok"

    def join_async(self, other_node: str, timeout: float = 60.0) -> Future:
        """This node joins other_node's cluster (manager.erl:311-334)."""
        fut = Future()
        self.runtime.post(self.name, ("join", other_node, timeout, fut))
        return fut

    def remove_async(self, target_node: str, timeout: float = 60.0
                     ) -> Future:
        fut = Future()
        self.runtime.post(self.name, ("remove", target_node, timeout, fut))
        return fut

    def create_ensemble(self, ensemble, leader: Optional[PeerId],
                        members, mod: str = "basic", args: Tuple = (),
                        timeout: float = 10.0) -> Future:
        """manager.erl:157-166 → root:set_ensemble."""
        from riak_ensemble_tpu_torch import root as rootlib
        info = EnsembleInfo(vsn=(0, 0), leader=leader,
                            views=(tuple(members),), seq=(0, 0),
                            mod=mod, args=tuple(args))
        return rootlib.set_ensemble(self, ensemble, info, timeout)

    def check_quorum(self, ensemble, timeout: float = 5.0) -> Future:
        """manager.erl:252-258 — resolves True iff the leader can
        commit against a quorum right now."""
        from riak_ensemble_tpu_torch import router as routerlib
        out = Future()
        fut = routerlib.sync_send_event_fut(self.runtime, self.node,
                                            ensemble, ("check_quorum",),
                                            timeout)
        fut.add_waiter(lambda r: out.resolve(r == "ok"))
        return out

    def count_quorum(self, ensemble, timeout: float = 5.0) -> Future:
        """manager.erl:260-267 — resolves to the number of reachable
        quorum members (0 on timeout)."""
        from riak_ensemble_tpu_torch import router as routerlib
        out = Future()
        fut = routerlib.sync_send_event_fut(self.runtime, self.node,
                                            ensemble, ("ping_quorum",),
                                            timeout)

        def done(r):
            if isinstance(r, tuple) and len(r) == 3:
                out.resolve(len(r[2]))
            else:
                out.resolve(0)

        fut.add_waiter(done)
        return out

    def get_leader_addr(self, ensemble):
        """get_leader_pid analog (manager.erl:112-119)."""
        leader = self.get_leader(ensemble)
        if leader is None:
            return None
        return self.get_peer_addr(ensemble, leader)

    # ------------------------------------------------------------------
    # actor event loop

    def handle(self, msg: Tuple) -> None:
        kind = msg[0]
        if kind == "tick":
            self._tick()
        elif kind == "init":
            self._state_changed()
        elif kind == "gossip":
            self._merge_gossip(msg[1])
        elif kind == "gossip_pending":
            _, ensemble, vsn, views = msg
            cs = statelib.set_pending(vsn, ensemble, views,
                                      self.cluster_state)
            if cs is not None:
                self._save_state(cs)
                self._state_changed()
        elif kind == "update_ensemble":
            _, ensemble, leader, views, vsn = msg
            cs = statelib.update_ensemble(vsn, ensemble, leader, views,
                                          self.cluster_state)
            if cs is not None:
                self._save_state(cs)
                self._state_changed()
        elif kind == "join":
            _, other_node, timeout, fut = msg
            self.runtime.spawn_task(self._do_join(other_node, timeout, fut),
                                    name=f"join:{self.node}")
        elif kind == "remove":
            _, target, timeout, fut = msg
            from riak_ensemble_tpu_torch import root as rootlib
            if target not in self.cluster_state.members:
                fut.resolve(("error", "not_member"))
            else:
                rootlib.remove(self, target, timeout).add_waiter(
                    lambda r: self._after_root_op(r, fut))
        elif kind == "mgr_rcall":
            _, from_, request = msg
            self._handle_rcall(from_, request)
        elif kind == "mgr_reply":
            _, ref, result = msg
            fut = self._pending_calls.pop(ref, None)
            if fut is not None:
                fut.resolve(result)
        elif kind == "peer_pid":
            _, key, addr = msg
            self.remote_peers[key] = addr
        elif kind == "request_peer_pid":
            _, from_name, key = msg
            ensemble, peer_id = key
            if peer_id.node == self.node:
                addr = self.get_peer_addr(ensemble, peer_id)
                if addr is not None:
                    self.send(from_name, ("peer_pid", key, addr))

    def _after_root_op(self, result, fut: Future) -> None:
        self._state_changed()
        fut.resolve(result)

    # -- cross-node manager calls --------------------------------------

    def _call_remote(self, node: str, request: Tuple,
                     timeout: float) -> Future:
        self._next_ref += 1
        ref = self._next_ref
        fut = Future()
        self._pending_calls[ref] = fut
        self.send(manager_name(node), ("mgr_rcall", (self.name, ref),
                                       request))
        out = self.runtime.with_timeout(fut, timeout)
        out.add_waiter(lambda _v: self._pending_calls.pop(ref, None))
        return out

    def _handle_rcall(self, from_: Tuple, request: Tuple) -> None:
        owner, ref = from_
        if request[0] == "get_cluster_state":
            self.send(owner, ("mgr_reply", ref, ("ok", self.cluster_state)))
        else:
            self.send(owner, ("mgr_reply", ref, ("error", "bad_call")))

    def _do_join(self, other_node: str, timeout: float, fut: Future):
        """Task: pull remote CS, validate, adopt, then root join
        (manager.erl:311-334)."""
        from riak_ensemble_tpu_torch import root as rootlib
        if other_node == self.node:
            fut.resolve(("error", "same_node"))
            return
        reply = yield self._call_remote(other_node, ("get_cluster_state",),
                                        min(timeout, 60.0))
        if not (isinstance(reply, tuple) and reply[0] == "ok"):
            fut.resolve(("error", "timeout"))
            return
        remote_cs: ClusterState = reply[1]
        allowed = self._join_allowed(self.cluster_state, remote_cs)
        if allowed is not True:
            fut.resolve(("error", allowed))
            return
        self._save_state(remote_cs)
        self._state_changed()
        result = yield rootlib.join(self, other_node, self.node, timeout)
        self._state_changed()
        fut.resolve(result)

    @staticmethod
    def _join_allowed(local_cs: ClusterState, remote_cs: ClusterState):
        """manager.erl:518-532."""
        if not remote_cs.enabled:
            return "remote_not_enabled"
        if local_cs.enabled and local_cs.id != remote_cs.id:
            return "already_enabled"
        return True

    # ------------------------------------------------------------------
    # gossip + reconciliation

    def _tick(self) -> None:
        self._request_remote_peers()
        self._send_gossip()
        self._tick_timer = self.send_after(TICK, ("tick",))

    def _send_gossip(self) -> None:
        cs = self.cluster_state
        others = [n for n in cs.members if n != self.node]
        self.runtime.rng.shuffle(others)
        for node in others[:GOSSIP_FANOUT]:
            self.send(manager_name(node), ("gossip", cs))

    def _merge_gossip(self, other_cs: ClusterState) -> None:
        merged = statelib.merge(self.cluster_state, other_cs)
        self._save_state(merged)
        self._state_changed()

    def _request_remote_peers(self) -> None:
        """manager.erl:643-666: ask peers' home nodes for addresses of
        wanted-but-unknown remote peers (incl. the root leader)."""
        wanted = set(self._wanted_remote_peers())
        rl = self.get_leader(ROOT)
        if rl is not None and rl.node != self.node:
            wanted.add((ROOT, rl))
        for key in wanted:
            if key in self.remote_peers:
                continue
            ensemble, peer_id = key
            self.send(manager_name(peer_id.node),
                      ("request_peer_pid", self.name, key))

    def _wanted_remote_peers(self) -> List[Tuple[Any, PeerId]]:
        """manager.erl:657-666: for each ensemble with a local member,
        every non-local member's address is wanted."""
        cs = self.cluster_state
        out = []
        for ensemble, info in cs.ensembles.items():
            members = self._all_members(ensemble, info.views)
            if not any(p.node == self.node for p in members):
                continue
            out.extend((ensemble, p) for p in members
                       if p.node != self.node)
        return out

    def _all_members(self, ensemble, views) -> Tuple[PeerId, ...]:
        """compute_all_members (manager.erl:605-614): pending views
        count — peers must exist before a membership change lands."""
        pending = self.cluster_state.pending.get(ensemble)
        all_views = list(pending[1]) + list(views) if pending else views
        seen: Dict[PeerId, None] = {}
        for view in all_views:
            for p in view:
                seen[p] = None
        return tuple(seen)

    # -- persistence ----------------------------------------------------

    def _reload_state(self) -> ClusterState:
        saved = self.storage.get("manager")
        if isinstance(saved, ClusterState):
            return saved
        cluster_id = (self.node, self.runtime.rng.random())
        return statelib.new_state(cluster_id)

    def _save_state(self, cs: ClusterState) -> None:
        if cs != self.cluster_state:
            # Intentionally no sync (manager.erl:557-567).
            self.storage.put("manager", cs)
        self.cluster_state = cs

    # -- state_changed (manager.erl:610-641) ----------------------------

    def _state_changed(self) -> None:
        cs = self.cluster_state
        self.ensemble_data = {
            ens: (info.leader, (info.vsn, info.views),
                  cs.pending.get(ens))
            for ens, info in cs.ensembles.items()
        }
        # check_peers: start wanted-but-missing, stop running-but-unwanted
        wanted = self._wanted_peers()
        running = set(self.local_peers)
        for key in running - set(wanted):
            self._stop_peer(key)
        for key, info in wanted.items():
            if key in running:
                continue
            self._start_peer(key, info)
        # prune dead local registrations
        for key in list(self.local_peers):
            name = peer_name(*key)
            if self.runtime.whereis(name) is None:
                del self.local_peers[key]

    def _wanted_peers(self) -> Dict[Tuple[Any, PeerId], EnsembleInfo]:
        """manager.erl:725-737."""
        cs = self.cluster_state
        out = {}
        for ensemble, info in cs.ensembles.items():
            for p in self._all_members(ensemble, info.views):
                if p.node == self.node:
                    out[(ensemble, p)] = info
        return out

    def _start_peer(self, key: Tuple[Any, PeerId],
                    info: EnsembleInfo) -> None:
        ensemble, peer_id = key
        backend_cls = BACKENDS[info.mod]
        args = tuple(info.args)
        if not args and info.mod == "basic" and self.storage.path:
            # The reference's basic backend derives its save file from
            # the app-env data_root (basic_backend.erl:102-111); mirror
            # that off the node's storage root so peer data survives
            # stop/start cycles (membership removal + re-add).
            import os
            args = (os.path.dirname(os.path.dirname(self.storage.path)),)
        info = __import__("dataclasses").replace(info, args=args)
        probe = backend_cls(ensemble, peer_id, args)
        if not probe.ready_to_start():
            return
        if self.runtime.whereis(peer_name(ensemble, peer_id)) is not None:
            return
        peer = Peer(self.runtime, ensemble, peer_id, self.config, self,
                    self.storage, backend=info.mod,
                    backend_args=tuple(info.args), **self.peer_kw)
        self.local_peers[key] = peer

    def _stop_peer(self, key: Tuple[Any, PeerId]) -> None:
        self.local_peers.pop(key, None)
        ensemble, peer_id = key
        name = peer_name(ensemble, peer_id)
        if self.runtime.whereis(name) is not None:
            self.runtime.stop_actor(name)

    def on_stop(self) -> None:
        self._tick_timer.cancel()
