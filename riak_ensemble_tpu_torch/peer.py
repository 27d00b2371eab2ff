"""The consensus core: per-peer Multi-Paxos state machine + K/V FSMs.

Copied from ``riak_ensemble_tpu/peer.py`` with its imports pointed at
this package, so the port imports nothing of the JAX package.

Host-runtime re-implementation of ``src/riak_ensemble_peer.erl`` (the
reference's 2242-line gen_fsm).  States: setup, probe, pending,
election, prefollow, prepare, prelead, leading, following, repair,
exchange (peer.erl:34-39).  The batched TPU engine
(:mod:`riak_ensemble_tpu_torch.ops.engine`) lifts the ballot/commit
bookkeeping of thousands of these FSMs onto ``[E, M]`` device arrays;
this scalar version is the semantics oracle and the host/slow path.

Key mechanics mirrored from the reference:

- Leader election: probe (fact discovery, :360-377) → election
  (randomized timeout, :493-505) → prepare (phase-1 ballot, epoch+1,
  :579-596) → prelead (phase-2 new_epoch, :609-620) → leading.
  Followers: prefollow (:540-568) → following (:794-836).
- Commits replicate the #fact{} to a quorum (try_commit, :776-788;
  local_commit, :891-909 resets the per-epoch obj_seq counter).
- The leader tick chains mod_tick → maybe_ping → maybe_change_views →
  maybe_clear_pending → maybe_update_ensembles → maybe_transition then
  renews the lease (:1074-1096).
- K/V ops run on hash-partitioned workers as blocking FSMs
  (:1267-1297, :1369-1500); per-key sequencing via obj_sequence
  (:1776-1791); reads take the lease fast path or a quorum epoch
  check (:1493-1516); stale reads rewrite the key at the current epoch
  (update_key, :1564-1596); all-notfound reads skip tombstones
  (:1568-1584).
- gen_fsm blocking semantics: the reference FSM blocks in callbacks
  during quorum waits while messages queue in the process mailbox.
  Here those sections run as "FSM tasks" — while one is active,
  incoming events are deferred to a backlog and replayed afterwards,
  giving the same serialization.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from riak_ensemble_tpu_torch import funref
from riak_ensemble_tpu_torch import msg as msglib
from riak_ensemble_tpu_torch.backend import BACKENDS, Backend
from riak_ensemble_tpu_torch.config import Config
from riak_ensemble_tpu_torch.directory import Directory
from riak_ensemble_tpu_torch.lease import Lease
from riak_ensemble_tpu_torch.runtime import Actor, Future, Runtime, Timer
from riak_ensemble_tpu_torch.storage import Storage
from riak_ensemble_tpu_torch.synctree import PeerTree, SyncTree
from riak_ensemble_tpu_torch.synctree import exchange as exchangelib
from riak_ensemble_tpu_torch.synctree.backends import DictBackend
from riak_ensemble_tpu_torch.types import (
    NOTFOUND, Fact, Obj, PeerId, initial_fact, latest_fact, members_of,
    peer_order,
)
from riak_ensemble_tpu_torch.worker import WorkerPool

H_OBJ_NONE = b"\x00"


def peer_name(ensemble: Any, peer_id: PeerId) -> Tuple:
    return ("peer", ensemble, peer_id)


def tree_name(ensemble: Any, peer_id: PeerId) -> Tuple:
    return ("tree", ensemble, peer_id)


def get_obj_hash(obj: Obj) -> bytes:
    """``<<0, Epoch:64, Seq:64>>`` — epoch/seq as the object hash;
    byte-order compare == version compare (peer.erl:1717-1724)."""
    return (H_OBJ_NONE + obj.epoch.to_bytes(8, "big")
            + obj.seq.to_bytes(8, "big"))


def valid_obj_hash(actual: bytes, known: bytes) -> bool:
    """peer.erl:1726-1729."""
    return actual[:1] == H_OBJ_NONE and known[:1] == H_OBJ_NONE and \
        actual >= known


class Peer(Actor):
    # ------------------------------------------------------------------
    # setup (peer.erl init:1810-1860)

    def __init__(self, runtime: Runtime, ensemble: Any, peer_id: PeerId,
                 config: Config, directory: Directory, storage: Storage,
                 backend: str = "basic", backend_args: Tuple = (),
                 tree_backend: Optional[Callable] = None,
                 clock: Optional[Callable[[], float]] = None,
                 initial_views=None) -> None:
        super().__init__(runtime, peer_name(ensemble, peer_id), peer_id.node)
        self.ensemble = ensemble
        self.id = peer_id
        self.config = config
        self.directory = directory
        self.storage = storage
        self.clock = clock if clock is not None else (lambda: runtime.now)

        self.fsm_state = "setup"
        self.ets: Dict[Any, int] = {}
        self.awaiting = msglib.MsgState(id=peer_id)
        self.preliminary: Optional[Tuple[PeerId, int]] = None
        self.abandoned: Optional[Tuple[int, int]] = None
        self.timer: Optional[Timer] = None
        self.ready = False
        self.tree_trust = not config.tree_validation
        self.tree_ready = False
        # NB: named alive_credits, not `alive` — Actor.alive is the
        # liveness flag and shadowing it would make _deliver drop
        # messages once the ping credits hit zero.
        self.alive_credits = config.alive_ticks
        self._backend_monitors: List[Tuple[Any, Callable]] = []
        self.last_views: Optional[Sequence] = None
        self.watchers: List[Any] = []
        self.busy = False
        self._fsm_backlog: List[Any] = []

        self.mod: Backend = BACKENDS[backend](ensemble, peer_id,
                                              backend_args)
        for helper in self.mod.monitored():
            self.monitor_backend(helper)
        # synctree (shared-tree override via synctree_path,
        # peer.erl:2155-2167).
        tree_path = self.mod.synctree_path(ensemble, peer_id)
        factory = tree_backend if tree_backend is not None else DictBackend
        if tree_path is None:
            tid, be = (ensemble, peer_id), factory()
        else:
            tid, p = tree_path
            be = factory(path=p)
        self.tree = tree_name(ensemble, peer_id)
        PeerTree(runtime, self.tree, self.node,
                 SyncTree(tree_id=tid, backend=be))

        self.workers = WorkerPool(runtime, config.peer_workers)
        self.lease_obj = Lease(self.clock)

        saved = self._reload_fact(initial_views)
        self.fact = saved
        self.members = members_of(saved.views)
        self._check_views()
        self._local_commit(self.fact)
        self.runtime.post(self.name, ("init",))

    # ------------------------------------------------------------------
    # fact accessors

    @property
    def epoch(self) -> int:
        return self.fact.epoch

    @property
    def seq(self) -> int:
        return self.fact.seq

    @property
    def leader(self) -> Optional[PeerId]:
        return self.fact.leader

    @property
    def views(self):
        return self.fact.views

    # ------------------------------------------------------------------
    # event plumbing

    def handle(self, msg: Tuple) -> None:
        if self.busy:
            self._fsm_backlog.append(msg)
            return
        kind = msg[0]
        # all-state events (handle_event, peer.erl:1886-1905)
        if kind == "reply":
            _, reqid, peer, value = msg
            self.awaiting = msglib.handle_reply(self, reqid, peer, value,
                                                self.awaiting)
            return
        if kind == "quorum_timeout_tick":
            if self.awaiting.awaiting == msg[1]:
                self.awaiting = msglib.quorum_timeout(self, self.awaiting)
            return
        if kind == "watch_leader_status":
            watcher = msg[1]
            if watcher not in self.watchers:
                self._notify_leader_status([watcher])
                self.watchers.append(watcher)
                # Watcher-death cleanup (erlang:monitor, peer.erl:1874,
                # 1920-1925).
                self.runtime.monitor(
                    watcher,
                    lambda w: self.watchers.remove(w)
                    if w in self.watchers else None)
            return
        if kind == "stop_watching":
            if msg[1] in self.watchers:
                self.watchers.remove(msg[1])
            return
        if kind == "backend_pong":
            self.alive_credits = self.config.alive_ticks
            return
        if kind == "backend_down":
            # DOWN for a backend-monitored process -> the behaviour
            # decides (module_handle_down, peer.erl:1937-1948).
            self._module_handle_down(msg[1])
            return
        if kind == "peer_sync":
            _, fut, inner = msg
            self._handle_sync(inner, fut)
            return
        if kind == "xcall":
            # Wire-safe remote sync call (exchange tree_pid etc.).
            _, from_, inner = msg
            fut = Future()
            msglib.handle_xcall(self, from_, fut)
            self._handle_sync(inner, fut)
            return
        handler = getattr(self, "st_" + self.fsm_state)
        handler(msg)

    def st_setup(self, msg: Tuple) -> None:
        if msg[0] == "init":
            self._probe_init()
        else:
            self._common(msg)

    def _run_fsm_section(self, gen) -> None:
        """Run a blocking FSM section as a task; defer events meanwhile
        (models gen_fsm blocking in a callback)."""
        assert not self.busy
        self.busy = True

        def wrapper():
            try:
                yield from gen
            finally:
                self.busy = False
                backlog, self._fsm_backlog = self._fsm_backlog, []
                for m in backlog:
                    self.runtime.post(self.name, m)

        self.runtime.spawn_task(wrapper(), name=f"fsm:{self.id}")

    # ------------------------------------------------------------------
    # timers (single slot, peer.erl set_timer/cancel_timer:2229-2242)

    def _set_timer(self, delay: float, event: Tuple) -> None:
        self._cancel_timer()
        self.timer = self.send_after(delay, event)

    def _cancel_timer(self) -> None:
        if self.timer is not None:
            self.timer.cancel()
            self.timer = None

    # ------------------------------------------------------------------
    # peer addressing / fan-out helpers

    def peer_addr(self, peer_id: PeerId):
        if peer_id == self.id:
            return self.name
        return self.directory.get_peer_addr(self.ensemble, peer_id)

    def get_peers(self, members) -> List[Tuple[PeerId, Any]]:
        return [(p, self.peer_addr(p)) for p in members]

    def _send_all(self, message: Tuple, required: str = "quorum",
                  members=None) -> None:
        members = members if members is not None else self.members
        self.awaiting = msglib.send_all(self, message, self.id,
                                        self.get_peers(members),
                                        self.views, required)

    def _blocking_send_all(self, message: Tuple, peers=None,
                           required: str = "quorum", extra=None) -> Future:
        peers = peers if peers is not None else self.get_peers(self.members)
        return msglib.blocking_send_all(self, message, self.id, peers,
                                        self.views, required, extra)

    def _cast_all(self, message: Tuple) -> None:
        msglib.cast_all(self, message, self.id,
                        self.get_peers(self.members))

    def _reply(self, from_, value) -> None:
        msglib.reply(self, from_, self.id, value)

    # ==================================================================
    # Core protocol states
    # ==================================================================

    def _probe_init(self) -> None:
        """probe(init), peer.erl:360-369."""
        self.fsm_state = "probe"
        self._set_fact(leader=None)
        if self._is_pending():
            self._pending_init()
        else:
            self._send_all(("probe",))

    def st_probe(self, msg: Tuple) -> None:
        kind = msg[0]
        if kind == "quorum_met":
            replies = msg[1]
            latest = latest_fact_of(replies, self.fact)
            existing = existing_leader(replies, self.abandoned, latest)
            self.fact = latest
            self.members = members_of(latest.views)
            self._maybe_follow(existing)
        elif kind == "timeout":
            latest = latest_fact_of(msg[1], self.fact)
            self.fact = latest
            self._check_views()
            self._probe_delay()
        elif kind == "probe_continue":
            self._probe_init()
        else:
            self._common(msg)

    def _probe_delay(self) -> None:
        self.fsm_state = "probe"
        self._set_timer(self.config.probe_delay, ("probe_continue",))

    def _maybe_follow(self, leader) -> None:
        """peer.erl:435-444."""
        if not self.tree_trust:
            self._exchange_init()
        elif leader is None or leader == self.id:
            self._set_fact(leader=None)
            self._election_init()
        else:
            self._set_fact(leader=leader)
            self._following_init(ready=False)

    # -- pending (peer.erl:394-432) ------------------------------------

    def _pending_init(self) -> None:
        self.fsm_state = "pending"
        self.tree_trust = False
        self._set_timer(self.config.pending(), ("pending_timeout",))

    def st_pending(self, msg: Tuple) -> None:
        kind = msg[0]
        if kind == "pending_timeout":
            self.st_probe(("timeout", []))
        elif kind == "prepare":
            _, cand, next_epoch, from_ = msg
            if next_epoch > self.epoch:
                self._reply(from_, self.fact)
                self._cancel_timer()
                self._prefollow_init(cand, next_epoch)
            # else: silently stay pending (reference keeps state)
        elif kind == "commit":
            _, fact, from_ = msg
            if fact.epoch >= self.epoch:
                self._reply(from_, "ok")
                self._local_commit(fact)
                self._cancel_timer()
                self._following_init()
        else:
            self._common(msg)

    def _is_pending(self) -> bool:
        """peer.erl:937-945."""
        pending = self.directory.get_pending(self.ensemble)
        if pending:
            _, pending_views = pending
            pend_members = members_of(pending_views)
            return self.id not in self.members and self.id in pend_members
        return False

    # -- repair / exchange (peer.erl:446-489) ---------------------------

    def _repair_init(self) -> None:
        self.fsm_state = "repair"
        self.tree_trust = False
        self.send_local(self.tree, ("tree_async_repair", self.name))

    def st_repair(self, msg: Tuple) -> None:
        if msg[0] == "repair_complete":
            self._exchange_init()
        else:
            self._common(msg)

    def _exchange_init(self) -> None:
        self.fsm_state = "exchange"
        self._start_exchange()

    def st_exchange(self, msg: Tuple) -> None:
        kind = msg[0]
        if kind == "exchange_complete":
            self.tree_trust = True
            self._election_init()
        elif kind == "exchange_failed":
            self._probe_delay()
        else:
            self._common(msg)

    def _start_exchange(self) -> None:
        exchangelib.start_exchange(self, self.tree,
                                   self.get_peers(self.members),
                                   self.views, self.tree_trust)

    # -- election (peer.erl:493-538) ------------------------------------

    def _election_init(self) -> None:
        self.fsm_state = "election"
        self._set_timer(self.config.election_timeout(self.runtime.rng),
                        ("election_timeout",))

    def st_election(self, msg: Tuple) -> None:
        kind = msg[0]
        if kind == "election_timeout":
            if self._mod_ping():
                self.timer = None
                self._prepare_init()
            else:
                self._election_init()
        elif kind == "prepare":
            _, cand, next_epoch, from_ = msg
            if next_epoch > self.epoch:
                self._reply(from_, self.fact)
                self._cancel_timer()
                self._prefollow_init(cand, next_epoch)
        elif kind == "commit":
            _, fact, from_ = msg
            if fact.epoch >= self.epoch:
                self._reply(from_, "ok")
                self._local_commit(fact)
                self._cancel_timer()
                self._following_init()
        else:
            self._common(msg)

    # -- prefollow (peer.erl:540-577) -----------------------------------

    def _prefollow_init(self, cand: PeerId, next_epoch: int) -> None:
        self.fsm_state = "prefollow"
        self.preliminary = (cand, next_epoch)
        self._set_timer(self.config.prefollow(), ("prefollow_timeout",))

    def st_prefollow(self, msg: Tuple) -> None:
        kind = msg[0]
        if kind == "new_epoch":
            _, cand, next_epoch, from_ = msg
            if (cand, next_epoch) == self.preliminary:
                self._set_fact(leader=cand, epoch=next_epoch)
                self._cancel_timer()
                self._reply(from_, "ok")
                self._following_init(ready=False)
            else:
                self._cancel_timer()
                self._probe_init()
        elif kind == "prefollow_timeout":
            self._probe_init()
        else:
            self._common(msg)

    # -- prepare / prelead (peer.erl:579-626) ---------------------------

    def _prepare_init(self) -> None:
        self.fsm_state = "prepare"
        next_epoch = self.epoch + 1
        self._send_all(("prepare", self.id, next_epoch))

    def st_prepare(self, msg: Tuple) -> None:
        kind = msg[0]
        if kind == "quorum_met":
            latest = latest_fact_of(msg[1], self.fact)
            next_epoch = self.epoch + 1
            self.fact = latest
            self.preliminary = (self.id, next_epoch)
            self.members = members_of(latest.views)
            self._prelead_init()
        elif kind == "timeout":
            self._probe_init()
        else:
            self._common(msg)

    def _prelead_init(self) -> None:
        self.fsm_state = "prelead"
        cand, next_epoch = self.preliminary
        assert cand == self.id
        self._send_all(("new_epoch", self.id, next_epoch))

    def st_prelead(self, msg: Tuple) -> None:
        kind = msg[0]
        if kind == "quorum_met":
            _, next_epoch = self.preliminary
            self.fact = _fact_replace(self.fact, leader=self.id,
                                      epoch=next_epoch, seq=0,
                                      view_vsn=(next_epoch, -1))
            self._leading_init()
        elif kind == "timeout":
            self._probe_init()
        else:
            self._common(msg)

    # -- leading (peer.erl:629-721) -------------------------------------

    def _leading_init(self) -> None:
        self.fsm_state = "leading"
        self.alive_credits = self.config.alive_ticks
        self.tree_ready = False
        self._start_exchange()
        self._notify_leader_status(self.watchers)
        self._leader_tick()

    def st_leading(self, msg: Tuple) -> None:
        kind = msg[0]
        if kind == "tick":
            self._leader_tick()
        elif kind == "exchange_complete":
            self.tree_trust = True
            self.tree_ready = True
        elif kind == "exchange_failed":
            self._step_down("probe")
        elif kind == "forward":
            _, fut, inner = msg
            self._leading_sync(inner, fut)
        else:
            self._common(msg)

    # -- following (peer.erl:791-867) -----------------------------------

    def _following_init(self, ready: Optional[bool] = None) -> None:
        if ready is False:
            self.ready = False
        self.fsm_state = "following"
        self._start_exchange()
        self._reset_follower_timer()

    def _reset_follower_timer(self) -> None:
        self._set_timer(self.config.follower(), ("follower_timeout",))

    def st_following(self, msg: Tuple) -> None:
        kind = msg[0]
        if kind == "commit":
            _, fact, from_ = msg
            if fact.epoch >= self.epoch:
                self._local_commit(fact)
                self._reply(from_, "ok")
                self._reset_follower_timer()
        elif kind == "exchange_complete":
            self.tree_trust = True
        elif kind == "exchange_failed":
            self._probe_init()
        elif kind == "follower_timeout":
            self.timer = None
            self._abandon()
        elif kind == "check_epoch":
            _, leader, epoch, from_ = msg
            if self._check_epoch(leader, epoch):
                self._reply(from_, "ok")
            else:
                self._reply(from_, "nack")
        elif kind == "get" and len(msg) == 5:
            _, key, peer, epoch, from_ = msg
            if self._valid_request(peer, epoch):
                self._do_local_get(from_, key)
            else:
                self._reply(from_, "nack")
        elif kind == "put" and len(msg) == 6:
            _, key, obj, peer, epoch, from_ = msg
            if self._valid_request(peer, epoch):
                self._do_local_put(from_, key, obj)
            else:
                self._reply(from_, "nack")
        elif kind == "update_hash":
            _, key, objhash, maybe_from = msg
            result = self.tree_insert_sync(key, objhash)
            if result == "corrupted":
                if maybe_from is not None:
                    self._reply(maybe_from, "nack")
                self._repair_init()
            else:
                if maybe_from is not None:
                    self._reply(maybe_from, "ok")
        else:
            self._common(msg)

    def _abandon(self) -> None:
        """peer.erl:932-935."""
        self.abandoned = (self.epoch, self.seq)
        self._set_fact(leader=None)
        self._probe_init()

    def _valid_request(self, peer, req_epoch) -> bool:
        return self.ready and req_epoch == self.epoch and peer == self.leader

    def _check_epoch(self, leader, epoch) -> bool:
        return epoch == self.epoch and leader == self.leader

    # -- common handlers (peer.erl:998-1045) ----------------------------

    def _common(self, msg: Tuple) -> None:
        kind = msg[0]
        if kind == "probe":
            self._reply(msg[1], self.fact)
        elif kind == "exchange":
            self._reply(msg[1], "ok" if self.tree_trust else "nack")
        elif kind == "all_exchange":
            self._reply(msg[1], "ok")
        elif kind == "tick":
            pass  # errant tick
        elif kind == "forward":
            pass  # not leading: drop, client times out
        elif kind == "update_hash":
            maybe_from = msg[3]
            if maybe_from is not None:
                self._reply(maybe_from, "nack")
        elif kind in ("quorum_met", "timeout", "exchange_complete",
                      "exchange_failed", "repair_complete",
                      "probe_continue", "election_timeout",
                      "prefollow_timeout", "follower_timeout",
                      "pending_timeout", "init"):
            if kind == "init" and self.fsm_state == "setup":
                self._probe_init()
            # else: stale event from a previous state; drop.
        else:
            self._nack(msg)

    def _nack(self, msg: Tuple) -> None:
        """peer.erl:1047-1069: nack only known request shapes."""
        kind = msg[0]
        if kind in ("prepare", "new_epoch"):
            self._reply(msg[3], "nack")
        elif kind == "commit":
            self._reply(msg[2], "nack")
        elif kind == "get" and len(msg) == 5:
            self._reply(msg[4], "nack")
        elif kind == "put" and len(msg) == 6:
            self._reply(msg[5], "nack")
        # anything else: silently ignored

    # ------------------------------------------------------------------
    # sync events (gen_fsm sync_send_event surface)

    def _handle_sync(self, inner: Tuple, fut: Future) -> None:
        kind = inner[0]
        # all-state sync events (peer.erl:1907-1933)
        if kind == "get_leader":
            fut.resolve(self.leader)
            return
        if kind == "get_info":
            fut.resolve((self.fsm_state, self.tree_trust, self.epoch))
            return
        if kind == "tree_info":
            top = self.tree_top_hash_sync()
            fut.resolve((self.tree_trust, self.tree_ready, top))
            return
        if kind == "debug_local_get":
            self._mod_get(inner[1], (fut, self.id))
            return
        if kind == "force_state":
            epoch, seq = inner[1]
            self._set_fact(epoch=epoch, seq=seq)
            fut.resolve("ok")
            return
        if kind == "tree_pid":
            fut.resolve(self.tree)
            return
        if kind == "fwd":
            # A request already forwarded once by a follower: handle
            # only if leading, else nack — never re-forward, or two
            # followers with mutually stale fact.leader would bounce
            # one request forever (the reference's forward is likewise
            # a single hop, peer.erl:864-867).
            if self.fsm_state == "leading":
                self._leading_sync(inner[1], fut)
            else:
                fut.resolve("nack")
            return
        if kind == "tree_corrupted":
            # common sync (peer.erl:1036-1040); leading overrides below.
            if self.fsm_state == "leading":
                fut.resolve("ok")
                self.tree_trust = False
                self._step_down("repair")
            else:
                fut.resolve("ok")
                self._repair_init()
            return
        if self.fsm_state == "leading":
            self._leading_sync(inner, fut)
        elif self.fsm_state == "following":
            self._following_sync(inner, fut)
        else:
            fut.resolve("nack")

    def _following_sync(self, inner: Tuple, fut: Future) -> None:
        """following/3: forward client K/V to the leader
        (peer.erl:838-858, 1348-1356)."""
        if inner[0] in ("get", "put", "overwrite", "join", "update_members"):
            leader_addr = self.peer_addr(self.leader) if self.leader else None
            if leader_addr is None:
                return  # drop; client times out
            if self.leader.node == self.node:
                # Same-host: hand over the caller's future directly.
                self.send(leader_addr, ("forward", fut, inner))
            else:
                # Cross-node: a live future can't ride the wire; use
                # the request-id'd xcall proxy (the From-pid analog).
                # "fwd"-wrapped so the remote never forwards again.
                out = msglib.xcall(self, leader_addr, ("fwd", inner),
                                   self.config.local_put_timeout)
                out.add_waiter(fut.resolve)
        else:
            fut.resolve("nack")

    def _leading_sync(self, inner: Tuple, fut: Future) -> None:
        """leading/3 (peer.erl:655-721) + leading_kv (1267-1297)."""
        kind = inner[0]
        if kind == "update_members":
            self._run_fsm_section(self._do_update_members(inner[1], fut))
        elif kind == "check_quorum":
            self._run_fsm_section(self._do_check_quorum(fut))
        elif kind == "ping_quorum":
            self._do_ping_quorum(fut)
        elif kind == "stable_views":
            pending, views = self.fact.pending, self.fact.views
            stable = len(views) == 1 and (pending is None or
                                          not pending[1])
            fut.resolve(("ok", stable))
        elif kind == "get" and len(inner) == 3:
            _, key, opts = inner
            if not self.tree_ready:
                fut.resolve("failed")
            else:
                self.workers.async_(
                    key, lambda: self._do_get_fsm(key, fut, opts))
        elif kind == "put":
            _, key, fun, args = inner
            try:
                # Wire events carry ("fn", name, bound) specs, not
                # closures (the reference's MFA, root.erl:82,104).
                fun = funref.resolve(fun)
            except ValueError:
                fun = None
            if fun is None or not self.tree_ready:
                fut.resolve("failed")
            else:
                self.workers.async_(
                    key, lambda: self._do_put_fsm(key, fun, args, fut))
        elif kind == "overwrite":
            _, key, value = inner
            if not self.tree_ready:
                fut.resolve("failed")
            else:
                self.workers.async_(
                    key, lambda: self._do_overwrite_fsm(key, value, fut))
        elif kind == "local_get":
            self._do_local_get((fut, None), inner[1])
        elif kind == "local_put":
            self._do_local_put((fut, None), inner[1], inner[2])
        elif kind == "request_failed":
            # No reply: the worker blocks; step_down kills it
            # (peer.erl:1274-1275 + reset_workers).
            self._step_down("prepare")
        elif kind == "join":
            self._run_fsm_section(
                self._do_update_members([("add", inner[1])], fut))
        else:
            fut.resolve("nack")

    # ------------------------------------------------------------------
    # leader periodic work

    def _leader_tick(self) -> None:
        self._run_fsm_section(self._leader_tick_gen())

    def _leader_tick_gen(self):
        """peer.erl:1074-1096."""
        self._mod_tick()
        result = "ok" if self._mod_ping() else "failed"
        if result == "ok":
            result = yield from self._maybe_change_views()
        if result == "ok":
            result = yield from self._maybe_clear_pending()
        if result == "ok":
            result = self._maybe_update_ensembles()
        if result == "ok":
            result = yield from self._maybe_transition()
        if result == "failed":
            self._step_down("probe")
        elif result == "shutdown":
            self.directory.stop_peer(self.ensemble, self.id)
            self._step_down("stop")
        else:
            self.lease_obj.lease(self.config.lease())
            self._set_timer(self.config.ensemble_tick, ("tick",))

    def _maybe_change_views(self):
        """peer.erl:1115-1135."""
        pending = self.directory.get_pending(self.ensemble)
        if not pending or not pending[1]:
            return "ok"
        vsn, views = pending
        pend_vsn = self.fact.pend_vsn
        if pend_vsn is None or vsn > pend_vsn:
            view_vsn = (self.epoch, self.seq)
            new_fact = _fact_replace(self.fact, views=tuple(views),
                                     pend_vsn=vsn, view_vsn=view_vsn)
            self.workers.pause()
            ok = yield from self._try_commit(new_fact)
            if ok:
                self.workers.unpause()
                return "changed"
            return "failed"
        return "ok"

    def _maybe_clear_pending(self):
        """peer.erl:1137-1159."""
        fact = self.fact
        if fact.pending is None or not fact.pending[1]:
            return "ok"
        vsn = fact.pending[0]
        if vsn == fact.pend_vsn and vsn == fact.commit_vsn:
            cur = self.directory.get_views(self.ensemble)
            if cur and tuple(cur[1]) == tuple(fact.views):
                new_fact = _fact_replace(
                    fact, pending=((fact.epoch, fact.seq), ()))
                ok = yield from self._try_commit(new_fact)
                return "changed" if ok else "failed"
        return "ok"

    def _maybe_update_ensembles(self) -> str:
        """peer.erl:1161-1178."""
        vsn = self.fact.view_vsn
        views = self.fact.views
        if self.ensemble == "root":
            self.directory.root_gossip(self, vsn, self.id, views)
        else:
            self.directory.update_ensemble(self.ensemble, self.id, views,
                                           vsn)
        if self.fact.pending is not None:
            pvsn, pviews = self.fact.pending
            self.directory.gossip_pending(self.ensemble, pvsn, pviews)
        return "ok"

    def _maybe_transition(self):
        """peer.erl:1199-1214."""
        if self._should_transition():
            return (yield from self._transition())
        ok = yield from self._try_commit(self.fact)
        return "ok" if ok else "failed"

    def _should_transition(self) -> bool:
        """peer.erl:751-755: views stable since last tick AND more than
        one view active."""
        return (self.views == self.last_views) and len(self.views) > 1

    def _transition(self):
        """peer.erl:756-774: collapse joint views to the newest."""
        fact = self.fact
        latest = fact.views[0]
        new_fact = _fact_replace(fact, views=(latest,),
                                 view_vsn=(fact.epoch, fact.seq),
                                 commit_vsn=fact.pend_vsn)
        ok = yield from self._try_commit(new_fact)
        if not ok:
            return "failed"
        if self.id not in latest:
            return "shutdown"
        return "ok"

    def _try_commit(self, new_fact: Fact):
        """peer.erl:776-788; generator returning bool."""
        views = self.views
        new_fact = _fact_replace(new_fact, seq=new_fact.seq + 1)
        self._local_commit(new_fact)
        fut = self._blocking_send_all(("commit", new_fact))
        outcome = yield fut
        if outcome[0] == "quorum_met":
            self.last_views = views
            return True
        self._set_fact(leader=None)
        return False

    def _do_update_members(self, changes, fut: Future):
        """leading({update_members,..}), peer.erl:655-672."""
        cluster = self.directory.cluster()
        view = list(self.views[0])
        members = list(self.members)
        errors = []
        for op, pid in changes:
            if op == "add":
                if pid.node not in cluster:
                    errors.append(("not_in_cluster", pid))
                elif pid in members:
                    errors.append(("already_member", pid))
                else:
                    members.append(pid)
                    view.append(pid)
            elif op == "del":
                if pid not in members:
                    errors.append(("not_member", pid))
                else:
                    members.remove(pid)
                    view.remove(pid)
        if errors:
            fut.resolve(("error", errors))
            return
        new_view = tuple(sorted(set(view), key=peer_order))
        views2 = (new_view,) + tuple(self.views)
        new_fact = _fact_replace(
            self.fact, pending=((self.epoch, self.seq), views2))
        ok = yield from self._try_commit(new_fact)
        if ok:
            fut.resolve("ok")
        else:
            fut.resolve("timeout")
            self._step_down("probe")

    def _do_check_quorum(self, fut: Future):
        """leading(check_quorum,..), peer.erl:673-680."""
        ok = yield from self._try_commit(self.fact)
        if ok:
            fut.resolve("ok")
        else:
            fut.resolve("timeout")
            self._step_down("probe")

    def _do_ping_quorum(self, fut: Future) -> None:
        """leading(ping_quorum,..), peer.erl:681-703: replicate a fact
        bump, let replies accumulate for 1s (lazy collector — everyone
        reachable gets counted, not just the first majority), then
        report who answered."""
        new_fact = _fact_replace(self.fact, seq=self.fact.seq + 1)
        self._local_commit(new_fact)
        qfut, cname = msglib.lazy_send_all(
            self, ("commit", new_fact), self.id,
            self.get_peers(self.members), self.views)
        extra = [(self.id, "ok")] if self.id in self.members else []
        tree_ready = self.tree_ready
        leader_id = self.id

        def waiter():
            yield self.runtime.sleep(1.0)
            if cname is not None:
                self.runtime.post(cname, ("ask",))
            outcome = yield self.runtime.with_timeout(qfut, 0.5,
                                                      ("timeout", []))
            if outcome[0] == "quorum_met":
                fut.resolve((leader_id, tree_ready, extra + outcome[1]))
            else:
                fut.resolve((leader_id, tree_ready, extra))

        self.runtime.spawn_task(waiter(), name="ping_quorum")

    # ------------------------------------------------------------------
    # step down / commit plumbing

    def _step_down(self, next_state: str = "probe") -> None:
        """peer.erl:911-930.  Watchers are told the NEXT state
        (notify_leader_status(Watchers, Next, ..), peer.erl:916)."""
        self._notify_leader_status(self.watchers, leading=False)
        self.lease_obj.unlease()
        self._cancel_timer()
        self.workers.reset()
        self._set_fact(leader=None)
        if next_state == "probe":
            self._probe_init()
        elif next_state == "prepare":
            self._prepare_init()
        elif next_state == "repair":
            self._repair_init()
        elif next_state == "stop":
            self.stop()

    def _local_commit(self, fact: Fact) -> None:
        """peer.erl:891-909: persist fact, reset per-epoch obj_seq."""
        self.fact = fact
        self._maybe_save_fact()
        epoch, seq = fact.epoch, fact.seq
        if ("obj_seq", epoch) in self.ets:
            self.ets["epoch"] = epoch
            self.ets["seq"] = seq
        else:
            self.ets.clear()
            self.ets.update({"epoch": epoch, "seq": seq,
                             ("obj_seq", epoch): 0})
        self.ready = True
        self.members = members_of(fact.views)

    def _set_fact(self, **kw) -> None:
        self.fact = _fact_replace(self.fact, **kw)

    def _check_views(self) -> None:
        """peer.erl:952-964."""
        cur = self.directory.get_views(self.ensemble)
        vsn = (self.fact.epoch, self.fact.seq)
        # Empty views = the reference's `undefined` (a manager-started
        # peer with no saved fact): always adopt the manager's views.
        if cur and (cur[0] > vsn or not self.fact.views):
            self.fact = _fact_replace(self.fact, views=tuple(cur[1]))
            self.members = members_of(self.fact.views)
        else:
            self.members = members_of(self.fact.views)

    # -- fact persistence (peer.erl:2185-2228) --------------------------

    def _fact_key(self):
        return (repr(self.ensemble), self.id)

    def _reload_fact(self, initial_views=None) -> Fact:
        saved = self.storage.get(self._fact_key())
        if saved is not None:
            return saved
        return initial_fact(initial_views if initial_views else ())

    def _maybe_save_fact(self) -> None:
        old = self.storage.get(self._fact_key())
        if old is None or _fact_replace(old, seq=0) != \
                _fact_replace(self.fact, seq=0):
            self.storage.put(self._fact_key(), self.fact)
            self.storage.sync()  # async flush; see storage.py coalescing

    # ------------------------------------------------------------------
    # backend indirection (peer.erl:2115-2153)

    def monitor_backend(self, actor_name: Any) -> None:
        """Monitor a backend helper process on the backend's behalf
        (erlang:monitor; DOWN flows to Mod:handle_down via the FSM
        mailbox so suspension semantics hold, peer.erl:1919-1929)."""
        def callback(name: Any) -> None:
            # The monitor fired (helper died): the entry is spent —
            # prune it so a backend that re-monitors a replacement
            # helper after every restart doesn't grow the list.  (The
            # deferred callback may land after on_stop cleared it.)
            try:
                self._backend_monitors.remove((name, callback))
            except ValueError:
                pass
            self.runtime.post(self.name, ("backend_down", name))

        self._backend_monitors.append((actor_name, callback))
        self.runtime.monitor(actor_name, callback)

    def _module_handle_down(self, name: Any) -> None:
        """module_handle_down (peer.erl:1937-1948): the behaviour
        returns False (not mine), ('ok',) (recovered), or ('reset',)
        — its storage is gone; step down and re-probe so the ensemble
        re-establishes state from the quorum."""
        result = self.mod.handle_down(name, name, "down")
        if result is False or result is None:
            return
        if result[0] == "reset":
            self._step_down("probe")

    def _mod_ping(self) -> bool:
        """Alive-ticks credit counter (peer.erl:2115-2128): 'async'
        spends a credit; backend_pong refills them."""
        result = self.mod.ping(self)
        if result == "ok":
            return True
        if result == "async" and self.alive_credits > 0:
            self.alive_credits -= 1
            return True
        return False

    def backend_pong(self) -> None:
        self.runtime.post(self.name, ("backend_pong",))

    def _mod_tick(self) -> None:
        f = self.fact
        self.mod.tick(f.epoch, f.seq, f.leader, f.views)

    def _mod_get(self, key, from_) -> None:
        self.mod.get(key, from_)

    def _mod_put(self, key, obj, from_) -> None:
        self.mod.put(key, obj, from_)

    def _do_local_get(self, from_, key) -> None:
        """Backend replies directly to from_ (reply-chain opt)."""
        self._mod_get(key, self._backend_from(from_))

    def _do_local_put(self, from_, key, obj) -> None:
        self._mod_put(key, obj, self._backend_from(from_))

    def _backend_from(self, from_):
        """Normalize a wire-from or (future, _) into a backend From."""
        if from_ is None:
            # Fire-and-forget put (read-repair cast, peer.erl:1518-1536:
            # From=undefined — the backend's reply is discarded).
            return (lambda value: None, self.id)
        if isinstance(from_, tuple) and len(from_) == 2 and \
                isinstance(from_[0], Future):
            return (from_[0], self.id)
        # wire from: (owner_name, reqid)
        return (lambda value: msglib.reply(self, from_, self.id, value),
                self.id)

    # ------------------------------------------------------------------
    # tree access (sync, same-node gen_server call semantics)

    def _tree_actor(self) -> PeerTree:
        return self.runtime.whereis(self.tree)

    def tree_get_sync(self, key):
        tree = self._tree_actor()
        fut = Future()
        tree.handle(("tree_get", key, fut))
        return fut.value

    def tree_insert_sync(self, key, objhash):
        tree = self._tree_actor()
        fut = Future()
        tree.handle(("tree_insert", key, objhash, fut))
        return fut.value

    def tree_top_hash_sync(self):
        tree = self._tree_actor()
        fut = Future()
        tree.handle(("tree_top_hash", fut))
        return fut.value

    # ==================================================================
    # K/V FSMs (run on workers; generators)
    # ==================================================================

    def _obj_sequence(self) -> int:
        """peer.erl:1776-1791."""
        epoch = self.ets["epoch"]
        seq = self.ets["seq"]
        self.ets[("obj_seq", epoch)] += 1
        return seq + self.ets[("obj_seq", epoch)]

    def _sync_to_self(self, inner: Tuple):
        """Worker-side sync_send_event back to own FSM; generator
        yielding the reply future (never resolves if the FSM kills the
        workers first — matching reference semantics)."""
        fut = Future()
        self.runtime.post(self.name, ("peer_sync", fut, inner))
        return fut

    def _local_get_from_worker(self, key):
        fut = Future()
        self.runtime.post(self.name, ("peer_sync", fut, ("local_get", key)))
        return self.runtime.with_timeout(fut, self.config.local_get_timeout)

    def _local_put_from_worker(self, key, obj):
        fut = Future()
        self.runtime.post(self.name,
                          ("peer_sync", fut, ("local_put", key, obj)))
        return self.runtime.with_timeout(fut, self.config.local_put_timeout)

    def _is_current(self, local, key, known_hash) -> str:
        """'timeout' | 'true' | 'false' (peer.erl:1550-1562)."""
        if local in ("timeout", "nack", "failed"):
            return "timeout"
        if local is NOTFOUND:
            return "false"
        if not self._verify_obj(key, local, known_hash):
            return "false"
        return "true" if local.epoch == self.epoch else "false"

    def _verify_obj(self, key, obj, known_hash) -> bool:
        """verify_hash (peer.erl:1740-1763)."""
        if obj is NOTFOUND:
            return known_hash is None
        if known_hash is None:
            return True
        return valid_obj_hash(get_obj_hash(obj), known_hash)

    # -- get FSM (peer.erl:1434-1491) -----------------------------------

    def _do_get_fsm(self, key, fut: Future, opts):
        known = self.tree_get_sync(key)
        if known == "corrupted":
            fut.resolve("failed")
            yield self._sync_to_self(("tree_corrupted",))
            return
        local = yield self._local_get_from_worker(key)
        local_only = "read_repair" not in opts
        cur = self._is_current(local, key, known)
        if cur == "timeout":
            fut.resolve("timeout")
        elif cur == "true":
            if local_only:
                ok = yield from self._check_lease()
                if ok:
                    fut.resolve(("ok", local))
                else:
                    fut.resolve("timeout")
                    yield self._sync_to_self(("request_failed",))
            else:
                result = yield from self._get_latest_obj(key, local, known)
                if result[0] == "ok":
                    _, latest, replies = result
                    self._maybe_repair(key, latest, replies)
                    fut.resolve(("ok", latest))
                else:
                    fut.resolve("timeout")
        else:
            result = yield from self._update_key(key, local, known)
            if result[0] == "ok":
                fut.resolve(("ok", result[1]))
            elif result[0] == "corrupted":
                fut.resolve("failed")
                yield self._sync_to_self(("tree_corrupted",))
            else:
                fut.resolve("failed")
                yield self._sync_to_self(("request_failed",))

    def _check_lease(self):
        """peer.erl:1493-1516.  The lease is trusted only up to the
        clock-skew margin (Config.read_margin) — the same guard the
        batched plane's read fast path applies; past it the read
        falls back to the check_epoch quorum round."""
        if self.config.trust_lease and \
                self.lease_obj.check_lease(self.config.read_margin()):
            return True
        fut = self._blocking_send_all(("check_epoch", self.id, self.epoch))
        outcome = yield fut
        return outcome[0] == "quorum_met"

    def _maybe_repair(self, key, latest, replies) -> None:
        """peer.erl:1518-1536: async read-repair puts."""
        should = any(obj != latest for _, obj in replies if obj != "nack")
        if should:
            self._cast_all(("put", key, latest, self.id, self.epoch, None))

    # -- put FSMs (peer.erl:1369-1432) ----------------------------------

    def _do_put_fsm(self, key, fun, args, fut: Future):
        known = self.tree_get_sync(key)
        if known == "corrupted":
            fut.resolve("failed")
            yield self._sync_to_self(("tree_corrupted",))
            return
        local = yield self._local_get_from_worker(key)
        cur = self._is_current(local, key, known)
        if cur == "timeout":
            fut.resolve("unavailable")
            return
        if cur == "true":
            yield from self._do_modify_fsm(key, local, fun, args, fut)
        else:
            result = yield from self._update_key(key, local, known)
            if result[0] == "ok":
                yield from self._do_modify_fsm(key, result[1], fun, args,
                                               fut)
            elif result[0] == "corrupted":
                fut.resolve("failed")
                yield self._sync_to_self(("tree_corrupted",))
            else:
                yield self._sync_to_self(("request_failed",))
                fut.resolve("unavailable")

    def _do_modify_fsm(self, key, current, fun, args, fut: Future):
        """peer.erl:1404-1416."""
        seq = self._obj_sequence()
        new = fun(current, seq, self, args)
        if new == "failed":
            fut.resolve("failed")
            return
        _, new_obj = new
        result = yield from self._put_obj(key, new_obj, seq)
        if result[0] == "ok":
            fut.resolve(("ok", result[1]))
        elif result[0] == "corrupted":
            fut.resolve("failed")
            yield self._sync_to_self(("tree_corrupted",))
        else:
            yield self._sync_to_self(("request_failed",))
            fut.resolve("timeout")

    def _do_overwrite_fsm(self, key, value, fut: Future):
        """peer.erl:1418-1432."""
        epoch = self.epoch
        seq = self._obj_sequence()
        obj = self.mod.new_obj(epoch, seq, key, value)
        result = yield from self._put_obj(key, obj, seq)
        if result[0] == "ok":
            fut.resolve(("ok", result[1]))
        elif result[0] == "corrupted":
            fut.resolve("timeout")
            yield self._sync_to_self(("tree_corrupted",))
        else:
            yield self._sync_to_self(("request_failed",))
            fut.resolve("timeout")

    # -- shared K/V helpers ---------------------------------------------

    def _update_key(self, key, local, known):
        """Quorum read + rewrite at current epoch (peer.erl:1564-1596).
        Returns ('ok', obj) | ('failed',) | ('corrupted',)."""
        num_peers = len(self.get_peers(self.members))
        result = yield from self._get_latest_obj(key, local, known)
        if result[0] != "ok":
            return ("failed",)
        _, latest, replies = result
        if latest is NOTFOUND and len(replies) + 1 == num_peers:
            # Everyone said notfound: skip the tombstone write
            # (peer.erl:1568-1584).
            seq = self._obj_sequence()
            new = self.mod.new_obj(self.epoch, seq, key, NOTFOUND)
            return ("ok", new)
        put = yield from self._put_obj(key, latest)
        return put

    def _get_latest_obj(self, key, local, known):
        """Quorum read with hash extra-check (peer.erl:1623-1662).
        Returns ('ok', latest, replies) | ('failed',)."""
        epoch = self.epoch
        peers = self.get_peers(self.members)

        def check(replies):
            for _, robj in replies:
                if robj == "nack":
                    continue
                if robj is NOTFOUND:
                    if known is None:
                        return True
                elif known is None or \
                        valid_obj_hash(get_obj_hash(robj), known):
                    # existing object is by definition newer than a
                    # notfound known-hash
                    return True
            return False

        extra = None if self._verify_obj(key, local, known) else check
        required = "all_or_quorum" if known is None else "quorum"
        fut = self._blocking_send_all(("get", key, self.id, epoch),
                                      peers=peers, required=required,
                                      extra=extra)
        outcome = yield fut
        if outcome[0] != "quorum_met":
            return ("failed",)
        replies = outcome[1]
        latest = local
        for _, robj in replies:
            if robj is NOTFOUND:
                continue
            if latest is NOTFOUND or latest in ("timeout", "nack", "failed"):
                latest = robj
            else:
                latest = self.mod.latest_obj(latest, robj)
        if latest in ("timeout", "nack", "failed"):
            latest = NOTFOUND
        if not self._verify_obj(key, latest, known):
            return ("failed",)
        return ("ok", latest, replies)

    def _put_obj(self, key, obj, seq: Optional[int] = None):
        """Quorum write + hash update (peer.erl:1664-1698).
        Returns ('ok', obj) | ('failed',) | ('corrupted',)."""
        if seq is None:
            seq = self._obj_sequence()
        epoch = self.epoch
        if obj is NOTFOUND:
            obj2 = self.mod.new_obj(epoch, seq, key, NOTFOUND)
        else:
            obj2 = self.mod.set_obj_epoch(
                epoch, self.mod.set_obj_seq(seq, obj))
        peers = self.get_peers(self.members)
        fut = self._blocking_send_all(("put", key, obj2, self.id, epoch),
                                      peers=peers)
        local = yield self._local_put_from_worker(key, obj2)
        if local in ("timeout", "nack", "failed"):
            yield self._sync_to_self(("request_failed",))
            return ("failed",)
        outcome = yield fut
        if outcome[0] != "quorum_met":
            return ("failed",)
        objhash = get_obj_hash(local)
        if self.tree_insert_sync(key, objhash) == "corrupted":
            return ("corrupted",)
        ok = yield from self._send_update_hash(key, objhash)
        if not ok:
            return ("failed",)
        return ("ok", local)

    def _send_update_hash(self, key, objhash):
        """peer.erl:1700-1715."""
        if not self.config.synchronous_tree_updates:
            self._cast_all(("update_hash", key, objhash, None))
            return True
        fut = self._blocking_send_all(("update_hash", key, objhash))
        outcome = yield fut
        return outcome[0] == "quorum_met"

    # ------------------------------------------------------------------
    # leadership watchers (peer.erl:212-218, 2070-2075)

    def _notify_leader_status(self, watchers, leading=None) -> None:
        if leading is None:
            leading = self.fsm_state == "leading"
        status = "is_leading" if leading else "is_not_leading"
        for w in list(watchers):
            if self.runtime.whereis(w) is None:
                if w in self.watchers:
                    self.watchers.remove(w)
                continue
            self.send_local(w, (status, self.name, self.id, self.ensemble,
                                self.epoch))

    def on_stop(self) -> None:
        self._cancel_timer()
        self.workers.reset()
        # A backend helper may outlive this peer: release its monitors
        # or each peer restart leaks a closure pinning the dead Peer.
        for target, callback in self._backend_monitors:
            self.runtime.demonitor(target, callback)
        self._backend_monitors.clear()
        if self.runtime.whereis(self.tree) is not None:
            self.runtime.stop_actor(self.tree)


# ---------------------------------------------------------------------------
# module helpers


def _fact_replace(fact: Fact, **kw) -> Fact:
    import dataclasses
    return dataclasses.replace(fact, **kw)


def latest_fact_of(replies, own: Fact) -> Fact:
    """peer.erl:2031-2040."""
    best = own
    for _, fact in replies:
        if isinstance(fact, Fact):
            best = latest_fact(best, fact)
    return best


def existing_leader(replies, abandoned, latest: Fact):
    """Vote among probe replies for a live leader (peer.erl:2042-2068)."""
    if latest.leader is None:
        members = members_of(latest.views)
        counts: Dict[Tuple[int, PeerId], int] = {}
        for _, fact in replies:
            if not isinstance(fact, Fact) or fact.leader is None:
                continue
            vsn = (fact.epoch, fact.seq)
            valid = abandoned is None or vsn > abandoned
            if valid and fact.leader in members:
                counts[(fact.epoch, fact.leader)] = \
                    counts.get((fact.epoch, fact.leader), 0) + 1
        if not counts:
            return None
        # max count; deterministic tie-break on (epoch, leader)
        (_, leader), _ = max(counts.items(),
                             key=lambda kv: (kv[1], kv[0][0]))
        return leader
    if abandoned is None or (latest.epoch, latest.seq) > abandoned:
        return latest.leader
    return None


# ---------------------------------------------------------------------------
# K/V modify functions (peer.erl do_kupdate/do_kput_once/do_kmodify)


@funref.register("peer:kupdate")
def do_kupdate(obj, _next_seq, peer: Peer, args):
    """CAS on (epoch, seq) (peer.erl:259-270)."""
    current, new = args
    expected = (peer.mod.obj_epoch(current), peer.mod.obj_seq(current))
    if (peer.mod.obj_epoch(obj), peer.mod.obj_seq(obj)) == expected:
        return ("ok", peer.mod.set_obj_value(new, obj))
    return "failed"


@funref.register("peer:kput_once")
def do_kput_once(obj, _next_seq, peer: Peer, args):
    """peer.erl:278-284."""
    (new,) = args
    if peer.mod.obj_value(obj) is NOTFOUND:
        return ("ok", peer.mod.set_obj_value(new, obj))
    return "failed"


@funref.register("peer:kmodify")
def do_kmodify(obj, next_seq, peer: Peer, args):
    """peer.erl:303-317: user function applied inside the put FSM."""
    mod_fun, default = args
    try:
        mod_fun = funref.resolve(mod_fun)
    except ValueError:
        return "failed"
    value = peer.mod.obj_value(obj)
    if value is NOTFOUND:
        value = default
    vsn = (peer.epoch, next_seq)
    new = mod_fun(vsn, value)
    if new == "failed":
        return "failed"
    return ("ok", peer.mod.set_obj_value(new, obj))


# ---------------------------------------------------------------------------
# Direct (router-less) sync API used by tests and the router


def sync_send_event(runtime: Runtime, target_name, message: Tuple,
                    timeout: float = 30.0):
    """gen_fsm:sync_send_event analog: drives the loop until replied."""
    fut = Future()
    runtime.post(target_name, ("peer_sync", fut, message))
    try:
        return runtime.await_future(
            runtime.with_timeout(fut, timeout), timeout=timeout + 1.0)
    except TimeoutError:
        return "timeout"
