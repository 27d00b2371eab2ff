"""Quorum fan-out + vote collection (host side).

Copied from ``riak_ensemble_tpu/msg.py`` with its imports pointed at
this package, so the port imports nothing of the JAX package.

Mirrors ``src/riak_ensemble_msg.erl``.  Two paths:

- **Non-blocking** (:func:`send_all` / :func:`handle_reply`): used from
  inside the peer FSM (probe/prepare/prelead/commit).  Replies arrive
  as ``('reply', reqid, peer, value)`` events on the peer; once quorum
  is met the peer receives ``('quorum_met', valid_replies)``, on nack
  or timeout ``('quorum_timeout', valid_replies)``
  (msg.erl:85-97,336-366).
- **Blocking** (:func:`blocking_send_all`): spawns a collector actor
  (the analog of the collector process, msg.erl:196-237) and returns a
  :class:`~riak_ensemble_tpu_torch.runtime.Future` resolving to
  ``('quorum_met', valid_replies)`` or ``('timeout', replies)``; K/V
  worker tasks ``yield`` it (= ``wait_for_quorum``, msg.erl:319-332).

``peers`` everywhere is a list of ``(peer_id, addr_or_None)``; a None
address is an offline peer and gets a synthesized nack
(msg.erl:132-142).  Requests carry a ``From = (dst_name, reqid)``;
responders answer with :func:`reply`, so replies route to whichever
actor issued the fan-out (peer or collector) — the reference's
"reply directly to the caller" optimization falls out for free.

The per-call quorum predicate is
:func:`riak_ensemble_tpu_torch.ops.quorum.quorum_met`; the batched engine
runs the same predicate as the jitted kernel.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence, Tuple

from riak_ensemble_tpu_torch.ops.quorum import MET, NACK, UNDECIDED, quorum_met, \
    find_valid
from riak_ensemble_tpu_torch.runtime import Actor, Future, Runtime, Timer

_reqids = itertools.count(1)

#: wire sentinel for negative votes
NACK_REPLY = "nack"


def make_from(owner_name: Any, reqid: int) -> Tuple[Any, int]:
    return (owner_name, reqid)


def reply(actor: Actor, from_: Tuple[Any, int], peer_id: Any,
          value: Any) -> None:
    """Route a reply back to the fan-out owner (msg.erl:180-182)."""
    owner, reqid = from_
    actor.send(owner, ("reply", reqid, peer_id, value))


@dataclass
class MsgState:
    """Non-blocking vote-collection state embedded in the peer FSM
    (``#msgstate{}``, msg.erl:44-49)."""

    id: Any
    awaiting: Optional[int] = None
    timer: Optional[Timer] = None
    required: str = "quorum"
    views: Sequence[Sequence[Any]] = ()
    replies: List[Tuple[Any, Any]] = field(default_factory=list)


def _fan_out(actor: Actor, owner_name: Any, msg: Tuple, reqid: int,
             peers, self_id) -> None:
    from_ = make_from(owner_name, reqid)
    request = msg + (from_,)
    for peer_id, addr in peers:
        if peer_id == self_id:
            continue
        if addr is None:
            # Offline peer: synthesized nack (msg.erl:134-138).
            actor.runtime.post(owner_name, ("reply", reqid, peer_id,
                                            NACK_REPLY))
        else:
            actor.send(addr, request)


def send_all(actor: Actor, msg: Tuple, self_id: Any, peers, views,
             required: str = "quorum") -> MsgState:
    """Fan out msg; replies flow back into the owning peer FSM.

    Returns the MsgState the peer must keep in its state and thread
    through :func:`handle_reply`.
    """
    if [p for p, _ in peers] == [self_id]:
        # Singleton ensemble: trivially met (msg.erl:86-89).
        actor.runtime.post(actor.name, ("quorum_met", []))
        return MsgState(id=self_id)
    reqid = next(_reqids)
    _fan_out(actor, actor.name, msg, reqid, peers, self_id)
    timer = actor.send_after(actor.config.quorum(), ("quorum_timeout_tick",
                                                     reqid))
    return MsgState(id=self_id, awaiting=reqid, timer=timer,
                    required=required, views=views)


def cast_all(actor: Actor, msg: Tuple, self_id: Any, peers) -> None:
    """Fire-and-forget to all peers but self (msg.erl:101-106)."""
    for peer_id, addr in peers:
        if peer_id != self_id and addr is not None:
            actor.send(addr, msg)


def handle_reply(actor: Actor, reqid: int, peer: Any, value: Any,
                 mstate: MsgState) -> MsgState:
    """Accumulate one reply (msg.erl:336-359)."""
    if reqid != mstate.awaiting:
        return mstate
    mstate.replies.append((peer, value))
    met = quorum_met(mstate.replies, mstate.id, mstate.views, mstate.required)
    if met == MET:
        if mstate.timer:
            mstate.timer.cancel()
        valid, _ = find_valid(mstate.replies)
        actor.runtime.post(actor.name, ("quorum_met", valid))
        return MsgState(id=mstate.id)
    if met == NACK:
        if mstate.timer:
            mstate.timer.cancel()
        return quorum_timeout(actor, mstate)
    return mstate


def quorum_timeout(actor: Actor, mstate: MsgState) -> MsgState:
    """Report failure with whatever valid replies arrived
    (msg.erl:361-366)."""
    valid, _ = find_valid(mstate.replies)
    actor.runtime.post(actor.name, ("timeout", valid))
    return MsgState(id=mstate.id)


# ---------------------------------------------------------------------------
# Wire-safe cross-node sync call (the gen_server:call-over-dist
# analog).  Messages carry only names and reqids — no Futures — so the
# same protocol runs on the simulator and the TCP transport.

_xproxy_ids = itertools.count(1)


class _XProxy(Actor):
    def __init__(self, runtime: Runtime, node, fut: Future,
                 ref: int) -> None:
        super().__init__(runtime, ("xproxy", node, next(_xproxy_ids)),
                         node)
        self.fut = fut
        self.ref = ref

    def handle(self, msg: Tuple) -> None:
        if msg[0] == "xreply" and msg[1] == self.ref:
            self.fut.resolve(msg[2])
            self.stop()


_xcall_refs = itertools.count(1)


def xcall(actor: Actor, dst_name: Any, inner: Tuple,
          timeout: float) -> Future:
    """Sync-call `dst_name` (a peer or tree actor on any node) with
    `inner`; resolves to the reply or ``"timeout"``.  The callee
    handles ``("xcall", (proxy_name, ref), inner)`` and replies
    ``("xreply", ref, value)`` to the proxy."""
    fut = Future()
    ref = next(_xcall_refs)
    proxy = _XProxy(actor.runtime, actor.node, fut, ref)
    actor.send(dst_name, ("xcall", (proxy.name, ref), inner))
    out = actor.runtime.with_timeout(fut, timeout)

    def cleanup(_v):
        if actor.runtime.whereis(proxy.name) is not None:
            actor.runtime.stop_actor(proxy.name)

    out.add_waiter(cleanup)
    return out


def handle_xcall(actor: Actor, from_: Tuple, fut: Future) -> Future:
    """Wire a local Future so its resolution answers an xcall."""
    owner, ref = from_
    fut.add_waiter(lambda v: actor.send(owner, ("xreply", ref, v)))
    return fut


# Blocking path: collector actor + future


class _Collector(Actor):
    """Stand-in for the collector process (msg.erl:212-317).

    Resolution rules (matching check_enough/try_collect_all):
      - quorum met, required != all_or_quorum  -> ('quorum_met', valid)
      - quorum met, all_or_quorum              -> keep collecting up to
        notfound_read_delay for *all* replies; resolve ('quorum_met',
        valid-so-far) on all-met, first nack, or delay expiry.
      - nack                                   -> ('timeout', replies)
      - idle for one quorum interval           -> ('timeout', replies)
    """

    def __init__(self, runtime: Runtime, name, node, config, self_id, views,
                 required, extra, future: Future) -> None:
        super().__init__(runtime, name, node)
        self.config = config
        self.self_id = self_id
        self.views = views
        self.required = required
        self.extra = extra
        self.future = future
        self.replies: List[Tuple[Any, Any]] = []
        self.reqid: Optional[int] = None
        self.phase = "collect"  # or "collect_all"
        self.lazy = False
        self.idle_timer: Optional[Timer] = None
        self.all_timer: Optional[Timer] = None

    def _arm_idle(self) -> None:
        if self.idle_timer:
            self.idle_timer.cancel()
        self.idle_timer = self.send_after(self.config.quorum(),
                                          ("idle_timeout",))

    def _finish(self, result: Tuple) -> None:
        self.future.resolve(result)
        self.stop()

    def on_stop(self) -> None:
        for t in (self.idle_timer, self.all_timer):
            if t:
                t.cancel()

    def handle(self, msg: Tuple) -> None:
        kind = msg[0]
        if kind == "reply":
            _, reqid, peer, value = msg
            if reqid != self.reqid:
                return
            self.replies.append((peer, value))
            if not self.lazy:
                self._check()
        elif kind == "ask":
            # Lazy mode: the caller starts waiting NOW (the reference's
            # {waiting, From, Ref} → check_enough handshake,
            # msg.erl:232-234,258-280).  Everything heard so far counts
            # — this is how ping_quorum/count_quorum see more than a
            # bare majority.
            met = quorum_met(self.replies, self.self_id, self.views,
                             self.required, extra=self.extra)
            if met == MET:
                valid, _ = find_valid(self.replies)
                self._finish(("quorum_met", valid))
            else:
                self._finish(("timeout", list(self.replies)))
        elif kind == "idle_timeout":
            if self.phase == "collect":
                self._finish(("timeout", list(self.replies)))
        elif kind == "all_timeout":
            valid, _ = find_valid(self.replies)
            self._finish(("quorum_met", valid))

    def _check(self) -> None:
        met = quorum_met(self.replies, self.self_id, self.views,
                         self.required, extra=self.extra)
        if self.phase == "collect_all":
            # Waiting for all after quorum (try_collect_all_impl).
            all_met = quorum_met(self.replies, self.self_id, self.views,
                                 "all")
            if all_met != UNDECIDED:
                valid, _ = find_valid(self.replies)
                self._finish(("quorum_met", valid))
            return
        self._arm_idle()
        if met == MET:
            if self.required == "all_or_quorum":
                self.phase = "collect_all"
                self.all_timer = self.send_after(
                    self.config.notfound_read_delay, ("all_timeout",))
            else:
                valid, _ = find_valid(self.replies)
                self._finish(("quorum_met", valid))
        elif met == NACK:
            self._finish(("timeout", list(self.replies)))


_collector_ids = itertools.count(1)


def blocking_send_all(actor: Actor, msg: Tuple, self_id: Any, peers, views,
                      required: str = "quorum",
                      extra: Optional[Callable] = None) -> Future:
    """Fan out and return a Future for a worker task to yield on
    (msg.erl:185-210 + wait_for_quorum:319-332)."""
    future = Future()
    others = [(p, a) for p, a in peers if p != self_id]
    if not others:
        future.resolve(("quorum_met", []))
        return future
    # Node-scoped name so cross-node replies can route back to the
    # collector over a real transport.
    name = ("collector", actor.node, next(_collector_ids))
    collector = _Collector(actor.runtime, name, actor.node, actor.config,
                           self_id, views, required, extra, future)
    reqid = next(_reqids)
    collector.reqid = reqid
    _fan_out(collector, name, msg, reqid, peers, self_id)
    collector._arm_idle()
    return future


def lazy_send_all(actor: Actor, msg: Tuple, self_id: Any, peers, views,
                  required: str = "quorum"):
    """Fan out but keep collecting until asked: the caller later posts
    ``("ask",)`` to the returned collector name and the future resolves
    against everything heard by then (the reference's parent-waiting
    collector protocol, used by ping_quorum).  Returns
    (future, collector_name_or_None)."""
    future = Future()
    others = [(p, a) for p, a in peers if p != self_id]
    if not others:
        future.resolve(("quorum_met", []))
        return future, None
    name = ("collector", actor.node, next(_collector_ids))
    collector = _Collector(actor.runtime, name, actor.node, actor.config,
                           self_id, views, required, None, future)
    collector.lazy = True
    reqid = next(_reqids)
    collector.reqid = reqid
    _fan_out(collector, name, msg, reqid, peers, self_id)
    # A lazy collector waits indefinitely for its owner's ("ask",) —
    # tie its lifetime to the owner (the Erlang collector dies with its
    # parent): if the owning actor stops before asking, stop the
    # collector too instead of leaking it in the registry forever.
    owner = actor.name

    def _owner_down(_name, cname=name):
        c = collector.runtime.whereis(cname)
        if c is not None and c.lazy:
            future.resolve(("timeout", list(collector.replies)))
            collector.runtime.stop_actor(cname)

    actor.runtime.monitor(owner, _owner_down)
    # The collector always stops eventually (ask path or owner-down
    # path); drop the owner monitor with it so a long-lived owner
    # doesn't accumulate one dead closure per lazy_send_all call.
    actor.runtime.monitor(
        name, lambda _n: actor.runtime.demonitor(owner, _owner_down))
    return future, name
