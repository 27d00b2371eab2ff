"""Leader routing with late-message isolation.

Copied from ``riak_ensemble_tpu/router.py`` with its imports pointed at
this package, so the port imports nothing of the JAX package.

Re-implementation of ``src/riak_ensemble_router.erl``: a pool of 7
router actors per node (``routers/0``, router.erl:163-170) that route a
request addressed by *ensemble id* to that ensemble's leader — local
leader gets the event directly, a remote leader gets the request
forwarded to a random router on the leader's node
(``ensemble_cast``, router.erl:216-232).

Late-message isolation (router.erl:40-43,75-122): every sync request
runs through a spawned per-request proxy actor; on timeout the caller
gets ``timeout`` and any stray late reply is absorbed by the
(now-stopped) proxy rather than corrupting a later request.  Request
identity is a fresh reqid per call (the ``make_ref()`` pattern).

Unknown leader → immediate ``timeout`` result (router.erl fail_cast /
``ensemble_cast`` error branch).
"""

from __future__ import annotations

import itertools
from typing import Any, Tuple

from riak_ensemble_tpu_torch.runtime import Actor, Future, Runtime

#: router.erl:163-170 — seven routers per node.
N_ROUTERS = 7

_proxy_ids = itertools.count(1)
_refs = itertools.count(1)


def router_name(node: str, i: int) -> Tuple:
    return ("router", node, i)


def manager_name(node: str) -> Tuple:
    return ("manager", node)


class Router(Actor):
    """One of the per-node router pool (router.erl gen_server)."""

    def __init__(self, runtime: Runtime, node: str, index: int) -> None:
        super().__init__(runtime, router_name(node, index), node)
        self.index = index

    def _directory(self):
        return self.runtime.whereis(manager_name(self.node))

    def handle(self, msg: Tuple) -> None:
        if msg[0] == "ensemble_cast":
            _, ensemble, inner = msg
            self.ensemble_cast(ensemble, inner)

    def ensemble_cast(self, ensemble: Any, inner: Tuple) -> None:
        """router.erl:216-232."""
        directory = self._directory()
        leader = directory.get_leader(ensemble) if directory else None
        if leader is None:
            _fail_cast(self, inner)
            return
        if leader.node == self.node:
            addr = directory.get_peer_addr(ensemble, leader)
            if addr is None:
                _fail_cast(self, inner)
                return
            self._handle_ensemble_cast(inner, addr)
        else:
            cast(self.runtime, self, leader.node, ensemble, inner)

    def _handle_ensemble_cast(self, inner: Tuple, addr: Any) -> None:
        """Deliver to the local leader; for sync requests bridge the
        peer's local Future reply back over the network
        (router.erl:235-249 spawned per-request caller)."""
        if inner[0] == "sync_send_event":
            _, from_, event, timeout = inner
            owner, ref = from_
            fut = Future()
            self.runtime.post(addr, ("peer_sync", fut, event))
            router = self

            def relay(result: Any) -> None:
                router.send(owner, ("rtr_reply", ref, result))

            self.runtime.with_timeout(fut, timeout).add_waiter(relay)


def _fail_cast(router: Router, inner: Tuple) -> None:
    """router.erl fail_cast: sync callers get an immediate timeout."""
    if inner[0] == "sync_send_event":
        _, (owner, ref), _, _ = inner
        router.send(owner, ("rtr_reply", ref, "timeout"))


def cast(runtime: Runtime, src: Actor, node: str, ensemble: Any,
         inner: Tuple) -> None:
    """Forward to a random router on `node` (router.erl:128-142); a
    dead/unreachable router means the message is simply lost and the
    caller times out (noconnect semantics, router.erl:144-160)."""
    pick = runtime.rng.randrange(N_ROUTERS)
    src.send(router_name(node, pick), ("ensemble_cast", ensemble, inner))


class _Proxy(Actor):
    """Per-request proxy (router.erl sync_proxy:89-122)."""

    def __init__(self, runtime: Runtime, node: str, fut: Future,
                 ref: int) -> None:
        super().__init__(runtime, ("rtr_proxy", node, next(_proxy_ids)),
                         node)
        self.fut = fut
        self.ref = ref

    def handle(self, msg: Tuple) -> None:
        if msg[0] == "rtr_reply" and msg[1] == self.ref:
            self.fut.resolve(msg[2])
            self.stop()


def sync_send_event_fut(runtime: Runtime, node: str, ensemble: Any,
                        event: Tuple, timeout: float) -> Future:
    """Route `event` to the ensemble's leader starting from `node`'s
    router pool; returns a Future resolving to the reply or
    ``"timeout"`` (router.erl sync_send_event:71-87).

    The per-request proxy lives on the CALLING process's node (a
    networked runtime hosts one node and exposes it as ``.node``; the
    simulator hosts all nodes, so the proxy co-locates with the target
    pool there) and the request reaches a possibly-remote router over
    the transport.
    """
    fut = Future()
    ref = next(_refs)
    local_node = getattr(runtime, "node", node)
    proxy = _Proxy(runtime, local_node, fut, ref)
    inner = ("sync_send_event", (proxy.name, ref), event, timeout)
    pick = runtime.rng.randrange(N_ROUTERS)
    runtime.net_send(local_node, router_name(node, pick),
                     ("ensemble_cast", ensemble, inner))

    out = runtime.with_timeout(fut, timeout)

    def cleanup(_v: Any) -> None:
        if runtime.whereis(proxy.name) is not None:
            runtime.stop_actor(proxy.name)

    out.add_waiter(cleanup)
    return out


def sync_send_event(runtime: Runtime, node: str, ensemble: Any,
                    event: Tuple, timeout: float = 10.0):
    """Blocking (loop-driving) form for tests/clients."""
    fut = sync_send_event_fut(runtime, node, ensemble, event, timeout)
    try:
        return runtime.await_future(fut, timeout=timeout + 1.0)
    except TimeoutError:
        return "timeout"


def start_routers(runtime: Runtime, node: str) -> None:
    """riak_ensemble_router_sup:init (router_sup.erl:40-45)."""
    for i in range(N_ROUTERS):
        if runtime.whereis(router_name(node, i)) is None:
            Router(runtime, node, i)
