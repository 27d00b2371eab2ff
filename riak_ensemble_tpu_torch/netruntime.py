"""Real-time networked host runtime: asyncio + TCP transport.

Copied from ``riak_ensemble_tpu/netruntime.py`` (:class:`NetRuntime`,
:class:`_NetPolicy`, :class:`_Conn`, ``FRAME_HEADER``), on the port's
own :mod:`.runtime` (``Actor`` / ``Future`` / ``Task`` / ``Timer``),
:mod:`.wire` and :mod:`.faults`, so it imports nothing of the JAX
package.  It is the real-time counterpart of the deterministic
simulator (:class:`.runtime.Runtime`): actor callbacks and timers run
on one asyncio loop with wall-clock time (``schedule`` is
``loop.call_later``), and node-to-node messages travel as
length-prefixed frames over TCP in the restricted wire codec (no code
execution on decode).  The keyed service's timer (``tick``, the burst
kick, ``stop()``) runs on it unchanged: :mod:`.svcnode` serves a
:class:`.parallel.batched_host.BatchedEnsembleService` built on it.

Failure semantics mirror the reference's:

- Unreachable node → frames are dropped after a bounded connect
  attempt; the quorum layer's timeouts/synthesized-nack machinery does
  the rest (noconnect casts, router.erl:144-160).
- Connections are re-established lazily per send batch; no session
  state is required by the protocol (every request carries its reqid).

Actor addressing is by the same structured names the simulator uses;
:func:`node_of_name` extracts the home node (peer ids embed their
node, service names carry it at index 1), so `Actor.send` works
unchanged on either runtime.
"""

from __future__ import annotations

import asyncio
import os
import random
import struct
import sys
import time
from typing import Any, Callable, Dict, Generator, List, Optional, Tuple

from riak_ensemble_tpu_torch import faults, wire
from riak_ensemble_tpu_torch.runtime import Actor, Future, Task, Timer
from riak_ensemble_tpu_torch.types import PeerId

FRAME_HEADER = struct.Struct(">I")
MAX_FRAME = 64 * 1024 * 1024

#: log every dropped (non-encodable or malformed) frame to stderr
_WIRE_DEBUG = bool(os.environ.get("RETPU_WIRE_DEBUG"))

_warned_types: set = set()


def _warn_unencodable(item: Any, exc: BaseException) -> None:
    """A value the wire codec rejects is silently lost to the caller
    (they see only a timeout), so say so — once per distinct cause
    (every time, with the full repr, under RETPU_WIRE_DEBUG).  The
    frame is always a (dst, msg) tuple, so dedupe on the error text,
    which names the actual offending inner type.  Everything here is
    guarded: this runs in the except path that must never kill the
    sender task, and a hostile __repr__/__str__ may raise."""
    try:
        cause = str(exc)[:200]
    except Exception:
        cause = type(exc).__name__
    try:
        desc = f"{cause}: {repr(item)[:300]}" if _WIRE_DEBUG else cause
    except Exception:
        desc = cause
    if _WIRE_DEBUG or desc not in _warned_types:
        if not _WIRE_DEBUG:
            _warned_types.add(desc)
        print(f"riak_ensemble_tpu_torch: dropping non-wire-encodable frame "
              f"({desc}); only plain data and registered protocol "
              f"types cross nodes", file=sys.stderr, flush=True)

#: service-style names carrying their node at index 1
_NODE_AT_1 = ("manager", "router", "rtr_proxy", "storage", "collector",
              "xproxy")


def node_of_name(name: Any) -> Optional[str]:
    """Home node of an actor name; None = deliver locally only."""
    if isinstance(name, tuple) and name:
        if name[0] in ("peer", "tree") and len(name) >= 3 and \
                isinstance(name[2], PeerId):
            return name[2].node
        if name[0] in _NODE_AT_1 and len(name) >= 2 and \
                isinstance(name[1], str):
            return name[1]
    return None


class NetRuntime:
    """Runtime-API-compatible real-time host for one node.

    ``peers`` maps node name → (host, port); this node's own entry
    defines the listen address.  All actor callbacks run on the
    asyncio loop thread — the same single-threaded execution model as
    the simulator (and the gen_server model it mirrors).
    """

    def __init__(self, node: str, peers: Dict[str, Tuple[str, int]],
                 seed: int = 0) -> None:
        self.node = node
        self.peers = dict(peers)
        self.rng = random.Random(seed)
        self.actors: Dict[Any, Actor] = {}
        self._monitors: Dict[Any, List[Callable[[Any], None]]] = {}
        self.trace: Optional[Callable[[str, Any], None]] = None
        self.net = _NetPolicy()
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: Dict[str, "_Conn"] = {}

    # -- time --------------------------------------------------------------

    @property
    def now(self) -> float:
        return time.monotonic()

    # -- registry (same surface as the simulator) --------------------------

    def register(self, actor: Actor) -> None:
        assert actor.name not in self.actors, f"duplicate {actor.name}"
        self.actors[actor.name] = actor

    def whereis(self, name: Any) -> Optional[Actor]:
        return self.actors.get(name)

    def stop_actor(self, name: Any) -> None:
        actor = self.actors.pop(name, None)
        if actor is not None:
            actor.alive = False
            actor.on_stop()
            for fn in self._monitors.pop(name, []):
                self.defer(lambda fn=fn: fn(name))

    def monitor(self, name: Any, callback: Callable[[Any], None]) -> None:
        if name not in self.actors:
            self.defer(lambda: callback(name))
            return
        self._monitors.setdefault(name, []).append(callback)

    def demonitor(self, name: Any,
                  callback: Callable[[Any], None]) -> None:
        fns = self._monitors.get(name)
        if fns is None:
            return
        try:
            fns.remove(callback)
        except ValueError:
            pass
        if not fns:
            del self._monitors[name]

    def suspend(self, name: Any) -> None:
        self.actors[name].suspended = True

    def resume(self, name: Any) -> None:
        actor = self.actors[name]
        if not actor.suspended:
            return
        actor.suspended = False
        backlog, actor._backlog = actor._backlog, []
        for msg in backlog:
            self.post(actor.name, msg)

    # -- scheduling --------------------------------------------------------

    def defer(self, fn: Callable[[], None]) -> None:
        assert self.loop is not None
        self.loop.call_soon(fn)

    def schedule(self, delay: float, fn: Callable[[], None]) -> Timer:
        assert self.loop is not None
        timer = Timer(self.now + delay)

        def fire() -> None:
            if not timer.cancelled:
                fn()

        self.loop.call_later(delay, fire)
        return timer

    def send_after(self, delay: float, dst: Any, msg: Any) -> Timer:
        return self.schedule(delay, lambda: self.post(dst, msg))

    def sleep(self, delay: float) -> Future:
        fut = Future()
        self.schedule(delay, lambda: fut.resolve(None))
        return fut

    def with_timeout(self, fut: Future, timeout: float,
                     timeout_value: Any = "timeout") -> Future:
        out = Future()
        fut.add_waiter(out.resolve)
        self.schedule(timeout, lambda: out.resolve(timeout_value))
        return out

    def spawn_task(self, gen: Generator, name: str = "task") -> Task:
        task = Task(self, gen, name)
        self.defer(lambda: task._step(None))
        return task

    # -- messaging ---------------------------------------------------------

    def post(self, dst: Any, msg: Any) -> None:
        def deliver() -> None:
            actor = self.actors.get(dst)
            if actor is not None:
                if self.trace:
                    self.trace("deliver", (dst, msg))
                actor._deliver(msg)

        self.defer(deliver)

    def net_send(self, src_node: str, dst: Any, msg: Any) -> None:
        dst_node = node_of_name(dst)
        if dst_node is None or dst_node == self.node:
            self.post(dst, msg)
            return
        if self.net.drop_hook is not None and \
                self.net.drop_hook(src_node, dst, msg):
            return
        fp = self.net.active_plan()
        if fp is not None:
            # fault-injection plane (docs/ARCHITECTURE.md §13):
            # directional drop, then injected per-link delay.  Delay
            # defers only the ENQUEUE onto the per-node connection
            # (call_later), so concurrent frames overlap their delays
            # like real in-flight latency; jitter within the delay
            # reorders frames on the link — the bounded-reorder mode
            # of this runtime (TCP still delivers each enqueue run in
            # order).
            if fp.should_drop(src_node, dst_node):
                return
            d = fp.delay_s(src_node, dst_node)
            if d > 0.0 and self.loop is not None:
                self.loop.call_later(
                    d, lambda: self._net_forward(dst_node, dst, msg))
                return
        self._net_forward(dst_node, dst, msg)

    def _net_forward(self, dst_node: str, dst: Any, msg: Any) -> None:
        conn = self._conns.get(dst_node)
        if conn is None:
            addr = self.peers.get(dst_node)
            if addr is None:
                return  # unknown node = unreachable (noconnect)
            conn = _Conn(self, dst_node, addr)
            self._conns[dst_node] = conn
        conn.send((dst, msg))

    # -- server ------------------------------------------------------------

    async def start(self) -> None:
        self.loop = asyncio.get_running_loop()
        host, port = self.peers[self.node]
        self._server = await asyncio.start_server(self._on_client,
                                                  host, port)

    async def _on_client(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                head = await reader.readexactly(FRAME_HEADER.size)
                (length,) = FRAME_HEADER.unpack(head)
                if length > MAX_FRAME:
                    break
                payload = await reader.readexactly(length)
                try:
                    dst, msg = wire.decode(payload)
                except Exception as exc:
                    if _WIRE_DEBUG:
                        print("WIRE-RXDROP", exc, payload[:120],
                              file=sys.stderr, flush=True)
                    continue  # corrupt/hostile frame: drop (the codec
                    # only constructs allowlisted protocol types)
                self.post(dst, msg)
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()

    async def stop(self) -> None:
        for conn in self._conns.values():
            conn.close()
        self._conns.clear()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    # -- blocking bridge (callers outside the loop) ------------------------

    async def await_future(self, fut: Future, timeout: float = 60.0):
        afut = asyncio.get_running_loop().create_future()
        fut.add_waiter(lambda v: afut.done() or afut.set_result(v))
        return await asyncio.wait_for(afut, timeout)


class _NetPolicy:
    """Test-hook surface kept API-compatible with the simulator's
    Network (partition/heal map to the drop hook here).  ``plan``
    attaches a :class:`riak_ensemble_tpu_torch.faults.FaultPlan`
    (directional drop / per-link delay / reorder-by-jitter); it
    defaults to the process-global plan, so the environment fault
    knobs arm a subprocess node without code changes."""

    def __init__(self) -> None:
        self.drop_hook: Optional[Callable[[str, Any, Any], bool]] = None
        #: fault-injection plan; None = consult the process-global
        #: plan (env-armed) on every send
        self.plan: Optional[faults.FaultPlan] = None

    def active_plan(self) -> Optional[faults.FaultPlan]:
        if self.plan is not None:
            return self.plan if self.plan.active() else None
        return faults.active_plan()

    def heal(self) -> None:
        self.drop_hook = None
        if self.plan is not None:
            self.plan.heal()


class _Conn:
    """Lazy outbound connection with a bounded send queue; frames are
    dropped while the node is unreachable (noconnect semantics)."""

    MAX_QUEUE = 10_000

    def __init__(self, runtime: NetRuntime, node: str,
                 addr: Tuple[str, int]) -> None:
        self.runtime = runtime
        self.node = node
        self.addr = addr
        self.queue: asyncio.Queue = asyncio.Queue(self.MAX_QUEUE)
        self._task = asyncio.get_running_loop().create_task(self._run())

    def send(self, frame: Any) -> None:
        try:
            self.queue.put_nowait(frame)
        except asyncio.QueueFull:
            pass  # backpressure by drop, like a full distribution buffer

    def close(self) -> None:
        self._task.cancel()

    async def _run(self) -> None:
        writer: Optional[asyncio.StreamWriter] = None
        try:
            while True:
                item = await self.queue.get()
                try:
                    payload = wire.encode(item)
                except Exception as exc:
                    # WireError for out-of-allowlist values; anything
                    # else (a hostile __repr__/__eq__, etc.) must not
                    # kill the sender task and wedge the link.
                    _warn_unencodable(item, exc)
                    continue  # not wire-encodable: local-only, drop
                if writer is None:
                    try:
                        _r, writer = await asyncio.wait_for(
                            asyncio.open_connection(*self.addr),
                            timeout=2.0)
                    except asyncio.CancelledError:
                        raise
                    except Exception:
                        # node down: drop the frame, pace retries
                        await asyncio.sleep(0.2)
                        continue
                try:
                    writer.write(FRAME_HEADER.pack(len(payload)) + payload)
                    await writer.drain()
                except asyncio.CancelledError:
                    raise
                except Exception:
                    writer.close()
                    writer = None  # frame dropped; reconnect next send
        except asyncio.CancelledError:
            if writer is not None:
                writer.close()
            raise
