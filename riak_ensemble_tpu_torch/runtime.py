"""Deterministic discrete-event host runtime: futures, timers, actors,
tasks, the virtual network and the seeded event loop.

Copied from ``riak_ensemble_tpu/runtime.py`` (``Future``, ``Timer``,
``Actor``, ``Task``, ``Network``, ``Runtime``), so the port imports
nothing of the JAX package.  The event order is the reference's: one
heap ordered by (time, insertion seq) and one seeded ``random.Random``
drawn in the same places, so the same calls under the same seed run the
same events in the same order, link faults included (the network's
:class:`..faults.FaultPlan`: directional drops and per-link delay on
virtual time).  :mod:`.netruntime` is the real-time counterpart.
"""

from __future__ import annotations

import heapq
import random
from typing import Any, Callable, Dict, Generator, List, Optional, Tuple


class Future:
    __slots__ = ("done", "value", "_waiters")

    def __init__(self) -> None:
        self.done = False
        self.value: Any = None
        self._waiters: List[Callable[[Any], None]] = []

    def resolve(self, value: Any) -> None:
        if self.done:
            return
        self.done = True
        self.value = value
        waiters, self._waiters = self._waiters, []
        # Every waiter runs even if an earlier one raises (the list is
        # already swapped out, so a skipped waiter could never fire);
        # the errors re-raise afterwards — all of them, as a group
        # when there are several — so no bug loses its signal.
        # KeyboardInterrupt/SystemExit abort immediately.
        errs: List[Exception] = []
        for w in waiters:
            try:
                w(value)
            except Exception as exc:
                errs.append(exc)
        if len(errs) == 1:
            raise errs[0]
        if errs:
            raise ExceptionGroup("future waiter errors", errs)

    def add_waiter(self, fn: Callable[[Any], None]) -> None:
        if self.done:
            fn(self.value)
        else:
            self._waiters.append(fn)


class Timer:
    __slots__ = ("cancelled", "fire_at")

    def __init__(self, fire_at: float) -> None:
        self.cancelled = False
        self.fire_at = fire_at

    def cancel(self) -> None:
        self.cancelled = True


class Actor:
    """Base class for addressable event handlers.

    Subclasses implement :meth:`handle` (the gen_fsm/gen_server event
    callback).  ``name`` is any hashable address; ``node`` scopes the
    actor to a virtual node for partitions and node-down semantics.
    """

    def __init__(self, runtime: "Runtime", name: Any, node: str) -> None:
        self.runtime = runtime
        self.name = name
        self.node = node
        self.suspended = False
        self.alive = True
        self._backlog: List[Any] = []
        runtime.register(self)

    # -- messaging ---------------------------------------------------------

    def send(self, dst: Any, msg: Any) -> None:
        """Send over the (virtual) network from this actor's node."""
        self.runtime.net_send(self.node, dst, msg)

    def send_local(self, dst: Any, msg: Any) -> None:
        """Same-node send: no network policy, but still async."""
        self.runtime.post(dst, msg)

    def send_after(self, delay: float, msg: Any) -> Timer:
        """Timer message to self (erlang:send_after)."""
        return self.runtime.send_after(delay, self.name, msg)

    # -- lifecycle ---------------------------------------------------------

    def handle(self, msg: Any) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def on_stop(self) -> None:
        """Cleanup hook when the actor is stopped/killed."""

    def stop(self) -> None:
        self.runtime.stop_actor(self.name)

    def _deliver(self, msg: Any) -> None:
        if not self.alive:
            return
        if self.suspended:
            self._backlog.append(msg)
            return
        self.handle(msg)


class Task:
    """Generator coroutine driven by the runtime.

    The generator yields :class:`Future` objects; the runtime resumes it
    with the future's value.  Yielding ``None`` re-schedules immediately
    (a cooperative yield point).
    """

    __slots__ = ("gen", "runtime", "alive", "name")

    def __init__(self, runtime: "Runtime", gen: Generator,
                 name: str = "task") -> None:
        self.runtime = runtime
        self.gen = gen
        self.alive = True
        self.name = name

    def kill(self) -> None:
        if self.alive:
            self.alive = False
            self.gen.close()

    def _step(self, send_value: Any) -> None:
        if not self.alive:
            return
        try:
            yielded = self.gen.send(send_value)
        except StopIteration:
            self.alive = False
            return
        if yielded is None:
            self.runtime.defer(lambda: self._step(None))
        elif isinstance(yielded, Future):
            yielded.add_waiter(
                lambda v: self.runtime.defer(lambda: self._step(v)))
        else:  # pragma: no cover - programming error
            raise TypeError(f"task {self.name} yielded {yielded!r}")


class Network:
    """Delivery policy between virtual nodes."""

    def __init__(self, runtime: "Runtime") -> None:
        self.runtime = runtime
        #: set of frozenset({a, b}) pairs that cannot communicate
        self.cut_links: set = set()
        #: test drop hook: fn(src_node, dst_name, msg) -> bool (drop?)
        self.drop_hook: Optional[Callable[[str, Any, Any], bool]] = None
        self.min_latency = 1e-4
        self.max_latency = 5e-4
        #: adversarial reorder window (chaos mode); 0 = off
        self.chaos_window = 0.0
        self.chaos_local = 0.0
        #: fault-injection plan (:class:`..faults.FaultPlan`):
        #: DIRECTIONAL drop (the one-way partition ``partition()``
        #: cannot express) + per-link injected delay, applied in
        #: net_send on top of the base latency.  Lazily created by
        #: :meth:`fault_plan`; healed with everything else
        self.plan = None

    def chaos(self, window: float = 0.05, local: float = 0.0) -> None:
        """PULSE-analog delivery permutation: every cross-node message
        gets an independent uniform delay in ``[0, window)``, so any
        two messages in flight within the window can deliver in either
        order — the seeded RNG makes each seed one reproducible total
        order of deliveries.  ``local`` adds the same treatment to
        same-node sends (stronger than Erlang, which guarantees
        per-pair signal order; protocols gated on reqids must still
        converge).  The window should dwarf max_latency and stay well
        under the protocol timeouts (tick/lease) or chaos turns into
        blanket message loss."""
        self.chaos_window = window
        self.chaos_local = local

    def partition(self, group_a: List[str], group_b: List[str]) -> None:
        """Cut all links between two node groups (sc.erl:1012-1022)."""
        for a in group_a:
            for b in group_b:
                self.cut_links.add(frozenset((a, b)))

    def fault_plan(self):
        """The network's fault-injection plan, created on first use
        (seeded from the runtime's RNG for reproducible schedules)."""
        if self.plan is None:
            from riak_ensemble_tpu_torch import faults

            self.plan = faults.FaultPlan(
                seed=self.runtime.rng.randrange(1 << 30))
        return self.plan

    def partition_oneway(self, srcs: List[str],
                         dsts: List[str]) -> None:
        """Cut links in ONE direction only: frames ``src→dst`` drop,
        ``dst→src`` still deliver — the classic failover killer the
        symmetric :meth:`partition` cannot express."""
        plan = self.fault_plan()
        for a in srcs:
            for b in dsts:
                plan.drop(a, b)

    def heal(self) -> None:
        self.cut_links.clear()
        if self.plan is not None:
            self.plan.heal()

    def can_reach(self, src: str, dst: str) -> bool:
        return src == dst or frozenset((src, dst)) not in self.cut_links

    def latency(self) -> float:
        if self.chaos_window > 0.0:
            return self.runtime.rng.uniform(0.0, self.chaos_window)
        return self.runtime.rng.uniform(self.min_latency, self.max_latency)

    def local_latency(self) -> float:
        if self.chaos_local > 0.0:
            return self.runtime.rng.uniform(0.0, self.chaos_local)
        return 0.0


class Runtime:
    def __init__(self, seed: int = 0) -> None:
        self.now = 0.0
        self.rng = random.Random(seed)
        self._heap: List[Tuple[float, int, Callable[[], None]]] = []
        self._seq = 0
        self.actors: Dict[Any, Actor] = {}
        self.net = Network(self)
        self.trace: Optional[Callable[[str, Any], None]] = None
        self._monitors: Dict[Any, List[Callable[[Any], None]]] = {}

    # -- registry ----------------------------------------------------------

    def register(self, actor: Actor) -> None:
        assert actor.name not in self.actors, f"duplicate actor {actor.name}"
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
        """erlang:monitor analog: callback(name) fires (deferred) when
        the named actor is stopped.  Monitoring a dead/unknown actor
        fires immediately (the DOWN-on-monitor semantic)."""
        if name not in self.actors:
            self.defer(lambda: callback(name))
            return
        self._monitors.setdefault(name, []).append(callback)

    def demonitor(self, name: Any,
                  callback: Callable[[Any], None]) -> None:
        """Remove a monitor registered with :meth:`monitor` — needed
        whenever the monitoring side finishes first, or a long-lived
        monitored actor accumulates dead callbacks forever."""
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
        """Freeze an actor (erlang:suspend_process analog)."""
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

    def _push(self, at: float, fn: Callable[[], None]) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (at, self._seq, fn))

    def defer(self, fn: Callable[[], None]) -> None:
        """Run fn at the current time, after already-queued events."""
        self._push(self.now, fn)

    def schedule(self, delay: float, fn: Callable[[], None]) -> Timer:
        timer = Timer(self.now + delay)

        def fire() -> None:
            if not timer.cancelled:
                fn()

        self._push(timer.fire_at, fire)
        return timer

    def send_after(self, delay: float, dst: Any, msg: Any) -> Timer:
        return self.schedule(delay, lambda: self.post(dst, msg))

    def sleep(self, delay: float) -> Future:
        fut = Future()
        self.schedule(delay, lambda: fut.resolve(None))
        return fut

    def with_timeout(self, fut: Future, timeout: float,
                     timeout_value: Any = "timeout") -> Future:
        """Future resolving to fut's value, or timeout_value after
        `timeout` seconds (the gen_fsm call-timeout analog)."""
        out = Future()
        fut.add_waiter(out.resolve)
        self.schedule(timeout, lambda: out.resolve(timeout_value))
        return out

    def post(self, dst: Any, msg: Any) -> None:
        """Deliver msg to actor dst at the current time (local send)."""
        def deliver() -> None:
            actor = self.actors.get(dst)
            if actor is not None:
                if self.trace:
                    self.trace("deliver", (dst, msg))
                actor._deliver(msg)

        self.defer(deliver)

    def net_send(self, src_node: str, dst: Any, msg: Any) -> None:
        """Network send with latency/partition/drop policy applied."""
        actor = self.actors.get(dst)
        dst_node = actor.node if actor is not None else None
        if dst_node is not None and not self.net.can_reach(src_node, dst_node):
            return
        if self.net.drop_hook is not None and \
                self.net.drop_hook(src_node, dst, msg):
            return
        delay = self.net.local_latency() if dst_node == src_node \
            else self.net.latency()
        plan = self.net.plan
        if plan is not None and dst_node is not None \
                and dst_node != src_node and plan.active():
            # fault plane: directional drop, then injected per-link
            # delay stacked on the base latency (virtual time — the
            # schedule stays deterministic under the seeded plan RNG)
            if plan.should_drop(src_node, dst_node):
                return
            delay += plan.delay_s(src_node, dst_node)
        self.send_after(delay, dst, msg)

    def spawn_task(self, gen: Generator, name: str = "task") -> Task:
        task = Task(self, gen, name)
        self.defer(lambda: task._step(None))
        return task

    # -- execution ---------------------------------------------------------

    def run_for(self, duration: float) -> None:
        self.run_until_time(self.now + duration)

    def run_until_time(self, deadline: float) -> None:
        while self._heap and self._heap[0][0] <= deadline:
            at, _, fn = heapq.heappop(self._heap)
            self.now = max(self.now, at)
            fn()
        self.now = max(self.now, deadline)

    def run_until(self, pred: Callable[[], bool], max_time: float = 60.0,
                  poll: float = 0.01) -> bool:
        """Advance until pred() is true (checked every `poll` virtual
        seconds); returns False on virtual-time budget exhaustion."""
        deadline = self.now + max_time
        while self.now < deadline:
            if pred():
                return True
            self.run_until_time(min(self.now + poll, deadline))
        return pred()

    def await_future(self, fut: Future, timeout: float = 60.0) -> Any:
        """Drive the loop until fut resolves (external/test entry point).
        Raises TimeoutError on virtual-time timeout."""
        ok = self.run_until(lambda: fut.done, max_time=timeout, poll=0.001)
        if not ok:
            raise TimeoutError("future not resolved in virtual time budget")
        return fut.value
