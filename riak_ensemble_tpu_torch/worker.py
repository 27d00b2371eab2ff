"""Per-peer async worker pool for K/V FSMs.

Copied from ``riak_ensemble_tpu/worker.py`` with its imports pointed at
this package, so the port imports nothing of the JAX package.

Mirrors ``src/riak_ensemble_peer_worker.erl`` + the peer's worker
management (``riak_ensemble_peer.erl:1220-1265``):

- Work is routed by ``hash(key) % n_workers`` (``async/3``,
  peer.erl:1220-1225) — same-key operations serialize on one worker,
  distinct keys run concurrently.
- Each worker runs one K/V FSM generator at a time, FIFO.
- ``pause``/``unpause`` is the barrier used while a view change
  commits (peer_worker.erl:53-68); paused workers finish nothing until
  unpaused.
- ``reset`` (leader step-down, peer.erl:1247-1259) kills in-flight
  FSMs and drops queued ones — a blocked FSM's client request dies with
  it and surfaces as a client timeout, exactly as in the reference.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Generator, Optional

from riak_ensemble_tpu_torch.runtime import Future, Runtime, Task


class Worker:
    def __init__(self, runtime: Runtime) -> None:
        self.runtime = runtime
        self.queue: deque = deque()
        self.current: Optional[Task] = None
        self.paused: Optional[Future] = None

    def submit(self, genfunc: Callable[[], Generator]) -> None:
        self.queue.append(genfunc)
        self._pump()

    def _pump(self) -> None:
        if self.current is not None and self.current.alive:
            return
        if self.paused is not None or not self.queue:
            return
        genfunc = self.queue.popleft()
        self.current = self.runtime.spawn_task(self._wrap(genfunc), "kv-fsm")

    def _wrap(self, genfunc):
        try:
            yield from genfunc()
        finally:
            self.current = None
            self.runtime.defer(self._pump)

    def pause(self) -> None:
        if self.paused is None:
            self.paused = Future()

    def unpause(self) -> None:
        if self.paused is not None:
            fut, self.paused = self.paused, None
            fut.resolve(None)
            self._pump()

    def reset(self) -> None:
        """Kill in-flight FSM and drop the queue (reset_workers)."""
        self.queue.clear()
        if self.current is not None:
            self.current.kill()
            self.current = None
        self.paused = None


class WorkerPool:
    def __init__(self, runtime: Runtime, n_workers: int) -> None:
        self.runtime = runtime
        self.workers = [Worker(runtime) for _ in range(n_workers)]

    def async_(self, key, genfunc) -> None:
        """Route by key hash (peer.erl:1220-1225); crc32 keeps the
        partition stable across processes (python hash() is seeded)."""
        import zlib
        idx = zlib.crc32(repr(key).encode()) % len(self.workers)
        self.workers[idx].submit(genfunc)

    def pause(self) -> None:
        for w in self.workers:
            w.pause()

    def unpause(self) -> None:
        for w in self.workers:
            w.unpause()

    def reset(self) -> None:
        for w in self.workers:
            w.reset()
