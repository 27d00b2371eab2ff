"""Coalesced fact/cluster-state storage, one per node.

Copied from ``riak_ensemble_tpu/storage.py`` with its imports pointed at
this package, so the port imports nothing of the JAX package.

Mirrors ``src/riak_ensemble_storage.erl``: a single table + one
``ensemble_facts`` file; puts stage in the table; ``sync`` resolves
once flushed; flush happens ``storage_delay`` after the first dirty
put/sync and at least every ``storage_tick``; unchanged images skip the
write (storage.erl:86-103, 133-137, 176-193).  Rationale: thousands of
independent synchronous writers overwhelmed I/O (storage.erl:21-39).
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, List, Optional

from riak_ensemble_tpu_torch import save
from riak_ensemble_tpu_torch.config import Config
from riak_ensemble_tpu_torch.runtime import Actor, Future, Runtime, Timer


class Storage(Actor):
    def __init__(self, runtime: Runtime, node: str, config: Config,
                 data_root: Optional[str]) -> None:
        super().__init__(runtime, ("storage", node), node)
        self.config = config
        self.path = (os.path.join(data_root, "ensembles", "ensemble_facts")
                     if data_root else None)
        self.table: Dict[Any, Any] = {}
        self.waiting: List[Future] = []
        self.timer: Optional[Timer] = None
        self.previous: Optional[bytes] = None
        if self.path:
            raw = save.read(self.path)
            if raw is not None:
                self.table = pickle.loads(raw)
        self.send_after(self.config.storage_tick, ("storage_tick",))

    # Direct-call API (the ETS is public in the reference; actors on
    # the same node call these synchronously).

    def put(self, key: Any, value: Any) -> None:
        self.table[key] = value

    def get(self, key: Any) -> Any:
        return self.table.get(key)

    def sync(self) -> Future:
        """Future resolves once staged puts hit disk."""
        fut = Future()
        self.waiting.append(fut)
        self._maybe_schedule_sync()
        return fut

    # -- internals ---------------------------------------------------------

    def _maybe_schedule_sync(self) -> None:
        if self.timer is None:
            self.timer = self.send_after(self.config.storage_delay,
                                         ("do_sync",))

    def handle(self, msg) -> None:
        kind = msg[0]
        if kind == "storage_tick":
            self._maybe_schedule_sync()
            self.send_after(self.config.storage_tick, ("storage_tick",))
        elif kind == "do_sync":
            self.timer = None
            self._do_sync()

    def _do_sync(self) -> None:
        data = pickle.dumps(self.table)
        if data != self.previous and self.path:
            save.write(self.path, data)
        self.previous = data
        waiting, self.waiting = self.waiting, []
        for fut in waiting:
            fut.resolve("ok")
