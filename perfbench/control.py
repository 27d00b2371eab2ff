"""The control: the plain reference put in the program's place, with one
guarantee of the configuration broken.

``correct`` must come out false on it.  It acknowledges a write once the
leader's replica alone holds it (the configuration states 3 of 5).
Everything else it answers as the reference does.  Run it at a
cell's size with ``python3 -m perfbench.control <cell> <seed>...``.
"""

from __future__ import annotations

import json
import sys
from typing import Any, Callable, Dict, List

import numpy as np

from perfbench import reference as ref


class Future:
    __slots__ = ("done", "value", "_waiters")

    def __init__(self) -> None:
        self.done, self.value = False, None
        self._waiters: List[Callable[[Any], None]] = []

    def resolve(self, value: Any) -> None:
        self.done, self.value = True, value
        for w in self._waiters:
            w(value)
        self._waiters = []

    def add_waiter(self, fn: Callable[[Any], None]) -> None:
        if self.done:
            fn(self.value)
        else:
            self._waiters.append(fn)


class ControlSystem:
    """A store of ``n_ens`` ensembles x ``n_peers`` replicas served by
    the reference, one flush at a time."""

    def __init__(self, cfg: dict, device: str) -> None:
        del device
        self.n_peers = int(cfg["n_peers"])
        self.model: Dict[int, ref.Ensemble] = {}
        #: replica -> ensemble -> key -> (value, vsn)
        self.held: List[Dict[int, Dict[Any, tuple]]] = [
            {} for _ in range(self.n_peers)]
        self._queue: List[tuple] = []
        self.flushes = 0

    def put(self, ens: int, keys: List[Any], values: List[bytes]):
        fut = Future()
        self._queue.append((ref.PUT, ens, keys, values, fut))
        return fut

    def get(self, ens: int, keys: List[Any]):
        fut = Future()
        self._queue.append((ref.GET, ens, keys, None, fut))
        return fut

    def flush(self) -> int:
        queue, self._queue = self._queue, []
        served = 0
        for kind, ens, keys, values, fut in queue:
            m = self.model.setdefault(ens, ref.Ensemble())
            if kind == ref.PUT:
                out = []
                for key, value in zip(keys, values):
                    vsn = m.put(key, value)
                    # the leader's replica alone holds it
                    self.held[0].setdefault(ens, {})[key] = (value, vsn)
                    out.append(("ok", vsn))
            else:
                out = []
                for key in keys:
                    cur = m.get(key)
                    out.append(("ok", None, (0, 0)) if cur is None
                               else ("ok", cur[0], cur[1]))
            served += len(keys)
            fut.resolve(out)
        self.flushes += 1
        return served

    def new_lat_records(self) -> List[dict]:
        return []

    def stats(self) -> Dict[str, Any]:
        return {"flushes": self.flushes}

    def replicas(self, rows: np.ndarray, keys_of: Dict[int, List[Any]]
                 ) -> Dict[int, Dict[Any, List[tuple]]]:
        return {int(e): {k: [h.get(int(e), {}).get(k, (None, (0, 0)))
                             for h in self.held]
                         for k in keys_of.get(int(e), ())}
                for e in rows}

    def close(self) -> None:
        pass


def main(argv: List[str]) -> int:
    """``<cell> [--seconds S] <seed>...``: the control at the cell's own
    size, one line of checks per seed."""
    from perfbench import harness

    cell, rest = argv[0], argv[1:]
    seconds = 10.0
    if rest[:1] == ["--seconds"]:
        seconds, rest = float(rest[1]), rest[2:]
    for seed in rest:
        res = harness.run_cell(cell, int(seed), seconds, False,
                               device="cpu", system_factory=ControlSystem)
        print(json.dumps({"cell": cell, "seed": int(seed),
                          "correct": res["correct"],
                          "attempted": res["attempted"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
