"""The system under test: ``riak_ensemble_tpu_torch``'s keyed service.

The one module of the benchmark that imports the program.  It builds
``BatchedEnsembleService`` on the configuration's shape under its
``WallRuntime`` (``tick=None``: the benchmark drives ``flush()``), with
the service's defaults, and exposes the few calls the harness makes: the
keyed batch verbs, ``flush``, the per-flush latency records and counters,
and the replica planes the check reads.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from riak_ensemble_tpu_torch.parallel.batched_host import (
    BatchedEnsembleService, WallRuntime)


class PortSystem:
    """One keyed service on ``device``, in memory (no data dir)."""

    def __init__(self, cfg: dict, device: str) -> None:
        if cfg["durability"] != "memory":
            raise ValueError(f"durability {cfg['durability']!r}")
        self.svc = BatchedEnsembleService(
            WallRuntime(), int(cfg["n_ens"]), int(cfg["n_peers"]),
            int(cfg["n_slots"]), tick=None,
            max_ops_per_tick=int(cfg["max_ops_per_tick"]),
            device=device)
        self._last_rec: Any = None

    # -- the timed path ---------------------------------------------------
    def put(self, ens: int, keys: List[Any], values: List[bytes]):
        return self.svc.kput_many(ens, keys, values)

    def get(self, ens: int, keys: List[Any]):
        return self.svc.kget_many(ens, keys, want_vsn=True)

    def flush(self) -> int:
        return self.svc.flush()

    # -- what the metrics read ---------------------------------------------
    def new_lat_records(self) -> List[Dict[str, float]]:
        """The latency records that landed since the last call (the
        service keeps the newest 1,024)."""
        recs = self.svc.lat_records
        out: List[Dict[str, float]] = []
        for r in reversed(recs):
            if r is self._last_rec:
                break
            out.append(r)
        if recs:
            self._last_rec = recs[-1]
        out.reverse()
        return out

    def stats(self) -> Dict[str, Any]:
        return self.svc.stats()

    def wrap_engine(self, wrap) -> None:
        """Route every launch through ``wrap(engine)``."""
        self.svc.engine = wrap(self.svc.engine)

    def warmup(self) -> None:
        """Every launch shape the service can take."""
        self.svc.warmup(capture_costs=False)

    # -- what the check reads ------------------------------------------------
    def replicas(self, rows: np.ndarray, keys_of: Dict[int, List[Any]]
                 ) -> Dict[int, Dict[Any, List[tuple]]]:
        """For each row and key: every replica's ``(value, (epoch,
        seq))`` as the device store holds it."""
        svc = self.svc
        st = svc.engine.gather_state(svc.state)
        idx = torch.as_tensor(np.asarray(rows, np.int64),
                              device=st.obj_val.device)
        ep = st.obj_epoch.index_select(0, idx).cpu().numpy()
        sq = st.obj_seq.index_select(0, idx).cpu().numpy()
        hv = st.obj_val.index_select(0, idx).cpu().numpy()
        out: Dict[int, Dict[Any, List[tuple]]] = {}
        for i, e in enumerate(rows):
            ks = svc.key_slot[int(e)]
            per: Dict[Any, List[tuple]] = {}
            for key in keys_of.get(int(e), ()):
                s = ks.get(key)
                if s is None:
                    per[key] = []
                    continue
                per[key] = [(svc.values.get(int(hv[i, m, s])),
                             (int(ep[i, m, s]), int(sq[i, m, s])))
                            for m in range(hv.shape[1])]
            out[int(e)] = per
        return out

    def close(self) -> None:
        self.svc.stop()

