"""Pluggable peer storage behaviour + reference in-memory/file backend.

Copied from ``riak_ensemble_tpu/backend.py`` with its imports pointed at
this package, so the port imports nothing of the JAX package.

Mirrors ``src/riak_ensemble_backend.erl`` (15-callback behaviour,
:51-108) and ``src/riak_ensemble_basic_backend.erl``.  The backend owns
the K/V object representation and **replies directly to the original
caller** — the reference's reply-chain optimization
(``riak_ensemble_backend:reply/2``, backend.erl:145-151;
``doc/Readme.md:454-459``): replies skip the peer FSM and resolve the
waiting worker's future straight from the backend.
"""

from __future__ import annotations

import os
import pickle
import zlib
from typing import Any, Callable, Dict, Optional, Tuple

from riak_ensemble_tpu_torch.types import NOTFOUND, Obj
from riak_ensemble_tpu_torch.runtime import Future


#: `from` for backend replies: (sink, peer_id) where sink is a Future,
#: a callable, or None (discard).  Resolving it is the moral equivalent
#: of `To ! {Tag, Reply}` — the reply skips the peer FSM entirely.
From = Tuple[Any, Any]


def reply(from_: From, value: Any) -> None:
    """backend.erl:145-151."""
    sink, _id = from_
    if sink is None:
        return
    if isinstance(sink, Future):
        sink.resolve(value)
    else:
        sink(value)


class Backend:
    """Behaviour contract (riak_ensemble_backend.erl:51-108).

    Subclasses may use any object representation by overriding the
    obj_* accessors; the framework default is
    :class:`riak_ensemble_tpu_torch.types.Obj`.
    """

    # -- lifecycle ---------------------------------------------------------

    def __init__(self, ensemble: Any, peer_id: Any, args: Tuple) -> None:
        self.ensemble = ensemble
        self.peer_id = peer_id
        self.args = args

    # -- object representation --------------------------------------------

    def new_obj(self, epoch: int, seq: int, key: Any, value: Any) -> Obj:
        return Obj(epoch=epoch, seq=seq, key=key, value=value)

    def obj_epoch(self, obj: Obj) -> int:
        return obj.epoch

    def obj_seq(self, obj: Obj) -> int:
        return obj.seq

    def obj_key(self, obj: Obj) -> Any:
        return obj.key

    def obj_value(self, obj: Obj) -> Any:
        return obj.value

    def set_obj_epoch(self, epoch: int, obj: Obj) -> Obj:
        return Obj(epoch=epoch, seq=obj.seq, key=obj.key, value=obj.value)

    def set_obj_seq(self, seq: int, obj: Obj) -> Obj:
        return Obj(epoch=obj.epoch, seq=seq, key=obj.key, value=obj.value)

    def set_obj_value(self, value: Any, obj: Obj) -> Obj:
        return Obj(epoch=obj.epoch, seq=obj.seq, key=obj.key, value=value)

    def latest_obj(self, a: Obj, b: Obj) -> Obj:
        """Newer of two objects by (epoch, seq) (backend.erl:132-143)."""
        va = (self.obj_epoch(a), self.obj_seq(a))
        vb = (self.obj_epoch(b), self.obj_seq(b))
        return b if vb > va else a

    # -- storage ops (must reply via `reply(from_, ...)`) -----------------

    def get(self, key: Any, from_: From) -> None:  # pragma: no cover
        raise NotImplementedError

    def put(self, key: Any, obj: Obj, from_: From) -> None:  # pragma: no cover
        raise NotImplementedError

    # -- housekeeping ------------------------------------------------------

    def tick(self, epoch: int, seq: int, leader: Any, views: Any) -> None:
        """Periodic leader housekeeping (backend.erl:77-79)."""

    def ping(self, peer) -> str:
        """Health check: 'ok' | 'async' | 'failed' (backend.erl:81-83).
        If 'async', backend must eventually call peer.backend_pong()."""
        return "ok"

    def ready_to_start(self) -> bool:
        return True

    def synctree_path(self, ensemble: Any, peer_id: Any):
        """None = default per-peer tree; or (tree_id, path) for shared
        trees (backend.erl:97-108)."""
        return None

    def monitored(self) -> Tuple[Any, ...]:
        """Actor names the owning peer should monitor on the backend's
        behalf at startup (the backend's helper processes; the peer
        passes their DOWN signals to :meth:`handle_down`, matching the
        monitor-then-callback flow of peer.erl:1919-1929).  Backends
        that spawn helpers later use ``peer.monitor_backend(name)``."""
        return ()

    def handle_down(self, ref: Any, pid: Any, reason: Any):
        """React to a DOWN signal for a monitored process
        (backend.erl:84-93): False = not mine / ignore; ('ok',) =
        handled, keep going; ('reset',) = storage lost — the peer must
        step down and re-probe (module_handle_down,
        peer.erl:1937-1948)."""
        return False


class BasicBackend(Backend):
    """In-memory dict + synchronous CRC-checked whole-image file write
    on every put (``riak_ensemble_basic_backend.erl:120-187``).  Used by
    the root ensemble.

    ``data_root=None`` keeps it memory-only (unit tests).
    """

    def __init__(self, ensemble, peer_id, args=()) -> None:
        super().__init__(ensemble, peer_id, args)
        data_root = args[0] if args else None
        self.path: Optional[str] = None
        if data_root is not None:
            fname = f"kv_{abs(hash((repr(ensemble), repr(peer_id)))):x}"
            self.path = os.path.join(data_root, "ensembles", fname)
        self.data: Dict[Any, Obj] = self._load()

    def _load(self) -> Dict[Any, Obj]:
        """CRC-checked reload (basic_backend.erl:151-179)."""
        if self.path is None or not os.path.exists(self.path):
            return {}
        try:
            with open(self.path, "rb") as f:
                raw = f.read()
            crc = int.from_bytes(raw[:4], "big")
            blob = raw[4:]
            if zlib.crc32(blob) & 0xFFFFFFFF != crc:
                return {}
            return pickle.loads(blob)
        except Exception:
            return {}

    def _save(self) -> None:
        """Synchronous whole-image save (basic_backend.erl:181-187)."""
        if self.path is None:
            return
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        blob = pickle.dumps(self.data)
        crc = (zlib.crc32(blob) & 0xFFFFFFFF).to_bytes(4, "big")
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(crc + blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def get(self, key, from_) -> None:
        reply(from_, self.data.get(key, NOTFOUND))

    def put(self, key, obj, from_) -> None:
        self.data[key] = obj
        self._save()
        reply(from_, obj)


BACKENDS: Dict[str, Callable] = {"basic": BasicBackend}


def register_backend(name: str, cls: Callable) -> None:
    BACKENDS[name] = cls
