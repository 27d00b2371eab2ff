"""Key/value store over the C++ treestore engine.

Copied from ``riak_ensemble_tpu/synctree/native_store.py``: the role
``synctree_leveldb.erl`` + eleveldb play for the reference — durable
ordered storage with a shared-engine registry and batched sequential
writes.  Keys and values are pickled terms (protocol 4); the engine
(``csrc/host/treestore.cc``, a copy of ``native/treestore.cc``: CRC-framed
append log + ordered in-memory index + snapshot compaction) stores the
raw bytes, so a store file either package wrote reads in the other.

The library is the port's own build of ``csrc/host/``
(:func:`..ops.build.load_host`), never the reference's ``native/*.so``;
a failed build raises.  The reference's probe for a stale library
without ``retpu_store_put_many`` is gone: the port builds the library
from the sources beside it.
"""

from __future__ import annotations

import ctypes
import errno as _errno
import pickle
import sys
from typing import Any, Iterable, List

import numpy as np

from riak_ensemble_tpu_torch import faults
from riak_ensemble_tpu_torch.ops import build

_corrupt_warned = False


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The treestore's C signatures (the reference's
    ``utils/native.py:95-125``)."""
    p, cp = ctypes.c_void_p, ctypes.c_char_p
    lib.retpu_store_open.restype = p
    lib.retpu_store_open.argtypes = [cp]
    lib.retpu_store_close.argtypes = [p]
    lib.retpu_store_put.restype = ctypes.c_int
    lib.retpu_store_put.argtypes = [p, cp, ctypes.c_uint32, cp,
                                    ctypes.c_uint32]
    lib.retpu_store_put_many.restype = ctypes.c_int
    lib.retpu_store_put_many.argtypes = [p, p, p, ctypes.c_int64]
    lib.retpu_store_get.restype = ctypes.c_int64
    lib.retpu_store_get.argtypes = [p, cp, ctypes.c_uint32, cp,
                                    ctypes.c_uint64]
    lib.retpu_store_delete.restype = ctypes.c_int
    lib.retpu_store_delete.argtypes = [p, cp, ctypes.c_uint32]
    lib.retpu_store_count.restype = ctypes.c_uint64
    lib.retpu_store_count.argtypes = [p]
    lib.retpu_store_key_at.restype = ctypes.c_int64
    lib.retpu_store_key_at.argtypes = [p, ctypes.c_uint64, cp,
                                       ctypes.c_uint64]
    lib.retpu_store_sync.argtypes = [p]
    lib.retpu_store_flush.argtypes = [p]
    lib.retpu_store_compact.argtypes = [p]
    return lib


def _storage_faults(fault_class: str, op: str) -> None:
    """The write-path seam of the storage fault plane for the C engine:
    injected EIO / ENOSPC raise as in the Python stores; a torn-write
    rule becomes an error-only injection (the engine owns its file
    handles, so Python cannot leave a physically torn frame — the write
    still fails and the rule is consumed)."""
    faults.storage_raise(fault_class, op)
    if op == "write":
        cut = faults.torn_limit(fault_class)
        if cut is not None:
            raise OSError(
                _errno.EIO,
                f"injected torn write (native {fault_class} store: "
                f"error-only, no partial frame)")


def _enc(term: Any) -> bytes:
    return pickle.dumps(term, protocol=4)


def _dec(blob: bytes) -> Any:
    return pickle.loads(blob)


class NativeBackend:
    """``fetch / exists / store / delete / keys`` over the C++ engine."""

    #: storage fault-plane path class; the WAL's ``_open_store`` rebinds
    #: it to ``"wal"``
    fault_class = "tree"

    def __init__(self, path: str) -> None:
        lib = _declare(build.load_host())
        self._lib = lib
        self._handle = lib.retpu_store_open(path.encode())
        if not self._handle:
            raise RuntimeError(f"cannot open treestore at {path}")
        self.path = path
        # the read-corruption knob cannot reach the C engine's replay
        # reads (its CRC gate runs in C); an armed rule must be loud
        global _corrupt_warned
        p = faults.active_plan()
        if (not _corrupt_warned and p is not None
                and p.describe().get("corrupt")):
            _corrupt_warned = True
            print("riak_ensemble_tpu_torch.native_store: "
                  "RETPU_FAULT_CORRUPT does not reach the C engine's "
                  "replay reads (corrupt native store files on disk "
                  "instead; the C CRC gate covers that path)",
                  file=sys.stderr, flush=True)

    def fetch(self, key, default=None):
        k = _enc(key)
        n = self._lib.retpu_store_get(self._handle, k, len(k), None, 0)
        if n < 0:
            return default
        buf = ctypes.create_string_buffer(n)
        n2 = self._lib.retpu_store_get(self._handle, k, len(k), buf, n)
        if n2 != n:  # pragma: no cover - single-threaded host
            return default
        return _dec(buf.raw)

    def exists(self, key) -> bool:
        k = _enc(key)
        return self._lib.retpu_store_get(self._handle, k, len(k),
                                         None, 0) >= 0

    def store(self, key, value) -> None:
        _storage_faults(self.fault_class, "write")
        k, v = _enc(key), _enc(value)
        self._lib.retpu_store_put(self._handle, k, len(k), v, len(v))

    def store_raw(self, k: bytes, v: bytes) -> None:
        """Append a pre-pickled record: identical framing to
        :meth:`store` of the decoded terms."""
        _storage_faults(self.fault_class, "write")
        self._lib.retpu_store_put(self._handle, k, len(k), v, len(v))

    def put_many_raw(self, arena, index) -> None:
        """One C call appends a whole arena of pre-pickled records
        ((key_off, key_len, val_off, val_len) rows; rows with
        key_len <= 0 are skipped): the per-flush WAL append of the
        native resolve path."""
        _storage_faults(self.fault_class, "write")
        a = np.ascontiguousarray(arena, np.uint8)
        idx = np.ascontiguousarray(index, np.int64)
        if idx.ndim != 2 or idx.shape[1] != 4:
            raise ValueError("arena index must be [n, 4] int64 rows")
        live = idx[idx[:, 1] > 0]
        if len(live) and (live.min() < 0 or
                          (live[:, 0] + live[:, 1]).max() > a.size or
                          (live[:, 2] + live[:, 3]).max() > a.size):
            raise ValueError("arena index rows outside the arena")
        self._lib.retpu_store_put_many(
            self._handle, a.ctypes.data_as(ctypes.c_void_p),
            idx.ctypes.data_as(ctypes.c_void_p), len(idx))

    def delete(self, key) -> None:
        _storage_faults(self.fault_class, "write")
        k = _enc(key)
        self._lib.retpu_store_delete(self._handle, k, len(k))

    def keys(self) -> Iterable:
        out: List[Any] = []
        i = 0
        while True:
            n = self._lib.retpu_store_key_at(self._handle, i, None, 0)
            if n < 0:
                break
            buf = ctypes.create_string_buffer(n)
            if self._lib.retpu_store_key_at(self._handle, i, buf,
                                            n) != n:  # pragma: no cover
                break
            out.append(_dec(buf.raw))
            i += 1
        return out

    def sync(self) -> None:
        if self.fault_class == "tree":
            # the WAL role has its own barriers (wal_fsync_pre / post
            # around the ServiceWAL sync call)
            faults.crashpoint("tree_save")
        faults.storage_raise(self.fault_class, "fsync")
        self._lib.retpu_store_sync(self._handle)

    def flush(self) -> None:
        """Flush only (no fsync): the process-crash durability floor."""
        self._lib.retpu_store_flush(self._handle)

    def compact(self) -> None:
        self._lib.retpu_store_compact(self._handle)

    def count(self) -> int:
        return self._lib.retpu_store_count(self._handle)

    def close(self) -> None:
        if self._handle:
            self._lib.retpu_store_close(self._handle)
            self._handle = None
