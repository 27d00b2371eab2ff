"""Synctree storage backends.

Copied from ``riak_ensemble_tpu/synctree/backends.py`` with its imports pointed at
this package, so the port imports nothing of the JAX package.

Reference: ``synctree_ets.erl`` / ``synctree_orddict.erl`` /
``synctree_leveldb.erl`` — all implement ``new/fetch/exists/store``.
Here: an in-memory dict backend (= ets/orddict), and a file-backed
backend that journals batches to an append-only CRC log (the role the
eleveldb C++ dependency plays for the reference; a C++ engine can slot
in behind the same interface — see ``native/``).
"""

from __future__ import annotations

import os
import pickle
import zlib
from typing import Any, Dict, Iterable, Tuple

from riak_ensemble_tpu_torch import faults
from riak_ensemble_tpu_torch.save import fsync_dir


class DictBackend:
    """synctree_ets/synctree_orddict equivalent."""

    def __init__(self) -> None:
        self.data: Dict[Any, Any] = {}

    def fetch(self, key, default=None):
        return self.data.get(key, default)

    def exists(self, key) -> bool:
        return key in self.data

    def store(self, key, value) -> None:
        self.data[key] = value

    def delete(self, key) -> None:
        self.data.pop(key, None)

    def keys(self) -> Iterable:
        return list(self.data.keys())


class FileBackend(DictBackend):
    """Persistent backend: in-memory dict + append-only CRC32-framed
    journal, compacted on open.  Plays eleveldb's role for synctree
    persistence (synctree_leveldb.erl:104-161; batched writes
    ``store/2:141-152``).  Key layout note (tree_id scoping for shared
    trees) is handled by the caller via key prefixing.
    """

    #: storage fault-plane path class (docs/ARCHITECTURE.md §15)
    fault_class = "tree"

    def __init__(self, path: str) -> None:
        super().__init__()
        self.path = path
        #: CRC-detected replay stops (corrupt/torn frames dropped,
        #: never served) — the detection evidence counter
        self.truncations = 0
        self.truncated_bytes = 0
        #: CRC-failed frames healed by a one-shot re-read (transient
        #: read corruption, not on-disk damage)
        self.read_retries = 0
        os.makedirs(os.path.dirname(path), exist_ok=True)
        existed = os.path.exists(path)
        self._replay()
        self._fh = open(self.path, "ab")
        if not existed:
            fsync_dir(os.path.dirname(path))

    def _replay(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            raw = f.read()
        pos = 0
        while pos + 8 <= len(raw):
            size = int.from_bytes(raw[pos:pos + 4], "big")
            crc = int.from_bytes(raw[pos + 4:pos + 8], "big")
            frame = faults.read_filter(self.fault_class,
                                       raw[pos + 8:pos + 8 + size])
            if len(frame) == size \
                    and (zlib.crc32(frame) & 0xFFFFFFFF) != crc:
                # one-shot re-read FROM DISK before trusting the
                # mismatch: a transient bad read heals on a real
                # retry; dropping the tail on it would discard
                # healthy on-disk frames behind it
                self.read_retries += 1
                with open(self.path, "rb") as rf:
                    rf.seek(pos + 8)
                    frame = faults.read_filter(self.fault_class,
                                               rf.read(size))
            if len(frame) < size or (zlib.crc32(frame) & 0xFFFFFFFF) != crc:
                # torn tail write or corrupt frame: DETECTED by the
                # CRC gate — stop replay here (count the evidence;
                # what was dropped heals from a live replica via the
                # exchange path, it is never served)
                self.truncations += 1
                self.truncated_bytes += len(raw) - pos
                break
            op, key, value = pickle.loads(frame)
            if op == "put":
                self.data[key] = value
            else:
                self.data.pop(key, None)
            pos += 8 + size
        # Compact: rewrite only the live image.
        tmp = self.path + ".compact"
        with open(tmp, "wb") as f:
            for key, value in self.data.items():
                f.write(self._frame(("put", key, value)))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        fsync_dir(os.path.dirname(self.path))

    @staticmethod
    def _frame(record: Tuple) -> bytes:
        blob = pickle.dumps(record)
        crc = zlib.crc32(blob) & 0xFFFFFFFF
        return len(blob).to_bytes(4, "big") + crc.to_bytes(4, "big") + blob

    def store(self, key, value) -> None:
        faults.storage_raise(self.fault_class, "write")
        super().store(key, value)
        self._fh.write(self._frame(("put", key, value)))

    def delete(self, key) -> None:
        faults.storage_raise(self.fault_class, "write")
        super().delete(key)
        self._fh.write(self._frame(("del", key, None)))

    def sync(self) -> None:
        self._fh.flush()
        faults.crashpoint("tree_save")
        faults.storage_raise(self.fault_class, "fsync")
        os.fsync(self._fh.fileno())

    def close(self) -> None:
        self._fh.close()
