"""Paranoid blob persistence: 4 CRC-framed copies across 2 files.

Copied from ``riak_ensemble_tpu/save.py`` (the port keeps its own copy
so it imports nothing of the JAX package); only this paragraph and the
faults import are new.  The format is the reference's byte for byte, so
a ``META`` or ``CURRENT`` file either package wrote reads in the other.

Mirrors ``src/riak_ensemble_save.erl``: each file holds
``[CRC:32][Size:32][Data]`` (forward copy) followed by
``[Data][CRC:32][Size:32]`` (trailing copy, read back-to-front); the
same image is written to ``<file>`` and ``<file>.backup``
(save.erl:31-47).  Read tries forward copy, trailing copy, then the
backup file (save.erl:49-98).  Writes go through tmp+fsync+rename with
read-back verification (riak_ensemble_util:replace_file, util.erl:36-50),
then fsync the parent DIRECTORY — a rename without a directory fsync is
not crash-durable on ext4/xfs.

This is also a seam of the storage fault plane: every write
consults the ``ckpt`` path class (injected EIO/ENOSPC/torn writes),
every read passes the bit-flip corruption filter BEFORE the CRC check
(so an injected silent corruption must be caught by the 4-copy
format, never returned), and callers persisting checkpoint state pass
``crash_class="ckpt"`` to arm the ``ckpt_tmp_write``/``ckpt_rename``
crash points.
"""

from __future__ import annotations

import errno as _errno
import os
import zlib
from typing import Optional

from riak_ensemble_tpu_torch import faults


def _crc(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed/created entry inside it
    survives power loss.  Platforms that refuse O_RDONLY directory
    fds (or fsync on them: EINVAL/ENOTSUP/EBADF...) skip the
    directory fsync rather than failing the write — but the REAL
    bad-disk errnos (EIO/ENOSPC) re-raise: swallowing them would
    report a rename durable that the dying disk never made so,
    defeating the storage degradation signal."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError as exc:
        if exc.errno in (_errno.EIO, _errno.ENOSPC):
            raise
        return
    try:
        os.fsync(fd)
    except OSError as exc:
        if exc.errno in (_errno.EIO, _errno.ENOSPC):
            raise
    finally:
        os.close(fd)


def _replace_file(path: str, payload: bytes,
                  crash_class: Optional[str] = None) -> None:
    """tmp + fsync + rename + dir fsync + read-back verify
    (util.erl:36-50).  ``crash_class`` arms the two checkpoint crash
    points around the rename barrier."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    faults.storage_raise("ckpt", "write")
    tmp = path + ".tmp"
    cut = faults.torn_limit("ckpt")
    with open(tmp, "wb") as f:
        f.write(payload if cut is None else payload[:cut])
        f.flush()
        faults.storage_raise("ckpt", "fsync")
        os.fsync(f.fileno())
    if cut is not None:
        raise OSError(_errno.EIO,
                      f"injected torn checkpoint write at byte {cut}")
    if crash_class:
        faults.crashpoint(crash_class + "_tmp_write")
    os.rename(tmp, path)
    fsync_dir(os.path.dirname(path))
    if crash_class:
        faults.crashpoint(crash_class + "_rename")
    with open(path, "rb") as f:
        assert f.read() == payload, f"read-back verify failed for {path}"


def write(path: str, data: bytes,
          crash_class: Optional[str] = None) -> None:
    meta = _crc(data).to_bytes(4, "big") + len(data).to_bytes(4, "big")
    payload = meta + data + data + meta
    _replace_file(path, payload, crash_class)
    _replace_file(path + ".backup", payload, crash_class)


def _safe_read(raw: bytes) -> Optional[bytes]:
    # Forward copy: CRC, size, data.
    if len(raw) >= 8:
        crc = int.from_bytes(raw[0:4], "big")
        size = int.from_bytes(raw[4:8], "big")
        data = raw[8:8 + size]
        if len(data) == size and _crc(data) == crc:
            return data
    # Trailing copy: ...data, CRC, size at the very end.
    if len(raw) > 8:
        crc = int.from_bytes(raw[-8:-4], "big")
        size = int.from_bytes(raw[-4:], "big")
        if size <= len(raw) - 8:
            data = raw[-8 - size:-8]
            if _crc(data) == crc:
                return data
    return None


def read(path: str) -> Optional[bytes]:
    for p in (path, path + ".backup"):
        try:
            with open(p, "rb") as f:
                raw = f.read()
        except OSError:
            continue
        data = _safe_read(faults.read_filter("ckpt", raw))
        if data is not None:
            return data
    return None
