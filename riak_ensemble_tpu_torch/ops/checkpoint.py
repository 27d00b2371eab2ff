"""Checkpoint and restore of the engine state, in the port's own format.

The reference writes its ``EngineState`` with orbax
(``riak_ensemble_tpu/ops/checkpoint.py``), which the card's machine does
not have; the two packages' checkpoints therefore do not cross (their
WAL generations and ``META`` files do).  The port's checkpoint of the
engine is ONE file, ``<dir>/engine``:

    b"RETE" | u32 header length | header | u32 CRC-32 of the planes
    | u64 planes length | the planes

The header is a protocol-4 pickle of ``[(field, dtype, shape), ...]`` in
``EngineState`` field order; the planes are each field's bytes, C order,
one after the other.  A restore gives back every plane bit for bit, on
the device it is asked for.  The file is written through
:func:`..save._replace_file` (tmp, fsync, rename, directory fsync,
read-back check) under the ``ckpt`` storage-fault class and crash points;
a read passes the ``ckpt`` bit-flip filter and a CRC mismatch raises,
so a damaged checkpoint is never served.

On CUDA the state moves to the host with one ``.cpu()`` per plane.
"""

from __future__ import annotations

import os
import pickle
import struct
import zlib

import numpy as np
import torch

from riak_ensemble_tpu_torch import faults, save
from riak_ensemble_tpu_torch.device import DeviceLike, resolve_device
from riak_ensemble_tpu_torch.ops.engine import EngineState

MAGIC = b"RETE"


def save_state(path: str, state: EngineState) -> None:
    """Write ``state`` to ``path`` (a directory; created) as
    ``path/engine``."""
    planes = [getattr(state, f).detach().cpu().contiguous().numpy()
              for f in EngineState._fields]
    header = pickle.dumps(
        [(f, a.dtype.str, a.shape)
         for f, a in zip(EngineState._fields, planes)], protocol=4)
    body = b"".join(a.tobytes() for a in planes)
    blob = b"".join((MAGIC, struct.pack("<I", len(header)), header,
                     struct.pack("<IQ", zlib.crc32(body), len(body)),
                     body))
    save._replace_file(os.path.join(path, "engine"), blob,
                       crash_class="ckpt")


def load_state(path: str, device: DeviceLike = None) -> EngineState:
    """Read ``path/engine`` back as an :class:`EngineState` on
    ``device`` (CUDA unless ``"cpu"``).  Raises ``ValueError`` on a
    damaged file (bad magic, header or CRC)."""
    dev = resolve_device(device)
    if os.path.isdir(os.path.join(path, "engine")):
        raise ValueError(f"{path}/engine is a directory, not a checkpoint "
                         f"of this package (the JAX package's format?)")
    with open(os.path.join(path, "engine"), "rb") as f:
        raw = faults.read_filter("ckpt", f.read())
    if raw[:4] != MAGIC or len(raw) < 8:
        raise ValueError(f"{path}/engine is not an engine checkpoint")
    (hlen,) = struct.unpack_from("<I", raw, 4)
    off = 8 + hlen
    if len(raw) < off + 12:
        raise ValueError(f"{path}/engine is truncated")
    crc, blen = struct.unpack_from("<IQ", raw, off)
    body = memoryview(raw)[off + 12:]
    if len(body) != blen or zlib.crc32(body) != crc:
        raise ValueError(f"{path}/engine fails its CRC: damaged "
                         f"checkpoint")
    try:
        layout = pickle.loads(raw[8:off])
    except (pickle.UnpicklingError, EOFError, ValueError) as exc:
        raise ValueError(f"{path}/engine: bad header") from exc
    if [f for f, _d, _s in layout] != list(EngineState._fields):
        raise ValueError(f"{path}/engine holds fields "
                         f"{[f for f, _d, _s in layout]}")
    planes = []
    pos = 0
    for _f, dtype, shape in layout:
        dt = np.dtype(dtype)
        n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        a = np.frombuffer(body[pos:pos + n], dt).reshape(shape)
        planes.append(torch.from_numpy(a.copy()).to(dev))
        pos += n
    if pos != blen:
        raise ValueError(f"{path}/engine: planes do not fill the file")
    return EngineState(*planes)
