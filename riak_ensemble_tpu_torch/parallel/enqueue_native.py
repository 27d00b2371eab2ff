"""The enqueue half's host passes: the pending-slab pack and the
completion-slab gather.

Port of ``riak_ensemble_tpu/parallel/enqueue_native.py``.  The service
keeps each flush's pending ops as a PENDING SLAB — per taken entry a run
descriptor (ensemble column, first plane row, run length, uniform op
kind) over concatenated int32 field lanes (slot, value or handle, the two
CAS-expectation halves) — and two passes walk those runs:

- :meth:`NativeEnqueue.pack`: the slab → the five ``[K, E]`` int32 op
  planes, in one C++ traversal (``csrc/host/enqueuekernel.cc``);
- :meth:`NativeEnqueue.gather`: the flush's result planes → the
  COMPLETION SLAB, ``[R]`` records in taken order.

:func:`pack_plain` and :func:`gather_plain` are their plain numpy
versions (the reference's fallbacks: one fancy index through
:func:`lane_indices`).  They compute the same bytes; the service runs them
only when asked (``plain_host_passes=True``), and the tests and the chip
smoke hold the C++ passes against them.

The library is the port's own build of the sources under
``csrc/host/`` (:func:`..ops.build.load_host`); a failed build raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from riak_ensemble_tpu_torch.ops import build

__all__ = ["get", "NativeEnqueue", "lane_indices", "pack_plain",
           "gather_plain"]

#: the C ABI version these wrappers speak (v1 took flat per-op lanes)
ABI_VERSION = 2


def get() -> "NativeEnqueue":
    """The wrapper over the host library, built first if needed."""
    return NativeEnqueue(build.load_host())


def _pt(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _i32(a: np.ndarray, name: str) -> None:
    if a.dtype != np.int32 or not a.flags.c_contiguous:
        raise TypeError(f"{name}: a C-contiguous int32 array is needed")


class NativeEnqueue:
    """Thin wrapper over the C ABI; outputs are written in place and
    equal the plain versions' bit for bit.  Both passes walk the pending
    slab's run descriptors, so the Python→C conversion cost scales with
    entries, not ops.  A run outside the ``[K, E]`` grid raises
    ``IndexError``."""

    def __init__(self, lib: ctypes.CDLL) -> None:
        p = ctypes.c_void_p
        head = [ctypes.c_int64, ctypes.c_int32, ctypes.c_int32]
        lib.retpu_enqueue_version.restype = ctypes.c_int
        lib.retpu_enqueue_pack.restype = ctypes.c_int
        lib.retpu_enqueue_pack.argtypes = head + [p] * 13
        lib.retpu_enqueue_gather.restype = ctypes.c_int
        lib.retpu_enqueue_gather.argtypes = head + [p] * 13
        if lib.retpu_enqueue_version() != ABI_VERSION:
            raise RuntimeError("host library speaks enqueue ABI "
                               f"{lib.retpu_enqueue_version()}, want "
                               f"{ABI_VERSION}")
        self._lib = lib

    def pack(self, k: int, e: int, ent_col: np.ndarray,
             ent_row0: np.ndarray, ent_len: np.ndarray,
             ent_kind: np.ndarray, slot: np.ndarray, val: np.ndarray,
             expe: np.ndarray, exps: np.ndarray,
             kind_p: np.ndarray, slot_p: np.ndarray,
             val_p: np.ndarray, expe_p: np.ndarray,
             exps_p: np.ndarray) -> None:
        """Scatter the pending slab into the five zero-initialized
        ``[K, E]`` int32 planes in one C traversal."""
        arrays = dict(ent_col=ent_col, ent_row0=ent_row0, ent_len=ent_len,
                      ent_kind=ent_kind, slot=slot, val=val, expe=expe,
                      exps=exps, kind_p=kind_p, slot_p=slot_p, val_p=val_p,
                      expe_p=expe_p, exps_p=exps_p)
        for name, a in arrays.items():
            _i32(a, name)
        for name in ("kind_p", "slot_p", "val_p", "expe_p", "exps_p"):
            if arrays[name].shape != (k, e):
                raise ValueError(f"{name}: shape {arrays[name].shape}, "
                                 f"want {(k, e)}")
        n_lanes = int(ent_len.sum())
        for name in ("slot", "val", "expe", "exps"):
            if arrays[name].size < n_lanes:
                raise ValueError(f"{name}: {arrays[name].size} lanes, the "
                                 f"runs take {n_lanes}")
        rc = self._lib.retpu_enqueue_pack(
            len(ent_col), k, e, *(_pt(a) for a in arrays.values()))
        if rc != 0:
            raise IndexError("a pending-slab run lies outside the "
                             f"[{k}, {e}] op grid")

    def gather(self, k: int, e: int, ent_col: np.ndarray,
               ent_row0: np.ndarray, ent_len: np.ndarray,
               committed: np.ndarray, get_ok: np.ndarray,
               found: np.ndarray, value: np.ndarray,
               vsn: np.ndarray, n_rows: int) -> Tuple[np.ndarray, ...]:
        """Result planes → completion slab: ``[R]`` records in taken
        order ``(ok, get_ok, found, value, vsn [R, 2])``, one C
        traversal.  The bool planes come as uint8 views
        (``batched_host._u8view``)."""
        for name, a, dt, shape in (
                ("committed", committed, np.uint8, (k, e)),
                ("get_ok", get_ok, np.uint8, (k, e)),
                ("found", found, np.uint8, (k, e)),
                ("value", value, np.int32, (k, e)),
                ("vsn", vsn, np.int32, (k, e, 2))):
            if a.dtype != dt or a.shape != shape \
                    or not a.flags.c_contiguous:
                raise TypeError(f"{name}: want a C-contiguous {dt.__name__} "
                                f"array of shape {shape}")
        for name, a in (("ent_col", ent_col), ("ent_row0", ent_row0),
                        ("ent_len", ent_len)):
            _i32(a, name)
        if int(ent_len.sum()) != n_rows:
            raise ValueError(f"the runs hold {int(ent_len.sum())} rows, "
                             f"not {n_rows}")
        out_ok = np.empty((n_rows,), np.uint8)
        out_gok = np.empty((n_rows,), np.uint8)
        out_fnd = np.empty((n_rows,), np.uint8)
        out_val = np.empty((n_rows,), np.int32)
        out_vsn = np.empty((n_rows, 2), np.int32)
        rc = self._lib.retpu_enqueue_gather(
            len(ent_col), k, e, _pt(ent_col), _pt(ent_row0),
            _pt(ent_len), _pt(committed), _pt(get_ok), _pt(found),
            _pt(value), _pt(vsn), _pt(out_ok), _pt(out_gok),
            _pt(out_fnd), _pt(out_val), _pt(out_vsn))
        if rc != 0:
            raise IndexError("a pending-slab run lies outside the "
                             f"[{k}, {e}] result grid")
        return (out_ok.view(bool), out_gok.view(bool),
                out_fnd.view(bool), out_val, out_vsn)


# -- plain versions ----------------------------------------------------------


def lane_indices(ent_col: np.ndarray, ent_row0: np.ndarray,
                 ent_len: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Flat (rows, cols) plane indices expanded from the pending slab's
    run descriptors (``_lane_indices``, batched_host.py:465-478): one
    ``np.repeat`` expansion, no Python loop."""
    ent_of = np.repeat(np.arange(len(ent_len)), ent_len)
    ends = np.cumsum(ent_len)
    starts = ends - ent_len
    within = np.arange(int(ends[-1]) if len(ends) else 0) \
        - starts[ent_of]
    return ent_row0[ent_of] + within, ent_col[ent_of]


def pack_plain(k: int, e: int, ent_col: np.ndarray, ent_row0: np.ndarray,
               ent_len: np.ndarray, ent_kind: np.ndarray, slot: np.ndarray,
               val: np.ndarray, expe: np.ndarray, exps: np.ndarray,
               kind_p: np.ndarray, slot_p: np.ndarray, val_p: np.ndarray,
               expe_p: np.ndarray, exps_p: np.ndarray) -> None:
    """:meth:`NativeEnqueue.pack` in numpy (batched_host.py:5385-5391)."""
    rows, cols = lane_indices(ent_col, ent_row0, ent_len)
    kind_p[rows, cols] = np.repeat(ent_kind, ent_len)
    slot_p[rows, cols] = slot
    val_p[rows, cols] = val
    expe_p[rows, cols] = expe
    exps_p[rows, cols] = exps


def gather_plain(k: int, e: int, ent_col: np.ndarray, ent_row0: np.ndarray,
                 ent_len: np.ndarray, committed: np.ndarray,
                 get_ok: np.ndarray, found: np.ndarray, value: np.ndarray,
                 vsn: np.ndarray, n_rows: int) -> Tuple[np.ndarray, ...]:
    """:meth:`NativeEnqueue.gather` in numpy (batched_host.py:6184-6190);
    the bool planes may be bool or their uint8 views."""
    rows, cols = lane_indices(ent_col, ent_row0, ent_len)
    return (committed[rows, cols].view(bool), get_ok[rows, cols].view(bool),
            found[rows, cols].view(bool), value[rows, cols],
            vsn[rows, cols])
