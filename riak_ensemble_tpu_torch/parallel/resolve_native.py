"""The resolve half's host passes: the packed-result unpack, the
mirror-slab scatter and the WAL encode.

Port of ``riak_ensemble_tpu/parallel/resolve_native.py`` (its unpack,
mirror scatter and WAL encode; the delta sections and the commutative
fold of ``csrc/host/resolvekernel.cc`` belong to the replication slice
and have no wrapper yet):

- :meth:`NativeResolve.unpack`: the packed device→host payload → full-
  width result planes in one C++ pass, the active-column scatter of a
  compacted or sliced launch included;
- :meth:`NativeResolve.scatter_mirrors`: a flush's committed writes and
  served reads → the service's ``_slot_vsn`` / ``_inline_value`` mirror
  slabs, in the per-op resolve loop's per-column round order;
- :meth:`NativeResolve.wal_encode`: a flush's committed keyed writes →
  one byte arena of protocol-4 pickled WAL records, byte-equal to
  ``pickle.dumps`` of the same terms (its plain version is the WAL's
  own :meth:`..wal.ServiceWAL.log`, which pickles each record).

:func:`unpack_results` and :func:`scatter_mirrors_plain` are their plain
versions: the unpack the service has always run, and the per-op loop's
mirror writes as one walk.  They compute the same bytes; the tests and
the chip smoke hold the C++ passes against them.

The library is the port's own build of the sources under
``csrc/host/`` (:func:`..ops.build.load_host`); a failed build raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from riak_ensemble_tpu_torch.ops import build

__all__ = ["get", "NativeResolve", "unpack_results", "scatter_mirrors_plain"]

#: the lowest C ABI version these wrappers speak
ABI_VERSION = 1


def get() -> "NativeResolve":
    """The wrapper over the host library, built first if needed."""
    return NativeResolve(build.load_host())


def _pt(a: Optional[np.ndarray]):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


def _check(name: str, a: np.ndarray, dtype, shape) -> None:
    if a.dtype != dtype or a.shape != shape or not a.flags.c_contiguous:
        raise TypeError(f"{name}: want a C-contiguous {np.dtype(dtype)} "
                        f"array of shape {shape}, got {a.dtype} {a.shape}")


class NativeResolve:
    """Thin, allocation-explicit wrapper over the C ABI.  Each method's
    output equals its plain version's bit for bit; a payload or plane
    that does not fit the layout raises."""

    def __init__(self, lib: ctypes.CDLL) -> None:
        p, i32 = ctypes.c_void_p, ctypes.c_int32
        lib.retpu_resolve_version.restype = ctypes.c_int
        lib.retpu_resolve_unpack.restype = ctypes.c_int
        lib.retpu_resolve_unpack.argtypes = [
            p, ctypes.c_int64, i32, i32, i32, i32, p, i32, i32, i32,
            p, p, p, p, p, p, p, p]
        lib.retpu_resolve_mirrors.restype = ctypes.c_int
        lib.retpu_resolve_mirrors.argtypes = [
            i32, i32, p, p, p, p, p, p, p, p, p, i32, i32,
            i32, i32, i32, i32, p, p, p, p, p]
        lib.retpu_wal_encode.restype = ctypes.c_int64
        lib.retpu_wal_encode.argtypes = [
            ctypes.c_int64, i32, p, p, p, p, p, p, p, p, p, p, p, p, p, p,
            p, p, ctypes.c_int64, p]
        if lib.retpu_resolve_version() < ABI_VERSION:
            raise RuntimeError("host library predates the resolve ABI")
        self._lib = lib

    def unpack(self, flat: np.ndarray, e: int, m: int, k: int,
               want_vsn: bool, active: Optional[np.ndarray],
               a_width: int, sliced: bool):
        """:func:`unpack_results` in one C pass: the same 8-tuple of
        full-width planes.  A payload shorter than the layout raises
        ``ValueError``."""
        flat = np.ascontiguousarray(flat, np.uint8)
        if active is not None:
            active = np.ascontiguousarray(active, np.int32)
            if active.size and (active.min() < 0 or active.max() >= e):
                raise ValueError("active column outside [0, E)")
        won = np.zeros((e,), bool)
        quorum = np.zeros((e,), bool)
        corrupt = np.zeros((e, m), bool)
        if k:
            committed = np.zeros((k, e), bool)
            get_ok = np.zeros((k, e), bool)
            found = np.zeros((k, e), bool)
            value = np.zeros((k, e), np.int32)
            vsn = np.zeros((k, e, 2), np.int32) if want_vsn else None
        else:
            # election-only launches carry no client planes; the pass
            # still unpacks the control planes
            committed = get_ok = found = value = vsn = None
        rc = self._lib.retpu_resolve_unpack(
            _pt(flat), flat.nbytes, e, m, k, int(want_vsn),
            _pt(active), 0 if active is None else len(active),
            a_width, int(bool(sliced)),
            _pt(won), _pt(quorum), _pt(corrupt),
            _pt(committed), _pt(get_ok), _pt(found),
            _pt(value), _pt(vsn))
        if rc != 0:
            raise ValueError(f"packed payload of {flat.nbytes} B does not "
                             f"hold the E={e} M={m} K={k} layout")
        return (won, quorum, corrupt, committed, get_ok, found,
                value, vsn)

    def scatter_mirrors(self, e_total: int, s_dim: int,
                        kind: np.ndarray, slot: np.ndarray,
                        committed: np.ndarray, get_ok: np.ndarray,
                        found: np.ndarray, value: np.ndarray,
                        vsn: Optional[np.ndarray],
                        cols: np.ndarray, kcounts: np.ndarray,
                        ack_reads: bool,
                        op_codes: Tuple[int, int, int, int],
                        vsn_np: np.ndarray, vsn_ok: np.ndarray,
                        inl_np: np.ndarray, inl_ok: np.ndarray,
                        inline_cls: np.ndarray) -> None:
        """Scatter a flush's committed mirror updates straight into the
        service's slabs (written in place), in the per-op resolve loop's
        per-column round order: :func:`scatter_mirrors_plain` in C."""
        k = kind.shape[0]
        kind = np.ascontiguousarray(kind, np.int32)
        slot = np.ascontiguousarray(slot, np.int32)
        value = np.ascontiguousarray(value, np.int32)
        # contiguous bool bytes (a view when the plane already is one)
        planes = {name: np.ascontiguousarray(a, np.bool_).view(np.uint8)
                  for name, a in (("committed", committed),
                                  ("get_ok", get_ok), ("found", found))}
        for name, a, dt in (("kind", kind, np.int32),
                            ("slot", slot, np.int32),
                            ("value", value, np.int32),
                            *((n, a, np.uint8) for n, a in planes.items())):
            _check(name, a, dt, (k, e_total))
        if vsn is not None:
            vsn = np.ascontiguousarray(vsn, np.int32)
            _check("vsn", vsn, np.int32, (k, e_total, 2))
        for name, a, dt, shape in (
                ("vsn_np", vsn_np, np.int32, (e_total, s_dim, 2)),
                ("vsn_ok", vsn_ok, np.bool_, (e_total, s_dim)),
                ("inl_np", inl_np, np.int32, (e_total, s_dim)),
                ("inl_ok", inl_ok, np.bool_, (e_total, s_dim)),
                ("inline_cls", inline_cls, np.bool_, (e_total, s_dim))):
            _check(name, a, dt, shape)
        cols = np.ascontiguousarray(cols, np.int32)
        kcounts = np.ascontiguousarray(kcounts, np.int32)
        if cols.shape != kcounts.shape or (cols.size and (
                cols.min() < 0 or cols.max() >= e_total
                or kcounts.min() < 0 or kcounts.max() > k)):
            raise ValueError("a taken column or its round count lies "
                             f"outside the [{k}, {e_total}] planes")
        op_put, op_cas, op_get, op_rmw = op_codes
        rc = self._lib.retpu_resolve_mirrors(
            e_total, s_dim, _pt(kind), _pt(slot), _pt(planes["committed"]),
            _pt(planes["get_ok"]), _pt(planes["found"]), _pt(value),
            _pt(vsn), _pt(cols), _pt(kcounts), len(cols),
            int(bool(ack_reads)), op_put, op_cas, op_get, op_rmw,
            _pt(vsn_np), _pt(vsn_ok), _pt(inl_np), _pt(inl_ok),
            _pt(inline_cls))
        if rc != 0:
            raise ValueError(f"mirror slabs of [{e_total}, {s_dim}] refused")

    def wal_encode(self, e_total: int, lane_j: np.ndarray,
                   lane_e: np.ndarray, lane_slot: np.ndarray,
                   lane_f2: np.ndarray, lane_inline: np.ndarray,
                   key_is_bytes: np.ndarray, key_off: np.ndarray,
                   key_len: np.ndarray, key_arena: bytes,
                   pay_off: np.ndarray, pay_len: np.ndarray,
                   pay_arena: bytes, committed: np.ndarray,
                   value: np.ndarray, vsn: np.ndarray
                   ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Pickle the flush's committed keyed WAL records into one
        preallocated byte arena (the reference's wrapper,
        ``resolve_native.py:164-200``).  Lane i is the record
        ``("kv", lane_e, lane_slot) -> (key, lane_f2, epoch, seq,
        payload, inline)`` of round ``lane_j``, written only when that
        round committed; an RMW lane (``lane_inline``) takes the
        computed value from ``value`` in place of ``lane_f2``.  Returns
        ``(arena_view, index)`` — ``index`` rows are (key_off, key_len,
        val_off, val_len) per lane, zero-length for uncommitted lanes —
        or None when the pass refuses (the caller pickles in Python)."""
        n = len(lane_j)
        k = committed.shape[0]
        for name, a in (("lane_j", lane_j), ("lane_e", lane_e),
                        ("lane_slot", lane_slot), ("lane_f2", lane_f2),
                        ("lane_inline", lane_inline),
                        ("key_is_bytes", key_is_bytes),
                        ("key_off", key_off), ("key_len", key_len),
                        ("pay_off", pay_off), ("pay_len", pay_len)):
            if a.shape != (n,) or not a.flags.c_contiguous:
                raise ValueError(f"{name}: want {n} contiguous lanes")
        if n and (lane_j.min() < 0 or lane_j.max() >= k
                  or lane_e.min() < 0 or lane_e.max() >= e_total
                  or (key_off + key_len).max() > len(key_arena)
                  or (pay_off + np.maximum(pay_len, 0)).max()
                  > len(pay_arena)):
            raise ValueError("a WAL lane lies outside its planes or "
                             "arenas")
        karr = np.frombuffer(key_arena, np.uint8)
        parr = np.frombuffer(pay_arena, np.uint8)
        # exact worst case per record pair: two PROTO+FRAME headers
        # (22), key pickle ("kv" + two ints <= 18), value pickle
        # (MARK/ints/bool/tuple overhead <= 30) + key and payload
        # bytes with their own opcode headers (<= 6 each)
        cap = int(76 * n + int(key_len.sum())
                  + int(np.maximum(pay_len, 0).sum()))
        arena = np.empty((max(cap, 1),), np.uint8)
        idx = np.zeros((n, 4), np.int64)
        used = self._lib.retpu_wal_encode(
            n, e_total, _pt(lane_j), _pt(lane_e), _pt(lane_slot),
            _pt(lane_f2), _pt(lane_inline), _pt(key_is_bytes),
            _pt(key_off), _pt(key_len), _pt(karr),
            _pt(pay_off), _pt(pay_len), _pt(parr),
            _pt(np.ascontiguousarray(committed, np.uint8)),
            _pt(np.ascontiguousarray(value, np.int32)),
            _pt(np.ascontiguousarray(vsn, np.int32)),
            _pt(arena), arena.nbytes, _pt(idx))
        if used < 0:
            return None
        return arena[:used], idx


# -- plain versions ----------------------------------------------------------


def unpack_results(flat: np.ndarray, e: int, m: int, k: int,
                   want_vsn: bool, active: Optional[np.ndarray] = None,
                   a_width: int = 0, sliced: bool = False):
    """Invert ``batched_host._pack_results_body``: one packed uint8 vector
    → ``(won, quorum_ok, corrupt, committed, get_ok, found, value, vsn)``
    full-width host arrays (the k == 0 planes are None); copied from
    the reference (batched_host.py:350-430).

    With ``active`` (the launch's active columns, packed at ``a_width``
    pow2-padded columns) the per-round planes arrive ``[K, A]`` and are
    scattered back to ``[K, E]``: inactive columns get the all-false /
    zero NOOP results.  ``sliced`` marks a launch whose step ran on the
    A rows only: then the won / quorum_ok / corrupt planes are A-wide
    too and scatter the same way."""
    aw = e if active is None else a_width
    hw = aw if sliced else e  # election/quorum/corrupt plane width
    nbits = 2 * hw + hw * m + 3 * k * aw
    bits = np.unpackbits(flat[:(nbits + 7) // 8],
                         count=nbits).astype(bool)
    ints = flat[(nbits + 7) // 8:].copy().view(np.int32)
    boff = ioff = 0

    def take_bits(n, shape=None):
        nonlocal boff
        out = bits[boff:boff + n]
        boff += n
        return out.reshape(shape) if shape is not None else out

    def take_ints(n, shape=None):
        nonlocal ioff
        out = ints[ioff:ioff + n]
        ioff += n
        return out.reshape(shape) if shape is not None else out

    won = take_bits(hw)
    quorum_ok = take_bits(hw)
    corrupt = take_bits(hw * m, (hw, m))
    if sliced and active is not None:
        a = len(active)

        def scat_cols(c, shape):
            out = np.zeros(shape, bool)
            out[active] = c[:a]
            return out
        won = scat_cols(won, (e,))
        quorum_ok = scat_cols(quorum_ok, (e,))
        corrupt = scat_cols(corrupt, (e, m))
    if k:
        committed = take_bits(k * aw, (k, aw))
        get_ok = take_bits(k * aw, (k, aw))
        found = take_bits(k * aw, (k, aw))
        value = take_ints(k * aw, (k, aw))
        vsn = None
        if want_vsn:
            vsn = np.stack([take_ints(k * aw, (k, aw)),
                            take_ints(k * aw, (k, aw))], axis=-1)
        if active is not None:
            a = len(active)

            def scatter(c, dtype):
                out = np.zeros((k, e) + c.shape[2:], dtype)
                out[:, active] = c[:, :a]
                return out
            committed = scatter(committed, bool)
            get_ok = scatter(get_ok, bool)
            found = scatter(found, bool)
            value = scatter(value, np.int32)
            if vsn is not None:
                vsn = scatter(vsn, np.int32)
    else:
        committed = get_ok = found = value = vsn = None
    return won, quorum_ok, corrupt, committed, get_ok, found, value, vsn


def scatter_mirrors_plain(e_total: int, s_dim: int, kind: np.ndarray,
                          slot: np.ndarray, committed: np.ndarray,
                          get_ok: np.ndarray, found: np.ndarray,
                          value: np.ndarray, vsn: Optional[np.ndarray],
                          cols: np.ndarray, kcounts: np.ndarray,
                          ack_reads: bool,
                          op_codes: Tuple[int, int, int, int],
                          vsn_np: np.ndarray, vsn_ok: np.ndarray,
                          inl_np: np.ndarray, inl_ok: np.ndarray,
                          inline_cls: np.ndarray) -> None:
    """:meth:`NativeResolve.scatter_mirrors` in Python: the mirror writes
    of the per-op resolve loop (``_resolve_flush``), per taken column in
    round order.  A committed put / CAS mirrors its version and drops the
    inline value (the slot flips to handle storage); a committed RMW
    mirrors its version and its computed value (0, the tombstone, drops
    it); a served read refreshes the version, and the inline value of a
    found, nonzero read of a device-native slot.  The storage class a
    read sees is ``inline_cls`` as this flush's earlier writes left it."""
    op_put, op_cas, op_get, op_rmw = op_codes
    overlay = {}
    for c, kc in zip(np.asarray(cols).tolist(), np.asarray(kcounts).tolist()):
        lanes = [p[:kc, c].tolist() for p in (kind, slot, committed, get_ok,
                                              found, value)]
        vs_l = vsn[:kc, c].tolist() if vsn is not None else [None] * kc
        for kd, s, comm, gok, fnd, v, vs in zip(*lanes, vs_l):
            if not 0 <= s < s_dim:
                continue
            if kd in (op_put, op_cas, op_rmw):
                if not comm:
                    continue
                if vs is not None:
                    vsn_np[c, s] = vs
                    vsn_ok[c, s] = True
                if kd == op_rmw:
                    if v:
                        inl_np[c, s] = v
                    inl_ok[c, s] = bool(v)   # a computed 0 = tombstone
                    overlay[(c, s)] = True
                else:
                    inl_ok[c, s] = False
                    overlay[(c, s)] = False
            elif kd == op_get:
                if not (gok and ack_reads):
                    continue
                if vs is not None:
                    vsn_np[c, s] = vs
                    vsn_ok[c, s] = True
                if fnd and v and overlay.get((c, s), inline_cls[c, s]):
                    inl_np[c, s] = v
                    inl_ok[c, s] = True
