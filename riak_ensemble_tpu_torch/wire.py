"""Restricted wire codec for the TCP transport.

Copied from ``riak_ensemble_tpu/wire.py``, so the port imports nothing
of the JAX package: the same tags, varints, record table and raw-buffer
section, so a frame encodes to the same bytes in both packages and
decodes to each package's own record classes.  One difference: the C++
codec is the port's own build (``csrc/host/wirecodec.cc`` through
:func:`..ops.build.load_wire`), and a failed build RAISES where the
reference falls back to the Python codec.  ``RETPU_NO_NATIVE_WIRE=1``
pins the Python codec, as in the reference.

The reference ships terms over disterl, whose decoder constructs only
plain Erlang terms — it can never execute code.  This codec gives the
TCP transport (:mod:`.netruntime`) the same property:
:func:`decode` builds values exclusively from an allowlist of plain
containers and the protocol's registered record types.  A hostile peer
that can reach the node port can at worst inject a well-formed protocol
message (the disterl trust model without the cookie); it cannot make
the decoder run arbitrary code the way ``pickle.loads`` would.

Format: one tag byte per value, then a payload.  Sizes/counts are
unsigned varints; ints are sign-magnitude big-endian byte strings so
arbitrary precision survives.  Containers are count-prefixed element
sequences; registered records are a type code plus their field values
in declaration order.

Anything not encodable (actor refs, futures, closures) raises
:class:`WireError` at *encode* time — the transport drops such frames
as local-only, exactly as it did for unpicklable values.

Raw-buffer section (the zero-copy bulk lane): a frame whose value
contains :class:`Raw` wrappers encodes via :func:`encode_parts` into a
``'B'``-tagged payload — a buffer-length table, the term section (in
which each Raw leaf is a 1-byte-tagged index reference), then the raw
bytes themselves, UNCOPIED: ``encode_parts`` returns the header plus
the callers' own buffers for a scatter-gather write, so a bulk numpy
plane rides after the term codec without ever being concatenated into
an intermediate bytes.  :func:`decode` resolves the references to
memoryview slices of the received payload (no second copy on the
receive side either).  The allowlist property is unchanged — a buffer
decodes to plain read-only memory, never code.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

from riak_ensemble_tpu_torch.state import ClusterState
from riak_ensemble_tpu_torch.types import (EnsembleInfo, Fact, NOTFOUND,
                                           Obj, PeerId)

__all__ = ["encode", "decode", "encode_parts", "Raw", "WireError"]


class WireError(Exception):
    """Value outside the wire allowlist, or a malformed frame."""


class Raw:
    """Zero-copy bulk-buffer wrapper for :func:`encode_parts`.

    Wraps anything exposing the buffer protocol (bytes, memoryview, a
    C-contiguous numpy array's ``.data``).  Inside a frame value a Raw
    encodes as a small index reference; the buffer itself rides after
    the term section, handed back verbatim by ``encode_parts`` so the
    sender can scatter-gather it onto the socket without a copy.  On
    decode the reference resolves to a read-only memoryview slice of
    the received payload."""

    __slots__ = ("buf",)

    def __init__(self, buf) -> None:
        m = memoryview(buf)
        if not m.contiguous:
            raise WireError("Raw buffer must be contiguous")
        if m.nbytes == 0:
            # cast("B") rejects zero-in-shape views; an empty buffer
            # is just the empty byte run
            self.buf = memoryview(b"")
        else:
            self.buf = (m.cast("B") if m.format != "B" or m.ndim != 1
                        else m)


_F64 = struct.Struct(">d")

#: recursion guard, both directions: protocol messages are shallow (a
#: gossip ClusterState inside a tuple is the deepest real frame).  On
#: encode it also turns pathological user values (1000-deep nesting,
#: self-referential containers) into WireError instead of
#: RecursionError, so the transport's drop path handles them.
_MAX_DEPTH = 32

# Registered record types: code -> (class, field names).  Field values
# recurse through the same codec, so nested records (a Fact's PeerId,
# a ClusterState's EnsembleInfo dict) need no special casing.
_RECORDS: Tuple[Tuple[type, Tuple[str, ...]], ...] = (
    (PeerId, ("name", "node")),
    (Obj, ("epoch", "seq", "key", "value")),
    (Fact, ("epoch", "seq", "leader", "views", "view_vsn", "pend_vsn",
            "commit_vsn", "pending")),
    (EnsembleInfo, ("vsn", "leader", "views", "seq", "mod", "args")),
    (ClusterState, ("id", "enabled", "members_vsn", "members",
                    "ensembles", "pending")),
)
_RECORD_BY_CLS = {cls: (code, fields)
                  for code, (cls, fields) in enumerate(_RECORDS)}


def _put_uvarint(out: List[bytes], n: int) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(bytes((b | 0x80,)))
        else:
            out.append(bytes((b,)))
            return


def _encode(out: List[bytes], v: Any, depth: int = 0,
            bufs: "List[memoryview]" = None) -> None:
    if depth > _MAX_DEPTH:
        raise WireError("value too deeply nested")
    t = type(v)
    if t is Raw:
        if bufs is None:
            raise WireError(
                "Raw buffers need encode_parts (raw-frame encoding)")
        out.append(b"r")
        _put_uvarint(out, len(bufs))
        bufs.append(v.buf)
        return
    if v is None:
        out.append(b"N")
    elif t is bool:
        out.append(b"T" if v else b"F")
    elif t is int:
        raw = v.to_bytes((v.bit_length() + 8) // 8 or 1, "big", signed=True)
        out.append(b"i")
        _put_uvarint(out, len(raw))
        out.append(raw)
    elif t is float:
        out.append(b"f" + _F64.pack(v))
    elif t is str:
        raw = v.encode("utf-8")
        out.append(b"s")
        _put_uvarint(out, len(raw))
        out.append(raw)
    elif t is bytes:
        out.append(b"b")
        _put_uvarint(out, len(v))
        out.append(v)
    elif t is tuple or t is list or t is set or t is frozenset:
        out.append({tuple: b"t", list: b"l", set: b"e", frozenset: b"z"}[t])
        _put_uvarint(out, len(v))
        for item in v:
            _encode(out, item, depth + 1, bufs)
    elif t is dict:
        out.append(b"d")
        _put_uvarint(out, len(v))
        for k, val in v.items():
            _encode(out, k, depth + 1, bufs)
            _encode(out, val, depth + 1, bufs)
    elif v is NOTFOUND:
        out.append(b"0")
    elif t in _RECORD_BY_CLS:
        code, fields = _RECORD_BY_CLS[t]
        out.append(b"R")
        _put_uvarint(out, code)
        for name in fields:
            _encode(out, getattr(v, name), depth + 1, bufs)
    else:
        raise WireError(f"type {t.__name__} is not wire-encodable")


def encode_py(v: Any) -> bytes:
    """Pure-Python encoder (fallback + differential-test oracle for
    the native codec)."""
    out: List[bytes] = []
    _encode(out, v)
    return b"".join(out)


def encode(v: Any) -> bytes:
    """Serialize an allowlisted value to a wire frame payload.

    Routed through the C++ codec (``native/wirecodec.cc`` — the
    disterl-term-codec-in-C role) when it builds; byte-exact with
    :func:`encode_py`, so native and Python frames are
    interchangeable on the wire.
    """
    native = _native_codec()
    if native is not None:
        return native.encode(v)
    return encode_py(v)


def encode_parts(v: Any) -> List[Any]:
    """Serialize a value that may contain :class:`Raw` buffers into a
    raw frame, WITHOUT copying the buffers.

    Returns ``[header, buf0, buf1, ...]``: the header bytes (the
    ``'B'`` tag, the buffer-length table and the term section) followed
    by the wrapped buffers in reference order.  The frame payload on
    the wire is the plain concatenation of the parts — hand the list to
    a scatter-gather send (``socket.sendmsg``) and the bulk planes go
    from their owning arrays straight to the kernel.  A value with no
    Raw leaves still encodes as a (bufferless) raw frame, so callers
    need not special-case.  The term walk runs in Python — it is the
    SMALL section by design; the native codec's role on this path is
    the decode side."""
    out: List[bytes] = []
    bufs: List[memoryview] = []
    _encode(out, v, 0, bufs)
    head: List[bytes] = [b"B"]
    _put_uvarint(head, len(bufs))
    for b in bufs:
        _put_uvarint(head, b.nbytes)
    return [b"".join(head + out)] + bufs


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes) -> None:
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if n < 0 or end > len(self.buf):
            raise WireError("truncated frame")
        chunk = self.buf[self.pos:end]
        self.pos = end
        return chunk

    def uvarint(self) -> int:
        shift = 0
        n = 0
        while True:
            byte = self.take(1)[0]
            n |= (byte & 0x7F) << shift
            if not byte & 0x80:
                return n
            shift += 7
            if shift > 63:
                raise WireError("varint too long")


def _decode(r: _Reader, depth: int,
            bufs: "List[memoryview]" = None) -> Any:
    if depth > _MAX_DEPTH:
        raise WireError("frame too deep")
    tag = r.take(1)
    if tag == b"r":
        idx = r.uvarint()
        if bufs is None or idx >= len(bufs):
            raise WireError(f"buffer ref {idx} outside raw frame")
        return bufs[idx]
    if tag == b"N":
        return None
    if tag == b"T":
        return True
    if tag == b"F":
        return False
    if tag == b"i":
        return int.from_bytes(r.take(r.uvarint()), "big", signed=True)
    if tag == b"f":
        return _F64.unpack(r.take(8))[0]
    if tag == b"s":
        try:
            return r.take(r.uvarint()).decode("utf-8")
        except UnicodeDecodeError as exc:
            raise WireError(f"bad utf-8 in frame: {exc}") from None
    if tag == b"b":
        return r.take(r.uvarint())
    if tag in (b"t", b"l", b"e", b"z"):
        n = r.uvarint()
        items = [_decode(r, depth + 1, bufs) for _ in range(n)]
        if tag == b"t":
            return tuple(items)
        if tag == b"l":
            return items
        try:  # unhashable members are a malformed frame, not a crash
            if tag == b"e":
                return set(items)
            return frozenset(items)
        except TypeError as exc:
            raise WireError(f"unhashable set member: {exc}") from None
    if tag == b"d":
        n = r.uvarint()
        try:
            return {_decode(r, depth + 1, bufs):
                    _decode(r, depth + 1, bufs)
                    for _ in range(n)}
        except TypeError as exc:
            raise WireError(f"unhashable dict key: {exc}") from None
    if tag == b"0":
        return NOTFOUND
    if tag == b"R":
        code = r.uvarint()
        if code >= len(_RECORDS):
            raise WireError(f"unknown record code {code}")
        cls, fields = _RECORDS[code]
        vals = [_decode(r, depth + 1, bufs) for _ in fields]
        return cls(**dict(zip(fields, vals)))
    raise WireError(f"unknown tag {tag!r}")


def _decode_raw_frame(payload: bytes) -> Any:
    """Decode a ``'B'``-tagged raw frame: length table, term section,
    then the raw bytes — resolved as read-only memoryview slices of
    ``payload`` (the receive-side zero-copy half)."""
    mv = memoryview(payload)
    r = _Reader(payload)
    r.take(1)  # the 'B' tag
    nbufs = r.uvarint()
    lens = [r.uvarint() for _ in range(nbufs)]
    total = sum(lens)
    data_start = len(payload) - total
    if data_start < r.pos:
        raise WireError("raw-buffer table exceeds frame")
    bufs: List[memoryview] = []
    off = data_start
    for n in lens:
        bufs.append(mv[off:off + n])
        off += n
    v = _decode(r, 0, bufs)
    if r.pos != data_start:
        raise WireError("trailing bytes in frame")
    return v


def decode_py(payload: bytes) -> Any:
    """Pure-Python decoder (fallback + differential-test oracle)."""
    if payload[:1] == b"B":
        return _decode_raw_frame(payload)
    r = _Reader(payload)
    v = _decode(r, 0)
    if r.pos != len(payload):
        raise WireError("trailing bytes in frame")
    return v


def decode(payload: bytes) -> Any:
    """Deserialize a frame payload; raises WireError on anything
    malformed or outside the allowlist.  Routed through the C++
    codec when available (same allowlist property: the native decoder
    constructs only plain containers and registered records)."""
    native = _native_codec()
    if native is not None:
        return native.decode(payload)
    return decode_py(payload)


_NATIVE = None
_NATIVE_TRIED = False


def _native_codec():
    """Build, load and register the C++ codec once; None only when
    ``RETPU_NO_NATIVE_WIRE=1`` pins the Python paths (the differential
    tests' oracle arm, and an operational escape hatch).  A codec that
    cannot be built or registered raises."""
    global _NATIVE, _NATIVE_TRIED
    if _NATIVE_TRIED:
        return _NATIVE
    import os

    if os.environ.get("RETPU_NO_NATIVE_WIRE"):
        _NATIVE_TRIED = True
        return None
    from riak_ensemble_tpu_torch.ops import build

    mod = build.load_wire()
    mod.register([(cls, fields) for cls, fields in _RECORDS],
                 NOTFOUND, WireError)
    _NATIVE = mod
    _NATIVE_TRIED = True
    return _NATIVE
