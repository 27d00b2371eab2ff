"""Network front-end of the keyed service: the main path's entry.

Copied from ``riak_ensemble_tpu/svcnode.py`` (:class:`ServiceServer`,
:class:`ServiceClient`, :func:`serve`, :func:`main`), on the port's own
:mod:`.wire`, :mod:`.netruntime` and
:class:`.parallel.batched_host.BatchedEnsembleService`, so it imports
nothing of the JAX package.  The frames are the reference's byte for
byte, so a client of either package talks to a server of either.  One
difference: the service's device is an argument of :func:`serve` and
the ``--device`` flag of ``python -m riak_ensemble_tpu_torch.svcnode``
(the card unless ``cpu`` is asked for).  ``--mesh-devices N`` serves
from a mesh engine (:func:`.parallel.mesh.mesh_engine`) sharded over N
devices along the 'ens' axis: the first N cards, or N shards of the
``--device`` given (``--device cpu`` is a CPU mesh of N shards).

An asyncio TCP server exposes a :class:`BatchedEnsembleService` — the
engine-backed thousands-of-ensembles K/V plane — to remote clients; the
service's timer runs on the same loop (:class:`.netruntime.NetRuntime`),
so a flush and the wait for its packed result run on the event loop, as
in the reference.

Protocol: length-prefixed frames in the restricted wire codec
(:mod:`.wire` — no code execution on decode).  Requests are
``(req_id, op, args...)`` tuples; each gets one ``(req_id, result)``
response, resolved when the op's flush lands, so a client can pipeline
requests and correlate out-of-order completions:

    ("kput", ens, key, value)        -> ("ok", (epoch, seq)) | "failed"
    ("kget", ens, key)               -> ("ok", value|NOTFOUND) | "failed"
    ("kget_vsn", ens, key)           -> ("ok", value, vsn) | "failed"
    ("kupdate", ens, key, vsn, val)  -> ("ok", new_vsn) | "failed"
    ("kput_once", ens, key, val)     -> ("ok", vsn) | "failed"
    ("kdelete", ens, key)            -> ("ok", vsn) | ("ok", NOTFOUND
                                        when no such key) | "failed"
    ("ksafe_delete", ens, key, vsn)  -> ("ok", new_vsn) | "failed"
    ("kput_many", ens, keys, vals)   -> [per-key results, in order]
    ("kget_many", ens, keys)         -> [per-key results, in order]
    ("kupdate_many", ens, keys, vsns, vals) / ("kdelete_many",
    ens, keys)                       -> [per-key results, in order]
    ("kput_slab", ens, key_lens, key_arena, val_lens, val_arena)
                                     -> [per-key results, in order]
    ("kget_slab", ens, key_lens, key_arena[, want_vsn])
                                     -> [per-key results, in order]

    ("stats",)                       -> dict
    ("controller",)                  -> dict: the runtime controller's
                                       health section + its full
                                       retained decision journal
                                       (docs/ARCHITECTURE.md §14;
                                       `--autotune` arms actuation)
    ("metrics",)                     -> dict: the service's full obs
                                       registry snapshot (counters,
                                       gauges, histograms, per-tenant
                                       attribution; docs/
                                       ARCHITECTURE.md §11)
    ("metrics", "prometheus")        -> str: the same registry in
                                       Prometheus text exposition
                                       format (scrape-ready)
    ("health",)                      -> dict: ensemble-health summary
                                       (leadered/electing/corrupt row
                                       counts, lease validity, WAL/
                                       queue/pending-write depths) —
                                       host mirrors only, zero device
                                       rounds (the cluster-status
                                       analog; ARCHITECTURE §11).
                                       While a fault-injection plan
                                       is armed (env fault knobs or
                                       programmatic) it carries an
                                       ``injected`` section — rules +
                                       counters — so an operator can
                                       tell a running nemesis from a
                                       real outage (ARCHITECTURE §13)
    ("health", ens)                  -> dict: one row's leader,
                                       lease validity + remaining,
                                       election churn, corrupt flag,
                                       committed (epoch, seq) high-
                                       water, queue/pending depths
    ("fleet", "metrics")             -> dict: every group host's
                                       registry snapshot under host
                                       labels + per-link clock-offset
                                       estimates (leader pulls its
                                       replicas over the obsq
                                       sideband; ARCHITECTURE §11)
    ("fleet", "metrics",
     "prometheus")                   -> str: ONE merged Prometheus
                                       scrape for the whole fleet,
                                       every sample host-labeled
    ("fleet", "health")              -> dict: every host's health
                                       section, host-labeled
    ("fleet", "timeline", fid)       -> dict: the clock-aligned
                                       cross-host timeline of one
                                       flush — leader and replica
                                       spans on ONE axis, honest to
                                       the estimated offset bounds

Reads (``kget``/``kget_vsn``/``kget_many``) are served through the
service's lease-protected fast path when its conditions hold — the
response arrives without waiting for a flush; semantics are
unchanged (linearizable).  ``--no-fast-reads`` opts out;
``("stats",)`` reports ``read_fastpath_hits``/``misses`` with
per-reason miss counters and the live ``lease_valid_fraction``.

The ``*_slab`` verbs are the zero-copy batched lane
(docs/ARCHITECTURE.md §12b): whole client-side op slabs — an int32
byte-length table plus one joined arena per column, ascii keys /
bytes payloads — ride a ``wire.Raw``/``encode_parts`` raw frame
client→leader the way PR 5's delta frames already ride
leader→replica, so a 10k-key batch decodes as a handful of term
objects + arena slices instead of 10k per-key containers.
:class:`ServiceClient`'s ``kput_many``/``kget_many`` route through
them automatically whenever the batch fits the slab subset (all-str
ascii keys, all-bytes values) and fall back to the legacy list verbs
otherwise — byte-exotic batches lose nothing.

Dynamic-lifecycle ops (service constructed with ``dynamic=True``;
the runtime create/destroy surface of
``riak_ensemble_manager:create_ensemble``, manager.erl:157-166):

    ("create_ensemble", name[, view]) -> ("ok", ens_id) |
                                         ("error", "no-capacity")
    ("destroy_ensemble", name)        -> ("ok",) | ("error", "unknown")
    ("resolve_ensemble", name)        -> ("ok", ens_id) |
                                         ("error", "unknown")

Malformed or non-allowlisted frames drop the connection (the codec
cannot construct anything outside the protocol types).

    python -m riak_ensemble_tpu_torch.svcnode --port 7601 \
        --n-ens 1024 --n-peers 5 --n-slots 128 [--fast] [--device cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import itertools
import os
import struct
import sys
from typing import Any, Dict, Optional, Tuple

from riak_ensemble_tpu_torch import faults, wire
from riak_ensemble_tpu_torch.config import Config, fast_test_config
from riak_ensemble_tpu_torch.device import DeviceLike
from riak_ensemble_tpu_torch.netruntime import NetRuntime
from riak_ensemble_tpu_torch.parallel.batched_host import (
    BatchedEnsembleService)

_HDR = struct.Struct(">I")
_MAX_FRAME = 16 << 20


class _Coalescer:
    """One connection's outgoing frames: everything written in one turn
    of the event loop leaves in ONE transport write at the end of that
    turn, so a burst of N pipelined frames reaches the peer as a few
    large segments instead of 2N small ones.  The byte stream is the
    same.  Under a user-space TCP stack (gVisor's netstack, ``runsc``)
    a receiver whose loop is busy while ~1,660 small segments arrive
    stops reopening its window: the sender then moves one segment per
    200 ms zero-window probe and a burst of 1,000 frames never finishes
    (``pipeline_probe.py``).  ``after`` runs after each write."""

    def __init__(self, writer: asyncio.StreamWriter, after=None) -> None:
        self._writer = writer
        self._after = after
        self._parts: list = []

    def write(self, *parts: Any) -> None:
        if not self._parts:
            asyncio.get_running_loop().call_soon(self._flush)
        self._parts.extend(parts)

    def _flush(self) -> None:
        parts, self._parts = self._parts, []
        if self._writer.is_closing():
            return
        self._writer.write(b"".join(parts))
        if self._after is not None:
            self._after()


def _slab_lens(lens_buf, arena_buf) -> "np.ndarray":
    """Validate one slab column's int32 byte-length table against its
    arena (trust boundary: both arrive off the network) and return
    the cumulative offsets [n+1].  Little-endian on the wire — the
    delta lane's existing raw-plane contract."""
    import numpy as np
    lens = np.frombuffer(lens_buf, dtype="<i4")
    if len(lens) and int(lens.min()) < 0:
        raise ValueError("negative slab length")
    offs = np.zeros((len(lens) + 1,), np.int64)
    np.cumsum(lens, out=offs[1:])
    if int(offs[-1]) != memoryview(arena_buf).nbytes:
        raise ValueError("slab arena size mismatch")
    return offs


def _slab_keys(lens_buf, arena_buf) -> list:
    """Key slab -> key list: ONE arena decode (the client's slab lane
    is ascii-only, so char offsets equal byte offsets) + one slice
    per key."""
    offs = _slab_lens(lens_buf, arena_buf)
    s = bytes(arena_buf).decode("ascii")
    o = offs.tolist()
    return [s[o[i]:o[i + 1]] for i in range(len(o) - 1)]


def _slab_vals(lens_buf, arena_buf) -> list:
    """Value slab -> bytes list: memoryview slices of the received
    frame, materialized per value (the payload store owns them past
    the frame's lifetime)."""
    offs = _slab_lens(lens_buf, arena_buf)
    mv = memoryview(arena_buf)
    o = offs.tolist()
    return [bytes(mv[o[i]:o[i + 1]]) for i in range(len(o) - 1)]


#: per-connection backpressure bounds: a client may pipeline at most
#: this many unresolved ops (further frames stay in the TCP receive
#: path — flow control rides the transport), and a client that stops
#: READING while the server responds is dropped once the send buffer
#: passes the cap (it can reconnect; unbounded buffering cannot be
#: taken back).
_MAX_INFLIGHT = 1024
_MAX_WRITE_BUF = 8 << 20


class ServiceServer:
    """TCP front-end around one BatchedEnsembleService."""

    def __init__(self, svc: BatchedEnsembleService,
                 host: str = "127.0.0.1", port: int = 0) -> None:
        self.svc = svc
        self.host, self.port = host, port
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> Tuple[str, int]:
        # the C++ codec is built (or found) and loaded before the first
        # client connects, so no client's frame pays for the build
        wire._native_codec()
        self._server = await asyncio.start_server(
            self._on_client, self.host, self.port)
        addr = self._server.sockets[0].getsockname()
        self.host, self.port = addr[0], addr[1]
        return self.host, self.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        self.svc.stop()

    def _dispatch(self, op: str, args: tuple):
        svc = self.svc
        if args:
            # The ensemble index comes from the network: reject
            # anything outside [0, n_ens) — Python negative indexing
            # would otherwise alias ens=-1 onto ensemble n_ens-1,
            # crossing the trust boundary.
            ens = args[0]
            if type(ens) is not int or not 0 <= ens < svc.n_ens:
                raise ValueError(f"bad ensemble index {ens!r}")
        if op == "kput":
            return svc.kput(*args)
        if op == "kget":
            return svc.kget(*args)
        if op == "kput_many":
            return svc.kput_many(*args)
        if op == "kget_many":
            return svc.kget_many(*args)
        if op == "kput_slab":
            # zero-copy batched lane: decode = arena slicing, not
            # per-key term decode (malformed tables raise here and
            # answer bad-request)
            return svc.kput_many(ens, _slab_keys(args[1], args[2]),
                                 _slab_vals(args[3], args[4]))
        if op == "kget_slab":
            return svc.kget_many(
                ens, _slab_keys(args[1], args[2]),
                want_vsn=bool(args[3]) if len(args) > 3 else False)
        if op == "kupdate_many":
            return svc.kupdate_many(*args)
        if op == "kdelete_many":
            return svc.kdelete_many(*args)
        if op == "kget_vsn":
            return svc.kget_vsn(*args)
        if op == "kupdate":
            return svc.kupdate(*args)
        if op == "kmodify":
            # mod_fun arrives as a wire-safe funref tuple; resolution
            # (and rejection of unregistered names) happens inside
            # kmodify — the no-code-on-decode trust model holds
            return svc.kmodify(*args)
        if op == "kmodify_many":
            return svc.kmodify_many(*args)
        if op == "kput_once":
            return svc.kput_once(*args)
        if op == "kdelete":
            return svc.kdelete(*args)
        if op == "ksafe_delete":
            return svc.ksafe_delete(*args)
        return None

    def _lifecycle(self, op: str, args: tuple):
        """Synchronous dynamic-ensemble ops (no flush involved): each
        drains the launch pipeline and runs one ``reset_rows`` on the
        service's device, on the event loop."""
        try:
            name = args[0]
            if op == "create_ensemble":
                view = None
                if len(args) > 1 and args[1] is not None:
                    import numpy as np
                    view = np.asarray(args[1], bool)
                if name in self.svc._ens_names:
                    # duplicate != capacity (an orchestrator must not
                    # provision more rows over an idempotent retry)
                    return ("error", "exists")
                row = self.svc.create_ensemble(name, view)
                return (("ok", row) if row is not None
                        else ("error", "no-capacity"))
            if op == "destroy_ensemble":
                return (("ok",) if self.svc.destroy_ensemble(name)
                        else ("error", "unknown"))
            row = self.svc.resolve_ensemble(name)
            return ("ok", row) if row is not None \
                else ("error", "unknown")
        except Exception:
            return ("error", "bad-request")

    async def _on_client(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        # Per-connection op budget: the read loop blocks once
        # _MAX_INFLIGHT ops are unresolved, so a pipelining client
        # can't grow the queues/pending maps without bound (the
        # VERDICT/advisor backpressure finding).
        inflight = asyncio.Semaphore(_MAX_INFLIGHT)
        bp = self.svc.svc_backpressure

        def check_buffer() -> None:
            transport = writer.transport
            if (transport is not None
                    and transport.get_write_buffer_size()
                    > _MAX_WRITE_BUF):
                # slow-reader drop: counted, so ``stats()`` and the
                # retpu_svc_backpressure_total family carry the
                # evidence an operator needs to tell a misbehaving
                # client from a server fault
                bp["write_buf_drops"] += 1
                transport.abort()
        out = _Coalescer(writer, check_buffer)

        def send(req_id: Any, result: Any) -> None:
            # Responses are written from flush-context future waiters
            # too — never after close, and never into an unbounded
            # buffer for a client that stopped reading (advisor: drain
            # is only awaited on the request path).
            if writer.is_closing():
                return
            try:
                payload = wire.encode((req_id, result))
            except wire.WireError:
                payload = wire.encode((req_id, "failed"))
            out.write(_HDR.pack(len(payload)), payload)

        try:
            while True:
                head = await reader.readexactly(_HDR.size)
                (length,) = _HDR.unpack(head)
                if length > _MAX_FRAME:
                    break  # hostile length: drop the connection
                frame = await reader.readexactly(length)
                try:
                    msg = wire.decode(frame)
                    req_id, op = msg[0], msg[1]
                    args = tuple(msg[2:])
                except (wire.WireError, IndexError, TypeError):
                    break  # malformed: drop the connection
                if op == "stats":
                    send(req_id, self.svc.stats())
                    continue
                if op == "metrics":
                    # the obs-plane export verb: the whole registry
                    # as plain JSON-able containers, or Prometheus
                    # text when asked (both wire-encodable)
                    if args and args[0] == "prometheus":
                        send(req_id,
                             self.svc.obs_registry.render_prometheus())
                    else:
                        send(req_id, self.svc.obs_registry.snapshot())
                    continue
                if op == "controller":
                    # runtime-controller verb (ARCHITECTURE §14):
                    # the health section plus the full retained
                    # decision journal — how an operator audits the
                    # self-tuning without grepping dumps
                    send(req_id, {
                        "controller":
                            self.svc.controller.health_section(),
                        "decisions":
                            self.svc.controller.journal.snapshot(),
                    })
                    continue
                if op == "health":
                    # ensemble-health verb (the cluster-status
                    # analog): host-mirror-sourced, zero device
                    # rounds — safe to poll on a loaded service
                    try:
                        ens_arg = None
                        if args:
                            ens_arg = args[0]
                            if type(ens_arg) is not int or \
                                    not 0 <= ens_arg < self.svc.n_ens:
                                raise ValueError(ens_arg)
                        send(req_id, self.svc.health(ens_arg))
                    except Exception:
                        send(req_id, ("error", "bad-request"))
                    continue
                if op == "fleet":
                    # fleet-scope obs verbs (docs/ARCHITECTURE.md
                    # §11): one process answering for the whole
                    # group — merged metrics/health under host
                    # labels, clock-aligned cross-host timelines.
                    # On a standalone service the fleet is this host
                    # alone (same shapes, trivial clock section) and
                    # answers instantly; a service whose fleet call
                    # PULLS (a replicated leader fronted by this
                    # server) blocks up to FLEET_PULL_TIMEOUT on
                    # replica round-trips, so the call runs in the
                    # default executor — never on the event loop,
                    # where it would stall EVERY client's ops.
                    try:
                        sub = args[0] if args else "health"
                        if sub == "metrics":
                            fmt = args[1] if len(args) > 1 else None
                            fn = (lambda f=("prometheus"
                                            if fmt == "prometheus"
                                            else None):
                                  self.svc.fleet_metrics(f))
                        elif sub == "health":
                            fn = self.svc.fleet_health
                        elif sub == "timeline":
                            fid = args[1]
                            if type(fid) is not int or fid <= 0:
                                raise ValueError(fid)
                            fn = (lambda f=fid:
                                  self.svc.fleet_timeline(f))
                        else:
                            send(req_id, ("error", "bad-request"))
                            continue
                        result = await asyncio.get_running_loop() \
                            .run_in_executor(None, fn)
                        send(req_id, result)
                    except Exception:
                        send(req_id, ("error", "bad-request"))
                    continue
                if op in ("create_ensemble", "destroy_ensemble",
                          "resolve_ensemble"):
                    send(req_id, self._lifecycle(op, args))
                    continue
                if inflight.locked():
                    # the read loop is about to block on the
                    # per-connection op budget: a pipelining client
                    # has _MAX_INFLIGHT unresolved ops
                    bp["inflight_stalls"] += 1
                await inflight.acquire()
                try:
                    fut = self._dispatch(op, args)
                except Exception:
                    # wrong arity / types from a hostile or buggy
                    # client: answer, don't let the task die with an
                    # unhandled traceback
                    inflight.release()
                    send(req_id, ("error", "bad-request"))
                    continue
                if fut is None:
                    inflight.release()
                    send(req_id, ("error", "unknown-op"))
                    continue

                # Resolution happens inside a flush on this same
                # loop; the waiter writes the response directly.
                def on_done(result: Any, rid: Any = req_id) -> None:
                    inflight.release()
                    send(rid, result)
                fut.add_waiter(on_done)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()


class ServiceClient:
    """Pipelined client: awaitable ops correlated by request id.

    A dropped socket no longer strands the client: the next op
    transparently reconnects (bounded backoff) before sending — safe
    for every verb, nothing was dispatched yet.  In-flight ops at the
    moment of the drop still resolve ``DISCONNECTED`` (ambiguous by
    contract), but the **idempotent** verbs (``kget*``, ``stats``,
    ``health``, ``metrics``) additionally retry ONCE on a fresh
    connection — a read that dies mid-flight cannot double-apply, so
    the caller never sees the blip.  Writes keep surfacing the
    ambiguity: auto-retrying a ``kput`` whose first attempt may have
    committed would double-apply."""

    #: side-effect-free verbs a mid-flight connection loss may safely
    #: re-issue (exactly once) after reconnecting.  ``kmodify`` /
    #: ``kmodify_many`` are deliberately NOT here and must never be
    #: added: a modify is a read-modify-WRITE, so an ambiguous drop
    #: after which the first attempt may have committed would
    #: double-apply on retry (rmw:add applied twice is a wrong
    #: counter — unlike a CAS, nothing downstream rejects the
    #: duplicate).  The §18 commutative lane raises the stakes: its
    #: early ack makes RMW storms the hot ambiguous-drop shape.
    #: tests/test_comm_repl.py pins this set's write-free-ness.
    IDEMPOTENT_OPS = frozenset({
        "kget", "kget_vsn", "kget_many", "kget_slab",
        "stats", "health", "metrics"})

    #: reconnect backoff schedule (seconds slept before attempts
    #: 2..N; the first attempt is immediate)
    RECONNECT_BACKOFF = (0.05, 0.1, 0.2)

    def __init__(self, host: str, port: int) -> None:
        self.host, self.port = host, port
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._out: Optional[_Coalescer] = None
        self._pending: Dict[int, asyncio.Future] = {}
        self._ids = itertools.count(1)
        self._pump: Optional[asyncio.Task] = None
        self._ever_connected = False
        self._closed = False
        self.reconnects = 0
        #: serializes reconnection so concurrent ops on a dropped
        #: socket dial once, not once each
        self._rlock = asyncio.Lock()

    async def connect(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port)
        self._out = _Coalescer(self._writer)
        self._ever_connected = True
        self._pump = asyncio.get_running_loop().create_task(
            self._read_loop())

    async def _reconnect(self) -> bool:
        """Bounded-backoff redial of the configured address; True on
        success.  Only meaningful after a successful :meth:`connect`
        (a never-connected or explicitly closed client stays in the
        documented DISCONNECTED regime)."""
        async with self._rlock:
            if self._closed or not self._ever_connected:
                return False
            if self._writer is not None \
                    and not self._writer.is_closing():
                return True  # a sibling op already re-dialed
            if self._pump is not None:
                self._pump.cancel()
            if self._writer is not None:
                self._writer.close()
            self._fail_pending()
            for i in range(1 + len(self.RECONNECT_BACKOFF)):
                if i:
                    await asyncio.sleep(self.RECONNECT_BACKOFF[i - 1])
                try:
                    await self.connect()
                except (OSError, ConnectionError):
                    continue
                self.reconnects += 1
                return True
            return False

    #: result for ops whose outcome is UNKNOWN (connection lost before
    #: the response arrived): distinct from the protocol's "failed",
    #: which is a definitive rejection — conflating them would let a
    #: retry loop double-apply a write that actually committed.
    DISCONNECTED = ("error", "disconnected")

    async def close(self) -> None:
        self._closed = True
        if self._pump is not None:
            self._pump.cancel()
        if self._writer is not None:
            self._writer.close()
        self._fail_pending()

    def _fail_pending(self) -> None:
        for fut in self._pending.values():
            if not fut.done():
                fut.set_result(self.DISCONNECTED)
        self._pending.clear()

    async def _read_loop(self) -> None:
        try:
            while True:
                head = await self._reader.readexactly(_HDR.size)
                (length,) = _HDR.unpack(head)
                frame = await self._reader.readexactly(length)
                req_id, result = wire.decode(frame)
                fut = self._pending.pop(req_id, None)
                if fut is not None and not fut.done():
                    fut.set_result(result)
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.CancelledError, wire.WireError):
            self._fail_pending()

    async def _roundtrip(self, encode, timeout: float):
        """The shared request lifecycle both frame flavors ride:
        disconnected guard, req-id allocation, pending registration,
        scatter-gather write, and the leak-proof cleanup on
        connection loss / timeout (advisor findings — ONE copy, so a
        fix can never miss a flavor).  ``encode(req_id)`` returns the
        frame's parts; encoding errors raise BEFORE the id registers
        (a WireError is a caller bug, never a leaked future)."""
        # Never-connected or already-closed clients get the documented
        # DISCONNECTED result, not an AttributeError (advisor finding).
        # A previously-connected client whose socket DROPPED instead
        # redials (bounded backoff) before sending — nothing was
        # dispatched yet, so this is safe for every verb.
        if self._writer is None or self._writer.is_closing():
            if not await self._reconnect():
                return self.DISCONNECTED
        req_id = next(self._ids)
        parts = encode(req_id)
        length = sum(memoryview(p).nbytes for p in parts)
        fut = asyncio.get_running_loop().create_future()
        self._pending[req_id] = fut
        try:
            self._out.write(_HDR.pack(length), *parts)
            await self._writer.drain()
        except (ConnectionError, OSError):
            # The write raced a connection loss: the future must not
            # leak in _pending (advisor finding).
            self._pending.pop(req_id, None)
            return self.DISCONNECTED
        try:
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            self._pending.pop(req_id, None)  # a long-lived pipelined
            raise                            # client must not leak ids

    async def _call_once_retry(self, op: str, encode, timeout: float):
        """One roundtrip, plus the idempotent-verb retry: a read that
        resolved DISCONNECTED mid-flight re-issues exactly once on a
        fresh connection (side-effect-free, so no double-apply risk);
        every other verb surfaces the ambiguity unchanged."""
        r = await self._roundtrip(encode, timeout)
        if r == self.DISCONNECTED and op in self.IDEMPOTENT_OPS \
                and await self._reconnect():
            r = await self._roundtrip(encode, timeout)
        return r

    async def call(self, op: str, *args: Any, timeout: float = 30.0):
        return await self._call_once_retry(
            op, lambda rid: [wire.encode((rid, op) + args)], timeout)

    async def call_parts(self, op: str, *args: Any,
                         timeout: float = 30.0):
        """Zero-copy variant of :meth:`call` for ``wire.Raw``-carrying
        frames (the ``*_slab`` verbs): the request encodes through
        :func:`wire.encode_parts`, so each wrapped buffer goes from
        its owning array straight to the transport — no per-key term
        encode, no arena concatenation into an intermediate frame."""
        return await self._call_once_retry(
            op, lambda rid: wire.encode_parts((rid, op) + args),
            timeout)

    # convenience wrappers
    async def kput(self, ens, key, value, **kw):
        return await self.call("kput", ens, key, value, **kw)

    async def kget(self, ens, key, **kw):
        return await self.call("kget", ens, key, **kw)

    async def kget_vsn(self, ens, key, **kw):
        return await self.call("kget_vsn", ens, key, **kw)

    async def kupdate(self, ens, key, vsn, value, **kw):
        return await self.call("kupdate", ens, key, vsn, value, **kw)

    async def kput_once(self, ens, key, value, **kw):
        return await self.call("kput_once", ens, key, value, **kw)

    async def kmodify(self, ens, key, fnref, default, **kw):
        """Server-side modify; ``fnref`` is a
        :func:`riak_ensemble_tpu_torch.funref.ref` tuple (names resolve in
        the SERVER's registry, the MFA discipline of
        riak_ensemble_peer:kmodify).  Funrefs that resolve to device
        mod-fun table entries (rmw:add etc.) take the single-round
        engine fast path server-side."""
        return await self.call("kmodify", ens, key, tuple(fnref),
                               default, **kw)

    async def kmodify_many(self, ens, keys, fnref, default=0, **kw):
        """Vectorized kmodify: one fnref applied to N keys, per-key
        ('ok', vsn) | 'failed' results in order."""
        return await self.call("kmodify_many", ens, list(keys),
                               tuple(fnref), default, **kw)

    async def kdelete(self, ens, key, **kw):
        return await self.call("kdelete", ens, key, **kw)

    async def ksafe_delete(self, ens, key, vsn, **kw):
        return await self.call("ksafe_delete", ens, key, vsn, **kw)

    @staticmethod
    def _key_slab(keys):
        """(lens, arena) for an all-str ascii key batch; None when the
        batch is outside the slab subset (the caller then takes the
        legacy list verb — nothing is lost, only the zero-copy lane)."""
        if not keys or not all(type(k) is str for k in keys):
            return None
        joined = "".join(keys)
        if not joined.isascii():  # byte lens must equal char lens
            return None
        import numpy as np
        lens = np.fromiter(map(len, keys), np.int32, len(keys))
        return lens, joined.encode("ascii")

    async def kput_many(self, ens, keys, values, **kw):
        """Vectorized keyed writes.  Slab-native: an all-str-ascii /
        all-bytes batch rides the ``kput_slab`` zero-copy lane (one
        length table + one joined arena per column, `wire.Raw` framed
        — no per-key term encode either side); anything else takes
        the legacy ``kput_many`` list verb with identical results."""
        keys, values = list(keys), list(values)
        ks = self._key_slab(keys)
        if ks is not None and len(keys) == len(values) \
                and all(type(v) is bytes for v in values):
            import numpy as np
            key_lens, key_arena = ks
            val_lens = np.fromiter(map(len, values), np.int32,
                                   len(values))
            return await self.call_parts(
                "kput_slab", ens, wire.Raw(key_lens),
                wire.Raw(key_arena), wire.Raw(val_lens),
                wire.Raw(b"".join(values)), **kw)
        return await self.call("kput_many", ens, keys, values, **kw)

    async def kget_many(self, ens, keys, want_vsn=False, **kw):
        """Vectorized keyed reads; all-str-ascii batches ride the
        ``kget_slab`` zero-copy lane (see :meth:`kput_many`)."""
        keys = list(keys)
        ks = self._key_slab(keys)
        if ks is not None:
            key_lens, key_arena = ks
            return await self.call_parts(
                "kget_slab", ens, wire.Raw(key_lens),
                wire.Raw(key_arena), bool(want_vsn), **kw)
        if want_vsn:
            return await self.call("kget_many", ens, list(keys), True,
                                   **kw)
        return await self.call("kget_many", ens, keys, **kw)

    async def kupdate_many(self, ens, keys, vsns, values, **kw):
        return await self.call("kupdate_many", ens, list(keys),
                               [tuple(v) for v in vsns], list(values),
                               **kw)

    async def kdelete_many(self, ens, keys, **kw):
        return await self.call("kdelete_many", ens, list(keys), **kw)

    async def stats(self, **kw):
        return await self.call("stats", **kw)

    async def metrics(self, fmt: Optional[str] = None, **kw):
        """Obs-registry export: dict snapshot by default,
        ``fmt="prometheus"`` for the text exposition format."""
        if fmt is None:
            return await self.call("metrics", **kw)
        return await self.call("metrics", fmt, **kw)

    async def health(self, ens: Optional[int] = None, **kw):
        """Ensemble-health snapshot (the riak_ensemble cluster-status
        analog): service-level depths + per-row aggregates, or one
        row's leader/lease/epoch/churn/corrupt detail with ``ens`` —
        served from host mirrors, zero device rounds."""
        if ens is None:
            return await self.call("health", **kw)
        return await self.call("health", ens, **kw)

    async def controller(self, **kw):
        """Runtime-controller audit verb (docs/ARCHITECTURE.md §14):
        the ``health()`` controller section plus the full retained
        decision journal (cause metric, observed value, old→new knob,
        flush id per decision)."""
        return await self.call("controller", **kw)

    async def fleet_metrics(self, fmt: Optional[str] = None, **kw):
        """Fleet metrics (docs/ARCHITECTURE.md §11): every group
        host's registry under ``host`` labels — dict snapshots by
        default, ``fmt="prometheus"`` for ONE merged scrape text."""
        if fmt is None:
            return await self.call("fleet", "metrics", **kw)
        return await self.call("fleet", "metrics", fmt, **kw)

    async def fleet_health(self, **kw):
        """Every group host's health section, host-labeled, plus the
        per-link clock-offset estimates."""
        return await self.call("fleet", "health", **kw)

    async def fleet_timeline(self, fid: int, **kw):
        """The clock-aligned cross-host timeline of one flush:
        leader and replica spans on ONE (leader-clock) axis, each
        role honest to its link's estimated offset bound."""
        return await self.call("fleet", "timeline", int(fid), **kw)

    async def create_ensemble(self, name, view=None, **kw):
        return await self.call("create_ensemble", name, view, **kw)

    async def destroy_ensemble(self, name, **kw):
        return await self.call("destroy_ensemble", name, **kw)

    async def resolve_ensemble(self, name, **kw):
        return await self.call("resolve_ensemble", name, **kw)


async def serve(n_ens: int, n_peers: int, n_slots: int,
                host: str = "127.0.0.1", port: int = 0,
                tick: float = 0.005,
                config: Optional[Config] = None,
                engine: Any = None, dynamic: Optional[bool] = None,
                data_dir: Optional[str] = None,
                warm: bool = False,
                fast_reads: Optional[bool] = None,
                autotune: Optional[bool] = None,
                device: DeviceLike = None,
                **svc_kw: Any) -> ServiceServer:
    """Bring up runtime + service + server; returns the started
    server (call ``await server.stop()`` to tear down).

    ``device`` is the service's device: the card unless ``"cpu"`` is
    passed (without a card the service raises).  ``svc_kw`` goes to the
    service as it is (``pipeline_depth``, ``max_ops_per_tick``,
    ``wal_sync``, the host-arm switches, ...).

    ``dynamic`` is tri-state: None (default) = no assertion — a
    restore adopts the persisted lifecycle mode; True/False = the
    caller's explicit assertion — a restore of a data_dir persisted
    with the OTHER mode fails loudly (``_merge_dynamic``).

    ``fast_reads`` is tri-state too: None keeps the service default
    (config.trust_lease); True/False forces
    the lease-protected read fast path on/off for this server."""
    runtime = NetRuntime("svc", {"svc": (host, 0)})
    runtime.loop = asyncio.get_running_loop()
    cfg = config if config is not None else Config()
    if data_dir is not None and (
            os.path.exists(os.path.join(data_dir, "META"))
            or os.path.exists(os.path.join(data_dir, "CURRENT"))):
        # Operator restart: a data_dir with prior state RESTORES
        # (checkpoint + WAL replay) — a fresh service over an old WAL
        # would silently serve empty while poisoning the log.  The
        # persisted shape wins over the CLI shape, and the persisted
        # lifecycle MODE wins unless the caller explicitly asserted
        # one: restore() treats any present 'dynamic' kwarg as an
        # explicit choice and fails loudly on mismatch, so forwarding
        # an unasserted default would crash every restart of a
        # --dynamic-persisted data_dir (ADVICE r3).  An explicit
        # True OR False still forwards, keeping the loud error for
        # genuinely contradictory assertions in both directions.
        dyn_kw = {} if dynamic is None else {"dynamic": bool(dynamic)}
        svc = BatchedEnsembleService.restore(
            runtime, data_dir, tick=tick, config=cfg, engine=engine,
            data_dir=data_dir, device=device, **dyn_kw, **svc_kw)
    else:
        svc = BatchedEnsembleService(
            runtime, n_ens, n_peers, n_slots, tick=tick, config=cfg,
            engine=engine, dynamic=bool(dynamic), data_dir=data_dir,
            device=device, **svc_kw)
    if fast_reads is not None:
        svc.set_fast_reads(fast_reads)
    if autotune is not None:
        # tri-state like fast_reads: None keeps the service default
        # (the RETPU_AUTOTUNE env knob, off for one release)
        svc.set_autotune(autotune)
    if warm:
        # the builds, the pinned upload slots and one launch per (K, A)
        # bucket, so no client pays a first use inside its op latency;
        # a --warm boot also records F1's per-bucket cost gauges
        # (retpu_step_cost_flops/_bytes) for the metrics verb
        svc.warmup(capture_costs=True)
    server = ServiceServer(svc, host, port)
    await server.start()
    return server


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7601)
    ap.add_argument("--n-ens", type=int, default=1024)
    ap.add_argument("--n-peers", type=int, default=5)
    ap.add_argument("--n-slots", type=int, default=128)
    ap.add_argument("--tick", type=float, default=0.005)
    ap.add_argument("--fast", action="store_true",
                    help="fast_test_config timeouts")
    ap.add_argument("--dynamic", action="store_true", default=None,
                    help="start with zero ensembles; clients create/"
                         "destroy them at runtime (on restart of an "
                         "existing --data-dir, omitting this adopts "
                         "the persisted mode)")
    ap.add_argument("--data-dir", default=None,
                    help="durability root (WAL + checkpoints); acked "
                         "writes survive crashes")
    ap.add_argument("--warm", "--warm-flush-ladder", dest="warm",
                    action="store_true",
                    help="build the libraries and launch the (K, A) "
                         "flush ladder — pow2 batch depths x pow2 "
                         "active-column buckets — before accepting "
                         "clients (slower boot, no first-use spikes)")
    ap.add_argument("--no-fast-reads", action="store_true",
                    help="disable the lease-protected read fast path "
                         "(every read takes a device round)")
    ap.add_argument("--device", default=None,
                    help="the service's device: the card (cuda) unless "
                         "'cpu' is given")
    ap.add_argument("--mesh-devices", type=int, default=0,
                    help="serve from a mesh engine sharded over this "
                         "many devices along the 'ens' axis (0 = "
                         "single-shard): the first N cards, or N shards "
                         "of --device when it is given")
    ap.add_argument("--autotune", action="store_true", default=None,
                    help="arm the obs-actuated runtime controller "
                         "(same as RETPU_AUTOTUNE=1): auto-tunes the "
                         "launch/replication pipeline knobs and the "
                         "tenant-admission guard from the measured "
                         "obs plane, every decision journaled "
                         "(docs/ARCHITECTURE.md §14; audit via the "
                         "('controller',) verb)")
    args = ap.parse_args(argv)

    engine = None
    if args.mesh_devices:
        from riak_ensemble_tpu_torch.parallel.mesh import mesh_engine
        engine = mesh_engine(args.mesh_devices, devices=(
            None if args.device is None
            else [args.device] * args.mesh_devices))

    async def run() -> None:
        server = await serve(
            args.n_ens, args.n_peers, args.n_slots, args.host,
            args.port, args.tick,
            config=fast_test_config() if args.fast else None,
            dynamic=args.dynamic, data_dir=args.data_dir,
            warm=args.warm,
            fast_reads=False if args.no_fast_reads else None,
            autotune=args.autotune, device=args.device, engine=engine)
        print(f"svcnode serving {args.n_ens} ensembles on "
              f"{server.host}:{server.port}", flush=True)
        fp = faults.active_plan()
        if fp is not None:
            # loud, once, at boot: a node started under fault-injection
            # knobs is part of a nemesis — an operator tailing the
            # log must never mistake its injected failures for a real
            # incident (the health verb carries the same section)
            print(f"svcnode: FAULT INJECTION ACTIVE "
                  f"{fp.describe()!r}", file=sys.stderr, flush=True)
        try:
            await asyncio.Event().wait()
        finally:
            await server.stop()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
