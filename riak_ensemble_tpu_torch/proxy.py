"""Stateless proxy/ingress tier (docs/ARCHITECTURE.md §16).

Copied from ``riak_ensemble_tpu/proxy.py`` onto the port's own
:mod:`.wire` and :mod:`.svcnode`: pure host code, byte-compatible with
either package's servers, importing nothing of the JAX package.

The serving plane's fan-in role, split out of the engine front-end:
a proxy terminates N client connections — accept, frame parse,
per-connection backpressure — and forwards each op to the group
leader over ONE shared upstream connection, so the leader's event
loop sees a handful of pipelined proxy sockets instead of every
client in the fleet.  Accept/parse/fan-out CPU now scales with proxy
count (run as many as ingress needs; they share nothing), which is
the compartmentalization move of HT-Paxos / Compartmentalized Paxos:
the consensus engine stops being the connection-termination tier.

Protocol: byte-compatible with :mod:`riak_ensemble_tpu_torch.svcnode` on
both sides — clients speak the same length-prefixed
``(req_id, op, args...)`` frames to a proxy they would speak to the
engine, and the proxy speaks them upstream.  The ``*_slab`` verbs
stay on the zero-copy lane END TO END: a decoded client slab's
length tables and arenas surface as memoryview slices of the
received frame, and the proxy forwards them wrapped in
:class:`wire.Raw` through ``encode_parts`` — one scatter-gather hop
per client batch, no re-framing, no per-key term decode anywhere in
the proxy.

Leader discovery: give a proxy the client ports of every group host;
it probes ``("stats",)`` for a host whose ``group.leader`` flag is
set, sticks to it, and re-resolves when an op answers
``("error", "not-leader")`` — the wire shape of ``DeposedError`` —
or the upstream socket drops.  Ops that were rejected not-leader
were never dispatched, so the proxy retries them transparently
against the new leader; an op that dies mid-flight surfaces
``("error", "disconnected")`` to the client unless its verb is
idempotent (``kget*``, ``stats``, ``health``, ``metrics``), which
retry once.  Proxies hold no durable state — restart one and it
re-discovers and serves; clients reconnect through any proxy.

    ("proxy_stats",) -> dict   # answered locally, never forwarded:
                               # live client count, forwarded/retry/
                               # reconnect counters, backpressure
                               # drops, current upstream address

    python -m riak_ensemble_tpu_torch.proxy --port 7701 \
        --upstream 127.0.0.1:7601,127.0.0.1:7602,127.0.0.1:7603
"""

from __future__ import annotations

import argparse
import asyncio
import time
from typing import Any, List, Optional, Tuple

from riak_ensemble_tpu_torch import wire
from riak_ensemble_tpu_torch.svcnode import (
    _HDR, _MAX_FRAME, _MAX_INFLIGHT, _MAX_WRITE_BUF, ServiceClient)

#: slab verbs ride the parts lane upstream: every buffer-typed arg
#: (the length tables and arenas, memoryview slices of the client's
#: frame) is re-wrapped in wire.Raw — the one re-encode is the frame
#: header, never the planes
_SLAB_OPS = frozenset({"kput_slab", "kget_slab"})


class LeaderLink:
    """One proxy's shared upstream: discovers the leader among the
    candidate addresses, pipelines every client's ops over a single
    connection, and re-resolves on not-leader / socket loss.

    The retry discipline mirrors :class:`repgroup.GroupClient`:
    a not-leader rejection always retries (the op was never
    dispatched into a flush); a mid-flight DISCONNECTED retries only
    for idempotent verbs — auto-retrying a write whose first attempt
    may have committed would double-apply."""

    CONNECT_TIMEOUT = 5.0

    def __init__(self, upstreams, op_timeout: float = 30.0,
                 discover_timeout: float = 30.0) -> None:
        self.upstreams = [(str(h), int(p)) for h, p in upstreams]
        self.op_timeout = op_timeout
        self.discover_timeout = discover_timeout
        self._client: Optional[ServiceClient] = None
        self.leader_addr: Optional[Tuple[str, int]] = None
        self._dlock = asyncio.Lock()
        self.rediscoveries = 0
        self.not_leader_retries = 0

    async def _discover(self, budget: float) -> ServiceClient:
        deadline = time.monotonic() + budget
        async with self._dlock:
            if self._client is not None:  # a sibling op already won
                return self._client
            first_err: Optional[str] = None
            while time.monotonic() < deadline:
                responsive = None
                for addr in self.upstreams:
                    c = ServiceClient(*addr)
                    try:
                        await asyncio.wait_for(c.connect(),
                                               self.CONNECT_TIMEOUT)
                        st = await c.call("stats", timeout=10.0)
                    except (OSError, ConnectionError,
                            asyncio.TimeoutError):
                        await c.close()
                        continue
                    if not isinstance(st, dict):
                        await c.close()
                        continue
                    grp = st.get("group")
                    if grp is None and responsive is None:
                        # a standalone svcnode (no replication
                        # group): any responsive host is the engine
                        responsive = (c, addr)
                        continue
                    if isinstance(grp, dict) and grp.get("leader"):
                        if responsive is not None:
                            await responsive[0].close()
                        self._client, self.leader_addr = c, addr
                        return c
                    await c.close()
                if responsive is not None:
                    self._client, self.leader_addr = responsive
                    return self._client
                first_err = first_err or "no leader elected yet"
                await asyncio.sleep(0.25)
        raise TimeoutError(
            f"no upstream leader among {self.upstreams}: "
            f"{first_err or 'all unreachable'}")

    async def _drop(self, failed: Optional[ServiceClient]) -> None:
        """Compare-and-drop (the GroupClient rule): a stale failure
        must not close a freshly discovered leader under siblings."""
        if failed is not None and self._client is not failed:
            await failed.close()
            return
        if self._client is not None:
            await self._client.close()
        self._client = None
        self.leader_addr = None
        self.rediscoveries += 1

    async def forward(self, op: str, args: tuple):
        """One client op against the current leader; transparent
        re-resolve + retry on safe-to-retry outcomes, bounded by
        ~discover_timeout overall."""
        deadline = time.monotonic() + self.discover_timeout
        retried_disconnect = False
        while True:
            c = self._client
            if c is None:
                try:
                    c = await self._discover(
                        max(1.0, deadline - time.monotonic()))
                except TimeoutError:
                    return ("error", "no-leader")
            try:
                if op in _SLAB_OPS:
                    fwd = tuple(
                        wire.Raw(a) if isinstance(
                            a, (bytes, bytearray, memoryview))
                        else a for a in args)
                    r = await c.call_parts(op, *fwd,
                                           timeout=self.op_timeout)
                else:
                    r = await c.call(op, *args,
                                     timeout=self.op_timeout)
            except asyncio.TimeoutError:
                r = ServiceClient.DISCONNECTED
            except wire.WireError:
                return ("error", "bad-request")
            if r == ("error", "not-leader"):
                # DeposedError's wire shape: never dispatched, always
                # safe to re-resolve and retry
                await self._drop(c)
                if time.monotonic() < deadline:
                    self.not_leader_retries += 1
                    continue
            if r == ServiceClient.DISCONNECTED:
                await self._drop(c)
                # writes — kmodify/kmodify_many included (NOT
                # idempotent: an ambiguous drop may have committed,
                # and a retried RMW double-applies) — surface the
                # ambiguity to the proxy client unchanged
                if (op in ServiceClient.IDEMPOTENT_OPS
                        and not retried_disconnect
                        and time.monotonic() < deadline):
                    retried_disconnect = True
                    continue
            return r

    async def close(self) -> None:
        if self._client is not None:
            await self._client.close()
        self._client = None


class ProxyServer:
    """TCP ingress front-end: svcnode-protocol server whose dispatch
    is a forward over one :class:`LeaderLink`."""

    def __init__(self, upstreams, host: str = "127.0.0.1",
                 port: int = 0, op_timeout: float = 30.0,
                 discover_timeout: float = 30.0) -> None:
        self.link = LeaderLink(upstreams, op_timeout=op_timeout,
                               discover_timeout=discover_timeout)
        self.host, self.port = host, port
        self._server: Optional[asyncio.AbstractServer] = None
        self.clients = 0
        self.forwarded = 0
        self.backpressure = {"inflight_stalls": 0,
                             "write_buf_drops": 0}

    async def start(self) -> Tuple[str, int]:
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
        await self.link.close()

    def proxy_stats(self) -> dict:
        la = self.link.leader_addr
        return {
            "clients": self.clients,
            "forwarded": self.forwarded,
            "not_leader_retries": self.link.not_leader_retries,
            "rediscoveries": self.link.rediscoveries,
            "backpressure": dict(self.backpressure),
            "upstream": (f"{la[0]}:{la[1]}" if la else None),
        }

    async def _on_client(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        # Same per-connection budget discipline as the engine
        # front-end (svcnode._on_client): a pipelining client blocks
        # at _MAX_INFLIGHT unresolved ops, a stalled reader is
        # dropped at the write-buffer cap — both counted.
        inflight = asyncio.Semaphore(_MAX_INFLIGHT)
        bp = self.backpressure
        self.clients += 1

        def send(req_id: Any, result: Any) -> None:
            if writer.is_closing():
                return
            try:
                payload = wire.encode((req_id, result))
            except wire.WireError:
                payload = wire.encode((req_id, "failed"))
            writer.write(_HDR.pack(len(payload)) + payload)
            transport = writer.transport
            if (transport is not None
                    and transport.get_write_buffer_size()
                    > _MAX_WRITE_BUF):
                bp["write_buf_drops"] += 1
                transport.abort()

        async def forward_one(req_id: Any, op: str,
                              args: tuple) -> None:
            try:
                r = await self.link.forward(op, args)
            except Exception:
                r = ("error", "bad-request")
            finally:
                inflight.release()
            self.forwarded += 1
            send(req_id, r)

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
                if op == "proxy_stats":
                    send(req_id, self.proxy_stats())
                    continue
                if inflight.locked():
                    bp["inflight_stalls"] += 1
                await inflight.acquire()
                # Forwarding runs as its own task so a slow upstream
                # op never serializes the whole connection behind it
                # — clients pipeline through a proxy exactly as they
                # would against the engine.  The task keeps `frame`
                # alive via `args` (slab memoryviews slice into it).
                asyncio.get_running_loop().create_task(
                    forward_one(req_id, op, args))
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            self.clients -= 1
            writer.close()


async def serve_proxy(upstreams, host: str = "127.0.0.1",
                      port: int = 0, op_timeout: float = 30.0,
                      discover_timeout: float = 30.0) -> ProxyServer:
    """Bring up one proxy; returns the started server (call
    ``await proxy.stop()`` to tear down).  Discovery is lazy — the
    first forwarded op dials upstream — so a proxy can boot before
    its group has elected."""
    proxy = ProxyServer(upstreams, host, port, op_timeout=op_timeout,
                        discover_timeout=discover_timeout)
    await proxy.start()
    return proxy


def _parse_addrs(s: str) -> List[Tuple[str, int]]:
    out = []
    for part in s.split(","):
        host, _, port = part.strip().rpartition(":")
        out.append((host or "127.0.0.1", int(port)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7701)
    ap.add_argument("--upstream", required=True,
                    help="comma-separated host:port candidates — the "
                         "group hosts' CLIENT ports (or one "
                         "standalone svcnode)")
    ap.add_argument("--op-timeout", type=float, default=30.0)
    ap.add_argument("--discover-timeout", type=float, default=30.0)
    args = ap.parse_args(argv)

    async def run() -> None:
        proxy = await serve_proxy(
            _parse_addrs(args.upstream), args.host, args.port,
            op_timeout=args.op_timeout,
            discover_timeout=args.discover_timeout)
        print(f"proxy serving on {proxy.host}:{proxy.port} -> "
              f"{args.upstream}", flush=True)
        try:
            await asyncio.Event().wait()
        finally:
            await proxy.stop()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
