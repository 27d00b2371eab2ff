"""Probe of many small requests pipelined on one TCP connection.

Drives N requests, all in flight at once on one connection, through
three servers on loopback and reports, for each, how many were answered
within a deadline and where the rest sat when progress stopped:

- ``raw``: a bare asyncio framed echo with the port's server read loop
  (``readexactly`` header and payload, answer from a 5 ms timer,
  ``await writer.drain()`` after every request), so the transport and
  the kernel's TCP are all that is under test;
- ``port``: the port's ``svcnode.serve(device="cpu")`` with its
  ``ServiceClient`` sending N small ``kput`` requests (both ends write
  the frames of one event-loop turn in one transport write);
- ``blocking``: two threads on plain blocking sockets, one sending N
  small frames with one ``send`` per header and per payload, the other
  reading them back, with no asyncio at all.

The ``raw`` case runs with the client writing a frame as two ``write``
calls (header, then payload) and as one.  Where a case stalls it prints both ends' kernel
queues (``SIOCOUTQ`` / ``SIOCINQ``), asyncio's own buffers and the
fields of ``TCP_INFO`` that say whether the sender waits on the
receiver's window.

    python3 pipeline_probe.py [--n 1000 ...] [--deadline 5]

It prints one JSON object per case and exits 0 whatever it found.
"""
from __future__ import annotations

import argparse
import asyncio
import fcntl
import json
import os
import platform
import socket
import struct
import sys
import threading
import time

_HDR = struct.Struct(">I")
_SIOCINQ, _SIOCOUTQ = 0x541B, 0x5411
_TCPI = ("state ca_state retransmits probes backoff options wscale "
         "app_limited").split() + (
    "rto ato snd_mss rcv_mss unacked sacked lost retrans fackets "
    "last_data_sent last_ack_sent last_data_recv last_ack_recv pmtu "
    "rcv_ssthresh rtt rttvar snd_ssthresh snd_cwnd advmss reordering "
    "rcv_rtt rcv_space total_retrans").split()
_TCPI_KEEP = ("probes", "backoff", "rto", "unacked", "snd_cwnd",
              "rcv_ssthresh", "rcv_space", "snd_mss", "rcv_mss",
              "last_data_sent", "last_data_recv", "retrans",
              "total_retrans")


def sock_state(sock) -> dict:
    """Kernel-side view of one socket: queued bytes each way and the
    TCP_INFO fields that show window waits (what the kernel offers)."""
    out = {}
    fd = sock.fileno()
    for name, req in (("inq", _SIOCINQ), ("outq", _SIOCOUTQ)):
        try:
            out[name] = struct.unpack(
                "i", fcntl.ioctl(fd, req, b"\0" * 4))[0]
        except OSError as e:
            out[name] = f"error {e.errno}"
    try:
        raw = sock.getsockopt(socket.IPPROTO_TCP, socket.TCP_INFO, 104)
        vals = struct.unpack_from("8B24I", raw.ljust(104, b"\0"))
        info = dict(zip(_TCPI, vals))
        out["tcp_info"] = {k: info[k] for k in _TCPI_KEEP}
    except OSError as e:
        out["tcp_info"] = f"error {e.errno}"
    return out


def environment() -> dict:
    env = {"uname": " ".join(platform.uname()),
           "python": sys.version.split()[0]}
    for path in ("/proc/version", "/proc/sys/net/ipv4/tcp_rmem",
                 "/proc/sys/net/ipv4/tcp_wmem",
                 "/proc/sys/net/ipv4/tcp_autocorking",
                 "/proc/sys/net/ipv4/tcp_moderate_rcvbuf",
                 "/proc/sys/net/core/rmem_default"):
        try:
            with open(path) as f:
                env[os.path.basename(path)] = f.read().strip()
        except OSError as e:
            env[os.path.basename(path)] = f"unreadable ({e.errno})"
    return env


def frame(i: int) -> bytes:
    # the size of a small kput frame of the wire codec (~25 bytes)
    return b"req%06d:" % i + b"x" * 16


async def raw_case(n: int, joined: bool, deadline: float) -> dict:
    """The bare asyncio server with the port's read loop shape."""
    conns = []

    async def on_client(reader, writer):
        conns.append((reader, writer))
        queue = []
        loop = asyncio.get_running_loop()

        def answer():
            if writer.is_closing():
                return
            for p in queue:
                writer.write(_HDR.pack(len(p)) + p)
            queue.clear()
        try:
            while True:
                (length,) = _HDR.unpack(await reader.readexactly(4))
                p = await reader.readexactly(length)
                if not queue:
                    loop.call_later(0.005, answer)
                queue.append(p)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()

    server = await asyncio.start_server(on_client, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    got = []

    async def pump():
        try:
            while True:
                (length,) = _HDR.unpack(await reader.readexactly(4))
                got.append(await reader.readexactly(length))
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.CancelledError):
            pass
    task = asyncio.get_running_loop().create_task(pump())

    async def one(i):
        p = frame(i)
        if joined:
            writer.write(_HDR.pack(len(p)) + p)
        else:
            writer.write(_HDR.pack(len(p)))
            writer.write(p)
        await writer.drain()
    t0 = time.perf_counter()
    await asyncio.gather(*[one(i) for i in range(n)])
    sent_s = time.perf_counter() - t0
    state = await wait_progress(lambda: len(got), n, deadline, t0)
    if len(got) < n:
        sreader, swriter = conns[0]
        state["client"] = {
            **sock_state(writer.get_extra_info("socket")),
            "write_buffer": writer.transport.get_write_buffer_size()}
        state["server"] = {
            **sock_state(swriter.get_extra_info("socket")),
            "write_buffer": swriter.transport.get_write_buffer_size(),
            "reader_buffer": len(sreader._buffer)}
    task.cancel()
    writer.close()
    server.close()
    return {"case": "raw", "joined": joined, "n": n, "answered": len(got),
            "all_written_s": sent_s, **state}


async def wait_progress(count, n: int, deadline: float, t0: float) -> dict:
    """Polls ``count()`` until it reaches ``n`` or ``deadline`` passes;
    returns the time to the last answer and the answer times' cadence
    after progress first paused for 100 ms."""
    last, last_t, stamps = count(), time.perf_counter(), []
    while count() < n and time.perf_counter() - t0 < deadline:
        await asyncio.sleep(0.001)
        c = count()
        if c != last:
            if time.perf_counter() - last_t > 0.1:
                stamps.append(round(time.perf_counter() - t0, 4))
            last, last_t = c, time.perf_counter()
    return {"last_answer_s": round(last_t - t0, 6),
            "answers_after_a_pause_at_s": stamps[:20]}


async def port_case(n: int, deadline: float) -> dict:
    """The port's server and client: N small kputs on one connection."""
    from riak_ensemble_tpu_torch import svcnode
    conns = []
    orig = svcnode.ServiceServer._on_client

    async def on_client(self, reader, writer):
        conns.append((reader, writer))
        await orig(self, reader, writer)
    svcnode.ServiceServer._on_client = on_client
    try:
        server = await svcnode.serve(max(n, 64), 3, 16, device="cpu",
                                     max_ops_per_tick=64)
    finally:
        svcnode.ServiceServer._on_client = orig
    c = svcnode.ServiceClient(server.host, server.port)
    await c.connect()
    done = []

    async def one(i):
        r = await c.kput(i, "k", b"v", timeout=deadline + 5)
        done.append(r)
    t0 = time.perf_counter()
    tasks = [asyncio.get_running_loop().create_task(one(i))
             for i in range(n)]
    state = await wait_progress(lambda: len(done), n, deadline, t0)
    if len(done) < n:
        sreader, swriter = conns[0]
        state["client"] = {
            **sock_state(c._writer.get_extra_info("socket")),
            "write_buffer": c._writer.transport.get_write_buffer_size()}
        state["server"] = {
            **sock_state(swriter.get_extra_info("socket")),
            "write_buffer": swriter.transport.get_write_buffer_size(),
            "reader_buffer": len(sreader._buffer),
            "queued_ops": sum(len(q) for q in server.svc.queues)
            if hasattr(server.svc, "queues") else None,
            "backpressure": dict(server.svc.svc_backpressure)}
    for t in tasks:
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)
    ok = sum(1 for r in done if r[0] == "ok")
    await c.close()
    await server.stop()
    return {"case": "port", "n": n,
            "answered": len(done), "ok": ok, **state}


def blocking_case(n: int, deadline: float) -> dict:
    """Plain blocking sockets: a sender thread, a reader thread."""
    ls = socket.socket()
    ls.bind(("127.0.0.1", 0))
    ls.listen(1)
    cs = socket.create_connection(ls.getsockname())
    cs.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    ss, _ = ls.accept()
    ss.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    got = [0]

    def reader():
        buf = b""
        ss.settimeout(deadline)
        try:
            while got[0] < n:
                chunk = ss.recv(65536)
                if not chunk:
                    return
                buf += chunk
                while len(buf) >= 4:
                    (length,) = _HDR.unpack(buf[:4])
                    if len(buf) < 4 + length:
                        break
                    buf = buf[4 + length:]
                    got[0] += 1
        except OSError:
            pass
    th = threading.Thread(target=reader, daemon=True)
    t0 = time.perf_counter()
    th.start()
    for i in range(n):
        p = frame(i)
        cs.sendall(_HDR.pack(len(p)))
        cs.sendall(p)
    th.join(deadline)
    out = {"case": "blocking", "n": n, "answered": got[0],
           "s": round(time.perf_counter() - t0, 6)}
    if got[0] < n:
        out["client"] = sock_state(cs)
        out["server"] = sock_state(ss)
    for s in (cs, ss, ls):
        s.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, action="append")
    ap.add_argument("--deadline", type=float, default=5.0)
    args = ap.parse_args(argv)
    sizes = args.n or [256, 1000, 2000]
    print(json.dumps({"environment": environment()}), flush=True)
    for n in sizes:
        print(json.dumps(blocking_case(n, args.deadline)), flush=True)
        for joined in (False, True):
            print(json.dumps(asyncio.run(
                raw_case(n, joined, args.deadline))), flush=True)
        print(json.dumps(asyncio.run(port_case(n, args.deadline))),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
