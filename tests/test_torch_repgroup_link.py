"""The port's leader↔replica link and catch-up codecs, held to the
reference's own link suite (``tests/test_repgroup_link.py``) on the
port's modules: tickets and their completion hooks, idle and mid-frame
receive timeouts, the bounded connect, the injected link faults (drops
both ways, delay, reorder) and the rate-limited drop log, and a
tree patch's control-plane meta validating before anything mutates.
Host code only, on the CPU; no JAX.
"""

import socket
import struct
import threading
import time

import pytest

from riak_ensemble_tpu_torch import wire
from riak_ensemble_tpu_torch.config import fast_test_config
from riak_ensemble_tpu_torch.parallel import repgroup
from riak_ensemble_tpu_torch.parallel.batched_host import (
    BatchedEnsembleService, WallRuntime,
)


def _frame_bytes(value) -> bytes:
    payload = wire.encode(value)
    return struct.Struct(">I").pack(len(payload)) + payload


class _FakeSock:
    """Scripted socket: each entry is bytes to serve, a 'timeout'
    sentinel, or an exception instance to raise."""

    def __init__(self, script):
        self.script = list(script)
        self.buf = b""

    def recv(self, n):
        if not self.buf:
            if not self.script:
                raise ConnectionError("script exhausted")
            item = self.script.pop(0)
            if item == "timeout":
                raise socket.timeout("timed out")
            if isinstance(item, Exception):
                raise item
            if isinstance(item, tuple) and item[0] == "wait":
                # block until the test's gate opens, then serve
                _tag, event, data = item
                event.wait(5.0)
                item = data
            self.buf = item
        out, self.buf = self.buf[:n], self.buf[n:]
        return out


def _make_link():
    # never connects (no server) — we drive _recv_loop directly; the
    # sender thread just idles on its queue
    link = repgroup.PeerLink("127.0.0.1", 1, lambda: 1)
    link.connected = True
    return link


def test_idle_timeout_with_empty_awaiting_keeps_link():
    """ADVICE r5: a 120 s idle-socket timeout on a link with NOTHING
    outstanding is benign — dropping it forced a full re-sync
    reconnect per idle period on quiet links (stepped-down
    ex-leaders, idle leaders)."""
    link = _make_link()
    link.needs_sync = False
    gen = link._gen
    t = repgroup._Ticket()
    gate = threading.Event()
    sock = _FakeSock([
        "timeout",                               # idle: must NOT drop
        # the response arrives only after the test queued its ticket
        ("wait", gate, _frame_bytes(("applied", 1, 1, 0))),
        ConnectionError("closed"),               # end the loop
    ])

    th = threading.Thread(target=link._recv_loop, args=(sock, gen),
                          daemon=True)
    th.start()
    # wait until the loop survived the idle timeout AND re-entered
    # recv (it popped the gated entry — only the terminal error
    # remains scripted), then queue the ticket and let the response
    # through
    deadline = time.monotonic() + 5.0
    while len(sock.script) > 1 and time.monotonic() < deadline:
        time.sleep(0.005)
    with link._alock:
        link._awaiting.append(t)
    gate.set()
    assert t.event.wait(5.0), "response never paired"
    assert t.result == ("applied", 1, 1, 0)
    th.join(5.0)
    # the idle timeout neither dropped nor desynced the link: the
    # final ConnectionError is what tore it down
    assert link.needs_sync  # set by the terminal drop only
    link.close()


def test_idle_timeout_with_overdue_request_drops():
    """A timeout while a response has been outstanding for a full
    IO_TIMEOUT means the peer is wedged — that still drops the link
    (and fails the ticket)."""
    link = _make_link()
    gen = link._gen
    t = repgroup._Ticket()
    t.posted = time.monotonic() - link.IO_TIMEOUT - 1.0  # overdue
    with link._alock:
        link._awaiting.append(t)
    sock = _FakeSock(["timeout"])
    link._recv_loop(sock, gen)
    assert t.event.is_set() and t.result is None
    assert not link.connected and link.needs_sync
    link.close()


def test_idle_timeout_with_fresh_request_keeps_link():
    """A request posted DURING the blocked recv (the closing instant
    of the idle window) is not overdue: the timeout keeps listening
    instead of failing a fresh request against a healthy peer."""
    link = _make_link()
    link.needs_sync = False
    gen = link._gen
    t = repgroup._Ticket()  # posted just now — not overdue
    with link._alock:
        link._awaiting.append(t)
    sock = _FakeSock([
        "timeout",
        _frame_bytes(("applied", 2, 2, 0)),  # the response arrives
        ConnectionError("closed"),
    ])
    link._recv_loop(sock, gen)
    assert t.event.is_set() and t.result == ("applied", 2, 2, 0)
    link.close()


def test_mid_frame_timeout_drops_even_when_idle():
    """A timeout AFTER bytes of a frame arrived desyncs the stream —
    always a drop, idle or not."""
    link = _make_link()
    gen = link._gen
    half_frame = _frame_bytes(("applied", 1, 1, 0))[:3]
    sock = _FakeSock([half_frame, "timeout"])
    link._recv_loop(sock, gen)
    assert not link.connected
    link.close()


def _mk_svc(dynamic=False):
    return BatchedEnsembleService(WallRuntime(), 4, 1, 8, tick=None,
                                  config=fast_test_config(), device="cpu",
                                  dynamic=dynamic)


def test_install_meta_validates_mode_before_mutating():
    """ADVICE r5: a lifecycle-mode mismatch must fail BEFORE the
    leader's control-plane vectors land — a half-applied meta leaves
    the replica campaigning with mixed state."""
    src = _mk_svc(dynamic=True)
    dst = _mk_svc(dynamic=False)
    # make the source's control plane visibly different
    src.create_ensemble("t0")
    meta = repgroup.dump_meta(src)
    assert repgroup.meta_dynamic(meta) is True
    before = dst.state
    with pytest.raises(ValueError, match="lifecycle-mode mismatch"):
        repgroup.install_meta(dst, meta)
    # NOTHING was applied: same state object, untouched mirrors
    assert dst.state is before
    assert not dst.dynamic
    src.stop()
    dst.stop()


def test_handle_tpatch_rejects_mode_mismatch_before_patches():
    """The tpatch handler rejects a mismatched meta before applying
    object patches — the frozen replica stays consistently frozen
    (still nacking at its old position) for the full-install
    fallback."""
    leader = _mk_svc(dynamic=True)
    leader.create_ensemble("t0")
    replica = _mk_svc(dynamic=False)
    core = repgroup.ReplicaCore(replica)
    state_before = replica.state
    patches = [(0, 0, 7, 7, 42, "k", 5, b"x")]
    frame = ("tpatch", 1, 1, (0, 0), repgroup.dump_meta(leader),
             patches)
    with pytest.raises(ValueError, match="lifecycle-mode mismatch"):
        core.handle_tpatch(frame)
    # the object patch did NOT land either
    assert replica.state is state_before
    assert (core.applied_ge, core.applied_seq) == (0, 0)
    leader.stop()
    replica.stop()


def test_ticket_on_done_fires_on_response_and_on_drop():
    """Round 7's shared-condition ack gather hangs off _Ticket.on_done
    — it must fire BOTH when a response pairs and when a connection
    drop fails the outstanding tickets (result None), or a batch
    settle could sleep to its deadline waiting on a dead link."""
    link = _make_link()
    gen = link._gen
    fired = []
    t_ok = repgroup._Ticket(on_done=lambda: fired.append("ok"))
    t_drop = repgroup._Ticket(on_done=lambda: fired.append("drop"))
    with link._alock:
        link._awaiting.append(t_ok)
        link._awaiting.append(t_drop)
    sock = _FakeSock([
        _frame_bytes(("applied", 1, 7, 123)),
        ConnectionError("closed"),
    ])
    link._recv_loop(sock, gen)
    assert t_ok.event.is_set() and t_ok.result == ("applied", 1, 7, 123)
    assert t_drop.event.is_set() and t_drop.result is None
    assert fired == ["ok", "drop"]
    link.close()


def test_ticket_on_done_exception_does_not_break_pairing():
    """A hook that raises must not tear the receive loop (later
    tickets still pair) — _fire swallows it."""
    link = _make_link()
    gen = link._gen

    def boom():
        raise RuntimeError("hook bug")

    t1 = repgroup._Ticket(on_done=boom)
    t2 = repgroup._Ticket()
    with link._alock:
        link._awaiting.append(t1)
        link._awaiting.append(t2)
    sock = _FakeSock([
        _frame_bytes(("applied", 1, 1, 1)),
        _frame_bytes(("applied", 1, 2, 2)),
        ConnectionError("closed"),
    ])
    link._recv_loop(sock, gen)
    assert t1.result == ("applied", 1, 1, 1)
    assert t2.result == ("applied", 1, 2, 2)
    link.close()


# -- fault-injection plane + bounded connect (round 10) ----------------------


from riak_ensemble_tpu_torch import faults


@pytest.fixture(autouse=True)
def _no_leaked_fault_plan():
    faults.clear()
    yield
    faults.clear()


class _StubReplica:
    """Minimal protocol-speaking replica: answers the hello handshake
    and then acks every frame ``("ping", i)`` with
    ``("applied", i, 0, 0)`` — enough wire truth for link-level fault
    tests without a real ReplicaServer."""

    def __init__(self, respond=True):
        self.srv = socket.create_server(("127.0.0.1", 0))
        self.port = self.srv.getsockname()[1]
        self.respond = respond
        self.received = []
        self._stop = False
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while not self._stop:
            try:
                conn, _ = self.srv.accept()
            except OSError:
                return
            try:
                if not self.respond:
                    # half-open: the SYN completed but nothing ever
                    # answers (response direction dead) — hold the
                    # socket open until the test tears down
                    while not self._stop:
                        time.sleep(0.02)
                    continue
                hello = repgroup.recv_frame(conn)
                assert hello[0] == "hello"
                repgroup.send_frame(conn, ("helloed", 1, 0, 0))
                while not self._stop:
                    frame = repgroup.recv_frame(conn)
                    self.received.append(frame)
                    repgroup.send_frame(
                        conn, ("applied", int(frame[1]), 0, 0))
            except (ConnectionError, OSError, wire.WireError):
                continue
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

    def close(self):
        self._stop = True
        try:
            self.srv.close()
        except OSError:
            pass


def test_half_open_connect_fails_within_bounded_timeout(monkeypatch):
    """Satellite: a peer that accepts the SYN but never answers the
    handshake (firewalled response path, SIGSTOP'd accept loop, a
    one-directional partition eating the reply) must fail the send
    within the CONNECT budget — the handshake previously ran under
    IO_TIMEOUT (120 s) and wedged the sender thread for two minutes
    per attempt."""
    stub = _StubReplica(respond=False)
    monkeypatch.setattr(repgroup.PeerLink, "CONNECT_TIMEOUT", 1.0)
    monkeypatch.setattr(repgroup.PeerLink, "RECONNECT_DELAY", 0.01)
    link = repgroup.PeerLink("127.0.0.1", stub.port, lambda: 1)
    try:
        t0 = time.monotonic()
        t = link.post(("ping", 1))
        assert t.event.wait(5.0), \
            "send wedged past the bounded connect timeout"
        assert time.monotonic() - t0 < 4.0
        assert t.result is None
        assert not link.connected and link.drops >= 1
        # the sender thread survived: a second send fails bounded too
        t2 = link.post(("ping", 2))
        assert t2.event.wait(5.0)
        assert t2.result is None
    finally:
        link.close()
        stub.close()


def test_injected_request_drop_fails_fast_and_counts():
    """A directional leader→replica drop blackholes the frame before
    any socket work: the ticket fires unresolved immediately (missed
    ack at injection speed), the link's injected counter advances,
    and link_stats() shows the rule targeting the link."""
    p = faults.install(faults.FaultPlan())
    # port 1: a real connect attempt would fail loudly — the drop
    # check must short-circuit before any socket work
    link = repgroup.PeerLink("127.0.0.1", 1, lambda: 1)
    p.drop(faults.LOCAL, link.label)
    try:
        t = link.post(("ping", 1))
        assert t.event.wait(2.0)
        assert t.result is None
        assert link.injected_drops == 1
        assert link.drops == 0  # no connection failure, an injection
        st = link.link_stats()
        assert st["injected"]["dropping"] is True
        assert st["injected"]["drops"] >= 1
    finally:
        link.close()


def test_injected_response_drop_consumes_ticket_keeps_pairing():
    """Dropping the RETURN direction: the request reaches the replica
    (and is applied there) but its ack vanishes — the ticket resolves
    None (missed ack), the connection survives, and the NEXT frame's
    response pairs correctly (no off-by-one desync)."""
    stub = _StubReplica()
    p = faults.install(faults.FaultPlan())
    link = repgroup.PeerLink("127.0.0.1", stub.port, lambda: 1)
    try:
        p.drop(link.label, faults.LOCAL)
        t1 = link.post(("ping", 1))
        assert t1.event.wait(5.0)
        assert t1.result is None          # ack blackholed...
        deadline = time.monotonic() + 5.0
        while not stub.received and time.monotonic() < deadline:
            time.sleep(0.01)
        assert stub.received, "request never reached the replica"
        assert link.injected_drops == 1
        assert link.connected             # ...but the link is alive
        p.heal()
        t2 = link.post(("ping", 2))
        assert t2.event.wait(5.0)
        assert t2.result == ("applied", 2, 0, 0)  # pairing intact
    finally:
        link.close()
        stub.close()


def test_injected_request_delay_slows_the_send():
    stub = _StubReplica()
    p = faults.install(faults.FaultPlan())
    link = repgroup.PeerLink("127.0.0.1", stub.port, lambda: 1)
    try:
        # connect cleanly first, then arm the delay
        t0 = link.post(("ping", 0))
        assert t0.event.wait(5.0) and t0.result is not None
        p.set_rtt(faults.LOCAL, link.label, 80.0)
        start = time.monotonic()
        t = link.post(("ping", 1))
        assert t.event.wait(5.0)
        assert t.result == ("applied", 1, 0, 0)
        assert time.monotonic() - start >= 0.080
        assert p.delayed_frames >= 1
    finally:
        link.close()
        stub.close()


def test_reorder_swaps_but_pairing_stays_consistent():
    """Injected adjacent-frame swaps change the WIRE order; tickets
    ride their frames, so every response still resolves the ticket of
    the frame it answers (FIFO in actual send order)."""
    stub = _StubReplica()
    p = faults.install(faults.FaultPlan(seed=1))
    link = repgroup.PeerLink("127.0.0.1", stub.port, lambda: 1)
    try:
        t0 = link.post(("ping", 0))     # establish the connection
        assert t0.event.wait(5.0) and t0.result is not None
        p.set_reorder(faults.LOCAL, link.label, 1.0)
        for i in range(1, 41, 2):
            ta = link.post(("ping", i))
            tb = link.post(("ping", i + 1))
            assert ta.event.wait(5.0) and tb.event.wait(5.0)
            assert ta.result == ("applied", i, 0, 0)
            assert tb.result == ("applied", i + 1, 0, 0)
        # with prob 1.0 and 20 rapid pairs, at least one swap really
        # happened (get_nowait found the second frame queued)
        assert p.reordered_frames >= 1
        swapped = any(
            stub.received[j][1] > stub.received[j + 1][1]
            for j in range(len(stub.received) - 1))
        assert swapped, stub.received
    finally:
        link.close()
        stub.close()


def test_drop_logging_rate_limited(monkeypatch, capsys):
    """Satellite: an active nemesis (or a real flapping link) drives
    drops at frame rate; stderr gets at most one summarized line per
    link per LOG_INTERVAL, while the stats counter keeps the truth."""
    monkeypatch.setattr(repgroup.PeerLink, "RECONNECT_DELAY", 0.0)
    link = _make_link()
    for _ in range(10):
        link._drop()
    assert link.drops == 10
    err = capsys.readouterr().err
    lines = [ln for ln in err.splitlines() if "connection dropped" in ln]
    assert len(lines) == 1, err            # first logs, rest suppressed
    assert "(1 drop(s)" in lines[0], lines[0]  # not the full count
    # after the interval passes, ONE more summarized line carries the
    # suppressed count
    link._last_drop_log -= link.LOG_INTERVAL + 1.0
    link._drop()
    err = capsys.readouterr().err
    lines = [ln for ln in err.splitlines() if "connection dropped" in ln]
    assert len(lines) == 1
    assert "(10 drop(s)" in lines[0], lines[0]
    # a deliberate close() is NOT a link failure: the teardown's own
    # socket drop neither counts nor logs
    before = link.drops
    link.close()
    link._drop()
    assert link.drops == before
    assert "connection dropped" not in capsys.readouterr().err
