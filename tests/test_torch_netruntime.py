"""The port's real-time runtime and the link half of its fault plane.

Mirrors ``tests/test_netruntime_hostile.py`` and the link cases of
``tests/test_faults.py``:

- hostile frames (garbage, unknown tags and records, nesting bombs,
  pickle opcodes) reaching a node's port are dropped and the node keeps
  serving; an oversized header closes that connection only;
- a frame crosses between a reference ``NetRuntime`` node and a port
  one in both directions (the frames are the same bytes);
- the link rules (directional drop, per-link RTT with jitter, reorder,
  the ``RETPU_FAULT_*`` link knobs) give the same ``describe()`` and
  counters as the reference's plan, on the simulator runtime the same
  deliveries at the same virtual times, and on the real-time runtime a
  dropped or delayed frame;
- the service's timer runs on real time: a ``BatchedEnsembleService``
  on a ``NetRuntime`` flushes itself (tick and burst kick) and
  ``stop()`` cancels it; ``SoakSchedule`` / ``wedge_soak`` answer as
  the reference's for a service without replication links.

Tolerance: exact equality (virtual times included).
"""

import asyncio

import pytest

from riak_ensemble_tpu_torch import faults as tfaults
from riak_ensemble_tpu_torch import runtime as trt
from riak_ensemble_tpu_torch import wire
from riak_ensemble_tpu_torch.config import fast_test_config
from riak_ensemble_tpu_torch.netruntime import FRAME_HEADER, NetRuntime
from riak_ensemble_tpu_torch.parallel import batched_host as tb
from riak_ensemble_tpu_torch.runtime import Actor
from test_torch_reference_natives import reference_natives  # noqa: F401 (autouse)


class _Sink(Actor):
    def __init__(self, runtime, name, node):
        super().__init__(runtime, name, node)
        self.got = []

    def handle(self, msg):
        self.got.append(msg)


def _frame(payload: bytes) -> bytes:
    return FRAME_HEADER.pack(len(payload)) + payload


HOSTILE = [
    b"", b"\x00" * 64, b"Q" + b"\xff" * 32, b"R\x7fNN",
    b"t\x01" * 64 + b"N", b"t" + bytes([0x80] * 5 + [0x01]),
    b"s\x02\xff\xff", b"e\x01l\x00", b"\x80\x04\x95n.",
]


async def _until(pred, n=300):
    for _ in range(n):
        if pred():
            return True
        await asyncio.sleep(0.01)
    return False


async def _node(mod, name):
    rt = mod.NetRuntime(name, {name: ("127.0.0.1", 0)})
    rt.loop = asyncio.get_running_loop()
    rt._server = await asyncio.start_server(rt._on_client, "127.0.0.1", 0)
    return rt, rt._server.sockets[0].getsockname()[1]


def test_hostile_frames_dropped_node_keeps_serving():
    async def scenario():
        runtime, port = await _node(__import__(
            "riak_ensemble_tpu_torch.netruntime", fromlist=["x"]), "node0")
        sink = _Sink(runtime, ("manager", "node0"), "node0")
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        for payload in HOSTILE:
            writer.write(_frame(payload))
        writer.write(_frame(wire.encode((("manager", "node0"),
                                         ("ping", 42)))))
        await writer.drain()
        assert await _until(lambda: sink.got)
        assert sink.got == [("ping", 42)]
        writer.write(FRAME_HEADER.pack(1 << 31))   # oversized: closed
        await writer.drain()
        writer.close()
        r2, w2 = await asyncio.open_connection("127.0.0.1", port)
        w2.write(_frame(wire.encode((("manager", "node0"), ("ping", 43)))))
        await w2.drain()
        assert await _until(lambda: len(sink.got) >= 2)
        assert sink.got[-1] == ("ping", 43)
        w2.close()
        await runtime.stop()

    asyncio.run(scenario())


def test_frames_cross_packages_both_ways():
    pytest.importorskip("jax")
    from riak_ensemble_tpu import netruntime as jnet
    from riak_ensemble_tpu import runtime as jrt
    from riak_ensemble_tpu.types import PeerId as JPeer
    from riak_ensemble_tpu_torch import netruntime as tnet
    from riak_ensemble_tpu_torch.types import PeerId

    async def scenario():
        a, pa = await _node(jnet, "a")
        b, pb = await _node(tnet, "b")
        a.peers["b"] = ("127.0.0.1", pb)
        b.peers["a"] = ("127.0.0.1", pa)

        class JSink(jrt.Actor):
            got: list

            def handle(self, msg):
                self.got.append(msg)
        ja = JSink(a, ("manager", "a"), "a")
        ja.got = []
        tb_ = _Sink(b, ("manager", "b"), "b")
        a.net_send("a", ("manager", "b"), ("hello", JPeer(1, "a"), b"x"))
        b.net_send("b", ("manager", "a"), ("hi", PeerId(2, "b"), [1.5]))
        assert await _until(lambda: tb_.got and ja.got)
        assert tb_.got == [("hello", PeerId(1, "a"), b"x")]
        assert type(tb_.got[0][1]) is PeerId
        assert ja.got == [("hi", JPeer(2, "b"), [1.5])]
        assert type(ja.got[0][1]) is JPeer
        # each server waits for its inbound connection, which the other
        # node's stop closes: stop both at once
        await asyncio.wait_for(asyncio.gather(a.stop(), b.stop()), 10)

    asyncio.run(scenario())


LINK_ENV = {"RETPU_FAULT_DROP": "a>b,c>*", "RETPU_FAULT_RTT_MS": "b>a=4,*>c=1.5",
            "RETPU_FAULT_RTT_JITTER_MS": "0.5",
            "RETPU_FAULT_REORDER": "a>c=0.25", "RETPU_FAULT_SEED": "3"}


def test_link_knobs_and_counters_equal_reference():
    pytest.importorskip("jax")
    from riak_ensemble_tpu import faults as jfaults
    plans = (jfaults.from_env(LINK_ENV), tfaults.from_env(LINK_ENV))
    out = []
    for p in plans:
        seen = []
        for src, dst in [("a", "b"), ("b", "a"), ("x", "c"), ("c", "a"),
                         ("a", "c"), ("b", "c")] * 5:
            seen.append((p.should_drop(src, dst),
                         round(p.delay_s(src, dst), 12),
                         p.should_swap(src, dst)))
        p.count_reorder("a", "c")
        out.append((seen, p.describe(), p.link_injected("a", "b"),
                    p.link_injected("b", "a")))
    assert out[1] == out[0]
    for bad in ({"RETPU_FAULT_RTT_MS": "a>b"},
                {"RETPU_FAULT_REORDER": "a>b=x"}):
        with pytest.raises(ValueError):
            tfaults.from_env(bad)


def _oneway_trace(mod, seed):
    rt = mod.Runtime(seed=seed)
    got = []

    class Rec(mod.Actor):
        def handle(self, msg):
            got.append((self.name, msg, round(self.runtime.now, 9)))
    for i, n in enumerate(("n0", "n1", "n2")):
        Rec(rt, f"a{i}", n)
    rt.net.partition_oneway(["n0"], ["n1"])
    rt.net.fault_plan().set_rtt("n2", "*", 7.0, 2.0)
    for step in range(30):
        rt.net_send(f"n{step % 3}", f"a{(step + 1) % 3}", step)
        rt.run_for(0.003)
    rt.run_for(1.0)
    plan = rt.net.plan
    return got, plan.counters(), rt.rng.random()


@pytest.mark.parametrize("seed", [0, 1])
def test_simulator_link_faults_equal_reference(seed):
    pytest.importorskip("jax")
    from riak_ensemble_tpu import runtime as jrt
    ref, got = _oneway_trace(jrt, seed), _oneway_trace(trt, seed)
    assert got == ref
    assert got[1]["dropped_frames"] == 10 and got[1]["delayed_frames"]


def test_netruntime_link_drop_and_delay():
    async def scenario():
        from riak_ensemble_tpu_torch import netruntime as tnet
        a, pa = await _node(tnet, "a")
        b, pb = await _node(tnet, "b")
        a.peers["b"] = ("127.0.0.1", pb)
        sink = _Sink(b, ("manager", "b"), "b")
        plan = tfaults.FaultPlan(seed=1).drop("a", "b")
        a.net.plan = plan
        a.net_send("a", ("manager", "b"), "lost")
        await asyncio.sleep(0.1)
        assert sink.got == [] and plan.dropped_frames == 1
        plan.heal()
        plan.set_rtt("a", "b", 60.0)
        t0 = asyncio.get_running_loop().time()
        a.net_send("a", ("manager", "b"), "late")
        assert await _until(lambda: sink.got)
        assert asyncio.get_running_loop().time() - t0 >= 0.05
        assert sink.got == ["late"] and plan.delayed_frames == 1
        await asyncio.wait_for(asyncio.gather(a.stop(), b.stop()), 10)

    asyncio.run(scenario())


def test_service_timer_runs_on_real_time():
    async def scenario():
        rt = NetRuntime("svc", {"svc": ("127.0.0.1", 0)})
        rt.loop = asyncio.get_running_loop()
        svc = tb.BatchedEnsembleService(rt, 4, 3, 16, tick=0.005,
                                        config=fast_test_config(),
                                        device="cpu", max_ops_per_tick=4)
        f = svc.kput(1, "k", b"v")                       # the tick
        assert await rt.await_future(f, 5.0) == ("ok", (1, 1))
        burst = [svc.kput(2, f"b{i}", b"v") for i in range(8)]   # kicks
        vals = [await rt.await_future(x, 5.0) for x in burst]
        assert all(v[0] == "ok" for v in vals)
        flushes = svc.flushes
        assert flushes >= 2
        svc.stop()
        late = svc.kput(3, "z", b"v")
        await asyncio.sleep(0.1)
        assert not late.done and svc.flushes == flushes

    asyncio.run(scenario())


def test_stop_disarms_a_deferred_kick():
    """A burst kick deferred before ``stop()`` does not flush after it (a
    flush that drained the queue first, such as a tick, leaves it armed)."""
    async def scenario():
        rt = NetRuntime("svc", {"svc": ("127.0.0.1", 0)})
        rt.loop = asyncio.get_running_loop()
        svc = tb.BatchedEnsembleService(rt, 4, 3, 16, tick=60.0,
                                        config=fast_test_config(),
                                        device="cpu", max_ops_per_tick=4)
        burst = [svc.kput(2, f"b{i}", b"v") for i in range(4)]
        assert svc._kick_pending
        svc.flush()                       # drains the queue before the kick
        assert all(f.done for f in burst)
        flushes = svc.flushes
        svc.stop()
        late = svc.kput(3, "z", b"v")
        await asyncio.sleep(0.05)
        assert not late.done and svc.flushes == flushes

    asyncio.run(scenario())


def test_soak_on_a_service_without_links():
    clock = [0.0]
    svc = tb.BatchedEnsembleService(tb.WallRuntime(), 2, 3, 8, tick=None,
                                    device="cpu")
    soak = tfaults.SoakSchedule(5.0, clock=lambda: clock[0])
    assert soak.maybe_run(svc) is None
    clock[0] = 6.0
    assert soak.maybe_run(svc) == {"ok": True,
                                   "skipped": "no replication links"}
    assert soak.runs == 1 and soak.failures == 0
    assert tfaults.wedge_soak(svc)["skipped"]
