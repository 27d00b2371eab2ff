"""The port's front end (``riak_ensemble_tpu_torch.svcnode``) against the
JAX package's.

Mirrors ``tests/test_svcnode.py`` and
``tests/test_svcnode_linearizability.py`` on the port's server
(``serve(..., device="cpu")``, its timer on a real-time ``NetRuntime``):

- the whole verb table end to end (keyed verbs, CAS, deletes, batch and
  slab verbs with their fallback, lifecycle, stats / health / metrics /
  controller / fleet), malformed requests answered, hostile frames
  dropping their connection only, the per-connection in-flight budget
  and the slow-reader drop (both counted in ``svc_backpressure``), and a
  restart from a data dir adopting the persisted dynamic mode;
- a serial client's response frames from the port's server equal the
  JAX server's, byte for byte;
- a reference ``ServiceClient`` works against the port's server and the
  port's client against the reference's;
- pipelined concurrent clients under a peer-flapping nemesis, one dying
  mid-stream, give histories the port's ``KeyModel`` accepts;
- ``python -m riak_ensemble_tpu_torch.svcnode --device cpu --data-dir D
  --dynamic`` killed with SIGKILL restarts on ``D`` with every acked
  write and the name directory.

Tolerance: exact equality (response bytes included).

The frames against the JAX server's, the cross-package clients and the
SIGKILL restart are in ``tests/test_torch_svcnode_wire.py``.
"""

import asyncio
import itertools
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from riak_ensemble_tpu_torch import funref, svcnode, wire
from riak_ensemble_tpu_torch.config import fast_test_config
from riak_ensemble_tpu_torch.linearizability import KeyModel
from riak_ensemble_tpu_torch.types import NOTFOUND
from test_torch_reference_natives import reference_natives  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _serve(*a, **kw):
    kw.setdefault("config", fast_test_config())
    return svcnode.serve(*a, port=0, device="cpu", **kw)


def _frame(msg):
    payload = wire.encode(msg)
    return struct.pack(">I", len(payload)) + payload


def test_end_to_end_verb_table():
    async def scenario():
        server = await _serve(4, 3, 8)
        c = svcnode.ServiceClient(server.host, server.port)
        await c.connect()
        r = await c.kput(0, "k", b"v1")
        assert r[0] == "ok"
        assert await c.kget(0, "k") == ("ok", b"v1")
        assert (await c.kupdate(0, "k", tuple(r[1]), b"v2"))[0] == "ok"
        r = await c.kget_vsn(0, "k")
        assert r[:2] == ("ok", b"v2")
        assert (await c.ksafe_delete(0, "k", tuple(r[2])))[0] == "ok"
        assert await c.kget(0, "k") == ("ok", NOTFOUND)
        assert await c.kdelete(0, "nope") == ("ok", NOTFOUND)
        assert (await c.kput_once(0, "once", b"a"))[0] == "ok"
        assert await c.kput_once(0, "once", b"b") == "failed"
        assert (await c.kmodify(1, "ctr", funref.ref("rmw:add", 3), 0))[0] \
            == "ok"
        assert (await c.kmodify_many(1, ["ctr", "c2"],
                                     funref.ref("rmw:add", 2)))[0][0] == "ok"
        assert await c.kget(1, "ctr") == ("ok", 5)
        puts = [c.kput(e, f"p{i}", b"x%d" % i)
                for e in range(4) for i in range(5)]
        assert all(r[0] == "ok" for r in await asyncio.gather(*puts))
        gets = [c.kget(e, f"p{i}") for e in range(4) for i in range(5)]
        assert [r[1] for r in await asyncio.gather(*gets)] == \
            [b"x%d" % i for _e in range(4) for i in range(5)]
        st = await c.stats()
        assert st["ops_served"] > 0 and st["obs_enabled"] is True
        ctl = await c.controller()
        assert ctl["controller"]["enabled"] is False
        assert ctl["decisions"] == []
        h = await c.health()
        assert h["controller"] == ctl["controller"]
        assert h["schema"] == "retpu-health-v1" and "storage" in h
        h0 = await c.health(0)
        assert h0["ens"] == 0 and h0["live_keys"] >= 5
        assert await c.health(99) == ("error", "bad-request")
        m = await c.metrics()
        assert m["retpu_flushes_total"] == st["flushes"] or \
            m["retpu_flushes_total"] >= st["flushes"]
        text = await c.metrics("prometheus")
        assert "# TYPE retpu_op_latency_ms histogram" in text
        fm = await c.fleet_metrics()
        assert fm["schema"] == "retpu-fleet-metrics-v1"
        fh = await c.fleet_health()
        assert len(fh["hosts"]) == 1
        fid = max(iter(__import__(
            "riak_ensemble_tpu_torch.obs", fromlist=["x"]).SPANS.flush_ids()))
        tl = await c.fleet_timeline(fid)
        assert tl["flush_id"] == fid
        assert await c.call("fleet", "bogus") == ("error", "bad-request")
        assert await c.call("bogus-op") == ("error", "unknown-op")
        for bad in (("kput", -1, "k", b"v"), ("kput", 99, "k", b"v"),
                    ("kput", 0)):
            assert await c.call(*bad) == ("error", "bad-request")
        assert await c.kget(1, "p0") == ("ok", b"x0")
        await c.close()
        await server.stop()

    asyncio.run(scenario())


def test_hostile_frames_drop_connection_only():
    async def scenario():
        server = await _serve(2, 3, 4)
        for junk in (b"\x93\x01\x02pickle-ish\xff", None):
            reader, writer = await asyncio.open_connection(
                server.host, server.port)
            writer.write(struct.pack(">I", (1 << 31) - 1) if junk is None
                         else struct.pack(">I", len(junk)) + junk)
            await writer.drain()
            assert await reader.read(1) == b""
            writer.close()
        c = svcnode.ServiceClient(server.host, server.port)
        await c.connect()
        assert (await c.kput(0, "k", b"v"))[0] == "ok"
        await c.close()
        await server.stop()

    asyncio.run(scenario())


def test_inflight_budget_and_slow_reader_drop(monkeypatch):
    monkeypatch.setattr(svcnode, "_MAX_INFLIGHT", 8)
    monkeypatch.setattr(svcnode, "_MAX_WRITE_BUF", 4096)

    async def scenario():
        server = await _serve(2, 3, 64)
        svc = server.svc
        orig, seen = svc.flush, []

        def spy():
            seen.append(sum(len(q) for q in svc.queues))
            return orig()
        svc.flush = spy
        reader, writer = await asyncio.open_connection(server.host,
                                                       server.port)
        n = 300
        for i in range(n):
            writer.write(_frame((i, "kput", i % 2, f"k{i % 16}", b"v")))
        await writer.drain()
        got = set()
        while len(got) < n:
            (length,) = struct.unpack(">I", await asyncio.wait_for(
                reader.readexactly(4), 30))
            rid, res = wire.decode(await reader.readexactly(length))
            assert res[0] == "ok"
            got.add(rid)
        assert max(seen) <= 8
        assert svc.svc_backpressure["inflight_stalls"] > 0
        writer.close()
        svc.flush = orig
        # a client that never reads is dropped once its replies pass
        # the cap; a well-behaved one stays served
        good = svcnode.ServiceClient(server.host, server.port)
        await good.connect()
        big = b"x" * 65536   # 400 replies: far past the socket buffers
        assert (await good.kput(0, "big", big))[0] == "ok"
        r2, w2 = await asyncio.open_connection(server.host, server.port)
        for i in range(400):
            w2.write(_frame((i, "kget", 0, "big")))
        try:
            await w2.drain()
        except ConnectionError:
            pass
        for _ in range(500):
            if svc.svc_backpressure["write_buf_drops"]:
                break
            await asyncio.sleep(0.01)
        assert svc.svc_backpressure["write_buf_drops"] >= 1
        w2.close()
        assert await good.kget(0, "big") == ("ok", big)
        assert (await good.stats())["svc_backpressure"][
            "write_buf_drops"] >= 1
        await good.close()
        await server.stop()

    asyncio.run(scenario())


@pytest.mark.parametrize("n", [1000, 2000])
def test_pipelined_burst_on_one_connection(monkeypatch, n):
    """``n`` small requests in flight at once on one connection (2,000
    is past the server's ``_MAX_INFLIGHT``) are all answered, and each
    end's frames of one event-loop turn leave in one transport write:
    a burst of 2n small segments is what stalls a user-space TCP stack
    (``pipeline_probe.py``)."""
    writes = []
    real = asyncio.StreamWriter.write

    def counted(self, data):
        writes.append(len(data))
        return real(self, data)
    monkeypatch.setattr(asyncio.StreamWriter, "write", counted)

    async def scenario():
        server = await _serve(64, 3, 64, max_ops_per_tick=64)
        c = svcnode.ServiceClient(server.host, server.port)
        await c.connect()
        res = await asyncio.gather(*[
            c.kput(i % 64, f"k{i}", b"v%d" % i, timeout=60)
            for i in range(n)])
        assert [r[0] for r in res] == ["ok"] * n
        got = await asyncio.gather(*[
            c.kget(i % 64, f"k{i}", timeout=60) for i in range(n)])
        assert got == [("ok", b"v%d" % i) for i in range(n)]
        assert server.svc.svc_backpressure["write_buf_drops"] == 0
        await c.close()
        await server.stop()

    asyncio.run(scenario())
    # 4n frames went each way in all; one write per frame would be 4n
    assert len(writes) <= n // 4, len(writes)


def test_pipeline_probe_answers_every_case(capsys):
    """``pipeline_probe.py`` (the diagnosis of a stalling TCP stack)
    runs each of its cases to the end here, where nothing stalls."""
    sys.path.insert(0, ROOT)
    try:
        import pipeline_probe
    finally:
        sys.path.remove(ROOT)
    assert pipeline_probe.main(["--n", "64", "--deadline", "10"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert "uname" in lines[0]["environment"]
    cases = lines[1:]
    assert [c["case"] for c in cases] == ["blocking", "raw", "raw", "port"]
    assert all(c["answered"] == 64 for c in cases)


def test_batch_and_slab_verbs_with_fallback():
    async def scenario():
        server = await _serve(2, 3, 32)
        c = svcnode.ServiceClient(server.host, server.port)
        await c.connect()
        keys = [f"k{i}" for i in range(10)]
        assert c._key_slab(keys) is not None
        res = await c.kput_many(1, keys, [b"v%d" % i for i in range(10)])
        assert len(res) == 10 and all(r[0] == "ok" for r in res)
        got = await c.kget_many(1, keys + ["nope"])
        assert [r[1] for r in got[:10]] == [b"v%d" % i for i in range(10)]
        assert got[10] == ("ok", NOTFOUND)
        up = await c.kupdate_many(1, [keys[0]], [tuple(res[0][1])],
                                  [b"up0"])
        assert up[0][0] == "ok"
        dl = await c.kdelete_many(1, [keys[1], "nope"])
        assert dl[0][0] == "ok" and dl[1] == ("ok", NOTFOUND)
        gv = await c.kget_many(1, [keys[0], "nope"], want_vsn=True)
        assert gv[0][:2] == ("ok", b"up0") and len(gv[0]) == 3
        assert gv[1] == ("ok", NOTFOUND, (0, 0))
        assert c._key_slab(["κλειδί"]) is None
        res = await c.kput_many(0, ["κλειδί", "plain"], [b"nb", b"pv"])
        assert [r[0] for r in res] == ["ok", "ok"]
        assert await c.kget_many(0, ["κλειδί"]) == [("ok", b"nb")]
        assert (await c.kput_many(0, ["obj"], ["not-bytes"]))[0][0] == "ok"
        assert await c.kget_many(0, ["obj"]) == [("ok", "not-bytes")]
        for bad in (("kput_slab", 0, wire.Raw(np.asarray([5], np.int32)),
                     wire.Raw(b"ab"), wire.Raw(np.asarray([1], np.int32)),
                     wire.Raw(b"x")),
                    ("kget_slab", 0, wire.Raw(np.asarray([-1], np.int32)),
                     wire.Raw(b""))):
            assert await c.call_parts(*bad) == ("error", "bad-request")
        assert (await c.kput_many(-1, ["k"], [b"v"]))[0] == "error"
        await c.close()
        await server.stop()

    asyncio.run(scenario())


def test_restart_adopts_persisted_dynamic_mode(tmp_path):
    data = str(tmp_path / "d")

    async def first_boot():
        server = await _serve(4, 3, 8, dynamic=True, data_dir=data)
        c = svcnode.ServiceClient(server.host, server.port)
        await c.connect()
        assert (await c.create_ensemble("tenant"))[0] == "ok"
        assert await c.create_ensemble("tenant") == ("error", "exists")
        ens = (await c.resolve_ensemble("tenant"))[1]
        assert (await c.kput(ens, "k", b"v"))[0] == "ok"
        assert (await c.create_ensemble("gone"))[0] == "ok"
        assert await c.destroy_ensemble("gone") == ("ok",)
        assert await c.destroy_ensemble("gone") == ("error", "unknown")
        await c.close()
        await server.stop()

    async def restart():
        server = await _serve(4, 3, 8, data_dir=data)
        assert server.svc.dynamic is True
        c = svcnode.ServiceClient(server.host, server.port)
        await c.connect()
        r = await c.resolve_ensemble("tenant")
        assert await c.kget(r[1], "k") == ("ok", b"v")
        assert await c.resolve_ensemble("gone") == ("error", "unknown")
        await c.close()
        await server.stop()

    async def conflicting():
        with pytest.raises(ValueError):
            await _serve(4, 3, 8, dynamic=False, data_dir=data)

    asyncio.run(first_boot())
    asyncio.run(restart())
    asyncio.run(conflicting())


# -- across packages ----------------------------------------------------------

SERIAL = [
    ("kput", 0, "k", b"v1"), ("kget", 0, "k"), ("kget_vsn", 0, "k"),
    ("kupdate", 0, "k", (1, 1), b"v2"), ("kupdate", 0, "k", (1, 1), b"x"),
    ("kput_once", 1, "o", b"a"), ("kput_once", 1, "o", b"b"),
    ("kdelete", 0, "nope"), ("kput_many", 2, ["a", "b", "a"],
                             [b"1", b"2", b"3"]),
    ("kget_many", 2, ["a", "b", "c"]), ("kget_many", 2, ["a", "zz"], True),
    ("kupdate_many", 2, ["a", "b"], [(1, 3), (9, 9)], [b"u", b"w"]),
    ("kdelete_many", 2, ["b", "never"]),
    ("kmodify", 3, "ctr", ("fn", "rmw:add", (4,)), 0),
    ("kmodify_many", 3, ["ctr", "c2"], ("fn", "rmw:add", (1,)), 0),
    ("kget", 3, "ctr"), ("ksafe_delete", 0, "k", (1, 2)),
    ("kget", 0, "k"), ("kput", 99, "k", b"v"), ("bogus",),
    ("kput", 0), ("resolve_ensemble", "nope"), ("create_ensemble", "n"),
]


async def _serial_frames(mod, cfg):
    server = await mod.serve(4, 3, 16, port=0, config=cfg,
                             **({"device": "cpu"} if mod is svcnode
                                else {}))
    reader, writer = await asyncio.open_connection(server.host,
                                                   server.port)
    out = []
    for i, req in enumerate(SERIAL):
        writer.write(_frame((i,) + req))
        await writer.drain()
        (length,) = struct.unpack(">I", await asyncio.wait_for(
            reader.readexactly(4), 30))
        out.append(await reader.readexactly(length))
    writer.close()
    await server.stop()
    return out


# -- pipelined histories against the linearizability checker ------------------

N_ENS, N_PEERS, N_KEYS, N_WORKERS, OPS = 4, 5, 3, 4, 30


async def _lin_scenario(seed):
    server = await _serve(N_ENS, N_PEERS, 16)
    svc = server.svc
    models = {(e, k): KeyModel(f"{e}/key{k}")
              for e in range(N_ENS) for k in range(N_KEYS)}
    vals = itertools.count(1)
    stopped = []

    async def nemesis():
        rng = np.random.default_rng(seed + 1)
        down = {}
        while not stopped:
            await asyncio.sleep(0.01)
            r = rng.random()
            if r < 0.35 and down:
                e = list(down)[int(rng.integers(len(down)))]
                svc.set_peer_up(e, down.pop(e), True)
            elif r < 0.7:
                e = int(rng.integers(N_ENS))
                if e not in down and svc.leader_np[e] >= 0:
                    p = int(svc.leader_np[e])
                    svc.set_peer_up(e, p, False)
                    down[e] = p
        for e, p in down.items():
            svc.set_peer_up(e, p, True)

    def settle_write(m, op_id, res):
        if isinstance(res, tuple) and res[0] == "ok":
            m.ack_write(op_id)
        elif res == svcnode.ServiceClient.DISCONNECTED:
            m.timeout_write(op_id)
        else:
            m.fail_write(op_id)

    async def worker(wid, die_early):
        rng = np.random.default_rng(seed * 100 + wid)
        c = svcnode.ServiceClient(server.host, server.port)
        await c.connect()
        for i in range(OPS):
            if die_early and i == OPS // 2:
                await c.close()
                return
            e = int(rng.integers(N_ENS))
            k = int(rng.integers(N_KEYS))
            m = models[(e, k)]
            r = rng.random()
            try:
                if r < 0.5:
                    v = b"v%d" % next(vals)
                    op = m.invoke_write(v)
                    settle_write(m, op, await c.kput(e, f"key{k}", v,
                                                     timeout=15.0))
                elif r < 0.8:
                    res = await c.kget(e, f"key{k}", timeout=15.0)
                    if isinstance(res, tuple) and res[0] == "ok":
                        m.ack_read(res[1])
                else:
                    op = m.invoke_write(NOTFOUND)
                    settle_write(m, op, await c.kdelete(e, f"key{k}",
                                                        timeout=15.0))
            except asyncio.TimeoutError:
                if r < 0.5 or r >= 0.8:
                    m.timeout_write(op)
        await c.close()

    nem = asyncio.ensure_future(nemesis())
    await asyncio.gather(*[worker(w, w == 0) for w in range(N_WORKERS)])
    stopped.append(True)
    await nem
    c = svcnode.ServiceClient(server.host, server.port)
    await c.connect()
    served = 0
    for (e, k), m in models.items():
        res = await c.kget(e, f"key{k}", timeout=20.0)
        if isinstance(res, tuple) and res[0] == "ok":
            m.ack_read(res[1])
            served += 1
    assert served == len(models)
    await c.close()
    await server.stop()


@pytest.mark.parametrize("seed", [
    7101, pytest.param(7102, marks=pytest.mark.slow),
    pytest.param(7103, marks=pytest.mark.slow)])
def test_pipelined_clients_linearizable(seed):
    asyncio.run(_lin_scenario(seed))


# -- a real process, SIGKILL and restart --------------------------------------

def _boot(data, port=0):
    env = dict(os.environ, PYTHONPATH=ROOT)
    p = subprocess.Popen(
        [sys.executable, "-m", "riak_ensemble_tpu_torch.svcnode",
         "--device", "cpu", "--port", str(port), "--n-ens", "8",
         "--n-peers", "3", "--n-slots", "32", "--fast", "--dynamic",
         "--data-dir", data], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    line = p.stdout.readline()
    assert "svcnode serving" in line, (line, p.stderr.read()[-2000:])
    host, port = line.rsplit(" ", 1)[1].strip().rsplit(":", 1)
    return p, host, int(port)
