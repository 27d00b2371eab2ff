"""The port's svcnode against the JAX package's over the wire and as a
process: response frames equal to the JAX server's, clients of either
package on servers of the other, and a SIGKILL restart that reads back every
acknowledged write (the verb-table cases and the shared helpers are in
``test_torch_svcnode.py``).
"""

import asyncio
import signal

import pytest

from riak_ensemble_tpu_torch import svcnode, wire
from riak_ensemble_tpu_torch.config import fast_test_config
from riak_ensemble_tpu_torch.types import NOTFOUND
from test_torch_reference_natives import reference_natives  # noqa: F401 (autouse)
from test_torch_svcnode import SERIAL, _boot, _serial_frames


def test_serial_response_frames_equal_jax_server():
    pytest.importorskip("jax")
    from riak_ensemble_tpu import svcnode as jsvc
    from riak_ensemble_tpu.config import fast_test_config as jcfg
    ref = asyncio.run(_serial_frames(jsvc, jcfg()))
    got = asyncio.run(_serial_frames(svcnode, fast_test_config()))
    assert len(got) == len(SERIAL)
    for req, a, b in zip(SERIAL, ref, got):
        assert b == a, (req, wire.decode(a), wire.decode(b))


def test_clients_work_across_packages():
    pytest.importorskip("jax")
    from riak_ensemble_tpu import svcnode as jsvc
    from riak_ensemble_tpu.config import fast_test_config as jcfg
    from riak_ensemble_tpu.types import NOTFOUND as JNF

    async def drive(server_mod, client_mod, cfg, nf, **kw):
        server = await server_mod.serve(2, 3, 16, port=0, config=cfg, **kw)
        c = client_mod.ServiceClient(server.host, server.port)
        await c.connect()
        assert (await c.kput(0, "k", b"v"))[0] == "ok"
        assert (await c.kput_many(1, ["a", "b"], [b"1", b"2"]))[1][0] == "ok"
        got = await c.kget_many(1, ["a", "b", "c"], want_vsn=True)
        assert got[:2] == [("ok", b"1", (1, 1)), ("ok", b"2", (1, 2))]
        assert got[2] == ("ok", nf, (0, 0)) and got[2][1] is nf
        assert await c.kget(0, "k") == ("ok", b"v")
        assert (await c.stats())["flushes"] >= 2
        assert "retpu_flushes_total" in await c.metrics()
        await c.close()
        await server.stop()

    asyncio.run(drive(svcnode, jsvc, fast_test_config(), JNF,
                      device="cpu"))
    asyncio.run(drive(jsvc, svcnode, jcfg(), NOTFOUND))


def test_sigkill_restart_reads_back_acked_writes(tmp_path):
    data = str(tmp_path / "d")
    p, host, port = _boot(data)
    acked = {}
    try:
        async def write():
            c = svcnode.ServiceClient(host, port)
            await c.connect()
            rows = {}
            for name in ("alpha", "beta"):
                rows[name] = (await c.create_ensemble(name))[1]
            for i in range(4):
                keys = [f"k{i}.{j}" for j in range(16)]
                vals = [b"v%d.%d" % (i, j) for j in range(16)]
                row = rows["alpha" if i % 2 else "beta"]
                res = await c.kput_many(row, keys, vals)
                for k, v, r in zip(keys, vals, res):
                    if r[0] == "ok":
                        acked[(row, k)] = v
            await c.close()
            return rows
        rows = asyncio.run(write())
    finally:
        p.send_signal(signal.SIGKILL)
        p.wait(30)
    assert len(acked) == 64
    p, host, port = _boot(data)
    try:
        async def read():
            c = svcnode.ServiceClient(host, port)
            await c.connect()
            for name, row in rows.items():
                assert await c.resolve_ensemble(name) == ("ok", row)
            for row in set(rows.values()):
                keys = [k for (r, k) in acked if r == row]
                got = await c.kget_many(row, keys)
                assert [g[1] for g in got] == [acked[(row, k)]
                                               for k in keys]
            await c.close()
        asyncio.run(read())
    finally:
        p.send_signal(signal.SIGKILL)
        p.wait(30)
