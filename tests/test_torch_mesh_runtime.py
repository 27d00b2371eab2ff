"""The service over the port's mesh engine on the simulator runtime, and
``svcnode --mesh-devices`` — the mirrors of ``tests/test_batched_host.py:
164`` / ``:273`` and of the reference's ``--mesh-devices`` flag.

- the service over a (4, 2) mesh on the port's ``Runtime`` (timer-driven
  flushes, ``fast_test_config``): puts and gets, every leader killed and
  re-elected, the reads again — equal to the JAX service on the JAX
  ``Runtime`` with the same seed and sequence;
- ``update_members`` through the serving path over the (4, 2) mesh,
  equal to the JAX service;
- ``python -m riak_ensemble_tpu_torch.svcnode --mesh-devices 4 --device
  cpu`` as a process: a ``ServiceClient`` writes, every acknowledged
  write reads back, and ``stats`` shows the shard-wise pack.

Tolerance: exact equality.
"""

import asyncio
import os
import socket
import subprocess
import sys

import numpy as np

from riak_ensemble_tpu_torch.config import fast_test_config
from riak_ensemble_tpu_torch.parallel import batched_host as tb
from riak_ensemble_tpu_torch.parallel.mesh import ShardedEngine, make_mesh
from riak_ensemble_tpu_torch.runtime import Runtime
from test_torch_compaction import norm
from test_torch_kmodify import FixedClock
from test_torch_mesh_service import drive, jb  # noqa: F401
from test_torch_reference_natives import reference_natives  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _settle(runtime, fut, timeout=5.0):
    return runtime.await_future(fut, timeout)


def test_service_composes_with_sharded_engine(jb):
    """test_batched_host.py:164 at (4, 2) on the port's simulator
    runtime: puts and gets, then every leader killed and the service
    re-elects; the JAX service on its own runtime, same seed and
    sequence, reads and elects the same."""
    from riak_ensemble_tpu.config import fast_test_config as jcfg
    from riak_ensemble_tpu.runtime import Runtime as JRuntime
    arms = []
    for rt, svc_cls, cfg, engine in (
            (JRuntime(seed=51), jb.BatchedEnsembleService, jcfg(), None),
            (Runtime(seed=51), tb.BatchedEnsembleService, fast_test_config(),
             ShardedEngine(make_mesh(4, 2, devices=["cpu"] * 8)))):
        svc = svc_cls(rt, n_ens=8, n_peers=4, n_slots=16, tick=0.005,
                      config=cfg, engine=engine)
        got = [_settle(rt, svc.kput(e, "k", f"v{e}".encode()))[0]
               for e in range(8)]
        got += [_settle(rt, svc.kget(e, "k")) for e in range(8)]
        leaders = np.asarray(svc.leader_np).copy()
        for e in range(8):
            svc.set_peer_up(e, int(leaders[e]), False)
        svc.lease_until[:] = 0.0
        rt.run_for(0.1)
        new = np.asarray(svc.leader_np).copy()
        assert (new != leaders).all()
        got += [_settle(rt, svc.kget(e, "k")) for e in range(8)]
        arms.append((got, leaders, new))
        svc.stop()
    (ja, jl, jn), (ta, tl, tn) = arms
    assert ta[:8] == ["ok"] * 8
    assert ta[8:] == [("ok", f"v{e}".encode()) for e in range(8)] * 2
    assert [norm(x) for x in ja] == [norm(x) for x in ta]
    assert np.array_equal(jl, tl) and np.array_equal(jn, tn)


def test_service_update_members_sharded_engine(jb):
    """test_batched_host.py:273: a membership change through the serving
    path composes with the (4, 2) mesh, and equals the JAX service."""
    results = []
    for svc in (jb.BatchedEnsembleService(FixedClock(), 8, 8, 8, tick=None),
                tb.BatchedEnsembleService(
                    FixedClock(), 8, 8, 8, tick=None,
                    engine=ShardedEngine(make_mesh(4, 2,
                                                   devices=["cpu"] * 8)))):
        out = drive(svc, [svc.kput(e, "k", b"x%d" % e) for e in range(8)])
        new_view = np.ones((8, 8), bool)
        new_view[:, 7] = False
        changed = svc.update_members(np.ones(8, bool), new_view)
        assert np.asarray(changed).all()
        out += drive(svc, [svc.kget(e, "k") for e in range(8)])
        results.append((out, np.asarray(svc.member_np).copy()))
        svc.stop()
    assert results[0][0] == results[1][0]
    assert results[1][0][8:] == [("ok", b"x%d" % e) for e in range(8)]
    assert np.array_equal(results[0][1], results[1][1])


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_svcnode_mesh_devices_serves_acked_writes(tmp_path):
    """``--mesh-devices 4 --device cpu``: the node serves from a mesh of
    four ``cpu`` shards; every acknowledged write reads back."""
    from riak_ensemble_tpu_torch.svcnode import ServiceClient
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "riak_ensemble_tpu_torch.svcnode",
         "--port", str(port), "--n-ens", "16", "--n-peers", "3",
         "--n-slots", "16", "--device", "cpu", "--mesh-devices", "4",
         "--data-dir", str(tmp_path / "d")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT, env=env)
    try:
        line = proc.stdout.readline()
        assert "svcnode serving 16 ensembles" in line, line

        async def run():
            c = ServiceClient("127.0.0.1", port)
            await c.connect()
            try:
                acked = {}
                for e in range(16):
                    for i in range(3):
                        r = await c.kput(e, f"k{i}", b"v%d.%d" % (e, i))
                        if r[0] == "ok":
                            acked[(e, f"k{i}")] = b"v%d.%d" % (e, i)
                got = {key: await c.kget(*key) for key in acked}
                stats = await c.stats()
                return acked, got, stats
            finally:
                await c.close()
        acked, got, stats = asyncio.run(asyncio.wait_for(run(), 120))
        assert len(acked) == 48
        assert all(got[k] == ("ok", v) for k, v in acked.items())
        assert stats["flushes"] > 0
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
