"""Multi-process bring-up of the port's mesh (``parallel/distributed.py``)
— the mirror of ``tests/test_distributed.py`` and of
``tests/test_multiprocess.py:180``.

- :func:`global_mesh` over one process's devices (eight ``cpu``
  shards): the shapes, 'peer' innermost, and an indivisible peer count
  refused; :func:`sharded_engine` elects and writes over every shard;
  :func:`initialize` is a no-op in one process.
- Two OS processes under :func:`initialize` over gloo (``tcp://``
  loopback, no JAX imported anywhere) form one global mesh: 4 ``cpu``
  shards each, an (8, 1) mesh whose 'ens' axis spans the processes, run
  the reference's CHILD scenario (elections, K/V, failover, a
  joint-consensus shrink, reads) through ``ShardedEngine``, and each
  process checks ITS shards against an unsharded run of the same
  scenario; then one ``cpu`` shard each, a (1, 2) mesh whose 'peer' axis
  spans them, runs it again with the quorum counts and maxima as
  ``all_reduce`` on the row's subgroup, checked the same way.

Tolerance: exact equality.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from riak_ensemble_tpu_torch.ops import engine as teng
from riak_ensemble_tpu_torch.parallel import distributed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = ["cpu"] * 8


@pytest.mark.parametrize("n_peer", [1, 2, 4])
def test_global_mesh_shapes(n_peer):
    mesh = distributed.global_mesh(n_peer=n_peer, devices=CPU8)
    assert mesh.shape == {"ens": 8 // n_peer, "peer": n_peer}
    assert mesh.all_local and mesh.rank == 0
    # 'peer' innermost: a row's peer shards are neighbouring devices
    order = [(i, j) for i in range(mesh.shape["ens"])
             for j in range(n_peer)]
    assert mesh.local_shards() == order


def test_global_mesh_rejects_indivisible():
    with pytest.raises(AssertionError):
        distributed.global_mesh(n_peer=3, devices=CPU8)


def test_sharded_engine_serves_over_all_devices():
    se = distributed.sharded_engine(n_peer=2, devices=CPU8)
    e, m = 8, 4
    state = se.init_state(e, m, 8, views=[list(range(m))])
    up = torch.ones((e, m), dtype=torch.bool)
    state, won = se.elect_step(state, torch.ones(e, dtype=torch.bool),
                               torch.zeros(e, dtype=torch.int32), up)
    kind = torch.full((2, e), teng.OP_PUT, dtype=torch.int32)
    slot = torch.zeros((2, e), dtype=torch.int32)
    val = torch.ones((2, e), dtype=torch.int32)
    state, res = se.kv_step_scan(state, kind, slot, val,
                                 torch.ones((2, e), dtype=torch.bool), up)
    assert won.numpy().all()
    assert res.committed.numpy().all()


def test_initialize_single_process_noop():
    assert distributed.initialize() is None
    assert distributed.initialize("127.0.0.1:1", 1, 0) is None
    assert not torch.distributed.is_initialized()


CHILD = r"""
import sys
sys.path.insert(0, {root!r})


class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "riak_ensemble_tpu"):
            raise ImportError("blocked: " + name)
        return None


sys.meta_path.insert(0, _Block())
import numpy as np
import torch
from riak_ensemble_tpu_torch.ops import engine as eng
from riak_ensemble_tpu_torch.parallel import distributed
from riak_ensemble_tpu_torch.parallel.mesh import ShardedEngine

pid = int(sys.argv[1])
coord = sys.argv[2]
backend = distributed.initialize(coord, 2, pid)
assert backend == "gloo", backend
S, K = 8, 4


def scenario(engine, state, e, m):
    rng = np.random.default_rng(7)
    t = torch.from_numpy
    kind = rng.choice([eng.OP_PUT, eng.OP_GET], (K, e)).astype(np.int32)
    slot = rng.integers(0, S, (K, e)).astype(np.int32)
    val = rng.integers(1, 1 << 20, (K, e)).astype(np.int32)
    lease = np.zeros((K, e), bool)
    up0 = np.ones((e, m), bool)
    up1 = up0.copy()
    up1[:, 0] = False                      # peer 0 dies everywhere
    elect = np.ones((e,), bool)
    shrink = np.ones((e, m), bool)
    shrink[:, 0] = False
    out = {{}}
    state, out["won0"] = engine.elect_step(
        state, t(elect), t(np.zeros(e, np.int32)), t(up0))
    state, res = engine.kv_step_scan(state, t(kind), t(slot), t(val),
                                     t(lease), t(up0))
    out["committed"] = res.committed
    state, out["won1"] = engine.elect_step(
        state, t(elect), t(np.ones(e, np.int32)), t(up1))
    state, out["installed"], _ = engine.reconfig_step(
        state, t(elect), t(shrink), t(up1))
    state, _, out["collapsed"] = engine.reconfig_step(
        state, t(np.zeros(e, bool)), t(shrink), t(up1))
    gk = np.full((K, e), eng.OP_GET, np.int32)
    state, res = engine.kv_step_scan(state, t(gk), t(slot),
                                     t(np.zeros((K, e), np.int32)),
                                     t(lease), t(up1))
    out["get_ok"], out["value"] = res.get_ok, res.value
    for f in eng.EngineState._fields:
        out[f] = getattr(state, f)
    return out


class _Local:
    elect_step = staticmethod(eng.elect_step)
    kv_step_scan = staticmethod(eng.kv_step_scan)
    reconfig_step = staticmethod(eng.reconfig_step)


def check(n_peer, devices, e, m, tag):
    mesh = distributed.global_mesh(n_peer=n_peer, devices=devices)
    se = ShardedEngine(mesh)
    got = scenario(se, se.init_state(e, m, S), e, m)
    want = scenario(_Local, eng.init_state(e, m, S, device="cpu"), e, m)
    checked = 0
    for name, arr in got.items():
        full = want[name].numpy()
        for idx, block in arr.shards():
            assert np.array_equal(block.numpy(), full[idx]), (tag, name)
            checked += 1
    assert checked > 0
    assert want["won1"].numpy().all() and want["collapsed"].numpy().all()
    print(f"{{tag}} ok ({{checked}} blocks, shards {{mesh.local_shards()}})",
          flush=True)


check(1, ["cpu"] * 4, 16, 3, "ENS-ACROSS")
check(2, ["cpu"], 4, 4, "PEER-ACROSS")
torch.distributed.destroy_process_group()
print("MPOK", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_mesh_engine_equivalence(tmp_path):
    script = tmp_path / "child.py"
    script.write_text(CHILD.format(root=ROOT))
    coord = f"127.0.0.1:{_free_port()}"
    # the processes run on the CPU: no card is theirs, so gloo
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(i), coord],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(tmp_path)) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=180)
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i}:\n{out[-3000:]}"
        assert "ENS-ACROSS ok" in out and "PEER-ACROSS ok" in out, out
        assert "MPOK" in out, out
    # each process held its own half of the (8, 1) grid
    assert "shards [(0, 0), (1, 0), (2, 0), (3, 0)]" in outs[0]
    assert "shards [(4, 0), (5, 0), (6, 0), (7, 0)]" in outs[1]
    assert "shards [(0, 0)]" in outs[0] and "shards [(0, 1)]" in outs[1]
