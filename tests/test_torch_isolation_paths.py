"""The port's paths run in subprocesses with ``jax`` and the JAX package
blocked (the blocker and the import scan are in ``test_torch_isolation.py``):
the simulator runtime and the lifecycle path, a ``ServiceClient`` session
with obs on, a wide and sharded service, a three-host group with the
replica CLI, the scalar plane's verify recipe, and the scale plane (a
tenant moved by a svcnode's registration, the read fast path under the
port's ``KeyModel``, the netnode CLI).
"""

import os
import subprocess
import sys

from test_torch_isolation import PKG, ROOT, _BLOCKED_IMPORT


_LIFECYCLE = r"""
import sys, tempfile
sys.path.insert(0, ROOT)
import numpy as np
from riak_ensemble_tpu_torch.config import fast_test_config
from riak_ensemble_tpu_torch.parallel.batched_host import (
    BatchedEnsembleService)
from riak_ensemble_tpu_torch.runtime import Actor, Network, Runtime, Task
rt = Runtime(seed=5)
assert isinstance(rt.net, Network)
seen = []

class Echo(Actor):
    def handle(self, msg):
        seen.append((round(self.runtime.now, 6), msg))

Echo(rt, "echo", "n1")
rt.net_send("n2", "echo", "hi")

def sleeper():
    yield rt.sleep(0.5)
    seen.append(("woke", rt.now))

assert isinstance(rt.spawn_task(sleeper()), Task)
d = tempfile.mkdtemp()
svc = BatchedEnsembleService(rt, 4, 3, 4, tick=0.005,
                             config=fast_test_config(), dynamic=True,
                             device="cpu", data_dir=d)
row = svc.create_ensemble("orders")
assert rt.await_future(svc.kput(row, "k", b"v"), 5)[0] == "ok"
view = np.ones((4, 3), bool)
view[:, 2] = False
assert svc.update_members(np.ones(4, bool), view)[row]
assert svc.destroy_ensemble("orders") and svc.create_ensemble("b") == row
rt.run_for(1.0)
svc.stop()
svc._wal.close()
back = BatchedEnsembleService.restore(rt, d, tick=None, device="cpu")
assert back.dynamic and back.resolve_ensemble("b") == row
assert len(seen) == 2 and seen[1][0] == "woke", seen
print("LIFECYCLE OK")
"""


def test_runtime_and_lifecycle_run_with_jax_blocked():
    """The simulator runtime (an actor, a network send, a task) and the
    lifecycle path (a timer-driven dynamic service: create, a keyed
    write, ``update_members``, destroy, a durable restore) run with
    ``jax`` and the JAX package blocked."""
    code = f"ROOT = {ROOT!r}\n" + _BLOCKED_IMPORT.split(
        "sys.path.insert")[0] + _LIFECYCLE
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LIFECYCLE OK" in proc.stdout


_FRONT_END = r"""
import asyncio, sys
sys.path.insert(0, ROOT)
from riak_ensemble_tpu_torch import svcnode
from riak_ensemble_tpu_torch.config import fast_test_config
from riak_ensemble_tpu_torch.utils.trace import Tracer

async def main():
    srv = await svcnode.serve(4, 3, 8, config=fast_test_config(),
                              device="cpu", dynamic=True)
    tr = Tracer(srv.svc.runtime, registry=srv.svc.obs_registry).install()
    c = svcnode.ServiceClient(srv.host, srv.port)
    await c.connect()
    row = (await c.create_ensemble("orders"))[1]
    assert (await c.kput_many(row, ["a", "b"], [b"1", b"2"]))[0][0] == "ok"
    assert await c.kget(row, "a") == ("ok", b"1")
    assert (await c.stats())["obs_enabled"] is True
    assert "retpu_trace_events_total" in await c.metrics("prometheus")
    assert tr.counters.get("svc_launch", 0) >= 1
    await c.close()
    await srv.stop()
asyncio.run(main())
from riak_ensemble_tpu_torch import wire
assert wire._NATIVE is not None
with open("/proc/self/maps") as maps:
    print("\n".join(sorted({ln.split()[-1] for ln in maps
                            if ln.rstrip().endswith(".so")})))
print("FRONT END OK")
"""


def test_front_end_serves_with_jax_blocked():
    """A ServiceClient session against ``serve(..., device="cpu")`` (obs
    on, a tracer folded into the registry) runs with ``jax`` and the JAX
    package blocked, on the port's own wire codec build."""
    code = f"ROOT = {ROOT!r}\n" + _BLOCKED_IMPORT.split(
        "sys.path.insert")[0] + _FRONT_END
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "FRONT END OK" in proc.stdout
    mapped = proc.stdout.split()
    build_dir = os.path.join(PKG, "build") + os.sep
    codec = [p for p in mapped if "_retpu_wire" in p]
    assert len(codec) == 1 and codec[0].startswith(build_dir), mapped
    native = os.path.join(ROOT, "native") + os.sep
    assert not [p for p in mapped if p.startswith(native)], mapped


_WIDE_SHARDED = r"""
import sys
sys.path.insert(0, ROOT)
import numpy as np
from riak_ensemble_tpu_torch.ops import engine as eng
from riak_ensemble_tpu_torch.parallel.batched_host import (
    BatchedEnsembleService, WallRuntime)
svc = BatchedEnsembleService(WallRuntime(), 4, 3, 16, tick=None,
                             max_ops_per_tick=8, device="cpu", wide=True,
                             validate_wide=True, resolve_shards=2)
futs = [svc.kput_many(e, ["a", "b", "a"], [b"1", b"2", b"3"])
        for e in range(4)]
svc.flush()
assert all(f.done for f in futs), futs
g = [svc.kget_many(e, ["a", "b"]) for e in range(4)]
svc.flush()
kind = np.full((4, 4), eng.OP_PUT, np.int32)
slot = np.tile(np.arange(4, dtype=np.int32)[:, None], (1, 4))
assert svc.execute(kind, slot, np.ones((4, 4), np.int32))[0].all()
st = svc.stats()
assert st["wide_launches"] >= 2 and st["resolve_shards"]["shards"] == 2
assert st["resolve_shards"]["sharded_flushes"] > 0
assert [f.value for f in g] == [[("ok", b"3"), ("ok", b"2")]] * 4
svc.stop()
assert svc._resolve_pool is None
print("WIDE SHARDED OK")
"""


def test_wide_and_sharded_service_run_with_jax_blocked():
    """Wide rounds (a duplicate chain, so G = 2) and the sharded host
    passes run with ``jax`` and the JAX package blocked."""
    code = f"ROOT = {ROOT!r}\n" + _BLOCKED_IMPORT.split(
        "sys.path.insert")[0] + _WIDE_SHARDED
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "WIDE SHARDED OK" in proc.stdout


_GROUP = r"""
import sys, time
sys.path.insert(0, ROOT)
from riak_ensemble_tpu_torch import funref
from riak_ensemble_tpu_torch.parallel import repgroup
from riak_ensemble_tpu_torch.parallel.batched_host import WallRuntime
srvs = [repgroup.ReplicaServer(4, 3, 8, device="cpu") for _ in range(2)]
svc = repgroup.ReplicatedService(
    WallRuntime(), 4, 1, 8, group_size=3, device="cpu",
    peers=[("127.0.0.1", s.repl_port) for s in srvs])
assert svc.takeover()
futs = [svc.kput_many(e, ["a", "b"], [b"1", b"2"]) for e in range(4)]
while not all(f.done for f in futs):
    svc.flush()
futs += [svc.kmodify_many(e, ["c", "c"], funref.ref("rmw:add", 2), 0)
         for e in range(4)]
while not all(f.done for f in futs):
    svc.flush()
assert all(r[0] == "ok" for f in futs for r in f.value), futs
svc.heartbeat()
g = svc.stats()["group"]
assert g["repl_delta_entries"] > 0 and g["repl_merge_cells"] > 0, g
want = repgroup.dump_state(svc)
for s in srvs:
    while s.core.applied_seq < svc.core.applied_seq:
        time.sleep(0.01)
    with s._lock:
        assert repgroup.dump_state(s.svc) == want
svc.stop()
for s in srvs:
    s.stop()
import runpy
sys.argv = ["repgroup", "--help"]
try:
    runpy.run_module("riak_ensemble_tpu_torch.parallel.repgroup",
                     run_name="__main__")
except SystemExit as exc:
    assert exc.code == 0
print("GROUP OK")
"""


def test_group_runs_with_jax_blocked():
    """A three-host group in one process — full, delta and merge entries,
    replicas bit-equal to the leader — and the replica host's CLI, with
    ``jax`` and the JAX package blocked."""
    code = f"ROOT = {ROOT!r}\n" + _BLOCKED_IMPORT.split(
        "sys.path.insert")[0] + _GROUP
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "GROUP OK" in proc.stdout and "--device" in proc.stdout


_SCALAR = r"""
import sys
sys.path.insert(0, ROOT)
from riak_ensemble_tpu_torch.testing import Cluster, ManagedCluster, make_peers
from riak_ensemble_tpu_torch.types import NOTFOUND, PeerId

c = Cluster(seed=42)
peers = make_peers(3)
c.create_ensemble("demo", peers)
leader = c.wait_stable("demo")
c.kput_ok("demo", "k", b"v")
assert c.kget_value("demo", "k") == b"v"
c.suspend_peer("demo", leader)
assert c.runtime.run_until(
    lambda: c.leader_id("demo") not in (None, leader), 60)
c.wait_stable("demo")
assert c.kget_value("demo", "k") == b"v"
assert c.kget("demo", "missing")[1].value is NOTFOUND

mc = ManagedCluster(seed=15, nodes=("node0", "node1", "node2"))
mc.enable("node0")
mc.join("node1", "node0")
mc.join("node2", "node0")
mc.create_ensemble("ens1", [PeerId(i, f"node{i}") for i in range(3)])
mc.wait_stable("ens1")
cl = mc.client("node1")
assert cl.kover("ens1", "key", b"val")[0] == "ok"
assert cl.kget("ens1", "key")[1].value == b"val"
from riak_ensemble_tpu_torch.utils import clock
assert clock.monotonic_time_ns() > 0
print("SCALAR OK")
"""


def test_scalar_plane_recipe_runs_with_jax_blocked():
    """The verify recipe on the port's ``testing.Cluster`` (create, wait
    stable, a put read back), a failover, and a managed three-node
    cluster's client, with ``jax`` and the JAX package blocked."""
    code = f"ROOT = {ROOT!r}\n" + _BLOCKED_IMPORT.split(
        "sys.path.insert")[0] + _SCALAR
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "SCALAR OK" in proc.stdout


_SCALE = r"""
import runpy, sys
sys.path.insert(0, ROOT)
from riak_ensemble_tpu_torch import service_directory as sd
from riak_ensemble_tpu_torch import service_manager as sm
from riak_ensemble_tpu_torch.config import fast_test_config
from riak_ensemble_tpu_torch.linearizability import ServiceReadWorkload
from riak_ensemble_tpu_torch.parallel.batched_host import (
    BatchedEnsembleService)
from riak_ensemble_tpu_torch.runtime import Runtime
from riak_ensemble_tpu_torch.testing import ManagedCluster

mc = ManagedCluster(seed=5, nodes=("node0", "node1"))
mc.enable("node0")
mc.join("node1", "node0")
reg, svcs = {}, {}
for node in ("node0", "node1"):
    name = "svc@" + node
    svcs[name] = BatchedEnsembleService(mc.runtime, 8, 3, 8, tick=0.05,
                                        config=fast_test_config(),
                                        dynamic=True, device="cpu")
    reg[name] = sm.ServiceReconciler(mc.runtime, mc.mgr(node), svcs[name],
                                     name, reg.get, poll=0.2)
    if node == "node0":
        assert sd.register_service(mc.mgr(node), mc.runtime, name, "h", 1,
                                   (8, 3, 8)) == "ok"
        for t in ("t0", "t1", "t2", "t3"):
            assert sm.create_tenant(mc.mgr(node), mc.runtime, t) == "ok"
        s0 = svcs[name]
        assert mc.runtime.run_until(lambda: len(s0._ens_names) == 4, 60.0)
        futs = [s0.kput(s0.resolve_ensemble(t), "k", t.encode())
                for t in s0._ens_names]
        assert mc.runtime.run_until(lambda: all(f.done for f in futs), 60)
assert sd.register_service(mc.mgr("node1"), mc.runtime, "svc@node1", "h", 2,
                           (8, 3, 8)) == "ok"
both = sorted(svcs)
assert mc.runtime.run_until(lambda: all(
    svcs[sm.place(t, both)].resolve_ensemble(t) is not None
    for t in ("t0", "t1", "t2", "t3")) and not reg["svc@node1"]._importing,
    60.0)
s1 = svcs["svc@node1"]
assert s1._ens_names
for t in s1._ens_names:
    f = s1.kget(s1.resolve_ensemble(t), "k")
    assert mc.runtime.run_until(lambda: f.done, 30.0)
    assert f.value == ("ok", t.encode()), f.value

rt = Runtime(seed=1201)
svc = BatchedEnsembleService(rt, 4, 5, n_slots=8, tick=None,
                             max_ops_per_tick=8, config=fast_test_config(),
                             device="cpu")
ServiceReadWorkload(svc, rt, seed=1201, rounds=10).run()
assert svc.read_fastpath_hits > 0
print("SCALE OK", flush=True)
sys.argv = ["netnode", "--help"]
runpy.run_module("riak_ensemble_tpu_torch.netnode", run_name="__main__")
"""


def test_scale_plane_runs_with_jax_blocked():
    """A tenant moved between two reconciled services by a svcnode's
    registration, the read fast path under the port's ``KeyModel``, and
    the netnode CLI, with ``jax`` and the JAX package blocked."""
    code = f"ROOT = {ROOT!r}\n" + _BLOCKED_IMPORT.split(
        "sys.path.insert")[0] + _SCALE
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "SCALE OK" in proc.stdout and "--script" in proc.stdout
