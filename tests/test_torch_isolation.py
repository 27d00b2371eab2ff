"""The torch port stands alone: it imports neither ``jax`` nor any module
of ``riak_ensemble_tpu``, its entry points never drift onto the CPU, and
the host library its service loads is its own build.  The durability
slice's modules (``faults``, ``save``, ``synctree.native_store``,
``parallel.wal``, ``ops.checkpoint``) are named, so a rename cannot drop
them from the blocked import; a third subprocess drives the simulator
runtime and the lifecycle path (dynamic rows, ``update_members``, a
restore) with both names blocked.  The front end's modules (``wire``,
``state``, ``netruntime``, ``svcnode``, every ``obs`` module,
``utils.trace``) are named too; a fourth subprocess serves a
``ServiceClient`` session with obs on and both names blocked, and maps
only the port's own wire codec; a fifth runs
``python -m riak_ensemble_tpu_torch.svcnode --help``.  The wide-round
slice's modules (``ops.schedule``, the wide steps of ``ops.engine``) are
named too, and a sixth subprocess runs a service with ``wide=True`` and
``resolve_shards=2`` (wide launches, sharded passes, ``stop()``) with
both names blocked.  The replication slice's modules
(``parallel.repgroup``, ``obs.watchdog``, ``proxy``) are named too; a
seventh subprocess runs a three-host group in one process (deltas, a
merge entry, bit-equal replicas) and ``python -m
riak_ensemble_tpu_torch.parallel.repgroup --help`` with both names
blocked, and the group's entry points default to the card as well.
The scalar plane's modules (``types``, ``state``, ``storage``, ``msg``,
``router``, ``directory``, ``lease``, ``backend``, ``worker``, ``peer``,
``root``, ``manager``, ``client``, ``app``, ``testing``, the host
synctree, ``synctree.remote_sync``, ``ops.hash``, ``ops.quorum`` and
``utils.clock``) are named too, and an eighth subprocess runs the
verify recipe (``testing.Cluster`` → ``create_ensemble`` →
``wait_stable`` → ``kput_ok`` / ``kget_value``), a failover and a
managed cluster's client with both names blocked.

A subprocess installs a meta-path blocker for both names and imports
every module of ``riak_ensemble_tpu_torch`` plus ``chip_smoke``'s
module-level imports; a source scan checks the same rule as text.  A
second subprocess builds a service with the native host passes and reads
the shared objects it mapped: the host library lies under
``riak_ensemble_tpu_torch/build/`` and nothing under ``native/`` is
loaded.
"""

import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import riak_ensemble_tpu_torch
from riak_ensemble_tpu_torch.ops import engine as eng
from riak_ensemble_tpu_torch.parallel.batched_host import (
    BatchedEnsembleService, WallRuntime)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "riak_ensemble_tpu_torch")
DURABILITY_MODULES = ("faults", "save", "synctree.native_store",
                      "parallel.wal", "ops.checkpoint")
FRONT_END_MODULES = ("wire", "state", "netruntime", "svcnode", "obs",
                     "obs.registry", "obs.spans", "obs.fingerprint",
                     "obs.flightrec", "obs.opslo", "obs.controller",
                     "obs.fleet", "utils.trace")
WIDE_MODULES = ("ops.schedule", "ops.engine", "ops.cuda_engine",
                "parallel.batched_host")
GROUP_MODULES = ("parallel.repgroup", "obs.watchdog", "proxy")
SCALAR_MODULES = ("types", "state", "storage", "msg", "router", "directory",
                  "lease", "backend", "worker", "peer", "root", "manager",
                  "client", "app", "testing", "synctree",
                  "synctree.backends", "synctree.tree", "synctree.peer_tree",
                  "synctree.exchange", "synctree.remote_sync", "ops.hash",
                  "ops.quorum", "utils.clock")

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

class Blocker:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "riak_ensemble_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Blocker())
sys.path.insert(0, ROOT)
import riak_ensemble_tpu_torch as pkg
names = [pkg.__name__] + [m.name for m in pkgutil.walk_packages(
    pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # module level only: main() runs under __main__
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "riak_ensemble_tpu"))
assert not leaked, leaked
print("IMPORTED", len(names))
"""


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, files in os.walk(PKG):
        if os.sep + "build" in dirpath[len(PKG):]:
            continue
        out += [os.path.join(dirpath, f) for f in files
                if f.endswith((".py", ".cu", ".cuh", ".cc"))]
    return sorted(out)


def test_port_imports_with_jax_and_reference_blocked():
    code = f"ROOT = {ROOT!r}\n" + _BLOCKED_IMPORT
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n = int(proc.stdout.split("IMPORTED")[1])
    mods = list(pkgutil.walk_packages(riak_ensemble_tpu_torch.__path__,
                                      "riak_ensemble_tpu_torch."))
    assert n == len(mods) + 1 and n >= 28
    names = {m.name for m in mods}
    for mod in (DURABILITY_MODULES + FRONT_END_MODULES + WIDE_MODULES
                + GROUP_MODULES + SCALAR_MODULES):
        assert "riak_ensemble_tpu_torch." + mod in names, mod


def test_port_sources_name_no_jax_or_reference_module():
    bad = re.compile(r"^\s*(import jax|from jax)|riak_ensemble_tpu\.",
                     re.MULTILINE)
    hits = []
    for path in _port_sources():
        with open(path, encoding="utf-8") as f:
            for m in bad.finditer(f.read()):
                hits.append(f"{os.path.relpath(path, ROOT)}: {m.group(0)}")
    assert not hits, hits


_HOST_LIBRARY = r"""
import sys
sys.path.insert(0, ROOT)
from riak_ensemble_tpu_torch.parallel.batched_host import (
    BatchedEnsembleService, WallRuntime)
import tempfile
svc = BatchedEnsembleService(WallRuntime(), 2, 3, 8, tick=None, device="cpu",
                             data_dir=tempfile.mkdtemp())
f = svc.kput_many(0, ["k"], [b"1"]); svc.flush()
assert f.value == [("ok", (1, 1))] and svc.native_enqueue_flushes == 1
assert type(svc._wal._store).__name__ == "NativeBackend"
assert svc._wal.count == 1          # the treestore of the port's build
with open("/proc/self/maps") as maps:
    print("\n".join(sorted({ln.split()[-1] for ln in maps
                            if ln.rstrip().endswith(".so")})))
"""


def test_host_library_is_the_ports_own_build():
    code = f"ROOT = {ROOT!r}\n" + _BLOCKED_IMPORT.split(
        "sys.path.insert")[0] + _HOST_LIBRARY
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    mapped = proc.stdout.split()
    build_dir = os.path.join(PKG, "build") + os.sep
    host = [p for p in mapped if "libretpu_host" in p]
    assert len(host) == 1 and host[0].startswith(build_dir), mapped
    native = os.path.join(ROOT, "native") + os.sep
    assert not [p for p in mapped if p.startswith(native)
                or "_retpu_resolve" in p], mapped


def test_entry_points_default_to_cuda():
    """``init_state`` and the service without ``device=`` run on the
    card; without one they raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        st = eng.init_state(2, 3, 16)
        assert st.epoch.device.type == "cuda"
        svc = BatchedEnsembleService(WallRuntime(), 2, 3, 16, tick=None)
        assert svc.state.obj_val.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        eng.init_state(2, 3, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedEnsembleService(WallRuntime(), 2, 3, 16, tick=None)
    from riak_ensemble_tpu_torch.parallel import repgroup
    with pytest.raises(RuntimeError, match="CUDA"):
        repgroup.ReplicatedService(WallRuntime(), 2, 1, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        repgroup.ReplicaServer(2, 3, 16)
    st = eng.init_state(2, 3, 16, device="cpu")
    assert st.epoch.device.type == "cpu"


def test_service_takes_no_timer_mode():
    """:class:`WallRuntime` has no event loop, so it takes no timer mode:
    a timer-driven service on it raises (``tick=None`` is its mode)."""
    with pytest.raises(RuntimeError, match="event loop"):
        BatchedEnsembleService(WallRuntime(), 2, 3, 16, tick=0.005,
                               device="cpu")


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


def test_svcnode_help_runs_with_jax_blocked():
    code = (f"ROOT = {ROOT!r}\n" + _BLOCKED_IMPORT.split(
        "sys.path.insert")[0] + "sys.path.insert(0, ROOT)\n"
        "import runpy\n"
        "sys.argv = ['svcnode', '--help']\n"
        "runpy.run_module('riak_ensemble_tpu_torch.svcnode',"
        " run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "--device" in proc.stdout and "--data-dir" in proc.stdout
    assert "--mesh-devices N" not in proc.stdout
    assert "--mesh-devices MESH_DEVICES" not in proc.stdout


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
