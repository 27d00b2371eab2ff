"""The torch port stands alone: it imports neither ``jax`` nor any module
of ``riak_ensemble_tpu``, its entry points never drift onto the CPU, and
the host library its service loads is its own build.

A subprocess installs a meta-path blocker for both names and imports
every module of ``riak_ensemble_tpu_torch`` plus ``chip_smoke``'s
module-level imports; a source scan checks the same rule as text.  Each
slice's modules are named, so a rename cannot drop them from the blocked
import: the durability slice's (``faults``, ``save``,
``synctree.native_store``, ``parallel.wal``, ``ops.checkpoint``), the
front end's (``wire``, ``state``, ``netruntime``, ``svcnode``, every
``obs`` module, ``utils.trace``), the wide-round slice's
(``ops.schedule``, the wide steps of ``ops.engine``), the replication
slice's (``parallel.repgroup``, ``obs.watchdog``, ``proxy``), the scalar
plane's (``types``, ``state``, ``storage``, ``msg``, ``router``,
``directory``, ``lease``, ``backend``, ``worker``, ``peer``, ``root``,
``manager``, ``client``, ``app``, ``testing``, the host synctree,
``synctree.remote_sync``, ``ops.hash``, ``ops.quorum``, ``utils.clock``),
the scale plane's (``service_directory``, ``service_manager``,
``linearizability``, ``netnode``) and the mesh's (``parallel.mesh``,
``parallel.distributed``) and the tools' (``tools.trace_export``).  The
names the package ``__init__``s re-export (the reference's: ``Obj`` ...
``NOTFOUND`` at the top, the quorum names in ``ops``, ``ShardedEngine``
and ``make_mesh`` in ``parallel``) import under the same blocker and
create no CUDA context.  A second subprocess builds a service
with the native host passes and reads the shared objects it mapped: the
host library lies under ``riak_ensemble_tpu_torch/build/`` and nothing
under ``native/`` is loaded.  A third runs ``python -m
riak_ensemble_tpu_torch.svcnode --help`` with both names blocked.  The
entry points, the group's included, default to the card.

``tests/test_torch_isolation_paths.py`` runs each slice's path in a
subprocess under the same blocker.
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
SCALE_MODULES = ("service_directory", "service_manager", "linearizability",
                 "netnode")
MESH_MODULES = ("parallel.mesh", "parallel.distributed")
TOOL_MODULES = ("tools", "tools.trace_export")
#: what each ``__init__`` re-exports, as the reference's do
EXPORTS = {"": ("__version__", "Obj", "Fact", "PeerId", "EnsembleInfo",
                "NOTFOUND", "resolve_device"),
           ".ops": ("MET", "UNDECIDED", "NACK", "quorum_met",
                    "quorum_met_batch"),
           ".parallel": ("ShardedEngine", "make_mesh")}

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
                + GROUP_MODULES + SCALAR_MODULES + SCALE_MODULES
                + MESH_MODULES + TOOL_MODULES):
        assert "riak_ensemble_tpu_torch." + mod in names, mod


_EXPORTS_BLOCKED = r"""
import importlib, torch
for sub, names in EXPORTS.items():
    mod = importlib.import_module("riak_ensemble_tpu_torch" + sub)
    for name in names:
        getattr(mod, name)
exec("from riak_ensemble_tpu_torch import " + ", ".join(EXPORTS[""]))
from riak_ensemble_tpu_torch.ops import MET, quorum_met_batch
from riak_ensemble_tpu_torch.parallel import ShardedEngine, make_mesh
assert not torch.cuda.is_initialized(), "an import made a CUDA context"
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "riak_ensemble_tpu"))
assert not leaked, leaked
print("EXPORTED")
"""


def test_package_exports_with_jax_and_reference_blocked():
    code = (f"ROOT = {ROOT!r}\nEXPORTS = {EXPORTS!r}\n"
            + _BLOCKED_IMPORT.split("import riak_ensemble_tpu_torch as")[0]
            + _EXPORTS_BLOCKED)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "EXPORTED" in proc.stdout


def _reference_exports(rel):
    """The names a reference ``__init__`` binds at its top level, read
    from its source (importing it could import JAX)."""
    import ast

    with open(os.path.join(ROOT, "riak_ensemble_tpu", rel,
                           "__init__.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets)
    return names


def test_exports_cover_the_references():
    """Every name a reference ``__init__`` exports (the top level, ``ops``,
    ``parallel``), the port's counterpart exports too, and the version
    string is the same."""
    import importlib

    for sub in sorted(EXPORTS):
        want = _reference_exports(sub.replace(".", "/").lstrip("/"))
        assert want and want <= set(EXPORTS[sub]), (sub, want)
        mod = importlib.import_module("riak_ensemble_tpu_torch" + sub)
        assert want <= set(dir(mod)), (sub, want - set(dir(mod)))
    with open(os.path.join(ROOT, "riak_ensemble_tpu", "__init__.py"),
              encoding="utf-8") as f:
        assert re.search(r'__version__ = "([^"]+)"', f.read()).group(1) \
            == riak_ensemble_tpu_torch.__version__


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
    # the reference's flag, which the mesh slice brought to the port
    assert "--mesh-devices MESH_DEVICES" in proc.stdout
