"""The torch port stands alone: it imports neither ``jax`` nor any module
of ``riak_ensemble_tpu``, its entry points never drift onto the CPU, and
the host library its service loads is its own build.  The durability
slice's modules (``faults``, ``save``, ``synctree.native_store``,
``parallel.wal``, ``ops.checkpoint``) are named, so a rename cannot drop
them from the blocked import.

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
    assert n == len(mods) + 1 and n >= 15
    names = {m.name for m in mods}
    for mod in DURABILITY_MODULES:
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
    st = eng.init_state(2, 3, 16, device="cpu")
    assert st.epoch.device.type == "cpu"


def test_service_takes_no_timer_mode():
    with pytest.raises(NotImplementedError):
        BatchedEnsembleService(WallRuntime(), 2, 3, 16, tick=0.005,
                               device="cpu")
