"""Build the package's CUDA and host sources and load them with ctypes.

Each ``csrc/<name>.cu`` compiles, at first use, into its own shared
library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

under ``riak_ensemble_tpu_torch/build/`` (listed in ``.gitignore``).
The file name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds
and an unchanged one is reused.

The host passes of the service (``csrc/host/*.cc``: the enqueue pack and
gather, the resolve unpack, mirror scatter and WAL encode, and the
treestore that holds the WAL) build the same way into ONE library, with
the host compiler::

    g++ -O2 -fPIC -std=c++17 -shared -o build/libretpu_host-<hash>.so \\
        csrc/host/enqueuekernel.cc csrc/host/resolvekernel.cc \\
        csrc/host/treestore.cc

its hash covering every source, the compiler and the flags.  A failed
build raises; nothing falls back.  Nothing here runs at import time;
:func:`build_all` starts one compiler per library, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional, Tuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")

HOST_DIR = os.path.join(CSRC_DIR, "host")
HOST_SOURCES = ("enqueuekernel.cc", "resolvekernel.cc", "treestore.cc")
#: the host compiler (a path or a name on PATH) and its flags
HOST_CXX = "g++"
HOST_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")
#: the name :func:`build_all` reports the host library's build under
HOST = "host"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, spills) per built source, for the record
build_log: Dict[str, str] = {}


def sources() -> List[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def nvcc_path() -> str:
    cand = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "riak_ensemble_tpu_torch build on a machine "
                           "with the CUDA toolkit")
    return cand


def _lib_path(name: str) -> str:
    """The library's path: its name carries a digest of the source, of
    every shared header (``csrc/*.cuh``) and of the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for f in [name + ".cu", *headers]:
        digest.update(f.encode())
        with open(os.path.join(CSRC_DIR, f), "rb") as src:
            digest.update(src.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _nvcc_cmd(name: str, out: str) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", out,
            os.path.join(CSRC_DIR, name + ".cu")]


def _host_lib_path() -> str:
    """The host library's path: its name carries a digest of the
    compiler, the flags and every source."""
    digest = hashlib.sha256(" ".join((HOST_CXX, *HOST_FLAGS)).encode())
    for f in HOST_SOURCES:
        digest.update(f.encode())
        with open(os.path.join(HOST_DIR, f), "rb") as src:
            digest.update(src.read())
    return os.path.join(BUILD_DIR,
                        f"libretpu_host-{digest.hexdigest()[:12]}.so")


def _host_cmd(out: str) -> List[str]:
    return [HOST_CXX, *HOST_FLAGS, "-o", out,
            *(os.path.join(HOST_DIR, f) for f in HOST_SOURCES)]


def build_all(names: Optional[List[str]] = None,
              host: bool = True) -> Dict[str, float]:
    """Compile every (or the named) CUDA source, and with ``host`` the
    host library, that has no current library yet: one compiler process
    per library, all started together.  Returns the wall seconds of the
    whole build per name (``HOST`` for the host library; 0.0 where the
    library was already current).  Raises on the first failed build,
    with the compiler's output."""
    names = sources() if names is None else names
    jobs = [(name, _lib_path(name), lambda out, n=name: _nvcc_cmd(n, out))
            for name in names]
    if host:
        jobs.append((HOST, _host_lib_path(), _host_cmd))
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs: List[Tuple[str, str, str, subprocess.Popen]] = []
    secs: Dict[str, float] = {}
    failed = []
    t0 = time.perf_counter()
    for name, out, cmd in jobs:
        if os.path.exists(out):
            secs[name] = 0.0
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        try:
            procs.append((name, out, tmp, subprocess.Popen(
                cmd(tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        except OSError as exc:   # the compiler itself is missing
            failed.append(f"building {name} failed: {exc}")
    for name, out, tmp, p in procs:
        log, _ = p.communicate()
        secs[name] = time.perf_counter() - t0
        build_log[name] = log
        if p.returncode != 0:
            failed.append(f"building {name} failed ({p.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not os.path.exists(path):
                build_all([name])
            lib = _libs[name] = ctypes.CDLL(path)
    return lib


def load_host() -> ctypes.CDLL:
    """The loaded host library (``csrc/host/*.cc``), built first if
    needed with ``HOST_CXX``; raises when it cannot be built."""
    path = _host_lib_path()
    lib = _libs.get(path)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(path)
        if lib is None:
            if not os.path.exists(path):
                build_all([])
            lib = _libs[path] = ctypes.CDLL(path)
    return lib
