"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles, at first use, into its own shared
library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

under ``riak_ensemble_tpu_torch/build/`` (listed in ``.gitignore``).
The file name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds
and an unchanged one is reused.  Nothing here runs at
import time; :func:`build_all` starts one nvcc per source, all at once.
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


def build_all(names: Optional[List[str]] = None) -> Dict[str, float]:
    """Compile every (or the named) source that has no current library
    yet: one nvcc process per source, all started together.  Returns
    the wall seconds of the whole build per source name (0.0 where the
    library was already current).  Raises on the first failed build,
    with nvcc's output."""
    names = sources() if names is None else names
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs: List[Tuple[str, str, str, subprocess.Popen]] = []
    secs: Dict[str, float] = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            secs[name] = 0.0
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        procs.append((name, out, tmp, subprocess.Popen(
            _nvcc_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, p in procs:
        log, _ = p.communicate()
        secs[name] = time.perf_counter() - t0
        build_log[name] = log
        if p.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({p.returncode}):\n{log}")
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
