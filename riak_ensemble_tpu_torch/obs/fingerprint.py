"""Box fingerprint: the environment a measurement actually ran in.

The port's counterpart of ``riak_ensemble_tpu/obs/fingerprint.py``:
the same schema and the same keys where a key names nothing of JAX
(host, platform, python, cpu count, numpy, loadavg, ``RETPU_*`` knobs),
and in place of the reference's jax / jaxlib versions the port's own
stack — the torch version, the CUDA runtime torch was built for, and,
where ``nvidia-smi`` answers, the driver version, the card's name and
its power limit.  Every flight-recorder dump embeds it.

Static fields are cached; load-dependent fields (loadavg) are re-read
per call.  Reading it never initializes a CUDA context: versions come
from package metadata and ``torch.version``, the card from
``nvidia-smi``.
"""

from __future__ import annotations

import os
import platform
import shutil
import socket
import subprocess
import sys
from typing import Any, Dict, Optional

__all__ = ["box_fingerprint"]

_static: Dict[str, Any] = {}


def _pkg_version(name: str) -> str:
    try:
        from importlib.metadata import version
        return version(name)
    except Exception:
        return "unknown"


def _smi() -> Dict[str, Optional[str]]:
    """The card's name, power limit and driver version as
    ``nvidia-smi`` reports them (None each without one)."""
    out: Dict[str, Optional[str]] = {"card": None, "power_limit": None,
                                     "cuda_driver": None}
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return out
    try:
        line = subprocess.run(
            [smi, "--query-gpu=name,power.limit,driver_version",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=10).stdout.splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return out
    parts = [p.strip() for p in line.split(",")]
    if len(parts) == 3:
        out.update(card=parts[0], power_limit=parts[1],
                   cuda_driver=parts[2])
    return out


def box_fingerprint() -> Dict[str, Any]:
    """A plain JSON-able dict identifying the box + software + knob
    state.  Cheap after the first call."""
    if not _static:
        import torch

        _static.update({
            "schema": "retpu-box-fingerprint-v1",
            "hostname": socket.gethostname(),
            "platform": platform.platform(),
            "machine": platform.machine(),
            "python": sys.version.split()[0],
            "cpu_count": os.cpu_count(),
            "torch": torch.__version__,
            "cuda_runtime": torch.version.cuda,
            "numpy": _pkg_version("numpy"),
            **_smi(),
        })
    out = dict(_static)
    try:
        la1, la5, la15 = os.getloadavg()
        out["loadavg"] = [round(la1, 2), round(la5, 2),
                          round(la15, 2)]
    except (OSError, AttributeError):
        out["loadavg"] = None
    out["retpu_knobs"] = {k: v for k, v in os.environ.items()
                          if k.startswith("RETPU_")}
    return out
