"""Kernels K1 and K2 — the quorum predicate — and their plain versions.

Both kernels live in ``csrc/quorum.cu``.  On a CUDA tensor a wrapper
launches its kernel; on a CPU tensor it runs the plain version, the
same function as torch ops.  There is no fallback between the two: a
CUDA call launches or raises.

K1, :func:`quorum_met_e`, is the wrapper the engine calls (replacing
the Pallas kernel ``quorum_met_epallas``,
``riak_ensemble_tpu/ops/pallas_quorum.py:172``): ``required="quorum"``,
no self term (the leader's vote is already in ``valid``), per-ensemble
view masks.  ``valid``/``nack`` are bool ``[R, M]``, ``view_mask`` bool
``[E, V, M]`` with ``R = E * w``: row ``r`` is judged against mask
``r // w``, so the engine's per-round call ``[E, W, M]`` passes the
unwidened mask.  Returns int8 ``[R]`` of MET / UNDECIDED / NACK.

K2, :func:`quorum_met_s` (replacing ``quorum_met_pallas``,
``pallas_quorum.py:83``), is ``quorum_met_batch`` over a 2-D ``[E, M]``
batch with ONE shared ``[V, M]`` mask, a self vote at ``self_idx`` and
every required mode.  As in the JAX package, no path of the service
calls it; it is held against its plain version on its own.

The bound at the main-path shape is bytes: about 200 KB (K1) or 150 KB
(K2) per call, ~0.05 us at 3.35 TB/s — both kernels are launch-bound
(see ``csrc/quorum.cu``; :func:`launch_floor` times an empty kernel on
K1's grid).  No path of the service launches K1 alone: its predicate
runs inside F1 (the flush), X1 (:mod:`.cuda_exchange`, the exchange)
and R1 (:mod:`.cuda_reconfig`, a reconfig step); the engine's election
step still calls it.
"""

from __future__ import annotations

import ctypes

import torch

from riak_ensemble_tpu_torch.ops import build
from riak_ensemble_tpu_torch.ops.quorum import (
    REQUIRED_MODES, quorum_met_batch, resolve_views)

#: limits of the kernels' contracts (the TPU kernels' one-tile bounds)
MAX_PEERS = 128
MAX_VIEWS = 8
MAX_VIEWS_S = 128

#: launches of each CUDA kernel since its count was last set to 0 —
#: counted where the kernel launches and nowhere else
quorum_launches = 0
quorum_s_launches = 0

_fns = {}


def _kernel(name: str = "retpu_quorum_met", n_ptr: int = 4,
            n_int: int = 4):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("quorum"), name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def call_on(dev: torch.device, fn, *args) -> int:
    """``fn(*args)``, a C entry point that launches on the current card,
    with ``dev`` the current card: the caller's current device may be
    another, and the stream in ``args`` belongs to ``dev``."""
    if torch.cuda.current_device() == dev.index:
        return fn(*args)
    with torch.cuda.device(dev):
        return fn(*args)


def _check(valid: torch.Tensor, nack: torch.Tensor,
           view_mask: torch.Tensor, w: int) -> None:
    if valid.dim() != 2 or nack.shape != valid.shape:
        raise ValueError(f"valid/nack must be [R, M] alike, got "
                         f"{tuple(valid.shape)} / {tuple(nack.shape)}")
    r, m = valid.shape
    if view_mask.dim() != 3 or view_mask.shape[2] != m \
            or view_mask.shape[0] * w != r or w < 1:
        raise ValueError(f"view_mask {tuple(view_mask.shape)} does not "
                         f"match [R={r}, M={m}] with w={w}")
    for name, t in (("valid", valid), ("nack", nack),
                    ("view_mask", view_mask)):
        if t.dtype != torch.bool:
            raise TypeError(f"{name} must be bool, got {t.dtype}")
        if t.device != valid.device:
            raise ValueError(f"{name} is on {t.device}, valid on "
                             f"{valid.device}")


def quorum_met_eplain(valid: torch.Tensor, nack: torch.Tensor,
                      view_mask: torch.Tensor, w: int = 1
                      ) -> torch.Tensor:
    """K1's function as plain torch ops (int32 counts): the CPU path
    and the kernel's oracle.  Same arguments as :func:`quorum_met_e`."""
    _check(valid, nack, view_mask, w)
    e, v, m = view_mask.shape
    vm = view_mask.to(torch.int32)[:, None]                 # [E, 1, V, M]
    va = valid.reshape(e, w, 1, m).to(torch.int32)          # [E, W, 1, M]
    na = nack.reshape(e, w, 1, m).to(torch.int32)
    members = vm.sum(-1, dtype=torch.int32)                 # [E, 1, V]
    heard = (vm * va).sum(-1, dtype=torch.int32)            # [E, W, V]
    n_nack = (vm * na).sum(-1, dtype=torch.int32)
    out = resolve_views(heard, n_nack, members, members // 2 + 1)
    return out.reshape(e * w)


def quorum_met_e(valid: torch.Tensor, nack: torch.Tensor,
                 view_mask: torch.Tensor, w: int = 1) -> torch.Tensor:
    """The engine's quorum predicate: the CUDA kernel for CUDA tensors,
    :func:`quorum_met_eplain` for CPU tensors."""
    global quorum_launches
    if valid.device.type == "cpu":
        return quorum_met_eplain(valid, nack, view_mask, w)
    _check(valid, nack, view_mask, w)
    if valid.device.type != "cuda":
        raise ValueError(f"quorum_met_e runs on cuda or cpu, "
                         f"not {valid.device}")
    r, m = valid.shape
    v = view_mask.shape[1]
    if m > MAX_PEERS or v > MAX_VIEWS:
        raise ValueError(f"K1 takes M <= {MAX_PEERS} and V <= "
                         f"{MAX_VIEWS}, got M={m}, V={v}")
    for name, t in (("valid", valid), ("nack", nack),
                    ("view_mask", view_mask)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((r,), dtype=torch.int8, device=valid.device)
    if r == 0:
        return out
    stream = torch.cuda.current_stream(valid.device).cuda_stream
    rc = call_on(valid.device, _kernel(), valid.data_ptr(), nack.data_ptr(),
                 view_mask.data_ptr(), out.data_ptr(), r, m, v, w, stream)
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: cudaGetLastError() = {rc}")
    quorum_launches += 1
    return out


def launch_floor(rows: int, device: torch.device) -> None:
    """Launch the empty kernel with K1's grid for ``rows`` rows through
    K1's ctypes route: what any launch of that grid costs on the card
    (its time is the floor under K1, K2 and R1).  Not counted: no path
    runs it."""
    if device.type != "cuda":
        raise ValueError(f"the launch floor runs on cuda, not {device}")
    fn = _fns.get("retpu_launch_floor")
    if fn is None:
        fn = getattr(build.load("quorum"), "retpu_launch_floor")
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["retpu_launch_floor"] = fn
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = call_on(device, fn, rows, stream)
    if rc != 0:
        raise RuntimeError(f"launch floor failed: cudaGetLastError() = {rc}")


def _check_s(valid: torch.Tensor, nack: torch.Tensor,
             view_mask: torch.Tensor, self_idx: torch.Tensor,
             required: str) -> None:
    if required not in REQUIRED_MODES:
        raise ValueError(f"required must be one of {REQUIRED_MODES}, "
                         f"got {required!r}")
    if valid.dim() != 2 or nack.shape != valid.shape:
        raise ValueError(f"valid/nack must be [E, M] alike, got "
                         f"{tuple(valid.shape)} / {tuple(nack.shape)}")
    e, m = valid.shape
    if view_mask.dim() != 2 or view_mask.shape[1] != m:
        raise ValueError(f"view_mask must be a shared [V, M={m}] mask, "
                         f"got {tuple(view_mask.shape)}")
    if self_idx.shape != (e,) or self_idx.dtype != torch.int32:
        raise ValueError(f"self_idx must be int32 [E={e}], got "
                         f"{self_idx.dtype} {tuple(self_idx.shape)}")
    for name, t in (("valid", valid), ("nack", nack),
                    ("view_mask", view_mask)):
        if t.dtype != torch.bool:
            raise TypeError(f"{name} must be bool, got {t.dtype}")
    for name, t in (("nack", nack), ("view_mask", view_mask),
                    ("self_idx", self_idx)):
        if t.device != valid.device:
            raise ValueError(f"{name} is on {t.device}, valid on "
                             f"{valid.device}")


def quorum_met_splain(valid: torch.Tensor, nack: torch.Tensor,
                      view_mask: torch.Tensor, self_idx: torch.Tensor,
                      required: str = "quorum") -> torch.Tensor:
    """K2's function as plain torch ops: ``quorum_met_batch`` on the
    shared mask, after K2's checks.  The CPU path and the kernel's
    oracle; same arguments as :func:`quorum_met_s`."""
    _check_s(valid, nack, view_mask, self_idx, required)
    return quorum_met_batch(valid, nack, view_mask, self_idx, required)


def quorum_met_s(valid: torch.Tensor, nack: torch.Tensor,
                 view_mask: torch.Tensor, self_idx: torch.Tensor,
                 required: str = "quorum") -> torch.Tensor:
    """``quorum_met_batch`` with one shared ``[V, M]`` mask: bool
    ``[E, M]`` valid/nack, int32 ``[E]`` self_idx (outside ``[0, M)``
    casts no self vote) → int8 ``[E]``.  The CUDA kernel K2 for CUDA
    tensors, :func:`quorum_met_splain` for CPU tensors."""
    global quorum_s_launches
    if valid.device.type == "cpu":
        return quorum_met_splain(valid, nack, view_mask, self_idx,
                                 required)
    _check_s(valid, nack, view_mask, self_idx, required)
    if valid.device.type != "cuda":
        raise ValueError(f"quorum_met_s runs on cuda or cpu, "
                         f"not {valid.device}")
    e, m = valid.shape
    v = view_mask.shape[0]
    if m > MAX_PEERS or v > MAX_VIEWS_S:
        raise ValueError(f"K2 takes M <= {MAX_PEERS} and V <= "
                         f"{MAX_VIEWS_S}, got M={m}, V={v}")
    for name, t in (("valid", valid), ("nack", nack),
                    ("view_mask", view_mask), ("self_idx", self_idx)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((e,), dtype=torch.int8, device=valid.device)
    if e == 0:
        return out
    stream = torch.cuda.current_stream(valid.device).cuda_stream
    rc = call_on(valid.device, _kernel("retpu_quorum_met_shared", 5, 4),
                 valid.data_ptr(), nack.data_ptr(), view_mask.data_ptr(),
                 self_idx.data_ptr(), out.data_ptr(), e, m, v,
                 REQUIRED_MODES.index(required), stream)
    if rc != 0:
        raise RuntimeError(f"K2 launch failed: cudaGetLastError() = {rc}")
    quorum_s_launches += 1
    return out
