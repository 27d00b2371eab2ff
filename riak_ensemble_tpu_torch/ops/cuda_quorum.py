"""Kernel K1 — the engine's quorum predicate — and its plain version.

:func:`quorum_met_e` is the wrapper the engine calls.  On a CUDA tensor
it launches the hand-written kernel in ``csrc/quorum.cu`` (replacing
the Pallas kernel ``quorum_met_epallas``,
``riak_ensemble_tpu/ops/pallas_quorum.py:172``); on a CPU tensor it
runs :func:`quorum_met_eplain`, the same function as torch ops.  There
is no fallback between the two: a CUDA call launches or raises.

The function: ``required="quorum"``, no self term (the leader's vote is
already in ``valid``), per-ensemble view masks.  ``valid``/``nack`` are
bool ``[R, M]``, ``view_mask`` bool ``[E, V, M]`` with ``R = E * w``:
row ``r`` is judged against mask ``r // w``, so the engine's per-round
call ``[E, W, M]`` passes the unwidened mask.  Returns int8 ``[R]`` of
MET / UNDECIDED / NACK.

The bound at the main-path shape is bytes: about 200 KB read and
10 KB written per call, ~0.06 us at 3.35 TB/s — the kernel is
launch-bound (see ``csrc/quorum.cu``).
"""

from __future__ import annotations

import ctypes

import torch

from riak_ensemble_tpu_torch.ops import build
from riak_ensemble_tpu_torch.ops.quorum import resolve_views

#: limits of the kernel's contract (the TPU kernel's one-tile bounds)
MAX_PEERS = 128
MAX_VIEWS = 8

#: launches of the CUDA kernel since the count was last set to 0 —
#: counted where the kernel launches and nowhere else
quorum_launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("quorum").retpu_quorum_met
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


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
    rc = _kernel()(valid.data_ptr(), nack.data_ptr(),
                   view_mask.data_ptr(), out.data_ptr(), r, m, v, w,
                   stream)
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: cudaGetLastError() = {rc}")
    quorum_launches += 1
    return out
