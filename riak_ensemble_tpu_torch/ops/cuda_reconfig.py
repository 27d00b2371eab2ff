"""R1 — a joint-consensus reconfig step as one CUDA kernel.

``csrc/reconfig_step.cu`` computes the commit gate, the install and the
collapse of :func:`..engine.reconfig_step`, :func:`..engine.reconfig_propose`
and :func:`..engine.reconfig_transition` (the reference's,
``riak_ensemble_tpu/ops/engine.py:1262-1384``) for every row in ONE
launch, one thread a row.  It redesigns K1 for the reconfig path: the
torch steps launched K1 (``cuda_quorum``) once per gate, twice per
``reconfig_step``, among some 60 small ops.

CUDA contract: ``view_mask``, ``view_vsn``, ``pend_vsn``, ``commit_vsn``
and ``fact_seq`` are stepped IN PLACE (the donated contract of the
torch path's ``_stepped``); ``installed [E]`` / ``collapsed [E]`` come
back as new tensors.  ``propose`` None proposes nothing
(``reconfig_transition``); ``vsn`` None is ``pend_vsn + 1``, wrapping as
int32 (``reconfig_step``); ``run`` None is ``~propose``
(``reconfig_step``).  The wrapper raises on anything outside the
contract and never runs the plain version (``engine.reconfig_step_plain``
is its oracle).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from riak_ensemble_tpu_torch.ops import build, cuda_quorum

#: the kernel's contract: 4-word peer masks and K1's views
MAX_PEERS = 128
MAX_VIEWS = 8

#: launches of R1 since the count was last set to 0 — counted where the
#: kernel launches and nowhere else
reconfig_launches = 0

_N_PTRS = 14
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("reconfig_step").retpu_reconfig_step
        fn.argtypes = [ctypes.POINTER(ctypes.c_uint64),
                       ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def check_contract(state, propose: Optional[torch.Tensor],
                   new_view: Optional[torch.Tensor],
                   vsn: Optional[torch.Tensor], run: Optional[torch.Tensor],
                   up: torch.Tensor) -> None:
    """Raise ``TypeError`` / ``ValueError`` unless the step's inputs lie
    inside R1's contract: the engine's dtypes and shapes, one device,
    contiguous tensors, ``1 <= M <= 128`` and ``1 <= V <= 8``;
    ``new_view`` goes with ``propose``."""
    i32, b = torch.int32, torch.bool
    if state.epoch.dim() != 2:
        raise ValueError(f"epoch must be [E, M], got "
                         f"{tuple(state.epoch.shape)}")
    e, m = state.epoch.shape
    if not 1 <= m <= MAX_PEERS:
        raise ValueError(f"R1 takes 1 <= M <= {MAX_PEERS} peers, got {m}")
    if state.view_mask.dim() != 3:
        raise ValueError("view_mask must be [E, V, M]")
    v = state.view_mask.shape[1]
    if not 1 <= v <= MAX_VIEWS:
        raise ValueError(f"R1 takes 1 <= V <= {MAX_VIEWS} views, got {v}")
    if (propose is None) != (new_view is None):
        raise ValueError("propose and new_view go together")
    named = [
        ("view_mask", state.view_mask, b, (e, v, m)),
        ("view_vsn", state.view_vsn, i32, (e,)),
        ("pend_vsn", state.pend_vsn, i32, (e,)),
        ("commit_vsn", state.commit_vsn, i32, (e,)),
        ("fact_seq", state.fact_seq, i32, (e, m)),
        ("epoch", state.epoch, i32, (e, m)),
        ("leader", state.leader, i32, (e,)),
        ("up", up, b, (e, m)),
        ("propose", propose, b, (e,)), ("new_view", new_view, b, (e, m)),
        ("vsn", vsn, i32, (e,)), ("run", run, b, (e,)),
    ]
    dev = state.epoch.device
    for name, t, dtype, shape in named:
        if t is None:
            continue
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the state on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def reconfig_step(state, propose: Optional[torch.Tensor],
                  new_view: Optional[torch.Tensor],
                  vsn: Optional[torch.Tensor], run: Optional[torch.Tensor],
                  up: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One R1 launch over a CUDA engine state (see the module docstring):
    steps the membership planes in place and returns ``(installed [E],
    collapsed [E])``."""
    global reconfig_launches
    dev = state.epoch.device
    if dev.type != "cuda":
        raise ValueError(f"R1 runs on cuda, not {dev}")
    check_contract(state, propose, new_view, vsn, run, up)
    e, m = state.epoch.shape
    installed = torch.empty((e,), dtype=torch.bool, device=dev)
    collapsed = torch.empty((e,), dtype=torch.bool, device=dev)
    if e == 0:
        return installed, collapsed

    def ptr(t):
        return 0 if t is None else t.data_ptr()
    ptrs = (ctypes.c_uint64 * _N_PTRS)(*map(ptr, (
        state.view_mask, state.view_vsn, state.pend_vsn, state.commit_vsn,
        state.fact_seq, state.epoch, state.leader, up, propose, new_view,
        vsn, run, installed, collapsed)))
    dims = (ctypes.c_int * 3)(e, m, state.view_mask.shape[1])
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = cuda_quorum.call_on(dev, _kernel(), ptrs, dims, stream)
    if rc != 0:
        raise RuntimeError(f"R1 launch failed: cudaGetLastError() = {rc}")
    reconfig_launches += 1
    return installed, collapsed
