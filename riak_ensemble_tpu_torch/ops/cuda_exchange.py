"""X1 — the anti-entropy exchange as one CUDA kernel.

``csrc/exchange_step.cu`` runs :func:`..engine.exchange_step` (the
reference's ``exchange_step``, ``riak_ensemble_tpu/ops/engine.py:1139-1219``)
in ONE launch: the quorum gate (kernel K1's predicate, ``cuda_quorum``,
inside the launch), the slot pass and the replica pass, on the rows in
``run`` only.  It redesigns K1 for the exchange path as F1 redesigned it
for the flush: the torch body launched K1 once and some 30 passes over
the whole store.  :func:`exchange_step` is the wrapper the engine calls
for a CUDA state; a CPU state takes ``engine.exchange_step_plain``.

CUDA contract: the object and tree planes of the stepped rows are
updated IN PLACE (rows outside ``run`` keep every plane bit for bit), and
``diverged [E, M]`` / ``synced [E]`` come back as new tensors.  A caller
that must roll back keeps the planes of the ``run`` rows first
(``engine.keep_rows``).  The wrapper raises on anything outside the
kernel's contract (:func:`check_contract`) and never runs the plain
version.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from riak_ensemble_tpu_torch.ops import build, cuda_engine, cuda_quorum
from riak_ensemble_tpu_torch.ops import hash as hashk

#: the kernel's contract: K1's (4-word peer masks, V <= 8)
MAX_PEERS = 128
MAX_VIEWS = 8

#: launches of X1 since the count was last set to 0 — counted where the
#: kernel launches and nowhere else
exchange_launches = 0

_N_PTRS = 11
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("exchange_step").retpu_exchange_step
        fn.argtypes = [ctypes.POINTER(ctypes.c_uint64),
                       ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def check_contract(state, run: torch.Tensor, up: torch.Tensor) -> None:
    """Raise ``TypeError`` / ``ValueError`` unless the exchange's inputs
    lie inside X1's contract: the engine's dtypes and shapes, one device,
    contiguous planes (``tree_leaf`` on a 16-byte boundary: a slot's four
    lanes load as one vector), ``1 <= M <= 128`` and ``1 <= V <= 8``."""
    i32, b = torch.int32, torch.bool
    if state.obj_epoch.dim() != 3:
        raise ValueError(f"obj_epoch must be [E, M, S], got "
                         f"{tuple(state.obj_epoch.shape)}")
    e, m, s = state.obj_epoch.shape
    if not 1 <= m <= MAX_PEERS:
        raise ValueError(f"X1 takes 1 <= M <= {MAX_PEERS} peers, got {m}")
    if state.view_mask.dim() != 3:
        raise ValueError("view_mask must be [E, V, M]")
    v = state.view_mask.shape[1]
    if not 1 <= v <= MAX_VIEWS:
        raise ValueError(f"X1 takes 1 <= V <= {MAX_VIEWS} views, got {v}")
    u = cuda_engine.n_uppers(s)
    named = [
        ("view_mask", state.view_mask, b, (e, v, m)),
        ("obj_epoch", state.obj_epoch, i32, (e, m, s)),
        ("obj_seq", state.obj_seq, i32, (e, m, s)),
        ("obj_val", state.obj_val, i32, (e, m, s)),
        ("tree_leaf", state.tree_leaf, i32, (e, m, s, hashk.LANES)),
        ("tree_node", state.tree_node, i32, (e, m, u, hashk.LANES)),
        ("run", run, b, (e,)), ("up", up, b, (e, m)),
    ]
    dev = state.obj_epoch.device
    for name, t, dtype, shape in named:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the state on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if state.tree_leaf.data_ptr() & 15:
        raise ValueError("tree_leaf must start on a 16-byte boundary")


def exchange_step(state, run: torch.Tensor, up: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One X1 launch over a CUDA engine state (see the module docstring):
    steps the run rows' object and tree planes in place and returns
    ``(diverged [E, M], synced [E])``."""
    global exchange_launches
    dev = state.obj_epoch.device
    if dev.type != "cuda":
        raise ValueError(f"X1 runs on cuda, not {dev}")
    check_contract(state, run, up)
    e, m, s = state.obj_epoch.shape
    diverged = torch.empty((e, m), dtype=torch.bool, device=dev)
    synced = torch.empty((e,), dtype=torch.bool, device=dev)
    if e == 0:
        return diverged, synced
    ptrs = (ctypes.c_uint64 * _N_PTRS)(*(t.data_ptr() for t in (
        state.obj_epoch, state.obj_seq, state.obj_val, state.tree_leaf,
        state.tree_node, state.view_mask, up, run,
        cuda_engine._fold_consts_on(dev), diverged, synced)))
    dims = (ctypes.c_int * 5)(e, m, s, state.tree_node.shape[2],
                              state.view_mask.shape[1])
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = cuda_quorum.call_on(dev, _kernel(), ptrs, dims, stream)
    if rc != 0:
        raise RuntimeError(f"X1 launch failed: cudaGetLastError() = {rc}")
    exchange_launches += 1
    return diverged, synced


def design_bytes(run: np.ndarray, heard: np.ndarray, synced: np.ndarray,
                 changed: dict, s: int, v: int) -> dict:
    """The bytes one exchange must move on these inputs, counted on the
    host: ``run [E]``, ``heard [E, M]`` (up members), ``synced [E]`` (the
    rows that adopted), ``changed`` the count of elements each plane's
    write changed (``obj_epoch`` / ``obj_seq`` / ``obj_val`` elements,
    ``tree_leaf`` / ``tree_node`` hashes of 16 bytes).  Reads: ``run``;
    the ``up`` and view masks of the run rows (the gate); the object,
    leaf and upper-node planes of each heard replica of an adopting row.
    Writes: ``diverged``, ``synced`` and the changed elements."""
    e, m = heard.shape
    u = cuda_engine.n_uppers(s)
    replica = 3 * s * 4 + s * 16 + u * 16
    reads = {"gate": e + int(run.sum()) * (m + v * m),
             "replicas": int((heard & synced[:, None]).sum()) * replica}
    writes = {"results": e * m + e,
              "objects": 4 * sum(changed.get(k, 0) for k in
                                 ("obj_epoch", "obj_seq", "obj_val")),
              "tree": 16 * (changed.get("tree_leaf", 0)
                            + changed.get("tree_node", 0))}
    return {"read": reads, "written": writes,
            "bytes": sum(reads.values()) + sum(writes.values())}


def design_ops(heard_adopting: int, found_slots: int, rebuilt: int,
               s: int) -> int:
    """The int32 operations one exchange's design needs, counted on the
    host at :mod:`.cuda_engine`'s price per fold and per leaf hash:
    ``heard_adopting`` heard replicas of adopting rows, each with a leaf
    verdict per slot and a node verdict per upper node (+4 a compare);
    ``found_slots`` slots with a winner, whose new leaf is hashed once;
    ``rebuilt`` replicas refolded (a written leaf or a failed verdict),
    every upper node once."""
    u = cuda_engine.n_uppers(s)
    return (heard_adopting * (s * (cuda_engine.LEAF_OPS + 4)
                              + u * (cuda_engine.FOLD_OPS + 4))
            + found_slots * cuda_engine.LEAF_OPS
            + rebuilt * u * cuda_engine.FOLD_OPS)
