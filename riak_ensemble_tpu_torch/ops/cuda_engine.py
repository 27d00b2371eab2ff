"""F1 — the engine's flush step as one CUDA kernel.

``csrc/engine_step.cu`` runs the election, the round context, the K K/V
rounds and the follower epoch adoption of every ensemble in ONE launch
(one thread block per ensemble, its planes staged in shared memory), the
quorum predicate inside it.  It redesigns kernel K1 (``cuda_quorum``),
which the torch round loop launched K + 2 times per flush, and replaces
that loop: ``engine.full_step``, ``kv_step_scan`` and ``kv_step`` call
:func:`engine_step` for a state on CUDA and their plain versions
(``full_step_plain``, ``kv_step_scan_plain``) for a state on the CPU.

:func:`engine_step` updates every state plane IN PLACE and returns
``won [E]`` (None without an election) and the stacked result planes in
``KvResult`` field order.  It raises on anything outside the kernel's
contract (:func:`check_contract`) and on a device other than CUDA; it
never runs the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from riak_ensemble_tpu_torch.ops import build
from riak_ensemble_tpu_torch.ops import hash as hashk

#: the kernel's contract: peers fit one warp's lanes (and a 32-bit peer
#: mask), views fit its view table, rounds are capped
MAX_PEERS = 32
MAX_VIEWS = 8
MAX_ROUNDS = 4096
#: shared memory a block may take on the H100 (227 KB), less a margin
#: for the kernel's own static arrays
MAX_SHARED_BYTES = 232_448 - 1_024

#: launches of F1 since the count was last set to 0 — counted where the
#: kernel launches and nowhere else
engine_step_launches = 0

_N_PTRS = 28
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load("engine_step")
        _fn = lib.retpu_engine_step
        _fn.argtypes = [ctypes.POINTER(ctypes.c_uint64),
                        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        _fn.restype = ctypes.c_int
    return _fn


def n_uppers(n_slots: int) -> int:
    """Upper tree nodes of an ``n_slots``-leaf width-16 trie (the sum of
    ``engine.tree_sizes``)."""
    total, n = 0, n_slots
    while n > 1:
        n = -(-n // 16)
        total += n
    return max(total, 1)


def shared_bytes(m: int, s: int, u: int) -> int:
    """Dynamic shared memory of one block (``smem_bytes`` in the
    kernel): three object planes padded to 16 bytes, the leaves, the
    uppers."""
    return 4 * 3 * ((m * s + 3) & ~3) + 16 * m * s + 16 * m * u


def fold_consts() -> torch.Tensor:
    """The fold's 16 position salts then 16 odd multipliers, as the int32
    bit patterns the kernel reads as uint32 (``hash._fold_consts_np``)."""
    salt, mul = hashk._fold_consts_np(16)
    return torch.cat([torch.from_numpy(salt[:, 0]),
                      torch.from_numpy(mul[:, 0])])


@functools.lru_cache(maxsize=None)
def _fold_consts_on(device: torch.device) -> torch.Tensor:
    return fold_consts().to(device)


def _want(name, t, dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def check_contract(state, elect: Optional[torch.Tensor],
                   cand: Optional[torch.Tensor], kind: torch.Tensor,
                   slot: torch.Tensor, val: torch.Tensor,
                   lease_ok: torch.Tensor, up: torch.Tensor,
                   exp_epoch: Optional[torch.Tensor] = None,
                   exp_seq: Optional[torch.Tensor] = None) -> None:
    """Raise ``TypeError`` / ``ValueError`` unless every argument lies
    inside F1's contract: the engine's dtypes and shapes, one device,
    contiguous 16-byte aligned tensors, ``1 <= M <= 32``,
    ``1 <= V <= 8``, ``K <= MAX_ROUNDS`` and the block's staged planes
    within ``MAX_SHARED_BYTES``."""
    i32, b = torch.int32, torch.bool
    e, m = state.epoch.shape if state.epoch.dim() == 2 else (-1, -1)
    if e < 0:
        raise ValueError(f"epoch must be [E, M], got "
                         f"{tuple(state.epoch.shape)}")
    if not 1 <= m <= MAX_PEERS:
        raise ValueError(f"F1 takes 1 <= M <= {MAX_PEERS} peers, got {m}")
    if state.view_mask.dim() != 3:
        raise ValueError("view_mask must be [E, V, M]")
    v = state.view_mask.shape[1]
    if not 1 <= v <= MAX_VIEWS:
        raise ValueError(f"F1 takes 1 <= V <= {MAX_VIEWS} views, got {v}")
    if state.obj_epoch.dim() != 3:
        raise ValueError("obj_epoch must be [E, M, S]")
    s = state.obj_epoch.shape[2]
    u = n_uppers(s)
    if kind.dim() != 2:
        raise ValueError(f"kind must be [K, E], got {tuple(kind.shape)}")
    k = kind.shape[0]
    if k > MAX_ROUNDS:
        raise ValueError(f"F1 takes K <= {MAX_ROUNDS} rounds, got {k}")
    need = shared_bytes(m, s, u)
    if need > MAX_SHARED_BYTES:
        raise ValueError(f"M={m} x S={s} needs {need} B of shared memory "
                         f"per block, over F1's {MAX_SHARED_BYTES}")
    named = [
        ("epoch", state.epoch, i32, (e, m)),
        ("fact_seq", state.fact_seq, i32, (e, m)),
        ("leader", state.leader, i32, (e,)),
        ("obj_seq_ctr", state.obj_seq_ctr, i32, (e,)),
        ("view_mask", state.view_mask, b, (e, v, m)),
        ("obj_epoch", state.obj_epoch, i32, (e, m, s)),
        ("obj_seq", state.obj_seq, i32, (e, m, s)),
        ("obj_val", state.obj_val, i32, (e, m, s)),
        ("tree_leaf", state.tree_leaf, i32, (e, m, s, hashk.LANES)),
        ("tree_node", state.tree_node, i32, (e, m, u, hashk.LANES)),
        ("kind", kind, i32, (k, e)), ("slot", slot, i32, (k, e)),
        ("val", val, i32, (k, e)), ("lease_ok", lease_ok, b, (k, e)),
        ("up", up, b, (e, m)),
    ]
    if (elect is None) != (cand is None):
        raise ValueError("elect and cand go together")
    if elect is not None:
        named += [("elect", elect, b, (e,)), ("cand", cand, i32, (e,))]
    for name, t in (("exp_epoch", exp_epoch), ("exp_seq", exp_seq)):
        if t is not None:
            named.append((name, t, i32, (k, e)))
    dev = state.epoch.device
    for name, t, dtype, shape in named:
        _want(name, t, dtype, shape)
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the state on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.numel() and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def engine_step(state, elect: Optional[torch.Tensor],
                cand: Optional[torch.Tensor], kind: torch.Tensor,
                slot: torch.Tensor, val: torch.Tensor,
                lease_ok: torch.Tensor, up: torch.Tensor,
                exp_epoch: Optional[torch.Tensor] = None,
                exp_seq: Optional[torch.Tensor] = None
                ) -> Tuple[Optional[torch.Tensor], Tuple[torch.Tensor, ...]]:
    """One F1 launch over a CUDA engine state (see the module docstring).
    ``elect``/``cand`` None skip the election (``kv_step_scan``).
    Returns ``(won, (committed, get_ok, found, value, obj_vsn,
    quorum_ok, tree_corrupt))``."""
    global engine_step_launches
    if state.epoch.device.type != "cuda":
        raise ValueError(f"F1 runs on cuda, not {state.epoch.device}")
    check_contract(state, elect, cand, kind, slot, val, lease_ok, up,
                   exp_epoch, exp_seq)
    dev = state.epoch.device
    k, e = kind.shape
    m = state.epoch.shape[1]

    def empty(*shape, dtype=torch.bool):
        return torch.empty(shape, dtype=dtype, device=dev)
    res = (empty(k, e), empty(k, e), empty(k, e),
           empty(k, e, dtype=torch.int32), empty(k, e, 2, dtype=torch.int32),
           empty(k, e), empty(k, e, m))
    won = None if elect is None else empty(e)
    if e == 0:
        return won, res

    def ptr(t):
        return 0 if t is None else t.data_ptr()
    ptrs = (ctypes.c_uint64 * _N_PTRS)(*map(ptr, (
        state.epoch, state.fact_seq, state.leader, state.obj_seq_ctr,
        state.view_mask, state.obj_epoch, state.obj_seq, state.obj_val,
        state.tree_leaf, state.tree_node, elect, cand, kind, slot, val,
        lease_ok, exp_epoch, exp_seq, up, _fold_consts_on(dev), won,
        *res)))
    dims = (ctypes.c_int * 6)(
        e, m, state.obj_epoch.shape[2], state.tree_node.shape[2],
        state.view_mask.shape[1], k)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _kernel()(ptrs, dims, stream)
    if rc != 0:
        raise RuntimeError(f"F1 launch failed: cudaGetLastError() = {rc}")
    engine_step_launches += 1
    return won, res
