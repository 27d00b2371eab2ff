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

Sliced mode (``engine.full_step_sliced``): with a host ``active_idx [A]``
the grid is A blocks, block b steps state row ``active_idx[b]`` in place,
and the op, election and result planes are A-wide.  The wrapper checks
the index on the host (:func:`check_active`) and uploads it itself.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
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
#: kernel launches and nowhere else; the sliced ones also in the second
engine_step_launches = 0
engine_step_sliced_launches = 0

_N_PTRS = 30
_N_DIMS = 7
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


def check_active(active_idx, e: int) -> int:
    """Raise ``TypeError`` / ``ValueError`` unless ``active_idx`` is a
    sliced launch's host index: a 1-D numpy int32 array of A >= 1 entries,
    the real ones ascending, distinct and below ``e``, then any number of
    padding entries equal to ``e``.  Two blocks stepping one row would race,
    so a duplicate raises here instead of launching.  Returns how many
    entries are real."""
    if not isinstance(active_idx, np.ndarray):
        raise TypeError("active_idx must be a host numpy array, got "
                        f"{type(active_idx).__name__}")
    if active_idx.dtype != np.int32 or active_idx.ndim != 1:
        raise TypeError(f"active_idx must be 1-D int32, got "
                        f"{active_idx.dtype} {active_idx.shape}")
    if active_idx.size == 0:
        raise ValueError("active_idx is empty")
    n_real = int(np.count_nonzero(active_idx < e))
    real, pads = active_idx[:n_real], active_idx[n_real:]
    if (real < 0).any():
        raise ValueError("active_idx holds a negative row")
    if (pads != e).any():
        raise ValueError(f"active_idx: after the real rows every entry must "
                         f"be the padding index {e}")
    if n_real > 1 and not (np.diff(real) > 0).all():
        raise ValueError("active_idx: the real rows must ascend with no "
                         "duplicate")
    return n_real


def check_contract(state, elect: Optional[torch.Tensor],
                   cand: Optional[torch.Tensor], kind: torch.Tensor,
                   slot: torch.Tensor, val: torch.Tensor,
                   lease_ok: torch.Tensor, up: torch.Tensor,
                   exp_epoch: Optional[torch.Tensor] = None,
                   exp_seq: Optional[torch.Tensor] = None,
                   n_cols: Optional[int] = None) -> None:
    """Raise ``TypeError`` / ``ValueError`` unless every argument lies
    inside F1's contract: the engine's dtypes and shapes, one device,
    contiguous 16-byte aligned tensors, ``1 <= M <= 32``,
    ``1 <= V <= 8``, ``K <= MAX_ROUNDS`` and the block's staged planes
    within ``MAX_SHARED_BYTES``.  ``n_cols`` is the width of the op,
    election and result planes: E (the default), or A for a sliced
    launch."""
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
    a = e if n_cols is None else n_cols
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
        ("kind", kind, i32, (k, a)), ("slot", slot, i32, (k, a)),
        ("val", val, i32, (k, a)), ("lease_ok", lease_ok, b, (k, a)),
        ("up", up, b, (e, m)),
    ]
    if (elect is None) != (cand is None):
        raise ValueError("elect and cand go together")
    if elect is not None:
        named += [("elect", elect, b, (a,)), ("cand", cand, i32, (a,))]
    for name, t in (("exp_epoch", exp_epoch), ("exp_seq", exp_seq)):
        if t is not None:
            named.append((name, t, i32, (k, a)))
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
                exp_seq: Optional[torch.Tensor] = None,
                active_idx: Optional[np.ndarray] = None
                ) -> Tuple[Optional[torch.Tensor], Tuple[torch.Tensor, ...]]:
    """One F1 launch over a CUDA engine state (see the module docstring).
    ``elect``/``cand`` None skip the election (``kv_step_scan``);
    ``active_idx`` (host int32 ``[A]``) makes it a sliced launch.
    Returns ``(won, (committed, get_ok, found, value, obj_vsn,
    quorum_ok, tree_corrupt))``, A-wide when sliced."""
    global engine_step_launches, engine_step_sliced_launches
    if state.epoch.device.type != "cuda":
        raise ValueError(f"F1 runs on cuda, not {state.epoch.device}")
    n_rows = state.epoch.shape[0]
    dev = state.epoch.device
    idx_dev = pad_ballot = None
    if active_idx is not None:
        n_real = check_active(active_idx, n_rows)
        check_contract(state, elect, cand, kind, slot, val, lease_ok, up,
                       exp_epoch, exp_seq, n_cols=active_idx.size)
        idx_dev = torch.from_numpy(active_idx).pin_memory().to(
            dev, non_blocking=True)
        if n_real < active_idx.size and n_real \
                and active_idx[n_real - 1] == n_rows - 1:
            # the pads read row E - 1 as it was before this launch, which
            # its own block rewrites: hand them a copy of its ballot
            pad_ballot = torch.cat((state.epoch[n_rows - 1],
                                    state.leader[n_rows - 1:]))
    else:
        check_contract(state, elect, cand, kind, slot, val, lease_ok, up,
                       exp_epoch, exp_seq)
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
        *res, idx_dev, pad_ballot)))
    dims = (ctypes.c_int * _N_DIMS)(
        n_rows, m, state.obj_epoch.shape[2], state.tree_node.shape[2],
        state.view_mask.shape[1], k, e)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _kernel()(ptrs, dims, stream)
    if rc != 0:
        raise RuntimeError(f"F1 launch failed: cudaGetLastError() = {rc}")
    engine_step_launches += 1
    if idx_dev is not None:
        engine_step_sliced_launches += 1
    return won, res
