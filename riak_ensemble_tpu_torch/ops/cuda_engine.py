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
the index on the host (:func:`check_active`) and uploads it itself,
through a ring of reused pinned buffers (:class:`_IndexRing`).

Wide mode (``engine.full_step_wide`` / ``full_step_wide_sliced`` /
``kv_step_scan_wide``): ``[G, C, W]`` op planes make the launch walk the
G·W rounds in (group, lane) order with the wide round's verify-before-
the-round semantics, and return ``[G, C, W]`` result planes
(``tree_corrupt [G, C, M]``).  Full width or sliced, as above.

The kernel's launch shape (warps per block) comes from the runtime's
occupancy query; :func:`occupancy` reports what a launch runs as.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from riak_ensemble_tpu_torch.ops import build, cuda_quorum
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
#: kernel launches and nowhere else; the sliced ones also in the second,
#: the wide ones (either grid) also in the third.  A wide launch counts
#: there only at W > 1: the C entry runs a ``[G, C, 1]`` plane through
#: the scalar instantiation (``wide = p.w > 1``), so that one is not.
engine_step_launches = 0
engine_step_sliced_launches = 0
engine_step_wide_launches = 0

_N_PTRS = 30
_N_DIMS = 8
_fn = None
_occ_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load("engine_step")
        _fn = lib.retpu_engine_step
        _fn.argtypes = [ctypes.POINTER(ctypes.c_uint64),
                        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        _fn.restype = ctypes.c_int
    return _fn


def _levels(s: int) -> Tuple[list, list]:
    """(sizes, offsets) of the upper levels of an ``s``-leaf width-16
    trie, leafward → root (``engine.tree_sizes``)."""
    sizes, n = [], s
    while n > 1:
        n = -(-n // 16)
        sizes.append(n)
    sizes = sizes or [1]
    return sizes, list(np.cumsum([0] + sizes[:-1]))


def n_uppers(n_slots: int) -> int:
    """Upper tree nodes of an ``n_slots``-leaf width-16 trie (the sum of
    ``engine.tree_sizes``)."""
    return sum(_levels(n_slots)[0])


def shared_bytes(m: int, s: int, u: int) -> int:
    """Dynamic shared memory of one block (``smem_bytes`` in the
    kernel): three object planes padded to 16 bytes, the leaves, the
    uppers, and the uppers' and the slots' state bytes (each padded to
    16)."""
    return (4 * 3 * ((m * s + 3) & ~3) + 16 * m * s + 16 * m * u
            + ((m * u + 15) & ~15) + ((m * s + 15) & ~15))


#: int32 operations of one 16-child fold (16 children x 4 lanes x (xor,
#: mul, add, 8 for fmix, sum), plus 4 lanes x 19 for the stir and seal)
#: and of one 4-lane leaf hash
FOLD_OPS = 16 * 4 * 12 + 4 * 19
LEAF_OPS = 4 * 13


def step_work(e: int, m: int, s: int, v: int, k: int, a: int,
              writers: int = 0) -> Tuple[int, int]:
    """(bytes, int32 ops) one F1 step needs: ``e`` rows stepped (A for a
    sliced step) of ``m`` peers, ``s`` slots and ``v`` views, ``k``
    rounds over ``a`` op columns, ``writers`` replica commits (commits x
    the ensemble's heard members).  Bytes: every state plane of the
    stepped rows read once and the ballot, object and tree planes
    written once, every input and result plane once.  Ops: per ensemble
    and round, the integrity gate of every replica (its leaf hash and one
    16-child fold per upper level) and, per committing replica, the new
    leaf hash and its path's folds; read repairs are not counted."""
    sizes = _levels(s)[0]
    u, nlev = sum(sizes), len(sizes)
    rw = 3 * e * m * s * 4 + e * m * s * 16 + e * m * u * 16 + 2 * e * m * 4 \
        + 2 * e * 4
    nbytes = (2 * rw + e * v * m + e * m + 5 * a
              + k * a * (5 * 4 + 1)                  # op planes
              + k * a * (4 + 4 + 8 + m) + a)         # results, won
    ops = k * e * m * (LEAF_OPS + 4 + nlev * (FOLD_OPS + 4)) \
        + writers * (LEAF_OPS + nlev * FOLD_OPS)
    return nbytes, ops


def design_work(heard: np.ndarray, kind: np.ndarray, slot: np.ndarray,
                committed: np.ndarray, s: int) -> dict:
    """The hashing F1's design needs for one launch on these inputs,
    counted on the host: ``heard [A, M]`` (the stepped rows' up members,
    pads all False), ``kind`` / ``slot`` / ``committed [K, A]``.  A round
    is LIVE when its kind is an op (1-4) and its slot valid; a row with a
    live round is staged.  Every heard replica of a staged row gets a
    verdict for each upper node (a fold) and each slot (a leaf hash).  A
    commit writes its slot for every heard
    replica: each distinct written slot's leaf is hashed once and each
    distinct node on the written paths refolded once.  Read repairs are not
    counted (as in :func:`step_work`).  ``ops`` is the int32 operations of
    it all, at :func:`step_work`'s price per fold and per leaf hash (+4 a
    compare)."""
    k, a = kind.shape
    sizes, offs = _levels(s)
    u = sum(sizes)
    live = (kind >= 1) & (kind <= 4) & (slot >= 0) & (slot < s)
    done = live & committed.astype(bool)
    n_heard = heard.sum(1)
    staged = live.any(0) if k else np.zeros(a, bool)
    written = np.zeros((a, u), bool)
    slots_written = np.zeros((a, s), bool)
    cols = np.broadcast_to(np.arange(a), (k, a))
    slots_written[cols[done], slot[done]] = True
    for lvl, off in enumerate(offs):
        node = off + np.clip(slot, 0, s - 1) // 16 ** (lvl + 1)
        written[cols[done], node[done]] = True
    verdicts = int((staged * n_heard).sum()) * u
    leaf_verdicts = int((staged * n_heard).sum()) * s
    refolds = int((written.sum(1) * n_heard).sum())
    leaf_writes = int((slots_written.sum(1) * n_heard).sum())
    return {"staged_rows": int(staged.sum()), "live_rounds": int(live.sum()),
            "verdict_folds": verdicts, "refold_folds": refolds,
            "leaf_verdicts": leaf_verdicts, "leaf_writes": leaf_writes,
            "ops": (verdicts * (FOLD_OPS + 4) + refolds * FOLD_OPS
                    + leaf_verdicts * (LEAF_OPS + 4)
                    + leaf_writes * LEAF_OPS)}


def flat_rounds(x: np.ndarray) -> np.ndarray:
    """A wide launch's ``[G, A, W]`` host plane as its ``[G*W, A]`` flat
    rounds in (group, lane) order, the order F1 walks them — the form
    :func:`design_work` and :func:`design_bytes` count."""
    g, a, w = x.shape
    return x.transpose(0, 2, 1).reshape(g * w, a)


def design_bytes(heard: np.ndarray, staged: np.ndarray, wrote: np.ndarray,
                 ballot_changed: np.ndarray, s: int, v: int, k: int,
                 a: int, groups: Optional[int] = None) -> dict:
    """The bytes one F1 launch must move on these inputs, counted on the
    host for the ``R`` rows it steps: ``heard [R, M]`` (each row's up
    members), ``staged [R]`` (rows with a live round), ``wrote [R, M]``
    (replicas whose objects or tree the launch changed: a commit or a
    read repair), ``ballot_changed [R]`` (rows whose epoch, fact_seq,
    leader or counter it changed); ``k`` rounds over ``a`` columns, in
    ``groups`` tree_corrupt rows (a wide launch's G; None: one a round).
    Reads: every stepped row's ballot, view and up masks; the object
    planes (three int32 a slot), leaves (16 B a slot) and upper nodes
    (16 B each) of each heard replica of a staged row; the op planes
    (five int32 and a byte a round and column) and the election's (a
    byte and an int32 a column).  Writes: the object and
    tree rows of each replica that wrote, the ballot of each row whose
    ballot changed, the result planes and ``won``."""
    m = heard.shape[1]
    u = n_uppers(s)
    replica = 3 * s * 4 + s * 16 + u * 16
    ballot = 2 * m * 4 + 2 * 4
    n_rows = heard.shape[0]
    reads = {"ballot": n_rows * (ballot + v * m + m),
             "replicas": int((heard & staged[:, None]).sum()) * replica,
             "ops": k * a * (5 * 4 + 1) + 5 * a}
    rows = k if groups is None else groups
    writes = {"replicas": int(wrote.sum()) * replica,
              "ballot": int(ballot_changed.sum()) * ballot,
              "results": k * a * (4 + 4 + 8) + rows * a * m + a}
    return {"read": reads, "written": writes,
            "bytes": sum(reads.values()) + sum(writes.values())}


def fold_consts() -> torch.Tensor:
    """The fold's 16 position salts then 16 odd multipliers, as the int32
    bit patterns the kernel reads as uint32 (``hash._fold_consts_np``)."""
    salt, mul = hashk._fold_consts_np(16)
    return torch.cat([torch.from_numpy(salt[:, 0]),
                      torch.from_numpy(mul[:, 0])])


@functools.lru_cache(maxsize=None)
def _fold_consts_on(device: torch.device) -> torch.Tensor:
    return fold_consts().to(device)


def _refuse(name, t, dtype, shape, dev) -> None:
    """Raise the error for the first way ``t`` breaks the contract."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, the state on {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    raise ValueError(f"{name} must start on a 16-byte boundary")


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
    if n_real < active_idx.size and (active_idx[n_real:] != e).any():
        raise ValueError(f"active_idx: after the real rows every entry must "
                         f"be the padding index {e}")
    if n_real > 1 and (active_idx[1:n_real] <= active_idx[:n_real - 1]).any():
        raise ValueError("active_idx: the real rows must ascend with no "
                         "duplicate")
    if n_real and active_idx[0] < 0:    # ascending: the first is the least
        raise ValueError("active_idx holds a negative row")
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
    ``1 <= V <= 8``, ``K <= MAX_ROUNDS`` (``G*W`` for the ``[G, C, W]``
    planes of a wide launch) and the block's staged planes within
    ``MAX_SHARED_BYTES``.  ``n_cols`` is the width C of the op, election
    and result planes: E (the default), or A for a sliced launch."""
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
    if kind.dim() not in (2, 3):
        raise ValueError(f"kind must be [K, E] or [G, E, W], got "
                         f"{tuple(kind.shape)}")
    k = kind.shape[0]
    a = e if n_cols is None else n_cols
    wide = kind.dim() == 3
    w = kind.shape[2] if wide else 1
    if w < 1:
        raise ValueError("a wide launch needs W >= 1 lanes a round")
    if k * w > MAX_ROUNDS:
        raise ValueError(f"F1 takes K <= {MAX_ROUNDS} rounds (G*W wide), "
                         f"got {k * w}")
    need = shared_bytes(m, s, u)
    if need > MAX_SHARED_BYTES:
        raise ValueError(f"M={m} x S={s} needs {need} B of shared memory "
                         f"per block, over F1's {MAX_SHARED_BYTES}")
    ops = (k, a, w) if wide else (k, a)
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
        ("kind", kind, i32, ops), ("slot", slot, i32, ops),
        ("val", val, i32, ops), ("lease_ok", lease_ok, b, ops),
        ("up", up, b, (e, m)),
    ]
    if (elect is None) != (cand is None):
        raise ValueError("elect and cand go together")
    if elect is not None:
        named += [("elect", elect, b, (a,)), ("cand", cand, i32, (a,))]
    for name, t in (("exp_epoch", exp_epoch), ("exp_seq", exp_seq)):
        if t is not None:
            named.append((name, t, i32, ops))
    dev = state.epoch.device
    for name, t, dtype, shape in named:
        if (t.dtype != dtype or t.shape != shape or t.device != dev
                or not t.is_contiguous() or t.data_ptr() & 15 and t.numel()):
            _refuse(name, t, dtype, shape, dev)


class _IndexRing:
    """Reused pinned host buffers and device buffers for the sliced
    launch's index, one ring per device: a launch writes its index into
    the next slot's pinned buffer, copies it to the slot's device buffer
    on the launch's stream and records the slot's event after the launch.
    A slot is rewritten only once its event has completed, so neither
    buffer changes under a copy or a kernel still reading it."""

    SLOTS = 32

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.cap = 0
        self.slots: list = []
        self.next = 0

    def _grow(self, n: int) -> None:
        for *_, ev in self.slots:
            ev.synchronize()
        self.cap = 1 << max(n - 1, 1).bit_length()
        self.slots = []
        for _ in range(self.SLOTS):
            host = torch.empty(self.cap, dtype=torch.int32, pin_memory=True)
            self.slots.append((host, host.numpy(), torch.empty(
                self.cap, dtype=torch.int32, device=self.device),
                torch.cuda.Event()))
        self.next = 0

    def upload(self, idx: np.ndarray) -> Tuple[torch.Tensor, torch.cuda.Event]:
        """The index on the device, and the event to record after the
        launch that reads it."""
        n = idx.size
        if n > self.cap:
            self._grow(n)
        host, host_np, dev, ev = self.slots[self.next]
        self.next = (self.next + 1) % self.SLOTS
        ev.synchronize()
        host_np[:n] = idx
        out = dev[:n]
        out.copy_(host[:n], non_blocking=True)
        return out, ev


@functools.lru_cache(maxsize=None)
def _ring(device: torch.device) -> _IndexRing:
    return _IndexRing(device)


def _dims(n_rows: int, m: int, s: int, u: int, v: int, k: int, a: int,
          w: int = 1):
    return (ctypes.c_int * _N_DIMS)(n_rows, m, s, u, v, k, a, w)


def occupancy(e: int, m: int, s: int, v: int, k: int,
              a: Optional[int] = None, w: int = 1) -> dict:
    """How an F1 launch at these dims runs on the current card (the C
    entry point's query): registers per thread, static and dynamic
    shared memory, spill bytes, warps per block, resident blocks per SM
    and the SM count (``k`` groups of ``w`` lanes for a wide launch)."""
    global _occ_fn
    if _occ_fn is None:
        fn = build.load("engine_step").retpu_engine_step_occupancy
        fn.argtypes = [ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        _occ_fn = fn
    out = (ctypes.c_int * 7)()
    rc = _occ_fn(_dims(e, m, s, n_uppers(s), v, k, e if a is None else a, w),
                 out)
    if rc != 0:
        raise RuntimeError(f"F1 occupancy query failed: {rc}")
    keys = ("regs_per_thread", "static_smem", "dynamic_smem", "spill_bytes",
            "warps_per_block", "blocks_per_sm", "sms")
    return dict(zip(keys, out))


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
    ``active_idx`` (host int32 ``[A]``) makes it a sliced launch; ``[G, C,
    W]`` op planes make it a wide one.  Returns ``(won, (committed,
    get_ok, found, value, obj_vsn, quorum_ok, tree_corrupt))``, A-wide
    when sliced, ``[G, C, W]`` (``tree_corrupt [G, C, M]``) when wide."""
    global engine_step_launches, engine_step_sliced_launches, \
        engine_step_wide_launches
    if state.epoch.device.type != "cuda":
        raise ValueError(f"F1 runs on cuda, not {state.epoch.device}")
    n_rows = state.epoch.shape[0]
    dev = state.epoch.device
    idx_dev = pad_ballot = done = None
    if active_idx is not None:
        n_real = check_active(active_idx, n_rows)
        check_contract(state, elect, cand, kind, slot, val, lease_ok, up,
                       exp_epoch, exp_seq, n_cols=active_idx.size)
        idx_dev, done = _ring(dev).upload(active_idx)
        if n_real < active_idx.size and n_real \
                and active_idx[n_real - 1] == n_rows - 1:
            # the pads read row E - 1 as it was before this launch, which
            # its own block rewrites: hand them a copy of its ballot
            pad_ballot = torch.cat((state.epoch[n_rows - 1],
                                    state.leader[n_rows - 1:]))
    else:
        check_contract(state, elect, cand, kind, slot, val, lease_ok, up,
                       exp_epoch, exp_seq)
    k, e = kind.shape[:2]
    w = kind.shape[2] if kind.dim() == 3 else 1
    lanes = tuple(kind.shape)
    m = state.epoch.shape[1]

    def empty(*shape, dtype=torch.bool):
        return torch.empty(shape, dtype=dtype, device=dev)
    res = (empty(*lanes), empty(*lanes), empty(*lanes),
           empty(*lanes, dtype=torch.int32),
           empty(*lanes, 2, dtype=torch.int32), empty(*lanes),
           empty(k, e, m))
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
    dims = _dims(n_rows, m, state.obj_epoch.shape[2],
                 state.tree_node.shape[2], state.view_mask.shape[1], k, e, w)
    stream = torch.cuda.current_stream(dev)
    rc = cuda_quorum.call_on(dev, _kernel(), ptrs, dims, stream.cuda_stream)
    if done is not None:
        done.record(stream)
    if rc != 0:
        raise RuntimeError(f"F1 launch failed: cudaGetLastError() = {rc}")
    engine_step_launches += 1
    if idx_dev is not None:
        engine_step_sliced_launches += 1
    if w > 1:
        engine_step_wide_launches += 1
    return won, res
