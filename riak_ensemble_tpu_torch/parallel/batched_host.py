"""Host↔engine bridge: many ensembles served through the torch engine.

Port of the main-path part of
``riak_ensemble_tpu/parallel/batched_host.py``: a host service that
multiplexes thousands of engine-backed ensembles —

- client ops (kget/kput/kdelete/CAS and their vectorized ``_many``
  forms) queue per ensemble and :meth:`BatchedEnsembleService.flush`
  packs them into ``[K, E]`` op planes for ONE :func:`engine.full_step`
  launch: elections for leaderless/leader-down ensembles fold into the
  same launch;
- the host keeps what consensus doesn't need on the device: key→slot
  per ensemble, the payload store (the device carries int32 handles;
  values live host-side keyed by handle), leases and the ``up`` mask;
- the launch's results come back as ONE bit-packed uint8 buffer
  (:func:`_pack_results_body`), byte-identical to the reference's, and
  resolve the client futures.

Keyed read-modify-write (:meth:`BatchedEnsembleService.kmodify`,
``kmodify_many``, ``ksafe_delete``) runs either as ONE ``OP_RMW`` engine
round (device mod-fun table funrefs, :mod:`..funref`) or as the host
read→fn→CAS chain, whose CAS half chains into the flush that resolved
its read.  Lease-protected fast reads serve ``kget`` / ``kget_vsn`` /
``kget_many`` from the leader's committed host mirrors, with no device
round, while the row's lease holds and the slot has no pending write.
A launch that flags synctree corruption runs the anti-entropy exchange
(:func:`engine.exchange_step`) when it settles, and
:meth:`BatchedEnsembleService.scrub` sweeps every replica's tree, on
demand or every ``scrub_every_flushes`` flushes.

Active-column compaction (on by default, ``compact=False`` turns it off,
the reference's ``RETPU_COMPACT``): a launch packs only the columns that
carry ops or elections (pow2-bucketed, ``A_BUCKET_MIN`` at least), and when
``E >= SLICE_MIN_E`` and the bucket is at most E/4 the step itself runs on
those rows only (:func:`engine.full_step_sliced`, sliced kernel F1 on CUDA).

The launch pipeline: every launch has an ENQUEUE half (plane build,
uploads, step, pack, start of the device→host copy) and a SETTLE half
(wait for the packed buffer, unpack, leader and lease mirrors, the
corruption-triggered exchange, the futures).  ``pipeline_depth`` launches
may be enqueued but unsettled, so launch N's copy and host resolve run
under launch N + 1's step; settles are FIFO.  :meth:`execute_async` is the
pipelined form of :meth:`execute`.

The host passes around a launch are the reference's default arm
(``native_enqueue`` / ``native_resolve``, its ``RETPU_NATIVE_ENQUEUE`` and
``RETPU_NATIVE_RESOLVE``): the flush walks its queues into a PENDING SLAB
(run descriptors over flat int32 lanes) that one C++ pass packs into the
op planes; one C++ pass unpacks a compacted packed result (numpy unpacks
a full-width one, the faster of the two there) and one scatters the
committed mirror updates; and every taken op resolves through the flush's
COMPLETION SLAB, one gathered record per round and one wake per flush
(:mod:`.enqueue_native`, :mod:`.resolve_native`, built from
``csrc/host/``).  ``False`` pins the per-entry pack and the per-op resolve
loops, the reference's oracle arm.

Durability (``data_dir``): committed client writes reach a write-ahead
log (:mod:`.wal`, forced down per ``wal_sync``) BEFORE any future of their
launch resolves, at depth 2 in settle order;
:meth:`BatchedEnsembleService.save` checkpoints the engine state
(:mod:`..ops.checkpoint`) and the host mirrors and rotates the WAL;
:meth:`BatchedEnsembleService.restore` replays the WAL over the latest
checkpoint, or over ``META`` alone.  EIO or ENOSPC at the
WAL barrier flips the service read-only (writes fail, reads serve).

A launch's contract follows its device, as the reference's default does
(``RETPU_DONATE`` unset): on the CPU the launch snapshots the state, the
leader mirror and the leases, and a failed launch restores them; on CUDA
F1 updates the state in place (the donated contract) and a failed launch
leaves it as the failure left it.  Every launch and exchange runs through
``engine`` (:class:`_LocalEngine` by default), the seam the tests inject
launch failures through.

It implements the reference service with ``RETPU_OBS=0``,
``RETPU_RESOLVE_SHARDS=1`` and no ``RETPU_WIDE``, a static row set
(``dynamic=False``) and a caller-driven flush (``tick=None``).  It reads
no environment variables except the storage-fault knobs of
:mod:`..faults`: the reference's ``RETPU_FAST_READS`` is
:meth:`BatchedEnsembleService.set_fast_reads`, its ``RETPU_COMM_REPL`` the
``comm_repl`` argument and its ``RETPU_COMPACT`` the ``compact`` argument.
Wide rounds, membership and the timer are later slices.
"""

from __future__ import annotations

import errno
import functools
import logging
import os
import pickle
import random
import shutil
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from riak_ensemble_tpu_torch import funref
from riak_ensemble_tpu_torch import save as savelib
from riak_ensemble_tpu_torch.config import Config
from riak_ensemble_tpu_torch.device import DeviceLike, resolve_device
from riak_ensemble_tpu_torch.ops import checkpoint
from riak_ensemble_tpu_torch.ops import engine as eng
from riak_ensemble_tpu_torch.ops import hash as hashk
from riak_ensemble_tpu_torch.parallel import enqueue_native, resolve_native
from riak_ensemble_tpu_torch.parallel.wal import ServiceWAL
from riak_ensemble_tpu_torch.parallel.resolve_native import unpack_results
from riak_ensemble_tpu_torch.runtime import Future, Timer
from riak_ensemble_tpu_torch.types import NOTFOUND

log = logging.getLogger(__name__)


@functools.lru_cache(maxsize=None)
def _bit_weights(device: torch.device) -> torch.Tensor:
    return torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                        device=device)


def packbits(bits: torch.Tensor) -> torch.Tensor:
    """``jnp.packbits`` of a flat bool tensor: MSB first, the tail byte
    zero-padded.  Torch has no packbits, so each group of 8 is weighted
    128, 64, …, 1 and summed."""
    n = bits.numel()
    b = bits.to(torch.int32)
    pad = (-n) % 8
    if pad:
        b = torch.cat([b, b.new_zeros(pad)])
    return (b.view(-1, 8) * _bit_weights(bits.device)).sum(
        -1, dtype=torch.int32).to(torch.uint8)


def _pack_results_body(won: torch.Tensor, res: eng.KvResult,
                       want_vsn: bool,
                       active_idx: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Flatten a launch's results into ONE uint8 vector on the device
    (batched_host.py:115-157), byte-identical to the reference.

    Layout: packbits([won E | quorum_ok E | corrupt E*M | committed K*A
    | get_ok K*A | found K*A]) ++ bytes([value K*A | (vsn_epoch K*A |
    vsn_seq K*A)]), A = E when uncompacted.  ``active_idx [A]`` (the
    pack-gather strength: pow2-bucketed, padding = column 0, ignored by
    the unpack) gathers the client planes down to the active columns
    (:func:`engine.gather_result_columns`); the won / quorum / corrupt
    planes stay full width.  A sliced launch hands in A-wide planes and no
    index.  The integer planes are the little-endian bytes of int32 — the
    reference's ``bitcast_convert_type(int32 → uint8)`` — taken here with
    ``.view(torch.uint8)`` on a contiguous int32 tensor."""
    if active_idx is not None:
        res = eng.gather_result_columns(res, active_idx)
    flags = torch.cat([
        won.reshape(-1),
        res.quorum_ok.any(0).reshape(-1),
        res.tree_corrupt.any(0).reshape(-1),
        res.committed.reshape(-1),
        res.get_ok.reshape(-1),
        res.found.reshape(-1),
    ]).to(torch.bool)
    ints = [res.value.reshape(-1)]
    if want_vsn:
        ints += [res.obj_vsn[..., 0].reshape(-1),
                 res.obj_vsn[..., 1].reshape(-1)]
    ints_u8 = torch.cat(ints).to(torch.int32).contiguous().view(torch.uint8)
    return torch.cat([packbits(flags), ints_u8])


#: Copied from ``riak_ensemble_tpu/parallel/batched_host.py:326-347``.
#: Smallest active-column bucket a compacted launch packs.
A_BUCKET_MIN = 8

#: Smallest grid width the SLICED launch engages at; below it compaction
#: only gathers the packed result (the pack-gather strength).
SLICE_MIN_E = 256


def packed_nbytes(e: int, m: int, k: int, want_vsn: bool,
                  a_width: Optional[int] = None) -> int:
    """Size in bytes of one :func:`_pack_results_body` payload — the
    per-flush device→host transfer.  ``a_width`` is the compacted column
    count (None = full width E)."""
    aw = e if a_width is None else a_width
    nbits = 2 * e + e * m + 3 * k * aw
    return (nbits + 7) // 8 + 4 * k * aw * (3 if want_vsn else 1)


def _u8view(x: np.ndarray) -> np.ndarray:
    """Zero-copy uint8 view of a contiguous bool plane (the C passes'
    input form); copies only when the plane is not contiguous, which a
    view would read wrongly (batched_host.py:479)."""
    if x.dtype == np.bool_ and x.flags.c_contiguous:
        return x.view(np.uint8)
    return np.ascontiguousarray(x, np.uint8)


def _bulk_planes(kind, slot, val, exp_epoch, exp_seq):
    """A bulk call's host planes as int32 arrays; raises on a put of a
    negative payload (not encodable: int32 handles, 0 = tombstone)."""
    kind = np.asarray(kind, np.int32)
    val = np.asarray(val, np.int32)
    if ((kind == eng.OP_PUT) & (val < 0)).any():
        raise ValueError("negative put payloads are not encodable "
                         "(int32 handles; 0 = tombstone/delete)")
    return (kind, np.asarray(slot, np.int32), val,
            None if exp_epoch is None else np.asarray(exp_epoch, np.int32),
            None if exp_seq is None else np.asarray(exp_seq, np.int32))


class _LocalEngine:
    """The default engine adapter (batched_host.py:494-515): the engine
    module's functions.  A subclass that overrides one of them (a test's
    failure injector) slots in through the service's ``engine``
    argument."""

    init_state = staticmethod(eng.init_state)
    full_step = staticmethod(eng.full_step)
    full_step_sliced = staticmethod(eng.full_step_sliced)
    exchange_step = staticmethod(eng.exchange_step)
    verify_trees = staticmethod(eng.verify_trees)
    rebuild_trees = staticmethod(eng.rebuild_trees)
    reset_rows = staticmethod(eng.reset_rows)


def _device_planes(device: torch.device, kind, slot, val, exp_epoch,
                   exp_seq):
    """A bulk call's DEVICE-RESIDENT planes: int32 ``[K, E]`` tensors
    on the service's device, made contiguous (a no-op for contiguous
    ones).  Nothing is copied to or checked on the host."""
    planes = [kind, slot, val, exp_epoch, exp_seq]
    shape = kind.shape
    for i, (name, t) in enumerate(zip(
            ("kind", "slot", "val", "exp_epoch", "exp_seq"), planes)):
        if t is None and i >= 3:
            continue
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 \
                or t.device.type != device.type \
                or device.index not in (None, t.device.index) \
                or t.shape != shape or t.dim() != 2:
            raise TypeError(f"device-resident execute: {name} must be an "
                            f"int32 [K, E] tensor on {device}")
        planes[i] = t.contiguous()
    return planes


@dataclass(slots=True)
class _InFlightLaunch:
    """One enqueued-but-unsettled launch (batched_host.py:645-700, the
    fields this port uses): what the settle half needs to finish it."""

    flat: torch.Tensor      # packed result on the device (kept alive
    #                         until the copy below has landed)
    host: Optional[torch.Tensor]  # pinned buffer the d2h copy fills (CUDA)
    done: Any               # CUDA event after that copy (None on the CPU)
    k: int
    want_vsn: bool
    elect: np.ndarray       # [E] this launch's election vector
    cand: np.ndarray        # [E] its candidates
    now: float              # runtime.now at enqueue (lease renewal)
    #: host kind and slot planes in op order (the mirror scatter reads
    #: them at settle: this launch's own arrays, never a reused buffer;
    #: None for device-resident planes)
    kind_np: Optional[np.ndarray]
    op_slot_np: Optional[np.ndarray]
    #: active-column compaction: the active columns (None = full-width
    #: pack), the pow2-bucketed packed width, and whether the STEP ran on
    #: those rows only (then won / quorum / corrupt are A-wide too)
    active: Optional[np.ndarray] = None
    a_width: int = 0
    sliced: bool = False
    #: flush path: the (ensemble, taken ops) pairs this launch serves
    taken: Any = None
    #: slab enqueue path: the flush's pending-slab record (ent_col,
    #: ent_row0, ent_len run descriptors, the taken round count, each
    #: entry's first slab row) — the completion slab gathers through it
    lanes: Any = None
    #: execute_async path: the client future and its op count, and the
    #: host planes its WAL records come from (None: nothing to log)
    exec_fut: Optional[Future] = None
    exec_ops: int = 0
    exec_wal: Any = None
    #: the rollback snapshot (CPU launches only; None = donated): the
    #: pre-launch state, leader mirror and leases
    snapshot: Any = None


class _Uploads:
    """Host buffers a launch's inputs are built in and uploaded from.

    On CUDA they are pinned, one set per in-flight slot, and the copies
    are ``non_blocking``: the host never waits for the device to take
    them.  A slot is handed out again only after the event recorded at
    the end of the launch that last used it (its device→host copy, after
    every upload and the step) has completed, so no enqueue overwrites a
    buffer whose copy is still pending.  On the CPU the buffers are fresh
    arrays the step reads directly."""

    def __init__(self, device: torch.device, n_slots: int) -> None:
        self.pinned = device.type == "cuda"
        self.device = device
        self._slots: List[Dict[str, torch.Tensor]] = [
            {} for _ in range(n_slots)]
        self._events: List[Any] = [None] * n_slots
        self._next = 0
        self._cur: Dict[str, torch.Tensor] = self._slots[0]
        self._cur_i = 0

    def begin(self) -> None:
        """Take the next slot, waiting for its last launch's copies."""
        i = self._cur_i = self._next
        self._next = (i + 1) % len(self._slots)
        ev = self._events[i]
        if ev is not None:
            ev.synchronize()
            self._events[i] = None
        self._cur = self._slots[i]

    def buffer(self, name: str, shape: Tuple[int, ...],
               dtype: torch.dtype) -> torch.Tensor:
        """A host tensor of ``shape`` to fill (through ``.numpy()``)."""
        if not self.pinned:
            return torch.empty(shape, dtype=dtype)
        n = 1
        for d in shape:
            n *= d
        t = self._cur.get(name)
        if t is None or t.numel() < n:
            t = self._cur[name] = torch.empty(max(n, 1), dtype=dtype,
                                              pin_memory=True)
        return t[:n].view(shape)

    def upload(self, t: torch.Tensor) -> torch.Tensor:
        if not self.pinned:
            return t
        return t.to(self.device, non_blocking=True)

    def end(self, event: Any) -> None:
        """Record the event that frees the current slot."""
        self._events[self._cur_i] = event


def _refuse_dynamic(meta: Dict[str, Any], path: str) -> None:
    """The port has no dynamic rows: a data dir the reference wrote with
    ``dynamic=True`` needs ROADMAP Queue 1 item 6 (dynamic rows and
    membership)."""
    if meta.get("dynamic"):
        raise NotImplementedError(
            f"{path} holds a dynamic-row service; dynamic rows and "
            f"membership are not ported yet (ROADMAP Queue 1 item 6)")


class WallRuntime:
    """Minimal real-time runtime for driving the service outside a
    simulator: ``now`` is the monotonic clock.  It has no event loop,
    so the caller drives ``flush()``."""

    @property
    def now(self) -> float:
        return time.monotonic()

    def schedule(self, delay: float, fn) -> Timer:
        raise RuntimeError(
            "WallRuntime has no event loop; use tick=None and drive "
            "flush() from the caller")


@dataclass(slots=True)
class _PendingOp:
    kind: int
    slot: int
    handle: int
    fut: Future
    key: Any = None
    #: slot write generation at enqueue (puts only) — lets the failed
    #: path tell whether it was the slot's last queued write
    gen: int = 0
    #: CAS expected version (OP_CAS); for OP_RMW, (fun code, 0) — the
    #: exp_epoch plane carries the mod-fun table code and ``handle``
    #: the int32 operand
    exp: Tuple[int, int] = (0, 0)
    #: resolve gets as ("ok", value, vsn) instead of ("ok", value)
    want_vsn: bool = False
    #: rounds this entry occupies in the [K, E] op matrix
    n: int = 1


@dataclass(slots=True)
class _PendingBatch:
    """A struct-of-arrays batch of keyed ops for ONE ensemble sharing
    one Future (kput_many/kget_many).  Arrays are COMPACT: keys with no
    slot never queue a device round — their results are pre-filled into
    the accumulator at submit time — and ``pos`` maps each compact row
    back to its position in the caller's key order."""

    kind: int
    slot: Any          # List[int] [n]
    handle: Any        # List[int] [n] (puts; zeros for gets; RMW
    #                    batches: int32 operands, fun code in exp_e)
    fut: Future
    pos: Any = None    # List[int] [n] position in the caller's order
    keys: Any = None   # list of key objects (puts: for recycle)
    gen: Any = None    # List[int] [n] slot generations (puts)
    exp_e: Any = None  # List[int] [n] CAS expected versions (OP_CAS)
    exp_s: Any = None  # List[int] [n]
    accum: Any = None  # shared _BatchAccum across splits
    want_vsn: bool = False
    n: int = 0

    def split(self, head_n: int) -> Tuple["_PendingBatch", "_PendingBatch"]:
        """Split into (head, tail) when a flush's K cap lands inside
        the batch; both halves share the Future and accumulator."""
        def cut(x, a, b):
            return None if x is None else x[a:b]
        h = _PendingBatch(self.kind, self.slot[:head_n],
                          self.handle[:head_n], self.fut,
                          self.pos[:head_n], cut(self.keys, 0, head_n),
                          cut(self.gen, 0, head_n),
                          cut(self.exp_e, 0, head_n),
                          cut(self.exp_s, 0, head_n), self.accum,
                          self.want_vsn, head_n)
        t = _PendingBatch(self.kind, self.slot[head_n:],
                          self.handle[head_n:], self.fut,
                          self.pos[head_n:], cut(self.keys, head_n, None),
                          cut(self.gen, head_n, None),
                          cut(self.exp_e, head_n, None),
                          cut(self.exp_s, head_n, None), self.accum,
                          self.want_vsn, self.n - head_n)
        return h, t


class _BatchAccum:
    """Positional result assembly for a (possibly split) batch: each
    chunk fills its rows by original position; the shared Future
    resolves once every position is filled."""

    __slots__ = ("remaining", "results")

    def __init__(self, total: int) -> None:
        self.remaining = total
        self.results: List[Any] = [None] * total

    def fill(self, fut: Future, positions: List[int],
             chunk: List[Any], resolver) -> None:
        res = self.results
        for i, r in zip(positions, chunk):
            res[i] = r
        self.remaining -= len(chunk)
        if self.remaining <= 0 and not fut.done:
            resolver(fut, res)


class BatchedEnsembleService:
    """N engine-backed ensembles behind a put/get API.

    ``n_slots`` bounds live keys per ensemble (slots are recycled when
    keys are deleted).  The caller drives :meth:`flush` (``tick`` must
    be None: the timer-driven mode needs an event-loop runtime, which
    this package does not have yet).  The engine state lives on
    ``device`` — CUDA unless ``device="cpu"``.  Lease-protected fast
    reads are on when ``config.trust_lease`` (:meth:`set_fast_reads`
    turns them off).  ``comm_repl`` gates :meth:`kmodify_many`'s
    enqueue-side coalescing of commutative and semilattice funs, as the
    reference's ``RETPU_COMM_REPL`` does.  ``scrub_every_flushes`` runs
    :meth:`scrub` every that many flushes (None: on demand only).
    ``compact`` turns active-column compaction on (the default, as the
    reference's ``RETPU_COMPACT``).  ``pipeline_depth`` bounds the
    launches that may be enqueued but unsettled (1: every flush settles
    its own launch).  ``native_enqueue`` (the pending slab, its C++ pack
    and the completion-slab resolve) and ``native_resolve`` (the C++
    unpack and mirror scatter) are the reference's default host arm;
    ``False`` pins its per-entry pack and per-op resolve, and either
    alone is the reference with that knob alone at 0.  Either builds
    the host library when the service is constructed, and a failed build
    raises.  ``plain_host_passes`` runs the passes' plain numpy versions
    in their place (the reference's arm with no host library: the slab
    path with the numpy pack and gather, the Python unpack and mirror
    walk, and the Python WAL store), and builds nothing.

    ``engine`` is the adapter every launch and exchange runs through
    (:class:`_LocalEngine` by default).  A launch that fails fails its
    ops and those of every later launch still in flight, and the error
    reaches the caller.  On the CPU the launch rolls the state, the
    leader mirror and the leases back to their pre-launch snapshot, as
    the reference's CPU default does; on CUDA the step updates the state
    in place (the donated contract), no snapshot is taken and the state
    stays as the failure left it.

    ``data_dir`` makes acks durable: committed writes reach the WAL
    under ``data_dir`` before their futures resolve, ``wal_sync``
    ("fsync" or "buffer") says how far down, and past
    ``wal_compact_records`` records an idle flush folds the WAL into a
    checkpoint (:meth:`save`).  The reference's defaults.
    """

    def __init__(self, runtime: Any, n_ens: int, n_peers: int,
                 n_slots: int = 128, tick: Optional[float] = None,
                 max_ops_per_tick: int = 64,
                 config: Optional[Config] = None,
                 device: DeviceLike = None,
                 comm_repl: bool = True,
                 scrub_every_flushes: Optional[int] = None,
                 compact: bool = True,
                 pipeline_depth: int = 1,
                 native_enqueue: bool = True,
                 native_resolve: bool = True,
                 plain_host_passes: bool = False,
                 engine: Optional[Any] = None,
                 data_dir: Optional[str] = None,
                 wal_sync: str = "fsync",
                 wal_compact_records: int = 1 << 18) -> None:
        if tick is not None:
            raise NotImplementedError(
                "timer-driven flushing is not ported; pass tick=None "
                "and call flush()")
        self.runtime = runtime
        self.config = config if config is not None else Config()
        self.n_ens, self.n_peers, self.n_slots = n_ens, n_peers, n_slots
        self.max_k = max_ops_per_tick
        self.device = resolve_device(device)
        self.engine = engine if engine is not None else _LocalEngine()
        #: the launch contract, picked by the device as the reference's
        #: default picks it (batched_host.py:1037-1043): CPU launches
        #: snapshot for rollback, CUDA launches step in place
        self._donate = self.device.type == "cuda"
        self.state = self.engine.init_state(n_ens, n_peers, n_slots,
                                            device=self.device)
        #: host failure detector input (set_peer_up)
        self.up = np.ones((n_ens, n_peers), dtype=bool)
        self._up_dev: Optional[torch.Tensor] = None  # see _up_device
        #: host mirrors of device ballot state (leader changes only via
        #: elections THIS host requested) — election planning costs
        #: zero device round trips
        self.leader_np = np.full((n_ens,), -1, dtype=np.int32)
        self.member_np = np.ones((n_ens, n_peers), dtype=bool)
        #: per-ensemble key→slot and free slots
        self.key_slot: List[Dict[Any, int]] = [dict() for _ in range(n_ens)]
        self.free_slots: List[List[int]] = [
            list(range(n_slots)) for _ in range(n_ens)]
        #: per-ensemble slot write generation: bumped on every queued
        #: put, so a delete's deferred recycle can tell whether a later
        #: write re-used the slot
        self.slot_gen: List[Dict[int, int]] = [dict() for _ in range(n_ens)]
        #: per-ensemble slot -> handle of the last COMMITTED payload
        self.slot_handle: List[Dict[int, int]] = [
            dict() for _ in range(n_ens)]
        #: deferred slot recycles: (key, slot, gen) waiting until no
        #: queued op still references the slot
        self._recycle_pending: List[List[Tuple[Any, int, int]]] = [
            [] for _ in range(n_ens)]
        #: per-ensemble slots holding DEVICE-NATIVE int32 values (the
        #: kmodify device fast path — OP_RMW commits) rather than
        #: payload-store handles: reads of these slots return the raw
        #: int32, and a committed RMW records the sentinel handle -1
        #: in ``slot_handle`` (blocks recycling like a live handle;
        #: released as a no-op).  A committed put/CAS flips the slot
        #: back to handle storage.  ``_inline_np`` is the same set as
        #: an [E, S] slab, kept in lockstep.
        self._inline_slots: List[set] = [set() for _ in range(n_ens)]
        self._inline_np = np.zeros((n_ens, n_slots), bool)
        #: per-slot count of QUEUED host-payload writes ([E][S] Python
        #: ints): a device RMW racing a same-flush kput would do int32
        #: arithmetic on the put's payload HANDLE, so RMW eligibility
        #: must see these (slot_handle only reflects COMMITTED writes)
        self._queued_handle_writes: List[List[int]] = [
            [0] * n_slots for _ in range(n_ens)]
        #: payload store: handle -> value.  0 is the tombstone handle;
        #: released handles are recycled (int32 handles would wrap).
        self.values: Dict[int, Any] = {}
        self._free_handles: List[int] = []
        self._next_handle = 1
        self.queues: List[List[Any]] = [[] for _ in range(n_ens)]
        #: queued device ROUNDS per ensemble (a batch entry occupies
        #: entry.n rounds) — drives flush depth
        self._queue_rounds: List[int] = [0] * n_ens
        #: ensembles with queued ops / pending recycles
        self._active: set = set()
        self._recycle_dirty: set = set()
        #: leader leases, host-side: ensemble -> expiry (runtime.now)
        self.lease_until = np.zeros((n_ens,), dtype=float)
        #: lease-protected read fast path: reads of keyed slots serve
        #: from the committed host mirrors below while the lease holds
        self._fast_reads = self.config.trust_lease
        self._read_margin = self.config.read_margin()
        if self._fast_reads:
            self._assert_read_margin()
        #: committed (epoch, seq) per slot — the version a fast
        #: kget_vsn serves.  Invalidated per row on won elections (the
        #: epoch bump re-versions objects lazily on next device
        #: access); repopulated by every committed write's resolve and
        #: refreshed by device reads.
        self._slot_vsn_np = np.zeros((n_ens, n_slots, 2), np.int32)
        self._slot_vsn_ok = np.zeros((n_ens, n_slots), bool)
        #: committed device-native int32 per inline (RMW) slot — the
        #: value a fast read of a device-native key serves
        self._inline_value_np = np.zeros((n_ens, n_slots), np.int32)
        self._inline_value_ok = np.zeros((n_ens, n_slots), bool)
        #: per-slot count of QUEUED writes (put/CAS/RMW/tombstone): a
        #: fast read of a slot with any pending write takes the device
        #: round, which orders it after the writes
        self._pending_writes: List[List[int]] = [
            [0] * n_slots for _ in range(n_ens)]
        #: rows whose launch flagged synctree corruption: fast reads
        #: take the device round (its integrity gate vets the read)
        #: until an exchange syncs the row
        self._corrupt_rows = np.zeros((n_ens,), dtype=bool)
        self.read_fastpath_hits = 0
        self.read_fastpath_misses = 0
        self.read_fastpath_miss_reasons: Dict[str, int] = {}
        self.flushes = 0
        self.ops_served = 0
        #: integrity-gate detections (replica flagged corrupt in a round,
        #: or found damaged by a scrub) and the divergent replicas that
        #: the exchange re-synced
        self.corruptions = 0
        self.repairs = 0
        #: periodic anti-entropy cadence, a flush-count watermark (the
        #: reference's AAE-timer analog)
        self.scrub_every_flushes = scrub_every_flushes
        self._scrubbed_at_flush = 0
        #: client waiter exceptions contained by _safe_resolve
        self.waiter_errors = 0
        #: RMW counters: host-path kmodify CAS attempts that failed and
        #: were retried, ops the device mod-fun table served, and
        #: duplicate-key ops kmodify_many folded into a queued row
        self.rmw_conflicts = 0
        self.rmw_device_fastpath = 0
        self.rmw_enqueue_coalesced = 0
        self._comm_repl = comm_repl
        #: kmodify mod-fun error log rate limit (one per second)
        self._kmodify_err_at = -1e9
        self._kmodify_err_dropped = 0
        #: backed-off kmodify retries: (due flush call, ensemble,
        #: client future, thunk), run at the top of the flush whose
        #: ordinal reaches them — backoff counts FLUSH CALLS, the
        #: service's round clock
        self._retry_at: List[Tuple[int, int, Future, Any]] = []
        self._flush_calls = 0
        self._rng = random.Random(0x524D57)
        #: same-flush chaining: set when a resolve enqueues follow-up
        #: ops (a kmodify read's CAS half), consumed by flush() to run
        #: one bounded extra launch cycle inside the same flush call
        self._chain_kick = False
        self._chain_depth = 0
        #: active-column compaction, and its observability: packed d2h
        #: bytes moved, the bytes the full-width layout would have moved,
        #: and the packed-grid occupancy (a_width / E; 1.0 uncompacted)
        self._compact = bool(compact)
        self.payload_bytes = 0
        self.payload_bytes_full_width = 0
        self._occ_sum = 0.0
        self._occ_launches = 0
        #: launches whose step ran on the active rows only
        self.sliced_launches = 0
        #: the bounded launch pipeline: enqueued, unsettled launches, FIFO
        self.pipeline_depth = max(1, int(pipeline_depth))
        self._inflight: "deque[_InFlightLaunch]" = deque()
        self._uploads = _Uploads(self.device, self.pipeline_depth + 1)
        #: CUDA: the side stream the packed result's d2h copy runs on
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        #: the host passes (batched_host.py:1101-1123).  The C++ unpack
        #: and mirror scatter, or None for the Python ones; op-carrying
        #: launches unpacked by each arm (the native arm's count includes
        #: the full-width payloads it unpacks with numpy).
        native = not plain_host_passes
        self._native_resolve = (resolve_native.get()
                                if native_resolve and native else None)
        self.native_resolve_flushes = 0
        self.fallback_resolve_flushes = 0
        #: the slab enqueue path: pending ops pack into the op planes
        #: from flat int32 lanes (the C++ pack, or the numpy pack when
        #: None) and each flush resolves through its COMPLETION SLAB;
        #: flushes packed by each arm
        self._enq_slab = bool(native_enqueue)
        self._native_enqueue = (enqueue_native.get()
                                if native_enqueue and native else None)
        self.native_enqueue_flushes = 0
        self.fallback_enqueue_flushes = 0
        #: completion-slab wakes (one per settled op-carrying flush) and
        #: the rounds those wakes fanned in
        self.completion_wakes = 0
        self.completion_rows = 0
        #: durability (batched_host.py:1044-1097): the WAL of committed
        #: writes, its compaction into checkpoints, and the read-only
        #: degrade after a fatal storage error at its barrier
        self.data_dir = data_dir
        self.wal_sync = wal_sync
        self.wal_compact_records = wal_compact_records
        self.wal_compactions = 0
        self.wal_compaction_ms_last = 0.0
        self.wal_compaction_ms_total = 0.0
        self._wal: Optional[ServiceWAL] = None
        self._in_save = False
        #: set once a WAL-enabled service served device-resident
        #: execute planes, which skip the WAL
        self._dev_exec_unlogged = False
        #: the read-only decision record (None: healthy)
        self._storage_degraded: Optional[Dict[str, Any]] = None
        #: WAL OSErrors seen on the ack path
        self.wal_storage_errors = 0
        #: the WAL's store: the C++ treestore on the default arm, the
        #: Python log on the plain one
        self._wal_native = native
        if data_dir is not None:
            os.makedirs(data_dir, exist_ok=True)
            meta_path = os.path.join(data_dir, "META")
            raw = savelib.read(meta_path)
            if raw is None:
                savelib.write(meta_path, pickle.dumps(
                    {"shape": (n_ens, n_peers, n_slots), "dynamic": False,
                     "hash_format": hashk.HASH_FORMAT}, protocol=4))
            else:
                _refuse_dynamic(pickle.loads(raw), data_dir)
            self._wal = ServiceWAL.open_gen(
                data_dir, self._current_ckpt(data_dir), wal_sync,
                native=self._wal_native)

    @property
    def grid_occupancy(self) -> float:
        """Mean packed-grid occupancy over the launches settled so far
        (the reference's ``stats()["grid_occupancy"]``)."""
        return (self._occ_sum / self._occ_launches
                if self._occ_launches else 1.0)

    def set_pipeline_depth(self, depth: int) -> int:
        """Change the launch pipeline depth; every in-flight launch
        settles first (batched_host.py:2223).  Returns the old depth."""
        depth = max(1, int(depth))
        old = self.pipeline_depth
        if depth != old:
            self._drain_launches()
            self.pipeline_depth = depth
            self._uploads = _Uploads(self.device, depth + 1)
        return old

    # -- client API --------------------------------------------------------

    def kput(self, ens: int, key: Any, value: Any) -> Future:
        """Quorum-replicated write; resolves ('ok', vsn) or 'failed'
        (no slot / no quorum this flush)."""
        fut = Future()
        slot = self._slot_for(ens, key, allocate=True)
        if slot is None:
            fut.resolve("failed")
            return fut
        handle = self._alloc_handle()
        self.values[handle] = value
        gen = self.slot_gen[ens].get(slot, 0) + 1
        self.slot_gen[ens][slot] = gen
        self._note_handle_write(ens, slot)
        self._push(ens, _PendingOp(eng.OP_PUT, slot, handle, fut,
                                   key, gen))
        return fut

    def kput_many(self, ens: int, keys: List[Any],
                  values: List[Any]) -> Future:
        """Vectorized keyed writes: N puts for one ensemble behind ONE
        future, resolving to a list of per-key results (('ok', vsn) |
        'failed') in key order.  Duplicate keys serialize in order;
        keys that can't get a slot resolve 'failed' immediately and
        consume no device round."""
        fut = Future()
        n = len(keys)
        if n != len(values):
            raise ValueError(
                f"kput_many: {n} keys vs {len(values)} values")
        if n == 0:
            fut.resolve([])
            return fut
        accum = _BatchAccum(n)
        slot_l: List[int] = []
        pos_l: List[int] = []
        live_keys: List[Any] = []
        miss_pos: List[int] = []
        ks = self.key_slot[ens]
        fs = self.free_slots[ens]
        for i, key in enumerate(keys):
            s = ks.get(key)
            if s is None:
                if not fs:
                    miss_pos.append(i)   # capacity-fail: no round
                    continue
                s = fs.pop()
                ks[key] = s
            slot_l.append(s)
            pos_l.append(i)
            live_keys.append(key)
        m = len(slot_l)
        handle_l = self._alloc_handles(m)
        self.values.update(zip(handle_l, (values[i] for i in pos_l)))
        sg = self.slot_gen[ens]
        gen_l: List[int] = []
        for s in slot_l:
            g = sg.get(s, 0) + 1
            sg[s] = g
            gen_l.append(g)
        qh = self._queued_handle_writes[ens]
        for s in slot_l:
            qh[s] += 1
        if miss_pos:
            accum.fill(fut, miss_pos, ["failed"] * len(miss_pos),
                       self._safe_resolve)
        if live_keys:
            self._push(ens, _PendingBatch(
                eng.OP_PUT, slot_l, handle_l, fut, pos_l, live_keys,
                gen_l, accum=accum, n=m))
        return fut

    def kget_many(self, ens: int, keys: List[Any],
                  want_vsn: bool = False) -> Future:
        """Vectorized keyed reads: one future resolving to a list of
        (('ok', value|NOTFOUND) | 'failed') in key order (with
        ``want_vsn`` each hit is ('ok', value, (epoch, seq))).  Unknown
        keys resolve ('ok', NOTFOUND) immediately and consume no
        device round; so do keys the lease-protected fast path
        serves."""
        fut = Future()
        n = len(keys)
        if n == 0:
            fut.resolve([])
            return fut
        accum = _BatchAccum(n)
        slot_l: List[int] = []
        pos_l: List[int] = []
        miss_pos: List[int] = []
        fast_pos: List[int] = []
        fast_res: List[Any] = []
        ks = self.key_slot[ens]
        # the ensemble-level fast-path gate is checked ONCE per batch;
        # the per-key conditions (pending write, mirror coverage) below
        ens_reason = self._fast_read_ok(ens, self.runtime.now)
        for i, key in enumerate(keys):
            s = ks.get(key)
            if s is None:
                miss_pos.append(i)
                continue
            if ens_reason is None:
                reason, res = self._fast_read_result(ens, s, want_vsn)
            else:
                reason, res = ens_reason, None
            if self._count_fast(reason):
                fast_pos.append(i)
                fast_res.append(res)
            else:
                slot_l.append(s)
                pos_l.append(i)
        if miss_pos:
            nf = (("ok", NOTFOUND, (0, 0)) if want_vsn
                  else ("ok", NOTFOUND))
            accum.fill(fut, miss_pos, [nf] * len(miss_pos),
                       self._safe_resolve)
        if fast_pos:
            accum.fill(fut, fast_pos, fast_res, self._safe_resolve)
        if slot_l:
            m = len(slot_l)
            self._push(ens, _PendingBatch(
                eng.OP_GET, slot_l, [0] * m, fut, pos_l, accum=accum,
                want_vsn=want_vsn, n=m))
        return fut

    def kget(self, ens: int, key: Any) -> Future:
        """Linearizable read; resolves ('ok', value|NOTFOUND) or
        'failed'.  Served from the leader's committed host mirror — no
        device round — while the fast path's conditions hold;
        otherwise the read rides an ``OP_GET`` round."""
        fut = Future()
        slot = self._slot_for(ens, key, allocate=False)
        if slot is None:
            fut.resolve(("ok", NOTFOUND))
            return fut
        hit, res = self._try_fast(ens, slot, False)
        if hit:
            self._safe_resolve(fut, res)
            return fut
        self._push(ens, _PendingOp(eng.OP_GET, slot, 0, fut))
        return fut

    def kget_vsn(self, ens: int, key: Any) -> Future:
        """Read returning the version too: ('ok', value|NOTFOUND,
        (epoch, seq)) — the handle a subsequent :meth:`kupdate` /
        :meth:`ksafe_delete` CAS needs.  An absent key reads as
        ('ok', NOTFOUND, (0, 0)).  Fast-path served like :meth:`kget`."""
        fut = Future()
        slot = self._slot_for(ens, key, allocate=False)
        if slot is None:
            fut.resolve(("ok", NOTFOUND, (0, 0)))
            return fut
        hit, res = self._try_fast(ens, slot, True)
        if hit:
            self._safe_resolve(fut, res)
            return fut
        self._push(ens, _PendingOp(eng.OP_GET, slot, 0, fut,
                                   want_vsn=True))
        return fut

    def kupdate(self, ens: int, key: Any, expected_vsn: Tuple[int, int],
                value: Any) -> Future:
        """Compare-and-swap (do_kupdate, peer.erl:259-270): commit
        `value` iff the key's current version equals `expected_vsn`;
        (0, 0) on an absent key is create-if-missing.  Resolves
        ('ok', new_vsn) or 'failed'."""
        fut = Future()
        slot = self._slot_for(ens, key, allocate=True)
        if slot is None:
            fut.resolve("failed")
            return fut
        handle = self._alloc_handle()
        self.values[handle] = value
        gen = self.slot_gen[ens].get(slot, 0) + 1
        self.slot_gen[ens][slot] = gen
        self._note_handle_write(ens, slot)
        self._push(ens, _PendingOp(
            eng.OP_CAS, slot, handle, fut, key, gen,
            exp=(int(expected_vsn[0]), int(expected_vsn[1]))))
        return fut

    def kput_once(self, ens: int, key: Any, value: Any) -> Future:
        """Create-if-missing (do_kput_once, peer.erl:278-284): the
        (0, 0)-expected CAS."""
        return self.kupdate(ens, key, (0, 0), value)

    def ksafe_delete(self, ens: int, key: Any,
                     expected_vsn: Tuple[int, int]) -> Future:
        """Version-guarded delete (ksafe_delete): CAS to a tombstone.
        Resolves ('ok', vsn) or 'failed' (version mismatch, no quorum,
        or no such key); the slot recycles once the tombstone
        commits."""
        fut = Future()
        slot = self._slot_for(ens, key, allocate=False)
        if slot is None:
            fut.resolve("failed")  # nothing at this key to guard
            return fut
        op = _PendingOp(eng.OP_CAS, slot, 0, fut, key,
                        self.slot_gen[ens].get(slot, 0),
                        exp=(int(expected_vsn[0]), int(expected_vsn[1])))
        self._push(ens, op)
        self._recycle_on_ok(fut, ens, key, slot)
        return fut

    def kdelete(self, ens: int, key: Any) -> Future:
        """Tombstone write (slot recycled once committed)."""
        fut = Future()
        slot = self._slot_for(ens, key, allocate=False)
        if slot is None:
            fut.resolve(("ok", NOTFOUND))
            return fut
        op = _PendingOp(eng.OP_PUT, slot, 0, fut, key,   # 0 = tombstone
                        self.slot_gen[ens].get(slot, 0))
        self._push(ens, op)
        self._recycle_on_ok(fut, ens, key, slot)
        return fut

    def kmodify(self, ens: int, key: Any, mod_fun: Any, default: Any,
                retries: int = 8) -> Future:
        """Server-side modify (do_kmodify, peer.erl:303-317): read the
        key, apply ``mod_fun`` to the current value (``default`` when
        absent), and commit the result under the read version's CAS
        guard, retrying the whole read→fn→CAS cycle on conflict.

        ``mod_fun`` is a callable or a funref (:mod:`..funref`), called
        as ``mod_fun(vsn, current_value) -> new_value | "failed"``,
        where ``vsn`` is the version the value was READ at.  Returning
        "failed" (or raising) aborts without writing.  Resolves
        ('ok', new_vsn) | 'failed'.

        The DEVICE FAST PATH: a funref that resolves to a mod-fun table
        entry (:func:`funref.device_entry`) on a key holding a
        device-native value (fresh, or written by this path) runs as
        ONE ``OP_RMW`` engine round: read, fun and commit fuse under
        the round's seq discipline, so the op costs one flush and never
        CAS-conflicts.  It requires ``default == 0`` (the engine reads
        absence as 0); anything else keeps the host path.

        The host path's read and CAS are ordinary queued ops, so
        concurrent kmodifys of one key serialize through device-round
        order and the losers retry — N concurrent increments converge
        to exactly +N.  The CAS half is chained into the flush that
        resolved its read, and conflicted retries back off by a
        jittered number of flushes.
        """
        fut = Future()
        try:
            fn = funref.resolve(mod_fun)
        except ValueError:
            fut.resolve("failed")
            return fut
        dev = funref.device_entry(mod_fun)
        if dev is not None and funref.is_int32(default) \
                and int(default) == 0:
            slot = self._slot_for(ens, key, allocate=True)
            if slot is None:
                fut.resolve("failed")
                return fut
            if self._rmw_eligible(ens, slot):
                # A device RMW cannot CAS-conflict, so a failed round
                # is a transient (quorum blip): honor ``retries``.  Each
                # attempt re-resolves the slot — a racing put may have
                # flipped the key to host storage, and then 'failed' is
                # the honest outcome.
                def dev_attempt(tries_left: int) -> None:
                    s = self._slot_for(ens, key, allocate=True)
                    if s is None or not self._rmw_eligible(ens, s):
                        self._safe_resolve(fut, "failed")
                        return
                    inner = Future()
                    self._push_rmw(ens, key, s, dev, inner)

                    def on_res(r: Any) -> None:
                        if fut.done:
                            return
                        if (isinstance(r, tuple) and r[0] == "ok") \
                                or tries_left <= 1:
                            self._safe_resolve(fut, r)
                            return
                        if (dev[0] == funref.RMW_PIA
                                and self.slot_handle[ens].get(s, 0)
                                == -1):
                            # deterministic refusal: the slot holds a
                            # live device value, so retrying a
                            # put-if-absent cannot change the outcome
                            self._safe_resolve(fut, r)
                            return
                        self._retry_later(
                            ens, fut, 0,
                            lambda: dev_attempt(tries_left - 1))
                    inner.add_waiter(on_res)

                dev_attempt(max(1, retries))
                return fut
            # the key holds a host payload: the host path below
        if funref.device_code(mod_fun) == funref.RMW_PIA \
                and len(mod_fun[2]) == 1:
            # put-if-absent over a host-payload key is the (0,0)-CAS —
            # the exact do_kput_once semantics (a live payload of ANY
            # value refuses, int 0 included).  Routed by NAME, so a
            # non-int32 operand takes this path too.
            self.kput_once(ens, key, mod_fun[2][0]).add_waiter(
                lambda r: self._safe_resolve(fut, r))
            return fut

        def attempt(tries_left: int, conflicts: int) -> None:
            g = self.kget_vsn(ens, key)

            def on_read(res: Any) -> None:
                if fut.done:
                    return
                if not (isinstance(res, tuple) and res[0] == "ok"):
                    self._safe_resolve(fut, "failed")
                    return
                cur, vsn = res[1], tuple(res[2])
                try:
                    new = fn(vsn, default if cur is NOTFOUND else cur)
                except Exception:
                    self._emit_kmodify_error()
                    self._safe_resolve(fut, "failed")
                    return
                if isinstance(new, str) and new == "failed":
                    self._safe_resolve(fut, "failed")
                    return
                if (dev is not None and funref.is_int32(new)
                        and int(new) == 0
                        and self._slot_for(ens, key, allocate=False)
                        is not None):
                    # a TABLE fun computing 0 means the tombstone on
                    # the device path: mirror it whenever the key has a
                    # slot (a kupdate would store a live int-0 payload
                    # that reads back found)
                    c = self.ksafe_delete(ens, key, vsn)
                else:
                    c = self.kupdate(ens, key, vsn, new)
                # the CAS was enqueued by a resolve: let the flush
                # settling this read serve it too
                self._chain_kick = True

                def on_cas(r: Any) -> None:
                    if fut.done:
                        return
                    if isinstance(r, tuple) and r[0] == "ok":
                        self._safe_resolve(fut, r)
                    elif tries_left > 1:
                        # retried CAS losses: write races plus
                        # transient quorum failures (indistinguishable
                        # from 'failed')
                        self.rmw_conflicts += 1
                        self._retry_later(
                            ens, fut, conflicts,
                            lambda: attempt(tries_left - 1,
                                            conflicts + 1))
                    else:
                        self._safe_resolve(fut, "failed")
                c.add_waiter(on_cas)
            g.add_waiter(on_read)

        attempt(max(1, retries), 0)
        return fut

    def kmodify_many(self, ens: int, keys: List[Any], mod_fun: Any,
                     default: Any = 0, retries: int = 8) -> Future:
        """Vectorized server-side modify: ONE ``mod_fun`` over N keys
        behind one future, resolving to per-key ('ok', new_vsn) |
        'failed' in key order.  A device-table funref takes one
        ``OP_RMW`` round per key — the batch is one struct-of-arrays
        queue entry costing one flush.  Non-table funs (or keys holding
        host payloads) take per-key :meth:`kmodify` chains sharing the
        batch accumulator.

        With ``comm_repl`` on and a commutative or semilattice fun,
        duplicate keys fold into ONE device row, operands merged with
        the int32-exact fold (sub ships as add of the folded negated
        operand), so the slot's final value and version equal the
        sequenced chain's.  Every member of a folded group shares the
        row's ('ok', vsn).  Ordered funs (set/bxor/put_if_absent) never
        fold."""
        fut = Future()
        n = len(keys)
        if n == 0:
            fut.resolve([])
            return fut
        accum = _BatchAccum(n)
        dev = funref.device_entry(mod_fun)
        device_ok = (dev is not None and funref.is_int32(default)
                     and int(default) == 0)

        def host_one(i: int, key: Any) -> None:
            f = self.kmodify(ens, key, mod_fun, default, retries)
            f.add_waiter(lambda r, i=i: accum.fill(
                fut, [i], [r], self._safe_resolve))

        if not device_ok:
            for i, key in enumerate(keys):
                host_one(i, key)
            return fut
        code, operand = dev
        coalesce = (self._comm_repl
                    and funref.merge_class(code) is not None)
        sg = self.slot_gen[ens]
        ks = self.key_slot[ens]
        fs = self.free_slots[ens]
        slot_l: List[int] = []
        ops_l: List[int] = []
        gen_l: List[int] = []
        live_keys: List[Any] = []
        members: List[List[int]] = []   # result positions per row
        row_of: Dict[int, int] = {}
        miss_pos: List[int] = []
        for i, key in enumerate(keys):
            s = ks.get(key)
            if s is None:
                if not fs:
                    miss_pos.append(i)
                    continue
                s = fs.pop()
                ks[key] = s
            if not self._rmw_eligible(ens, s):
                host_one(i, key)  # host-payload key: per-key fallback
                continue
            if coalesce:
                r = row_of.get(s)
                if r is not None:
                    ops_l[r] = funref.fold_operand(code, ops_l[r], operand)
                    members[r].append(i)
                    self.rmw_enqueue_coalesced += 1
                    continue
                row_of[s] = len(slot_l)
            g = sg.get(s, 0) + 1
            sg[s] = g
            slot_l.append(s)
            ops_l.append(funref.fold_seed(code, operand) if coalesce
                         else operand)
            gen_l.append(g)
            live_keys.append(key)
            members.append([i])
        if slot_l:
            self._inline_slots[ens].update(slot_l)
            self._inline_np[ens, np.asarray(slot_l, np.int32)] = True
        if miss_pos:
            accum.fill(fut, miss_pos, ["failed"] * len(miss_pos),
                       self._safe_resolve)
        if live_keys:
            m = len(slot_l)
            self.rmw_device_fastpath += sum(len(mb) for mb in members)
            # folded operands live in the MERGE_ADD-normalized domain,
            # so a folded sub ships as add (cur-a-b == cur+(-(a+b))
            # under int32 wraparound)
            ship_code = (funref.RMW_ADD
                         if coalesce and code == funref.RMW_SUB
                         else code)
            # the batch rides an INNER future so transiently failed
            # rows get their remaining ``retries`` through the scalar
            # path; a failed folded row applied NOTHING, so each member
            # retrying its own single op is exact
            inner = Future()
            self._push(ens, _PendingBatch(
                eng.OP_RMW, slot_l, ops_l, inner,
                list(range(m)), live_keys, gen_l, [ship_code] * m,
                [0] * m, _BatchAccum(m), want_vsn=True, n=m))

            def on_batch(results: Any) -> None:
                if not isinstance(results, list):
                    allp = [p for mb in members for p in mb]
                    accum.fill(fut, allp, ["failed"] * len(allp),
                               self._safe_resolve)
                    return
                for mb, key, r in zip(members, live_keys, results):
                    if (isinstance(r, tuple) and r[0] == "ok") \
                            or retries <= 1:
                        accum.fill(fut, mb, [r] * len(mb),
                                   self._safe_resolve)
                    else:
                        for pos in mb:
                            f = self.kmodify(ens, key, mod_fun,
                                             default, retries - 1)
                            f.add_waiter(
                                lambda r2, pos=pos: accum.fill(
                                    fut, [pos], [r2],
                                    self._safe_resolve))
            inner.add_waiter(on_batch)
        return fut

    # -- lease-protected read fast path -------------------------------------

    def set_fast_reads(self, enabled: bool) -> None:
        """Turn the lease-protected read fast path on or off (the
        reference's ``RETPU_FAST_READS``); off routes every read
        through the device round.  ``config.trust_lease=False`` keeps
        it off."""
        enabled = bool(enabled) and self.config.trust_lease
        if enabled:
            # the safety inequality is a precondition of SERVING, so
            # it is checked at every enable
            self._assert_read_margin()
        self._fast_reads = enabled

    def _assert_read_margin(self) -> None:
        if not (0.0 <= self._read_margin
                and self.config.lease() + self._read_margin
                < self.config.follower()):
            raise ValueError(
                "need 0 <= read_margin and lease + read_margin < "
                "follower_timeout to enable lease-protected reads")

    def _fast_read_ok(self, ens: int, now: float) -> Optional[str]:
        """None when ensemble ``ens`` may serve lease-protected reads
        right now; otherwise the miss reason."""
        if not self._fast_reads:
            return "disabled"
        lead = self.leader_np[ens]
        if lead < 0 or not self.up[ens, lead]:
            # leaderless / leader-down rows are electing: never serve
            # around that
            return "no_leader"
        if self._corrupt_rows[ens]:
            return "corrupt"
        if self.lease_until[ens] <= now + self._read_margin:
            return "no_lease"
        return None

    def _try_fast(self, ens: int, slot: int, want_vsn: bool
                  ) -> Tuple[bool, Any]:
        """The whole fast-path gate for one scalar read: (hit,
        result), the attempt accounted either way."""
        reason = self._fast_read_ok(ens, self.runtime.now)
        if reason is None:
            reason, res = self._fast_read_result(ens, slot, want_vsn)
        else:
            res = None
        return self._count_fast(reason), res

    def _fast_read_result(self, ens: int, slot: int, want_vsn: bool
                          ) -> Tuple[Optional[str], Any]:
        """(miss_reason, result) for one slot read off the committed
        host mirrors; ``result`` is valid only when the reason is
        None.  The caller has already passed :meth:`_fast_read_ok`."""
        if self._pending_writes[ens][slot]:
            return "pending_write", None
        vsn: Any = None
        if want_vsn:
            if not self._slot_vsn_ok[ens, slot]:
                # unmirrored version (post-election invalidation): the
                # device round re-versions and re-mirrors it
                return "vsn_unmirrored", None
            ve, vs = self._slot_vsn_np[ens, slot]
            vsn = (int(ve), int(vs))
        h = self.slot_handle[ens].get(slot, 0)
        if h == -1:
            if not self._inline_value_ok[ens, slot]:
                return "inline_unmirrored", None
            out: Any = int(self._inline_value_np[ens, slot])
        elif h:
            out = self.values.get(h, NOTFOUND)
        else:
            # nothing committed (tombstone or never-written slot); a
            # tombstone's real vsn rides along so CAS chains work
            out = NOTFOUND
        return None, (("ok", out, vsn) if want_vsn else ("ok", out))

    def _count_fast(self, reason: Optional[str]) -> bool:
        """Account one fast-path attempt; True = hit (serve now)."""
        if reason is None:
            self.read_fastpath_hits += 1
            # a mirror-served read is a served op
            self.ops_served += 1
            return True
        self.read_fastpath_misses += 1
        r = self.read_fastpath_miss_reasons
        r[reason] = r.get(reason, 0) + 1
        return False

    def _note_write(self, ens: int, slot: int) -> None:
        self._pending_writes[ens][slot] += 1

    def _unnote_write(self, ens: int, slot: int) -> None:
        # clamped at 0: an unpaired un-note must park reads on the
        # safe device round, not hide every later write
        row = self._pending_writes[ens]
        if row[slot] > 0:
            row[slot] -= 1

    # -- read-modify-write internals ----------------------------------------

    def _rmw_eligible(self, ens: int, slot: int) -> bool:
        """A slot the device fast path may RMW: no QUEUED host-payload
        write racing it, and device-native already or holding no
        committed host payload — int32 arithmetic over a payload
        HANDLE would corrupt the data while acking 'ok'."""
        if self._queued_handle_writes[ens][slot]:
            return False
        return (slot in self._inline_slots[ens]
                or self.slot_handle[ens].get(slot, 0) == 0)

    def _note_handle_write(self, ens: int, slot: int) -> None:
        self._queued_handle_writes[ens][slot] += 1

    def _unnote_handle_write(self, ens: int, slot: int) -> None:
        row = self._queued_handle_writes[ens]
        if row[slot] > 0:
            row[slot] -= 1

    def _push_rmw(self, ens: int, key: Any, slot: int,
                  dev: Tuple[int, int], fut: Future) -> None:
        code, operand = dev
        gen = self.slot_gen[ens].get(slot, 0) + 1
        self.slot_gen[ens][slot] = gen
        # optimistic inline marking: a second kmodify racing this
        # one's commit must still see the slot as device-native
        self._inline_slots[ens].add(slot)
        self._inline_np[ens, slot] = True
        self.rmw_device_fastpath += 1
        self._push(ens, _PendingOp(eng.OP_RMW, slot, operand, fut,
                                   key, gen, exp=(code, 0),
                                   want_vsn=True))

    def _retry_later(self, ens: int, fut: Future, conflict_idx: int,
                     thunk) -> None:
        """Jittered backoff between retries, in flush calls: retry 0
        is immediate, later ones draw a uniform delay from a doubling
        window so N stampeding writers spread over ~N flushes.  The
        draws come from one seeded generator, in the reference's
        order."""
        delay = self._rng.randrange(1 << min(conflict_idx, 4))
        if delay == 0:
            thunk()
            # an immediate retry enqueued during a resolve is a chain
            # follow-up like the CAS half
            self._chain_kick = True
        else:
            self._retry_at.append((self._flush_calls + delay, ens,
                                   fut, thunk))

    def _run_due_retries(self) -> None:
        if not self._retry_at:
            return
        now = self._flush_calls
        due = [t for at, _e, fut, t in self._retry_at
               if at <= now and not fut.done]
        self._retry_at = [r for r in self._retry_at
                          if r[0] > now and not r[2].done]
        for thunk in due:
            thunk()

    def _fire_idle_retries(self) -> None:
        """At the end of a flush that left nothing queued, fire every
        parked retry now: with no concurrent writer left the backoff is
        pure latency, and a caller looping ``while any(svc.queues):
        flush()`` would otherwise stop with the futures unresolved."""
        if self._retry_at and not self._active and not self._inflight:
            parked, self._retry_at = self._retry_at, []
            for _at, _e, fut, thunk in parked:
                if not fut.done:
                    thunk()

    def _emit_kmodify_error(self) -> None:
        """Log a mod-fun exception (called inside its ``except``),
        rate-limited to one traceback per second; suppressed counts
        ride the next one."""
        now = time.monotonic()
        if now - self._kmodify_err_at >= 1.0:
            self._kmodify_err_at = now
            log.warning("kmodify mod_fun raised (%d earlier errors "
                        "suppressed)", self._kmodify_err_dropped,
                        exc_info=True)
            self._kmodify_err_dropped = 0
        else:
            self._kmodify_err_dropped += 1

    def set_peer_up(self, ens: int, peer: int, up: bool) -> None:
        """Failure-detector input (the host's nodedown/suspend signal)."""
        self.up[ens, peer] = up
        self._up_dev = None

    def execute(self, kind: np.ndarray, slot: np.ndarray,
                val: np.ndarray,
                exp_epoch: Optional[np.ndarray] = None,
                exp_seq: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, np.ndarray,
                           np.ndarray, np.ndarray]:
        """Bulk array API: run ``[K, E]`` op matrices through the service
        in one launch and return ``(committed, get_ok, found, value)`` as
        ``[K, E]`` arrays.  Callers address slots directly and carry
        int32 payloads inline (no host handle store).  Payload 0 is the
        tombstone (a put of 0 is a delete).  OP_RMW rows carry the fun
        code in ``exp_epoch`` and return the computed value.  Elections
        fold in and leases check/renew as for queued ops.  It settles
        every launch in flight first, so its results land behind them.

        The planes may be DEVICE-RESIDENT: int32 tensors on the
        service's device (batched_host.py:5002-5026).  Then no op plane
        is copied to the device, the payloads are not checked on the
        host, the launch is full width, and ``ops_served`` grows by
        ``k * E``.  With a ``data_dir`` a host-array call logs its
        committed writes before it returns (the result is the ack); a
        device-resident call is not logged (its recovery point is the
        last checkpoint) and sets ``_dev_exec_unlogged``."""
        self._drain_launches()
        if isinstance(kind, torch.Tensor):
            kind, slot, val, exp_e, exp_s = _device_planes(
                self.device, kind, slot, val, exp_epoch, exp_seq)
            self._note_dev_exec_unlogged()
            k = int(kind.shape[0])
            committed, get_ok, found, value, _ = self._launch(
                kind, slot, val, k, want_vsn=False, exp_e=exp_e,
                exp_s=exp_s)
            self.ops_served += k * self.n_ens
            return committed, get_ok, found, value
        kind, slot, val, exp_e, exp_s = _bulk_planes(kind, slot, val,
                                                     exp_epoch, exp_seq)
        if (self._wal is not None and self._storage_degraded is not None
                and ((kind == eng.OP_PUT) | (kind == eng.OP_CAS)
                     | (kind == eng.OP_RMW)).any()):
            # read-only: the result is the ack, and these writes cannot
            # be made durable (batched_host.py:5033-5042)
            raise OSError(
                errno.EIO, "service is read-only (storage degraded): "
                "execute() writes cannot be made durable")
        want_vsn = self._wal is not None
        committed, get_ok, found, value, vsn = self._launch(
            kind, slot, val, int(kind.shape[0]), want_vsn=want_vsn,
            exp_e=exp_e, exp_s=exp_s)
        if self._wal is not None:
            self._log_execute_wal(kind, slot, val, committed, vsn, value)
        self.ops_served += int((kind != eng.OP_NOOP).sum())
        return committed, get_ok, found, value

    def _note_dev_exec_unlogged(self) -> None:
        # the reference's trace event for this waits for obs (ROADMAP
        # Queue 1 item 5); the flag is its record
        if self._wal is not None:
            self._dev_exec_unlogged = True

    def execute_async(self, kind: np.ndarray, slot: np.ndarray,
                      val: np.ndarray,
                      exp_epoch: Optional[np.ndarray] = None,
                      exp_seq: Optional[np.ndarray] = None) -> Future:
        """Pipelined :meth:`execute` (batched_host.py:5089-5150): enqueue
        the ``[K, E]`` batch and return a :class:`Future` resolving to
        ``(committed, get_ok, found, value)`` (or 'failed' on a failed
        launch or WAL error).  Up to ``pipeline_depth`` batches overlap
        — batch N's copy and host resolve run under batch N + 1's step —
        and results resolve strictly in submission order; a later call,
        or an idle :meth:`flush`, settles the tail.  The same
        device-resident and WAL contract as :meth:`execute`."""
        fut = Future()
        exec_wal = None
        if isinstance(kind, torch.Tensor):
            kind, slot, val, exp_e, exp_s = _device_planes(
                self.device, kind, slot, val, exp_epoch, exp_seq)
            self._note_dev_exec_unlogged()
            k = int(kind.shape[0])
            n_ops = k * self.n_ens
            want_vsn = False
        else:
            kind, slot, val, exp_e, exp_s = _bulk_planes(
                kind, slot, val, exp_epoch, exp_seq)
            k = int(kind.shape[0])
            n_ops = int((kind != eng.OP_NOOP).sum())
            want_vsn = self._wal is not None
            if want_vsn:
                exec_wal = (kind, slot, val)
        # an in-flight launch may be about to install a leader: electing
        # again would re-version its objects, so settle first
        elect, cand = self._election_inputs()
        if elect.any() and self._inflight:
            self._drain_launches()
            elect, cand = self._election_inputs()
        try:
            fl = self._launch_enqueue(kind, slot, val, k,
                                      want_vsn=want_vsn, exp_e=exp_e,
                                      exp_s=exp_s, elect=elect, cand=cand)
        except BaseException:
            self._safe_resolve(fut, "failed")
            raise
        fl.exec_fut = fut
        fl.exec_ops = n_ops
        fl.exec_wal = exec_wal
        self._inflight.append(fl)
        self._drain_launches(keep=self.pipeline_depth - 1)
        return fut

    def flush(self) -> int:
        """One device launch for everything queued, plus at most two
        chained launches for follow-ups its settle enqueued (kmodify
        CAS halves, immediate retries); returns ops served by the
        launches SETTLED during this call.

        With ``pipeline_depth`` > 1 the launch is only enqueued here while
        work stays queued: it settles during a later flush, after that
        flush's launch is enqueued (FIFO).  A flush that empties the queues
        settles everything, so flush-until-done callers see resolved
        futures exactly as at depth 1 (batched_host.py:5152-5170)."""
        self._flush_calls += 1
        self._run_due_retries()
        active = self._active
        k = min(self.max_k,
                max((self._queue_rounds[e] for e in active), default=0))
        served = 0
        if k == 0:
            # idle flush: settle the pipeline; chained follow-ups get
            # their own launch cycle; an election-only launch runs if one
            # is needed
            served += self._drain_launches()
            served += self._chain_flush()
            if not self._election_inputs()[0].any():
                self._flush_maintenance()
                return served
        # Bucket the batch depth to the next power of two (capped at
        # max_k), as the reference does for its compile cache — kept so
        # the launch shapes, and the packed buffers, match it.
        if k:
            b = 1
            while b < k:
                b <<= 1
            k = min(b, self.max_k)

        kind = np.zeros((k, self.n_ens), dtype=np.int32)
        slot = np.zeros((k, self.n_ens), dtype=np.int32)
        val = np.zeros((k, self.n_ens), dtype=np.int32)
        exp_e = np.zeros((k, self.n_ens), dtype=np.int32)
        exp_s = np.zeros((k, self.n_ens), dtype=np.int32)
        #: (ensemble, taken ops) pairs — ACTIVE ensembles only
        taken: List[Tuple[int, List[Any]]] = []
        still_active = set()
        #: the slab path (batched_host.py:5243-5345): the walk collects
        #: the PENDING SLAB — one run descriptor per taken entry (its
        #: column, first plane row, run length, op kind) over
        #: concatenated per-op field lanes — and the planes are packed
        #: from it in one pass below.  ``offs`` is each entry's first
        #: slab row, which the completion-slab resolve indexes by.
        use_slab = self._enq_slab
        ent_col: List[int] = []
        ent_row0: List[int] = []
        ent_len: List[int] = []
        ent_kind: List[int] = []
        slot_l: List[int] = []
        val_l: List[int] = []
        expe_l: List[int] = []
        exps_l: List[int] = []
        offs: List[int] = []
        lane_n = 0
        for e in sorted(active):
            q = self.queues[e]
            ops: List[Any] = []
            rounds = idx = 0
            while idx < len(q) and rounds < k:
                op = q[idx]
                if rounds + op.n <= k:
                    ops.append(op)
                    rounds += op.n
                    idx += 1
                else:
                    # K cap lands inside a batch: take the head rounds
                    # now; the tail (same Future/accumulator) leads the
                    # next flush.
                    head, tail = op.split(k - rounds)
                    ops.append(head)
                    rounds = k
                    q[idx] = tail
                    break
            self.queues[e] = q[idx:]
            self._queue_rounds[e] -= rounds
            if self.queues[e]:
                still_active.add(e)
            if ops:
                taken.append((e, ops))
            j = 0
            if use_slab:
                # list appends only: the lanes convert once per flush
                for op in ops:
                    n = op.n
                    offs.append(lane_n)
                    lane_n += n
                    ent_col.append(e)
                    ent_row0.append(j)
                    ent_len.append(n)
                    ent_kind.append(op.kind)
                    if isinstance(op, _PendingBatch):
                        slot_l.extend(op.slot)
                        val_l.extend(op.handle)
                        if op.exp_e is not None:
                            expe_l.extend(op.exp_e)
                            exps_l.extend(op.exp_s)
                        else:
                            z = [0] * n
                            expe_l.extend(z)
                            exps_l.extend(z)
                    else:
                        slot_l.append(op.slot)
                        val_l.append(op.handle)
                        expe_l.append(op.exp[0])
                        exps_l.append(op.exp[1])
                    j += n
                continue
            for op in ops:
                if isinstance(op, _PendingBatch):
                    n = op.n
                    kind[j:j + n, e] = op.kind
                    slot[j:j + n, e] = op.slot
                    val[j:j + n, e] = op.handle
                    if op.exp_e is not None:
                        exp_e[j:j + n, e] = op.exp_e
                        exp_s[j:j + n, e] = op.exp_s
                    j += n
                else:
                    kind[j, e] = op.kind
                    slot[j, e] = op.slot
                    val[j, e] = op.handle
                    exp_e[j, e], exp_s[j, e] = op.exp
                    j += 1
        lanes = None
        if use_slab and lane_n:
            # the pack (batched_host.py:5346-5405): one C++ traversal of
            # the runs, or the numpy pack
            ec = np.asarray(ent_col, np.int32)
            er = np.asarray(ent_row0, np.int32)
            el = np.asarray(ent_len, np.int32)
            args = (k, self.n_ens, ec, er, el,
                    np.asarray(ent_kind, np.int32),
                    np.asarray(slot_l, np.int32), np.asarray(val_l, np.int32),
                    np.asarray(expe_l, np.int32),
                    np.asarray(exps_l, np.int32),
                    kind, slot, val, exp_e, exp_s)
            if self._native_enqueue is not None:
                self._native_enqueue.pack(*args)
                self.native_enqueue_flushes += 1
            else:
                enqueue_native.pack_plain(*args)
                self.fallback_enqueue_flushes += 1
            lanes = (ec, er, el, lane_n, offs)
        self._active = still_active
        # Elections plan from the host mirrors, which an in-flight launch
        # may still be about to update (a won election lands at settle):
        # settle first, or the row re-elects and the epoch bump
        # re-versions its objects.
        elect, cand = self._election_inputs()
        if elect.any() and self._inflight:
            served += self._drain_launches()
            elect, cand = self._election_inputs()
        try:
            fl = self._launch_enqueue(kind, slot, val, k, want_vsn=True,
                                      exp_e=exp_e, exp_s=exp_s,
                                      elect=elect, cand=cand)
        except BaseException:
            # A failed device launch must not orphan the taken ops:
            # fail them all, then let the error reach the flush() caller.
            for e, ops in taken:
                for op in ops:
                    self._fail_entry(e, op)
            raise
        fl.taken = taken
        fl.lanes = lanes
        self._inflight.append(fl)
        # settle everything when the queues drained, else down to
        # depth - 1 in flight: the window the next flush overlaps
        keep = self.pipeline_depth - 1 if self._active else 0
        served += self._drain_launches(keep=keep)
        served += self._chain_flush()
        self._flush_maintenance()
        return served

    def _chain_flush(self) -> int:
        """Same-flush chaining: when a resolve enqueued follow-up ops —
        a host-path kmodify read's CAS half, or an immediate conflict
        retry — run ONE more launch cycle inside the same flush() call,
        so the follow-up costs this flush instead of the next.  Nesting
        is capped at 2; the backoff queue carries the rest."""
        if not self._chain_kick:
            return 0
        self._chain_kick = False
        if not self._active or self._chain_depth >= 2:
            return 0
        self._chain_depth += 1
        try:
            return self.flush()
        finally:
            self._chain_depth -= 1

    # -- internals ---------------------------------------------------------

    def _up_device(self) -> torch.Tensor:
        """Device copy of the up mask, re-uploaded only after a
        failure-detector change (steady state: zero h2d bytes)."""
        if self._up_dev is None:
            up = torch.from_numpy(self.up.copy())
            if self.device.type == "cuda":
                up = up.pin_memory().to(self.device, non_blocking=True)
            self._up_dev = up
        return self._up_dev

    def _alloc_handle(self) -> int:
        if self._free_handles:
            return self._free_handles.pop()
        h = self._next_handle
        assert h <= 0x7FFFFFFF, "2^31 live payloads cannot fit int32 handles"
        self._next_handle += 1
        return h

    def _alloc_handles(self, m: int) -> List[int]:
        """``m`` payload handles in ONE slab operation — the pooled tail
        (in the exact order ``m`` sequential pops would yield) then a
        fresh contiguous range."""
        free = self._free_handles
        t = min(m, len(free))
        out = free[len(free) - t:][::-1]
        if t:
            del free[len(free) - t:]
        if t < m:
            h0 = self._next_handle
            self._next_handle = h0 + (m - t)
            assert self._next_handle - 1 <= 0x7FFFFFFF, \
                "2^31 live payloads cannot fit int32 handles"
            out.extend(range(h0, self._next_handle))
        return out

    def _release_handle(self, handle: int) -> None:
        """Drop a payload and make its handle reusable (double release
        is a no-op)."""
        if handle and self.values.pop(handle, None) is not None:
            self._free_handles.append(handle)

    def _slot_for(self, ens: int, key: Any, allocate: bool) -> Optional[int]:
        slot = self.key_slot[ens].get(key)
        if slot is not None or not allocate:
            return slot
        if not self.free_slots[ens]:
            return None
        slot = self.free_slots[ens].pop()
        self.key_slot[ens][key] = slot
        return slot

    def _drain_recycles(self) -> None:
        """Free slots whose recycle was deferred, once nothing queued
        references them and the conditions still hold: no later put
        bumped the generation, nothing live is committed, and the key
        still owns the slot."""
        if not self._recycle_dirty:
            return
        dirty, self._recycle_dirty = self._recycle_dirty, set()
        for e in dirty:
            pend = self._recycle_pending[e]
            if not pend:
                continue
            busy = set()
            for op in self.queues[e]:
                if isinstance(op, _PendingBatch):
                    busy.update(op.slot)
                else:
                    busy.add(op.slot)
            keep = []
            for key, slot, gen in pend:
                if slot in busy:
                    keep.append((key, slot, gen))
                elif self.slot_gen[e].get(slot, 0) == gen \
                        and self.slot_handle[e].get(slot, 0) == 0 \
                        and self.key_slot[e].get(key) == slot:
                    # (a live device-native value holds the -1 sentinel
                    # in slot_handle, so it never reaches this branch)
                    del self.key_slot[e][key]
                    self._inline_slots[e].discard(slot)
                    self._inline_np[e, slot] = False
                    self.free_slots[e].append(slot)
                # else: the slot was re-used meanwhile — drop the stale
                # recycle request
            self._recycle_pending[e] = keep
            if keep:  # still blocked: revisit on a later drain
                self._recycle_dirty.add(e)

    def _push(self, ens: int, op) -> None:
        """Enqueue one entry.  Writes register in the per-slot
        pending-write index here — the one choke point every keyed
        write passes — and deregister when they resolve or fail."""
        if op.kind != eng.OP_GET:
            if isinstance(op, _PendingBatch):
                pw = self._pending_writes[ens]
                for s in op.slot:
                    pw[s] += 1
            else:
                self._note_write(ens, op.slot)
            if self._storage_degraded is not None:
                # read-only: the WAL cannot take the durability barrier,
                # so no write may queue toward an ack; it fails through
                # the normal path (batched_host.py:3214-3221)
                self._fail_entry(ens, op)
                return
        self.queues[ens].append(op)
        self._queue_rounds[ens] += op.n
        self._active.add(ens)

    def _queue_recycle(self, ens: int, item: Tuple[Any, int, int]) -> None:
        self._recycle_pending[ens].append(item)
        self._recycle_dirty.add(ens)

    def _recycle_on_ok(self, fut: Future, ens: int, key: Any,
                       slot: int) -> None:
        """Once a delete commits, queue the slot for deferred recycling
        (validated and applied by _drain_recycles)."""
        gen = self.slot_gen[ens].get(slot, 0)

        def recycle(result):
            if isinstance(result, tuple) and result[0] == "ok":
                self._queue_recycle(ens, (key, slot, gen))
        fut.add_waiter(recycle)

    def _election_inputs(self) -> Tuple[np.ndarray, np.ndarray]:
        """Elect wherever there is no leader or the leader is down;
        candidate = lowest-index up member.  Host mirrors only."""
        leader = self.leader_np
        leader_up = np.zeros((self.n_ens,), dtype=bool)
        has = leader >= 0
        leader_up[has] = self.up[np.nonzero(has)[0], leader[has]]
        cand_ok = self.up & self.member_np
        any_up = cand_ok.any(1)
        cand = np.where(any_up, cand_ok.argmax(1), -1).astype(np.int32)
        elect = (~has | ~leader_up) & any_up
        return elect, cand

    def _fetch_packed(self, fl: _InFlightLaunch) -> np.ndarray:
        """Block until the launch's packed result is on the host (the
        ONE device→host transfer per launch)."""
        if fl.done is None:
            return fl.flat.numpy()
        fl.done.synchronize()
        return fl.host.numpy()

    def _launch_enqueue(self, kind: np.ndarray, slot: np.ndarray,
                        val: np.ndarray, k: int, want_vsn: bool,
                        exp_e: Optional[np.ndarray] = None,
                        exp_s: Optional[np.ndarray] = None,
                        elect: Optional[np.ndarray] = None,
                        cand: Optional[np.ndarray] = None
                        ) -> _InFlightLaunch:
        """ENQUEUE half of a launch (batched_host.py:3405-3640): choose
        the active set, build and upload the inputs, step, pack, and
        start the packed result's device→host copy.  Nothing here waits
        for the device on CUDA: uploads come from pinned buffers, and the
        copy runs on a side stream that waits on an event recorded after
        the pack.  On the CPU the same steps run synchronously.

        Active-column compaction, two strengths: the columns holding ops
        or elections, pow2-bucketed from ``A_BUCKET_MIN``.  With
        ``E >= SLICE_MIN_E`` and a bucket of at most E/4 the step itself
        runs on those rows (SLICED: inputs and results A-wide, pads =
        index E, NOOP and not electing); otherwise, while the bucket is
        below E, the step keeps the full grid and only the pack gathers
        the client planes (pads = column 0).  Device-resident planes
        (tensors) skip compaction and every op-plane upload.

        On the CPU the launch first snapshots the state, the leader
        mirror and the leases; a failure here restores them
        (:meth:`_rollback_launch`), and so does one at settle."""
        if elect is None:
            elect, cand = self._election_inputs()
        now = self.runtime.now
        lease_ok = self.lease_until > now
        e = self.n_ens
        step, step_sliced = self._step_fns()
        host_planes = not isinstance(kind, torch.Tensor)
        active = pad = None
        a_width = 0
        sliced = False
        if self._compact and k and host_planes:
            cols = np.flatnonzero((kind != eng.OP_NOOP).any(axis=0)
                                  | elect)
            if cols.size:
                a_b = A_BUCKET_MIN
                while a_b < cols.size:
                    a_b <<= 1
                if a_b < e:
                    active = cols.astype(np.int32)
                    a_width = a_b
                    sliced = (step_sliced is not None
                              and e >= SLICE_MIN_E and a_b * 4 <= e)
                    pad = np.full((a_b,), e if sliced else 0, np.int32)
                    pad[:cols.size] = active
        width = a_width if sliced else e
        a_n = 0 if active is None else active.size
        ups = self._uploads
        ups.begin()

        def plane(name: str, src: np.ndarray, dtype: torch.dtype):
            """Upload a [K, E] host plane, column-sliced when sliced (a
            device-resident plane is used as it is)."""
            if not host_planes:
                return src
            buf = ups.buffer(name, (k, width), dtype)
            out = buf.numpy()
            if sliced:
                out[:, :a_n] = src[:, active]
                out[:, a_n:] = 0
            else:
                out[...] = src
            return ups.upload(buf)

        def vector(name: str, src: np.ndarray, dtype: torch.dtype):
            buf = ups.buffer(name, (width,), dtype)
            out = buf.numpy()
            if sliced:
                out[:a_n] = src[active]
                out[a_n:] = 0
            else:
                out[...] = src
            return ups.upload(buf)

        kind_j = plane("kind", kind, torch.int32)
        slot_j = plane("slot", slot, torch.int32)
        val_j = plane("val", val, torch.int32)
        exp_e_j = None if exp_e is None else plane("exp_e", exp_e,
                                                   torch.int32)
        exp_s_j = None if exp_s is None else plane("exp_s", exp_s,
                                                   torch.int32)
        # the lease plane travels contiguous [K, width]: F1 refuses
        # broadcast views
        lease_buf = ups.buffer("lease", (k, width), torch.bool)
        lease_np = lease_buf.numpy()
        if sliced:
            lease_np[:, :a_n] = lease_ok[active][None, :]
            lease_np[:, a_n:] = False
        else:
            lease_np[...] = lease_ok[None, :]
        lease_j = ups.upload(lease_buf)
        elect_j = vector("elect", elect, torch.bool)
        cand_j = vector("cand", cand, torch.int32)
        aidx_j = None
        if active is not None and not sliced:
            abuf = ups.buffer("aidx", (a_width,), torch.int32)
            abuf.numpy()[...] = pad
            aidx_j = ups.upload(abuf)
        up_j = self._up_device()
        # the rollback snapshot (batched_host.py:3586-3598): the CPU
        # step updates the object and tree planes in place, so they are
        # cloned; CUDA launches keep the donated contract and no copy
        snapshot = None if self._donate else (
            eng.EngineState(*(t.clone() for t in self.state)),
            self.leader_np.copy(), self.lease_until.copy())
        try:
            if sliced:
                state, won, res = step_sliced(
                    self.state, pad, elect_j, cand_j, kind_j, slot_j,
                    val_j, lease_j, up_j, exp_epoch=exp_e_j,
                    exp_seq=exp_s_j)
            else:
                state, won, res = step(
                    self.state, elect_j, cand_j, kind_j, slot_j, val_j,
                    lease_j, up_j, exp_epoch=exp_e_j, exp_seq=exp_s_j)
            self.state = state
            # a sliced launch's planes are already A-wide; pack-gather
            # hands the pack the index
            flat = _pack_results_body(won, res, want_vsn,
                                      active_idx=aidx_j)
            host = done = None
            if self._copy_stream is not None:
                packed = torch.cuda.Event()
                packed.record(torch.cuda.current_stream(self.device))
                self._copy_stream.wait_event(packed)
                host = ups.buffer("out", (flat.numel(),), torch.uint8)
                with torch.cuda.stream(self._copy_stream):
                    host.copy_(flat, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(self._copy_stream)
                ups.end(done)
        except BaseException:
            self._rollback_launch(snapshot)
            raise
        if sliced:
            self.sliced_launches += 1
        return _InFlightLaunch(
            flat=flat, host=host, done=done, k=k, want_vsn=want_vsn,
            elect=elect, cand=cand, now=now,
            kind_np=kind if host_planes else None,
            op_slot_np=slot if host_planes else None,
            active=active, a_width=a_width, sliced=sliced,
            snapshot=snapshot)

    def _step_fns(self) -> Tuple[Any, Any]:
        """The engine's (full_step, full_step_sliced) programs
        (batched_host.py:3324-3383).  An engine subclass that overrides
        the plain step but inherits the sliced one must not have its
        override bypassed: the sliced step is trusted only when the
        class (or instance) that defines the plain step defines it too;
        otherwise launches keep the full grid (None)."""
        e = self.engine

        def definer(attr):
            for c in type(e).__mro__:
                if attr in c.__dict__:
                    return c
            return None
        sliced = getattr(e, "full_step_sliced", None)
        if (sliced is not None
                and "full_step_sliced" not in getattr(e, "__dict__", {})
                and definer("full_step_sliced") is not definer("full_step")):
            sliced = None
        return e.full_step, sliced

    def _rollback_launch(self, snapshot) -> None:
        """Restore the pre-launch state and host mirrors after a failed
        launch (batched_host.py:3667-3685): a mirror claiming a leader
        the restored state does not have would suppress re-election.  A
        donated launch (CUDA, ``snapshot`` None) has no rollback; the
        state stays as the failure left it."""
        if snapshot is None:
            return
        self.state, self.leader_np, self.lease_until = snapshot

    def _launch_resolve(self, fl: _InFlightLaunch):
        """RESOLVE half of a launch (batched_host.py:3667-3880): wait for
        the packed result, unpack it to full-width planes, apply the
        leader and lease mirrors, and run the anti-entropy exchange for
        rows it flagged corrupt — on the CURRENT state, which at depth 2
        already holds the next launch's step, so a flagged row is
        repaired before any later result is acked.  Returns np result
        planes ``(committed, get_ok, found, value, vsn)`` (None planes
        for k == 0; vsn None unless asked).  A failure here rolls the
        launch back as a failed enqueue does (CPU launches)."""
        try:
            flat = self._fetch_packed(fl)
            e, m = self.n_ens, self.n_peers
            # the native arm (batched_host.py:3728-3744): one C++ pass
            # scatters a compacted payload into full-width planes.  A full-
            # width payload has nothing to scatter, and there numpy's byte-
            # wise unpackbits beats the pass's bit loop (3.0-4.8 against
            # 1.7-2.1 ms per call on the H100 machine's host, PERF.md §6), so
            # the arm unpacks it with numpy: the same bytes either way.
            # Election-only launches (k == 0) take the oracle's unpack, as in
            # the reference.
            if self._native_resolve is not None and fl.k:
                if fl.active is not None:
                    planes8 = self._native_resolve.unpack(
                        flat, e, m, fl.k, fl.want_vsn, fl.active, fl.a_width,
                        fl.sliced)
                else:
                    planes8 = unpack_results(flat, e, m, fl.k, fl.want_vsn)
                self.native_resolve_flushes += 1
            else:
                planes8 = unpack_results(flat, e, m, fl.k, fl.want_vsn,
                                         active=fl.active, a_width=fl.a_width,
                                         sliced=fl.sliced)
                self.fallback_resolve_flushes += 1
            (won_np, quorum_ok, corrupt_np, committed, get_ok, found, value,
             vsn) = planes8
            self.payload_bytes += int(flat.nbytes)
            self.payload_bytes_full_width += packed_nbytes(e, m, fl.k,
                                                           fl.want_vsn)
            self._occ_sum += (fl.a_width / e if fl.active is not None
                              else 1.0)
            self._occ_launches += 1
            # Host mirror: a won election installed our candidate.
            self.leader_np = np.where(won_np, fl.cand, self.leader_np)
            # Lease renewal: a won election, or any round in which the
            # leader confirmed its epoch with a quorum (peer.erl:1092-1095).
            renew = won_np | quorum_ok
            self.lease_until[renew] = fl.now + self.config.lease()
            # Device-detected integrity failures -> anti-entropy exchange for
            # the affected ensembles (tree_corrupted -> repair -> exchange,
            # peer.erl:1276-1277): divergent slots re-adopt the newest
            # hash-valid copy and the replicas' trees are rebuilt.  Flagged
            # rows take the device round for reads until the exchange syncs
            # them; residual damage re-flags on its next device access.
            if fl.k and corrupt_np.any():
                self.corruptions += int(corrupt_np.sum())
                run = corrupt_np.any(1)
                self._corrupt_rows |= run
                self.state, diverged, synced = self.engine.exchange_step(
                    self.state, torch.from_numpy(run).to(self.device),
                    self._up_device())
                synced_np = synced.cpu().numpy()
                self.repairs += int(diverged.cpu().numpy()[synced_np].sum())
                self._corrupt_rows &= ~(run & synced_np)
            self.flushes += 1
        except BaseException:
            self._rollback_launch(fl.snapshot)
            raise
        # A won election bumped the row's ballot epoch: the next device
        # access of each object re-versions it, so the row's vsn mirror
        # is stale — drop it (plain value reads stay fast).
        if won_np.any():
            self._slot_vsn_ok[won_np] = False
        return committed, get_ok, found, value, vsn

    def _launch(self, kind: np.ndarray, slot: np.ndarray, val: np.ndarray,
                k: int, want_vsn: bool,
                exp_e: Optional[np.ndarray] = None,
                exp_s: Optional[np.ndarray] = None):
        """One SYNCHRONOUS launch: the two halves back to back (the bulk
        :meth:`execute` path)."""
        return self._launch_resolve(self._launch_enqueue(
            kind, slot, val, k, want_vsn, exp_e, exp_s))

    def _settle_launch(self, fl: _InFlightLaunch
                       ) -> Tuple[int, Optional[BaseException]]:
        """SETTLE one in-flight launch end to end (batched_host.py:
        5649-5716): resolve it, log its committed writes to the WAL, then
        fan out its futures — the flush's taken ops or the
        ``execute_async`` future.  Returns (ops served, WAL error or
        None): a WAL failure is reported, not raised, so the drain keeps
        settling later launches, whose commits are independent of this
        one's disk error.  A launch failure fails the launch's clients
        and re-raises."""
        try:
            planes = self._launch_resolve(fl)
        except BaseException:
            self._abandon_launch(fl)
            raise
        if fl.exec_fut is not None:
            return self._settle_execute(fl, planes)
        # The durability barrier: committed writes reach the WAL (synced
        # per wal_sync) BEFORE any future resolves.  If the WAL write
        # fails, the commits stand on the device (the bookkeeping runs)
        # but their clients get 'failed' — an unacked commit is an
        # allowed outcome, a lost acked one is not.  A degraded service
        # neither logs nor acks writes; its reads still serve.
        wal_err: Optional[BaseException] = None
        degraded = self._storage_degraded is not None
        if self._wal is not None and not degraded:
            try:
                self._log_wal(fl.taken or [], planes)
            except Exception as exc:
                wal_err = exc
        served = self._resolve_flush(fl, planes,
                                     ack=wal_err is None and not degraded)
        return served, wal_err

    def _settle_execute(self, fl: _InFlightLaunch, planes
                        ) -> Tuple[int, Optional[BaseException]]:
        """Resolve one ``execute_async`` launch (batched_host.py:
        5718-5755): log its committed writes (host-array planes with a
        WAL), then resolve the future with the result planes.  An
        unpersisted commit is never acked: the future resolves
        'failed'."""
        committed, get_ok, found, value, vsn = planes
        if fl.exec_wal is not None and self._wal is not None:
            if self._storage_degraded is not None:
                self._safe_resolve(fl.exec_fut, "failed")
                return 0, None
            kind, slot, val = fl.exec_wal
            try:
                self._log_execute_wal(kind, slot, val, committed, vsn,
                                      value)
            except Exception as exc:
                self._safe_resolve(fl.exec_fut, "failed")
                return 0, exc
        self.ops_served += fl.exec_ops
        self._safe_resolve(fl.exec_fut, (committed, get_ok, found, value))
        return fl.exec_ops, None

    def _drain_launches(self, keep: int = 0) -> int:
        """Settle in-flight launches oldest-first until at most ``keep``
        remain; returns ops served (batched_host.py:5532-5583).  When a
        launch fails, every later in-flight launch stepped on the state
        the failed one left, so their clients fail too
        (``_abandon_launch``) and the error re-raises.  A WAL failure is
        different: the launch's commits are real, so later launches
        settle normally; after the drain, EIO or ENOSPC degrades the
        service to read-only and any other WAL error re-raises."""
        served = 0
        wal_err: Optional[BaseException] = None
        fatal_err: Optional[BaseException] = None
        while len(self._inflight) > keep:
            fl = self._inflight.popleft()
            try:
                n, err = self._settle_launch(fl)
            except BaseException:
                while self._inflight:
                    self._abandon_launch(self._inflight.popleft())
                raise
            served += n
            if err is not None:
                if wal_err is None:
                    wal_err = err
                if isinstance(err, OSError):
                    self.wal_storage_errors += 1
                    # a fatal errno on a LATER launch must still win
                    if fatal_err is None and err.errno in (errno.EIO,
                                                           errno.ENOSPC):
                        fatal_err = err
        if fatal_err is not None:
            self._degrade_storage("wal", fatal_err)
        elif wal_err is not None:
            raise wal_err
        return served

    def _degrade_storage(self, plane: str, exc: BaseException) -> None:
        """Flip the service read-only after a fatal storage error on the
        ack path (batched_host.py:5585-5617): queued and later writes
        fail, reads keep serving, a degraded service never compacts, and
        the decision is kept in ``_storage_degraded`` (the reference's
        ``health()["storage"]``, which waits for obs).  Recovery is a
        restart: :meth:`restore` replays the WAL on a healthy disk.  The
        first error wins the record."""
        if self._storage_degraded is not None:
            return
        code = getattr(exc, "errno", None)
        self._storage_degraded = {
            "plane": plane,
            "mode": "read_only",
            "errno": errno.errorcode.get(code, str(code)),
            "error": repr(exc)[:200],
            "at_flush": int(self.flushes),
        }
        self._fail_queued_writes()

    def _fail_queued_writes(self) -> None:
        """Fail every queued write entry, keeping queued reads
        (batched_host.py:5619-5631)."""
        for e in list(self._active):
            q = self.queues[e]
            drop = [op for op in q if op.kind != eng.OP_GET]
            if not drop:
                continue
            keep = [op for op in q if op.kind == eng.OP_GET]
            self.queues[e] = keep
            self._queue_rounds[e] = sum(op.n for op in keep)
            for op in drop:
                self._fail_entry(e, op)

    def _abandon_launch(self, fl: _InFlightLaunch) -> None:
        """Fail an in-flight launch's clients (batched_host.py:5639)."""
        if fl.exec_fut is not None:
            self._safe_resolve(fl.exec_fut, "failed")
        if fl.taken:
            for e, ops in fl.taken:
                for op in ops:
                    self._fail_entry(e, op)

    def _flush_maintenance(self) -> None:
        """Post-settle upkeep of every flush (batched_host.py:5471-5511):
        WAL compaction past the record bound, the periodic scrub against
        its flush-count watermark, then the idle retry collapse.
        Compaction is a full checkpoint, so it waits for an idle flush
        (queues empty, pipeline drained) and runs in-line only past twice
        the bound; a degraded service never compacts (the save would
        write the same dead disk)."""
        if (self._wal is not None and not self._in_save
                and self._storage_degraded is None
                and self._wal.count >= self.wal_compact_records):
            idle = not self._active and not self._inflight
            if idle or self._wal.count >= 2 * self.wal_compact_records:
                self._compact_wal()
        if (self.scrub_every_flushes
                and self.flushes - self._scrubbed_at_flush
                >= self.scrub_every_flushes):
            self.scrub()
        self._fire_idle_retries()

    def _compact_wal(self) -> None:
        """Fold the WAL into a fresh checkpoint, timed
        (batched_host.py:5513-5530)."""
        t0 = time.perf_counter()
        self.save()
        dt = (time.perf_counter() - t0) * 1e3
        self.wal_compactions += 1
        self.wal_compaction_ms_last = dt
        self.wal_compaction_ms_total += dt

    def scrub(self) -> Dict[str, int]:
        """Full anti-entropy sweep (batched_host.py:3918-3961): verify
        every replica's tree, run the exchange over the ensembles holding
        damage, verify again, and report what was found and healed.
        Damage on a slot no read touches is invisible to the data path
        until a scrub.  Swept rows with residual damage stay off the
        read fast path; healed ones re-admit it.  If the exchange
        raises, the state is left as it was.  In-flight launches settle
        first."""
        self._drain_launches()
        self._scrubbed_at_flush = self.flushes
        node_bad, leaf_bad = self.engine.verify_trees(self.state)
        bad = (node_bad | leaf_bad).cpu().numpy()             # [E, M]
        found = int(bad.sum())
        if not found:
            return {"replicas_damaged": 0, "replicas_healed": 0,
                    "ensembles_swept": 0}
        run = bad.any(1)
        self.corruptions += found
        snapshot = self.state
        try:
            self.state, diverged, synced = self.engine.exchange_step(
                self.state, torch.from_numpy(run).to(self.device),
                self._up_device())
            node_bad2, leaf_bad2 = self.engine.verify_trees(self.state)
            still = (node_bad2 | leaf_bad2).cpu().numpy() & bad
        except BaseException:
            self.state = snapshot
            raise
        healed = found - int(still.sum())
        self.repairs += int(
            diverged.cpu().numpy()[synced.cpu().numpy()].sum())
        self._corrupt_rows = np.where(run, still.any(1), self._corrupt_rows)
        return {"replicas_damaged": found, "replicas_healed": healed,
                "ensembles_swept": int(run.sum())}

    def _safe_resolve(self, fut: Future, result: Any) -> None:
        """Resolve a client future, containing waiter exceptions so one
        client's callback cannot abort the resolve loop."""
        try:
            fut.resolve(result)
        except Exception:
            self.waiter_errors += 1
            log.exception("client future waiter raised")

    def _fail_entry(self, e: int, op) -> None:
        """Fail one queue entry (scalar op or batch)."""
        if isinstance(op, _PendingBatch):
            self._fail_batch(e, op)
        else:
            self._fail_op(e, op)

    def _fail_batch(self, e: int, op: _PendingBatch) -> None:
        if op.fut.done:
            return
        if op.kind in (eng.OP_PUT, eng.OP_CAS, eng.OP_RMW):
            for i in range(op.n):
                self._unnote_write(e, op.slot[i])
                if op.kind != eng.OP_RMW:
                    # an RMW entry's handle field is its int32 operand,
                    # not a payload handle
                    self._release_handle(op.handle[i])
                    if op.handle[i]:
                        self._unnote_handle_write(e, op.slot[i])
                if op.keys is not None:
                    self._queue_recycle(e, (op.keys[i], op.slot[i],
                                            op.gen[i]))
        op.accum.fill(op.fut, op.pos, ["failed"] * op.n,
                      self._safe_resolve)

    def _fail_op(self, e: int, op: _PendingOp) -> None:
        """Resolve one queued op as failed, releasing a put's payload
        and queueing its slot for recycling: a failed write that was
        the slot's last queued write may leave it holding nothing
        committed.  (An RMW's handle field is its operand — nothing to
        release; the recycle drain's committed-handle check covers the
        -1 inline sentinel.)"""
        if op.fut.done:
            return
        if op.kind in (eng.OP_PUT, eng.OP_CAS):
            self._release_handle(op.handle)
            if op.handle:
                self._unnote_handle_write(e, op.slot)
        if op.kind in (eng.OP_PUT, eng.OP_CAS, eng.OP_RMW):
            self._unnote_write(e, op.slot)
            if op.key is not None:
                self._queue_recycle(e, (op.key, op.slot, op.gen))
        self._safe_resolve(op.fut, "failed")

    def _resolve_batch(self, e: int, j: int, op: _PendingBatch,
                       planes, ack: bool,
                       native_mirrors: bool = False) -> None:
        """Resolve one batch entry from result-plane column slices.
        Every committed write updates the fast path's mirrors before
        its result is handed to the client; with ``native_mirrors`` the
        C++ pass already wrote this flush's ``_slot_vsn`` /
        ``_inline_value`` slabs, so only the Python-owned bookkeeping
        runs here.  ``ack=False`` (the WAL write failed) keeps the
        committed writes' bookkeeping but resolves them 'failed'."""
        committed, get_ok, found, value, vsn = planes
        n = op.n
        results: List[Any] = []
        append = results.append
        slot_handle = self.slot_handle[e]
        inline = self._inline_slots[e]
        inline_row = self._inline_np[e]
        inline_val_np = self._inline_value_np[e]
        inline_val_ok = self._inline_value_ok[e]
        vsn_row = self._slot_vsn_np[e]
        vsn_ok_row = self._slot_vsn_ok[e]
        if op.kind in (eng.OP_PUT, eng.OP_CAS):
            comm_l = committed[j:j + n, e].tolist()
            vs_l = vsn[j:j + n, e].tolist()
            keys = op.keys if op.keys is not None else [None] * n
            recycle = self._recycle_pending[e].append
            self._recycle_dirty.add(e)
            release = self._release_handle
            for comm, s, h, g, key, vs in zip(comm_l, op.slot, op.handle,
                                              op.gen, keys, vs_l):
                self._unnote_write(e, s)
                if h:
                    self._unnote_handle_write(e, s)
                if not comm:
                    release(h)
                    if key is not None:
                        recycle((key, s, g))
                    append("failed")
                    continue
                old = slot_handle.pop(s, 0)
                if old != h:
                    release(old)
                if h:
                    slot_handle[s] = h
                # a committed put/CAS flips a device-native slot back
                # to handle storage
                inline.discard(s)
                inline_row[s] = False
                if not native_mirrors:
                    inline_val_ok[s] = False
                    vsn_row[s] = vs
                    vsn_ok_row[s] = True
                append(("ok", tuple(vs)) if ack else "failed")
        elif op.kind == eng.OP_RMW:
            comm_l = committed[j:j + n, e].tolist()
            vs_l = vsn[j:j + n, e].tolist()
            val_l = value[j:j + n, e].tolist()
            release = self._release_handle
            recycle = self._recycle_pending[e].append
            self._recycle_dirty.add(e)
            keys = op.keys if op.keys is not None else [None] * n
            for comm, s, g, key, vs, v in zip(comm_l, op.slot, op.gen,
                                              keys, vs_l, val_l):
                self._unnote_write(e, s)
                if not comm:
                    if key is not None:
                        recycle((key, s, g))
                    append("failed")
                    continue
                old = slot_handle.pop(s, 0)
                if old > 0:
                    release(old)
                if v:  # live value; a computed 0 is the tombstone
                    slot_handle[s] = -1
                    if not native_mirrors:
                        inline_val_np[s] = v
                        inline_val_ok[s] = True
                else:
                    if not native_mirrors:
                        inline_val_ok[s] = False
                    if key is not None:  # tombstone: recycle the slot
                        recycle((key, s, g))
                inline.add(s)
                inline_row[s] = True
                if not native_mirrors:
                    vsn_row[s] = vs
                    vsn_ok_row[s] = True
                append(("ok", tuple(vs)) if ack else "failed")
        else:  # OP_GET batch
            ok_l = get_ok[j:j + n, e].tolist()
            found_l = found[j:j + n, e].tolist()
            val_l = value[j:j + n, e].tolist()
            vs_l = vsn[j:j + n, e].tolist()
            values = self.values
            for ok, fnd, v, vs, s in zip(ok_l, found_l, val_l, vs_l,
                                         op.slot):
                if ok:
                    if fnd and v != 0:
                        if s in inline:
                            # device-native slots carry the value
                            # itself; the read refreshes its mirror
                            out = v
                            if not native_mirrors:
                                inline_val_np[s] = v
                                inline_val_ok[s] = True
                        else:
                            out = values.get(v, NOTFOUND)
                    else:
                        out = NOTFOUND
                    if not native_mirrors:
                        vsn_row[s] = vs
                        vsn_ok_row[s] = True
                    append(("ok", out, tuple(vs)) if op.want_vsn
                           else ("ok", out))
                else:
                    append("failed")
        op.accum.fill(op.fut, op.pos, results, self._safe_resolve)

    # -- completion-slab resolve (the slab enqueue path) ---------------------

    def _resolve_taken_slab(self, taken, planes, lanes, ack: bool,
                            native_mirrors: bool) -> int:
        """Resolve every taken entry through the flush's COMPLETION SLAB
        (batched_host.py:6134-6229): each result plane is gathered through
        the flush's runs ONCE (``[R]`` records, R = taken rounds), the
        lanes become Python lists once, and each entry resolves from its
        row segment.  Exactly one wake per flush.  Results and mirror
        slabs equal the per-op loops'."""
        committed, get_ok, found, value, vsn = planes
        ent_col, ent_row0, ent_len, n_rows, offs = lanes
        k, e = committed.shape
        if self._native_enqueue is not None:
            got = self._native_enqueue.gather(
                k, e, ent_col, ent_row0, ent_len, _u8view(committed),
                _u8view(get_ok), _u8view(found),
                np.ascontiguousarray(value, np.int32),
                np.ascontiguousarray(vsn, np.int32), n_rows)
        else:
            got = enqueue_native.gather_plain(
                k, e, ent_col, ent_row0, ent_len, committed, get_ok, found,
                value, vsn, n_rows)
        ok_l, gok_l, fnd_l, val_l = (a.tolist() for a in got[:4])
        # (epoch, seq) as tuples of ints, not R two-int lists: the GC
        # untracks such tuples, while R live lists survive into the old
        # generation and bring its full collections sooner
        vs_l = list(zip(*got[4].T.tolist()))
        self.completion_wakes += 1
        self.completion_rows += n_rows
        served = 0
        ei = 0
        for e, ops in taken:
            for op in ops:
                off = offs[ei]
                ei += 1
                end = off + op.n
                if isinstance(op, _PendingBatch):
                    self._resolve_batch_slab(
                        e, op, ok_l[off:end], gok_l[off:end],
                        fnd_l[off:end], val_l[off:end], vs_l[off:end],
                        ack, native_mirrors, got, off)
                else:
                    self._resolve_scalar_slab(
                        e, op, ok_l[off], gok_l[off], fnd_l[off],
                        val_l[off], tuple(vs_l[off]), ack,
                        native_mirrors)
                served += op.n
        return served

    def _resolve_batch_slab(self, e: int, op: _PendingBatch, comm_l,
                            gok_l, fnd_l, val_l, vs_l, ack: bool,
                            native_mirrors: bool, np_lanes, off: int
                            ) -> None:
        """One batch entry from its completion-slab segment
        (batched_host.py:6230-6400): the slab form of
        :meth:`_resolve_batch`, with identical results and mirror slabs.
        The segments are plain-list slices; ``np_lanes`` (the gathered
        numpy lanes, the segment at ``off``) is read only when the
        Python writes the mirrors.  The mirrors are written before the
        accumulator fill, the first effect a client sees."""
        n = op.n
        results: List[Any] = []
        append = results.append
        comm_slots: List[int] = []
        if op.kind in (eng.OP_PUT, eng.OP_CAS):
            slot_l = op.slot
            handle_l = op.handle
            gen_l = op.gen
            keys = op.keys if op.keys is not None else [None] * n
            slot_handle = self.slot_handle[e]
            recycle = self._recycle_pending[e].append
            self._recycle_dirty.add(e)
            release = self._release_handle
            pw = self._pending_writes[e]
            qh = self._queued_handle_writes[e]
            for i, comm in enumerate(comm_l):
                h = handle_l[i]
                s = slot_l[i]
                # every op un-notes, committed or not, clamped at 0 as
                # in _unnote_write
                if pw[s] > 0:
                    pw[s] -= 1
                if h and qh[s] > 0:
                    qh[s] -= 1
                if not comm:
                    release(h)
                    if keys[i] is not None:
                        recycle((keys[i], s, gen_l[i]))
                    append("failed")
                    continue
                old = slot_handle.pop(s, 0)
                if old != h:
                    release(old)
                if h:
                    slot_handle[s] = h
                comm_slots.append(s)
                append(("ok", tuple(vs_l[i])) if ack else "failed")
            if comm_slots:
                # committed writes flip their slots to handle storage;
                # the vsn mirror scatters in round order (numpy keeps the
                # last of duplicate slots, the one committed last)
                self._inline_slots[e].difference_update(comm_slots)
                self._inline_np[e, comm_slots] = False
                if not native_mirrors:
                    ok_a, _g, _f, _v, vsn_a = np_lanes
                    okm = ok_a[off:off + n]
                    self._inline_value_ok[e, comm_slots] = False
                    self._slot_vsn_np[e, comm_slots] = \
                        vsn_a[off:off + n][okm]
                    self._slot_vsn_ok[e, comm_slots] = True
        elif op.kind == eng.OP_RMW:
            slot_l = op.slot
            gen_l = op.gen
            keys = op.keys if op.keys is not None else [None] * n
            slot_handle = self.slot_handle[e]
            release = self._release_handle
            recycle = self._recycle_pending[e].append
            self._recycle_dirty.add(e)
            pw = self._pending_writes[e]
            for i, comm in enumerate(comm_l):
                s = slot_l[i]
                if pw[s] > 0:  # clamped, like _unnote_write
                    pw[s] -= 1
                if not comm:
                    if keys[i] is not None:
                        recycle((keys[i], s, gen_l[i]))
                    append("failed")
                    continue
                old = slot_handle.pop(s, 0)
                if old > 0:  # superseded host payload (-1 stays put)
                    release(old)
                if val_l[i]:  # live value; a computed 0 = tombstone
                    slot_handle[s] = -1
                elif keys[i] is not None:
                    recycle((keys[i], s, gen_l[i]))
                comm_slots.append(s)
                append(("ok", tuple(vs_l[i])) if ack else "failed")
            if comm_slots:
                self._inline_slots[e].update(comm_slots)
                self._inline_np[e, comm_slots] = True
                if not native_mirrors:
                    ok_a, _g, _f, val_a, vsn_a = np_lanes
                    okm = ok_a[off:off + n]
                    cvals = val_a[off:off + n][okm]
                    cvs = vsn_a[off:off + n][okm]
                    if len(set(comm_slots)) != len(comm_slots):
                        # duplicate slots: live / tombstone interleavings
                        # are round-ordered, so walk them in order
                        for s, v, vv in zip(comm_slots, cvals.tolist(),
                                            cvs.tolist()):
                            if v:
                                self._inline_value_np[e, s] = v
                            self._inline_value_ok[e, s] = bool(v)
                            self._slot_vsn_np[e, s] = vv
                            self._slot_vsn_ok[e, s] = True
                    else:
                        csl = np.asarray(comm_slots, np.int32)
                        live = cvals != 0
                        lsl = csl[live]
                        if lsl.size:
                            self._inline_value_np[e, lsl] = cvals[live]
                            self._inline_value_ok[e, lsl] = True
                        self._inline_value_ok[e, csl[~live]] = False
                        self._slot_vsn_np[e, csl] = cvs
                        self._slot_vsn_ok[e, csl] = True
        else:  # OP_GET segment
            want_vsn = op.want_vsn
            slot_l = op.slot
            inline = self._inline_slots[e]
            values = self.values
            served_slots: List[int] = []
            for i, okv in enumerate(gok_l):
                if not okv:
                    append("failed")
                    continue
                v = val_l[i]
                if fnd_l[i] and v != 0:
                    out = v if slot_l[i] in inline \
                        else values.get(v, NOTFOUND)
                else:
                    out = NOTFOUND
                served_slots.append(slot_l[i])
                append(("ok", out, tuple(vs_l[i])) if want_vsn
                       else ("ok", out))
            if not native_mirrors and served_slots:
                # served reads refresh the vsn mirror, reads of live
                # inline slots the inline one (no write interleaves
                # inside one entry's rounds, so scatter order is moot)
                _o, gok_a, fnd_a, val_a, vsn_a = np_lanes
                okm = gok_a[off:off + n]
                self._slot_vsn_np[e, served_slots] = \
                    vsn_a[off:off + n][okm]
                self._slot_vsn_ok[e, served_slots] = True
                sl_a = np.asarray(slot_l, np.intp)
                refr = okm & fnd_a[off:off + n] \
                    & (val_a[off:off + n] != 0) \
                    & self._inline_np[e, sl_a]
                if refr.any():
                    rsl = sl_a[refr]
                    self._inline_value_np[e, rsl] = \
                        val_a[off:off + n][refr]
                    self._inline_value_ok[e, rsl] = True
        op.accum.fill(op.fut, op.pos, results, self._safe_resolve)

    def _resolve_scalar_slab(self, e: int, op: _PendingOp, comm: bool,
                             gok: bool, fnd: bool, v: int, vs, ack: bool,
                             native_mirrors: bool) -> None:
        """One scalar op from its completion-slab row
        (batched_host.py:6406-6481): the per-op loop's logic on the
        gathered row alone."""
        slot_handle = self.slot_handle[e]
        s = op.slot
        if op.kind in (eng.OP_PUT, eng.OP_CAS, eng.OP_RMW) and not comm:
            self._fail_op(e, op)
        elif op.kind in (eng.OP_PUT, eng.OP_CAS):
            self._unnote_write(e, s)
            if op.handle:
                self._unnote_handle_write(e, s)
            old = slot_handle.pop(s, 0)
            if old != op.handle:
                self._release_handle(old)
            if op.handle:
                slot_handle[s] = op.handle
            self._inline_slots[e].discard(s)
            self._inline_np[e, s] = False
            if not native_mirrors:
                self._inline_value_ok[e, s] = False
                self._slot_vsn_np[e, s] = vs
                self._slot_vsn_ok[e, s] = True
            self._safe_resolve(op.fut, ("ok", vs) if ack else "failed")
        elif op.kind == eng.OP_RMW:
            self._unnote_write(e, s)
            old = slot_handle.pop(s, 0)
            if old > 0:
                self._release_handle(old)
            if v:
                slot_handle[s] = -1
            elif op.key is not None:
                self._queue_recycle(e, (op.key, s, op.gen))
            self._inline_slots[e].add(s)
            self._inline_np[e, s] = True
            if not native_mirrors:
                if v:
                    self._inline_value_np[e, s] = v
                self._inline_value_ok[e, s] = bool(v)
                self._slot_vsn_np[e, s] = vs
                self._slot_vsn_ok[e, s] = True
            self._safe_resolve(op.fut, ("ok", vs) if ack else "failed")
        elif gok:  # OP_GET
            if fnd and v != 0:
                if s in self._inline_slots[e]:
                    out = v
                    if not native_mirrors:
                        self._inline_value_np[e, s] = v
                        self._inline_value_ok[e, s] = True
                else:
                    out = self.values.get(v, NOTFOUND)
            else:
                out = NOTFOUND
            if not native_mirrors:
                self._slot_vsn_np[e, s] = vs
                self._slot_vsn_ok[e, s] = True
            self._safe_resolve(op.fut, ("ok", out, vs) if op.want_vsn
                               else ("ok", out))
        else:
            self._fail_op(e, op)

    def _resolve_flush(self, fl: _InFlightLaunch, planes,
                       ack: bool = True) -> int:
        """Resolve every op ``fl`` took from the result planes, in device
        round order per ensemble (batched_host.py:6484-6720).

        With the C++ resolve, one pass over the launch's own host kind
        and slot planes scatters every committed mirror update
        (``_slot_vsn`` / ``_inline_value`` slabs, read refreshes) in the
        loops' per-column round order, and the loops below skip their
        mirror writes.  When the flush has a pending-slab record
        (``fl.lanes``), resolution runs through the completion slab
        (:meth:`_resolve_taken_slab`) instead of the per-op loops, the
        reference's oracle arm, with identical results and slabs.
        ``ack=False`` (the WAL write failed, or the service is read-only)
        resolves committed writes 'failed' with their bookkeeping kept;
        reads still serve (batched_host.py:6484-6500)."""
        taken, lanes = fl.taken or [], fl.lanes
        committed, get_ok, found, value, vsn = planes
        if committed is None:  # k == 0: election-only launch, no ops
            assert not taken, "ops taken but no result planes"
            self._drain_recycles()
            return 0
        native_mirrors = False
        if self._native_resolve is not None and taken:
            cols = np.fromiter((e for e, _ops in taken), np.int32,
                               len(taken))
            kcounts = np.fromiter((sum(op.n for op in ops)
                                   for _e, ops in taken), np.int32,
                                  len(taken))
            # reads always ack here: no replication group withholds them
            self._native_resolve.scatter_mirrors(
                self.n_ens, self.n_slots, fl.kind_np, fl.op_slot_np,
                committed, get_ok, found, value, vsn, cols, kcounts, True,
                (eng.OP_PUT, eng.OP_CAS, eng.OP_GET, eng.OP_RMW),
                self._slot_vsn_np, self._slot_vsn_ok,
                self._inline_value_np, self._inline_value_ok,
                self._inline_np)
            native_mirrors = True
        if lanes is not None and taken:
            served = self._resolve_taken_slab(taken, planes, lanes, ack,
                                              native_mirrors)
            self.ops_served += served
            self._drain_recycles()
            return served
        # one bulk conversion to Python lists, only if a scalar op needs
        # per-op cells
        committed_l = get_ok_l = found_l = value_l = vsn_l = None
        if any(not isinstance(op, _PendingBatch)
               for _e, ops in taken for op in ops):
            committed_l = committed.tolist()
            get_ok_l = get_ok.tolist()
            found_l = found.tolist()
            value_l = value.tolist()
            vsn_l = vsn.tolist()
        served = 0
        for e, ops in taken:
            slot_handle = self.slot_handle[e]
            j = -1
            for op in ops:
                if isinstance(op, _PendingBatch):
                    self._resolve_batch(e, j + 1, op, planes, ack,
                                        native_mirrors)
                    served += op.n
                    j += op.n
                    continue
                j += 1
                served += 1
                s = op.slot
                if op.kind in (eng.OP_PUT, eng.OP_CAS):
                    if committed_l[j][e]:
                        self._unnote_write(e, s)
                        if op.handle:
                            self._unnote_handle_write(e, s)
                        # Release the payload this write superseded
                        # (rounds resolve in device order, so the last
                        # committed handle per slot survives).
                        old = slot_handle.pop(s, 0)
                        if old != op.handle:
                            self._release_handle(old)
                        if op.handle:
                            slot_handle[s] = op.handle
                        # a committed put/CAS flips a device-native
                        # slot back to handle storage
                        self._inline_slots[e].discard(s)
                        self._inline_np[e, s] = False
                        # mirror before the ack: a fast read issued
                        # after this future resolves sees the write
                        if not native_mirrors:
                            self._inline_value_ok[e, s] = False
                            self._slot_vsn_np[e, s] = vsn_l[j][e]
                            self._slot_vsn_ok[e, s] = True
                        self._safe_resolve(op.fut,
                                           ("ok", tuple(vsn_l[j][e]))
                                           if ack else "failed")
                    else:
                        self._fail_op(e, op)
                elif op.kind == eng.OP_RMW:
                    if committed_l[j][e]:
                        self._unnote_write(e, s)
                        old = slot_handle.pop(s, 0)
                        if old > 0:  # superseded host payload
                            self._release_handle(old)
                        # the -1 sentinel: a LIVE value committed
                        # device-side.  A computed 0 is the tombstone:
                        # no sentinel, and the slot recycles like a
                        # committed delete.
                        v = value_l[j][e]
                        if v:
                            slot_handle[s] = -1
                        elif op.key is not None:
                            self._queue_recycle(e, (op.key, s, op.gen))
                        if not native_mirrors:
                            if v:
                                self._inline_value_np[e, s] = v
                            self._inline_value_ok[e, s] = bool(v)
                            self._slot_vsn_np[e, s] = vsn_l[j][e]
                            self._slot_vsn_ok[e, s] = True
                        self._inline_slots[e].add(s)
                        self._inline_np[e, s] = True
                        self._safe_resolve(op.fut,
                                           ("ok", tuple(vsn_l[j][e]))
                                           if ack else "failed")
                    else:
                        self._fail_op(e, op)
                elif get_ok_l[j][e]:
                    v = value_l[j][e]
                    if found_l[j][e] and v != 0:
                        if s in self._inline_slots[e]:
                            # device-native slots carry the value itself
                            out = v
                            if not native_mirrors:
                                self._inline_value_np[e, s] = v
                                self._inline_value_ok[e, s] = True
                        else:
                            out = self.values.get(v, NOTFOUND)
                    else:
                        out = NOTFOUND
                    # vsn is the object's — a tombstone's real version
                    # rides along with NOTFOUND, so CAS chains work; the
                    # device read also refreshes the vsn mirror
                    if not native_mirrors:
                        self._slot_vsn_np[e, s] = vsn_l[j][e]
                        self._slot_vsn_ok[e, s] = True
                    self._safe_resolve(
                        op.fut, ("ok", out, tuple(vsn_l[j][e]))
                        if op.want_vsn else ("ok", out))
                else:
                    self._fail_op(e, op)
        self.ops_served += served
        self._drain_recycles()
        return served

    # -- durability: the WAL barrier, checkpoints, restore -------------------

    def _log_wal(self, taken, planes) -> None:
        """Append this flush's committed client writes to the WAL,
        latest record per (ensemble, slot); called BEFORE any future
        resolves (batched_host.py:5764-5832).  Records:
        ``("kv", e, slot) -> (key, handle, epoch, seq, payload, False)``
        for a put / CAS (payload None for a tombstone), and
        ``(key, computed value, epoch, seq, None, True)`` for an RMW.

        The native arm encodes batch-only flushes whose keys and payloads
        fit the C++ pickler's subset in one pass
        (:meth:`_log_wal_native`); the store contents are byte-identical
        to this Python walk, which logs everything else."""
        committed, _get_ok, _found, value, vsn = planes
        if committed is None:
            return
        if (self._native_resolve is not None and vsn is not None
                and self._log_wal_native(taken, planes)):
            return
        committed_l = committed.tolist()
        vsn_l = vsn.tolist()
        puts = (eng.OP_PUT, eng.OP_CAS)
        recs = []
        for e, ops in taken:
            j = -1
            for op in ops:
                if isinstance(op, _PendingBatch):
                    if op.kind in puts:
                        comm = committed[j + 1:j + 1 + op.n, e]
                        vs2 = vsn[j + 1:j + 1 + op.n, e]
                        for i in np.nonzero(comm)[0]:
                            h = int(op.handle[i])
                            recs.append((
                                ("kv", e, int(op.slot[i])),
                                (op.keys[i], h, int(vs2[i, 0]),
                                 int(vs2[i, 1]),
                                 self.values.get(h) if h else None,
                                 False)))
                    elif op.kind == eng.OP_RMW:
                        # the committed COMPUTED value rides the handle
                        # field of a keyed inline record
                        comm = committed[j + 1:j + 1 + op.n, e]
                        vs2 = vsn[j + 1:j + 1 + op.n, e]
                        vv = value[j + 1:j + 1 + op.n, e]
                        for i in np.nonzero(comm)[0]:
                            recs.append((
                                ("kv", e, int(op.slot[i])),
                                (op.keys[i], int(vv[i]),
                                 int(vs2[i, 0]), int(vs2[i, 1]),
                                 None, True)))
                    j += op.n
                    continue
                j += 1
                if op.kind in puts and committed_l[j][e]:
                    payload = (self.values.get(op.handle)
                               if op.handle else None)
                    ve, vs = vsn_l[j][e]
                    recs.append((("kv", e, op.slot),
                                 (op.key, op.handle, ve, vs, payload,
                                  False)))
                elif op.kind == eng.OP_RMW and committed_l[j][e]:
                    ve, vs = vsn_l[j][e]
                    recs.append((("kv", e, op.slot),
                                 (op.key, int(value[j, e]), ve, vs,
                                  None, True)))
        if recs:
            self._wal.log(recs)

    def _log_wal_native(self, taken, planes) -> bool:
        """The single-pass WAL encode (batched_host.py:5834-5930): gather
        the flush's write lanes and joined key / payload arenas, pickle
        every record in one C++ pass (:meth:`.resolve_native.
        NativeResolve.wal_encode`) and append the arena verbatim
        (:meth:`.wal.ServiceWAL.log_arena`).  Returns False when a lane
        lies outside the pass's subset — a scalar write, a key that is
        not a str, a payload that is neither bytes nor None, a non-ASCII
        key, or a record of 64 KiB or more — and the caller's Python walk
        then logs EVERY record, so the order within the flush holds."""
        committed, _get_ok, _found, value, vsn = planes
        lane_j: List[int] = []
        lane_e: List[int] = []
        lane_slot: List[int] = []
        lane_f2: List[int] = []
        lane_inl: List[int] = []
        keys: List[str] = []
        pays: List[Any] = []
        values = self.values
        for e, ops in taken:
            j = -1
            for op in ops:
                if not isinstance(op, _PendingBatch):
                    j += 1
                    if op.kind != eng.OP_GET:
                        # scalar write lanes interleave with batch
                        # records on the same (ens, slot): only the
                        # Python walk keeps that order
                        return False
                    continue
                if op.kind in (eng.OP_PUT, eng.OP_CAS, eng.OP_RMW):
                    ks = op.keys
                    if ks is None or not all(type(kk) is str for kk in ks):
                        return False
                    if op.kind == eng.OP_RMW:
                        pays.extend([None] * op.n)
                        lane_f2.extend([0] * op.n)
                        lane_inl.extend([1] * op.n)
                    else:
                        for h in op.handle:
                            p = values.get(h) if h else None
                            if p is not None and type(p) is not bytes:
                                return False
                            pays.append(p)
                        lane_f2.extend(op.handle)
                        lane_inl.extend([0] * op.n)
                    keys.extend(ks)
                    lane_j.extend(range(j + 1, j + 1 + op.n))
                    lane_e.extend([e] * op.n)
                    lane_slot.extend(op.slot)
                j += op.n
        if not lane_j:
            return True  # a read-only flush: nothing to log
        joined = "".join(keys)
        key_arena = joined.encode("utf-8")
        if len(key_arena) != len(joined):
            return False  # non-ASCII keys: char lengths != byte lengths
        n = len(lane_j)
        key_len = np.fromiter(map(len, keys), np.int64, n)
        key_off = np.zeros((n,), np.int64)
        np.cumsum(key_len[:-1], out=key_off[1:])
        pay_len = np.fromiter(
            (-1 if p is None else len(p) for p in pays), np.int64, n)
        if int((key_len + np.maximum(pay_len, 0)).max()) >= 65500:
            # CPython's pickler splits frames once a record's body
            # reaches its 64 KiB frame target; the pass writes one frame
            # per record, so such records take the Python walk
            return False
        pay_arena = b"".join(p for p in pays if p is not None)
        pay_off = np.zeros((n,), np.int64)
        np.cumsum(np.maximum(pay_len, 0)[:-1], out=pay_off[1:])
        out = self._native_resolve.wal_encode(
            self.n_ens, np.asarray(lane_j, np.int32),
            np.asarray(lane_e, np.int32), np.asarray(lane_slot, np.int32),
            np.asarray(lane_f2, np.int32), np.asarray(lane_inl, np.uint8),
            np.zeros((n,), np.uint8), key_off, key_len, key_arena,
            pay_off, pay_len, pay_arena, committed, value, vsn)
        if out is None:
            return False
        arena, idx = out
        idx = idx[idx[:, 1] > 0]  # drop uncommitted lanes
        if len(idx):
            self._wal.log_arena(arena, idx)
        return True

    def _log_execute_wal(self, kind, slot, val, committed, vsn,
                         value) -> None:
        """WAL records of a host-array bulk call's committed writes
        (batched_host.py:5070-5088): keyless inline records
        ``("kv", e, slot) -> (None, value, epoch, seq, None, True)`` in
        row-major round order; an RMW row logs the value it COMPUTED."""
        wmask = (((kind == eng.OP_PUT) | (kind == eng.OP_CAS)
                  | (kind == eng.OP_RMW)) & committed)
        js, es = np.nonzero(wmask)
        if not js.size:
            return
        wval = np.where(kind == eng.OP_RMW, value, val)
        cols = (es.tolist(), slot[js, es].tolist(), wval[js, es].tolist(),
                vsn[js, es, 0].tolist(), vsn[js, es, 1].tolist())
        self._wal.log([(("kv", e, s), (None, v, ve, vs, None, True))
                       for e, s, v, ve, vs in zip(*cols)])

    def save(self, path: Optional[str] = None) -> None:
        """Checkpoint the whole service (batched_host.py:2741-2833): the
        engine state (:func:`..ops.checkpoint.save_state`, the port's own
        format) and the host mirrors (key → slot maps, payload store,
        leaders) as one 4-copy CRC blob, under a fresh ``ckpt.<n>``
        directory; then the CRC-protected ``CURRENT`` pointer flips to
        ``n``, older checkpoints are pruned and, for the service's own
        ``data_dir``, the WAL rotates to generation ``n``.  A crash at
        any point leaves the previous checkpoint restorable.

        Queued ops are flushed and in-flight launches settled first, so
        the saved mirrors carry no half-applied effects.  Leases are
        never persisted.  On CUDA the state moves to the host plane by
        plane."""
        if path is None:
            path = self.data_dir
        if path is None:
            raise ValueError("save() needs a path or a data_dir")
        self._in_save = True
        try:
            while self._active:
                self.flush()
            self._drain_launches()
        finally:
            self._in_save = False
        os.makedirs(path, exist_ok=True)
        n = self._current_ckpt(path) + 1
        d = os.path.join(path, f"ckpt.{n}")
        checkpoint.save_state(d, self.state)
        host = {
            "shape": (self.n_ens, self.n_peers, self.n_slots),
            "key_slot": self.key_slot,
            "free_slots": self.free_slots,
            "slot_gen": self.slot_gen,
            "slot_handle": self.slot_handle,
            "inline_slots": [sorted(s) for s in self._inline_slots],
            "recycle_pending": self._recycle_pending,
            "values": self.values,
            "free_handles": self._free_handles,
            "next_handle": self._next_handle,
            "leader": self.leader_np,
            "member": self.member_np,
            "up": self.up,
            "dynamic": False,
        }
        savelib.write(os.path.join(d, "host"),
                      pickle.dumps(host, protocol=4), crash_class="ckpt")
        # the new ckpt.<n> directory's entry must be durable before
        # CURRENT names it
        savelib.fsync_dir(path)
        savelib.write(os.path.join(path, "CURRENT"), str(n).encode(),
                      crash_class="ckpt")
        for name in os.listdir(path):
            if name.startswith("ckpt.") and name != f"ckpt.{n}":
                shutil.rmtree(os.path.join(path, name), ignore_errors=True)
        # checkpoint n subsumes every WAL record; a crash between the
        # CURRENT flip and this rotation leaves stale wal.<n-1> dirs
        # that restore ignores and the next rotation removes
        if self._wal is not None and path == self.data_dir:
            self._wal = ServiceWAL.rotate(self.data_dir, n, self._wal,
                                          self.wal_sync)

    @staticmethod
    def _current_ckpt(path: str) -> int:
        raw = savelib.read(os.path.join(path, "CURRENT"))
        try:
            return int(raw.decode()) if raw else 0
        except ValueError:
            return 0

    @classmethod
    def restore(cls, runtime: Any, path: str, **kw
                ) -> "BatchedEnsembleService":
        """Bring a service back from :meth:`save` (batched_host.py:
        2845-2932); ``kw`` are constructor arguments (``device``: CUDA
        unless ``"cpu"``, as for every entry point).  Every write acked
        after the latest checkpoint replays from its WAL generation — or,
        with no checkpoint at all, from ``META`` and WAL generation 0,
        which is also how a data dir the JAX package wrote restores here
        (checkpoints do not cross: the formats differ).  Pass
        ``data_dir=path`` to keep logging.  Leases start expired."""
        n = cls._current_ckpt(path)
        d = os.path.join(path, f"ckpt.{n}")
        raw = savelib.read(os.path.join(d, "host"))
        if raw is None:
            meta_raw = savelib.read(os.path.join(path, "META"))
            if meta_raw is None:
                raise FileNotFoundError(f"no service checkpoint at {path}")
            meta = pickle.loads(meta_raw)
            _refuse_dynamic(meta, path)
            svc = cls(runtime, *meta["shape"], **kw)
            svc._replay_wal_from(path, 0)
            return svc
        host = pickle.loads(raw)
        _refuse_dynamic(host, path)
        n_ens, n_peers, n_slots = host["shape"]
        svc = cls(runtime, n_ens, n_peers, n_slots, **kw)
        svc.state = checkpoint.load_state(d, svc.device)
        svc.key_slot = host["key_slot"]
        svc.free_slots = host["free_slots"]
        svc.slot_gen = host["slot_gen"]
        svc.slot_handle = host["slot_handle"]
        svc._inline_slots = [set(s) for s in host["inline_slots"]]
        for row, slots_ in enumerate(svc._inline_slots):
            if slots_:
                svc._inline_np[row, list(slots_)] = True
        svc._recycle_pending = host["recycle_pending"]
        # restored pending recycles re-enter the dirty set, or the
        # sparse drain would never revisit them
        svc._recycle_dirty = {e for e, p in
                              enumerate(svc._recycle_pending) if p}
        svc.values = host["values"]
        svc._free_handles = host["free_handles"]
        svc._next_handle = host["next_handle"]
        svc.leader_np = np.asarray(host["leader"])
        svc.member_np = np.asarray(host["member"])
        svc.up = np.asarray(host["up"])
        svc._up_dev = None
        svc._replay_wal_from(path, n)
        return svc

    def _replay_wal_from(self, path: str, gen: int) -> None:
        """Replay WAL generation ``gen`` under ``path`` if it exists,
        through this service's own handle when it logs to the same
        generation."""
        gen_path = ServiceWAL.gen_path(path, gen)
        if not os.path.isdir(gen_path):
            return
        own = self._wal is not None and self._wal.dir_path == gen_path
        wal = self._wal if own else ServiceWAL.open_gen(
            path, gen, native=self._wal_native)
        try:
            self._replay_wal(wal)
        finally:
            if not own:
                wal.close()

    def _replay_wal(self, wal: ServiceWAL) -> None:
        """Install every WAL record into the state and host mirrors
        (batched_host.py:2965-3100).  Objects land on every replica at
        their committed (epoch, seq); ballot epochs rise to at least the
        newest installed object epoch, so the restart's elections propose
        higher; every replica's tree rebuilds over its store; the fast
        read mirrors (``_slot_vsn``, the inline mirrors) are set from the
        replayed records, and leaders and leases are cleared."""
        recs = wal.records()
        if not recs:
            return
        e_, m_, s_ = self.n_ens, self.n_peers, self.n_slots
        obj_epoch = self.state.obj_epoch.cpu().numpy().copy()
        obj_seq = self.state.obj_seq.cpu().numpy().copy()
        obj_val = self.state.obj_val.cpu().numpy().copy()
        epoch = self.state.epoch.cpu().numpy().copy()
        #: ens -> slot -> replayed owner key (None: tombstoned or bulk);
        #: checkpoint-era mappings that disagree are dropped below
        owners: Dict[int, Dict[int, Any]] = {}
        for key, value in recs:
            if key[0] == "mem":
                raise NotImplementedError(
                    "the WAL holds membership records; membership is not "
                    "ported yet (ROADMAP Queue 1 item 6)")
            _, ens, slot = key
            key_obj, handle, oe, os_, payload, inline = value
            obj_epoch[ens, :, slot] = oe
            obj_seq[ens, :, slot] = os_
            obj_val[ens, :, slot] = handle
            if inline:
                # the int32 value IS the payload.  A key with a live
                # value is a device-native slot (a committed RMW); a
                # keyed inline tombstone replays like a delete; keyless
                # records are bulk-array writes
                if key_obj is not None and handle:
                    self._inline_slots[ens].add(slot)
                    self._inline_np[ens, slot] = True
                    self._inline_value_np[ens, slot] = handle
                    self._inline_value_ok[ens, slot] = True
                    self._slot_vsn_np[ens, slot] = (oe, os_)
                    self._slot_vsn_ok[ens, slot] = True
                    self.slot_handle[ens][slot] = -1
                    self.key_slot[ens][key_obj] = slot
                    owners.setdefault(ens, {})[slot] = key_obj
                else:
                    if key_obj is not None:
                        self._inline_slots[ens].discard(slot)
                        self._inline_np[ens, slot] = False
                        self._inline_value_ok[ens, slot] = False
                        self.slot_handle[ens].pop(slot, None)
                    owners.setdefault(ens, {})[slot] = None
                continue
            self._inline_slots[ens].discard(slot)
            self._inline_np[ens, slot] = False
            self._inline_value_ok[ens, slot] = False
            self._slot_vsn_np[ens, slot] = (oe, os_)
            self._slot_vsn_ok[ens, slot] = True
            if handle:
                self.values[handle] = payload
                self._next_handle = max(self._next_handle, handle + 1)
                self.slot_handle[ens][slot] = handle
                if key_obj is not None:
                    self.key_slot[ens][key_obj] = slot
                owners.setdefault(ens, {})[slot] = key_obj
            else:
                self.slot_handle[ens].pop(slot, None)
                owners.setdefault(ens, {})[slot] = None
        for ens, owner in owners.items():
            ks = self.key_slot[ens]
            for k in [k for k, s in ks.items()
                      if s in owner and owner[s] != k]:
                del ks[k]
        for ens in range(e_):
            used = set(self.key_slot[ens].values())
            self.free_slots[ens] = [s for s in range(s_) if s not in used]
        epoch = np.maximum(epoch, obj_epoch.max(-1))
        dev = self.device
        state = self.state._replace(
            epoch=torch.from_numpy(epoch).to(dev),
            obj_epoch=torch.from_numpy(obj_epoch).to(dev),
            obj_seq=torch.from_numpy(obj_seq).to(dev),
            obj_val=torch.from_numpy(obj_val).to(dev))
        self.state = self.engine.rebuild_trees(
            state, torch.ones((e_, m_), dtype=torch.bool, device=dev))
        self._up_dev = None
        self.leader_np = np.full((e_,), -1, dtype=np.int32)
        self.lease_until[:] = 0.0
