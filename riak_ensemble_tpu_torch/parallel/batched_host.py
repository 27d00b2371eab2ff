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
(:func:`engine.exchange_step`, one launch of kernel X1 on CUDA, which
steps the flagged rows in place) when it settles, and
:meth:`BatchedEnsembleService.scrub` sweeps every replica's tree, on
demand or every ``scrub_every_flushes`` flushes, keeping the swept rows'
planes until its exchange has gone through.

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

The timer: with ``tick`` (the reference's default 0.005 s) the service
flushes itself on its runtime's clock — every ``tick`` seconds, and on
the next runtime turn once a queue reaches a full launch's depth (the
burst trigger); ``tick=None`` leaves every flush to the caller, the only
mode :class:`WallRuntime` supports.  Leader watchers
(:meth:`BatchedEnsembleService.watch_leader`) hear every leader change a
launch or a membership change makes.

Membership: :meth:`BatchedEnsembleService.update_members` changes views
by joint consensus in two reconfig launches of their own
(:func:`engine.reconfig_step`, one launch of kernel R1 on CUDA), and with
``dynamic=True`` rows are created, destroyed and recycled under names
(:meth:`BatchedEnsembleService.create_ensemble`).  Both reach the WAL as
``("mem", row)`` records.

The observability plane (:mod:`..obs`) is on by default, as the
reference's is: every launch carries a latency record
(:attr:`BatchedEnsembleService.lat_records`,
:meth:`BatchedEnsembleService.latency_breakdown`), a flush id, spans and
a flight-recorder entry; every op an SLO stamp; every row a tenant
ledger; and the service answers :meth:`BatchedEnsembleService.stats`,
:meth:`~BatchedEnsembleService.health` and its metrics registry
(``obs_registry``).  ``RETPU_OBS=0`` (read at construction) records
none of it.  The runtime controller (``controller``) observes only,
unless ``RETPU_AUTOTUNE=1`` or :meth:`~BatchedEnsembleService.set_autotune`
arms it.  Trace events go to ``runtime.trace`` when one is installed
(:class:`..utils.trace.Tracer`).

Wide rounds (``wide=True``, the reference's ``RETPU_WIDE=1``): a flush
whose host op planes schedule into at most two conflict-free wide rounds
(:mod:`..ops.schedule`) launches ``full_step_wide`` (F1's wide mode on
CUDA) and its results route back to op order at settle;
``validate_wide=True`` (``RETPU_VALIDATE_WIDE=1``) checks each plan's
precondition on the host.  Sharded host passes (``resolve_shards=N``,
``RETPU_RESOLVE_SHARDS``): the pending-slab pack, the completion-slab
gather and the mirror scatter split over N threads, state-identical to
one.

The service reads the obs knobs (``RETPU_OBS``, ``RETPU_SLO_RING``,
``RETPU_OBS_DUMP_DIR``, ``RETPU_AUTOTUNE``, ...) and the fault knobs of
:mod:`..faults`, and no other environment variable: the reference's
``RETPU_FAST_READS`` is :meth:`BatchedEnsembleService.set_fast_reads`, its
``RETPU_COMM_REPL`` the ``comm_repl`` argument, its ``RETPU_COMPACT`` the
``compact`` argument, and ``RETPU_WIDE``, ``RETPU_VALIDATE_WIDE`` and
``RETPU_RESOLVE_SHARDS`` the ``wide``, ``validate_wide`` and
``resolve_shards`` arguments.

Over a mesh (``engine=`` a :class:`..parallel.mesh.ShardedEngine`,
batched_host.py:160-302, 431-486): the service keeps its tensors on the
mesh's first device and the steps keep the full grid (a mesh defines no
sliced step).  With an unsharded peer axis and more than one ens shard
the pack runs PER ENS SHARD on that shard's device and each shard's
packed bytes copy straight into their slice of one host buffer, in shard
order, with no cross-device gather (:func:`mesh_ens_shards`); compaction
there buckets each shard's LOCAL active columns at the busiest shard's
pow2 width (:func:`..ops.schedule.shard_active_columns`), and the settle
unpacks block by block in Python (:func:`unpack_results_sharded`; the
native unpack walks one block).  With a sharded peer axis the results
gather to the first device and pack once.  Whatever reads the state's
planes on the host goes through ``engine.gather_state``, and whatever
writes a whole state goes through ``engine.shard_state``.
"""

from __future__ import annotations

import contextlib
import errno
import functools
import operator
import os
import pickle
import random
import shutil
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from riak_ensemble_tpu_torch import faults, funref, obs
from riak_ensemble_tpu_torch import save as savelib
from riak_ensemble_tpu_torch.config import Config
from riak_ensemble_tpu_torch.device import DeviceLike, resolve_device
from riak_ensemble_tpu_torch.ops import build, checkpoint
from riak_ensemble_tpu_torch.ops import engine as eng
from riak_ensemble_tpu_torch.ops import hash as hashk
from riak_ensemble_tpu_torch.ops import schedule
from riak_ensemble_tpu_torch.parallel import enqueue_native, resolve_native
from riak_ensemble_tpu_torch.parallel.wal import ServiceWAL
from riak_ensemble_tpu_torch.parallel.resolve_native import unpack_results
from riak_ensemble_tpu_torch.runtime import Future, Timer
from riak_ensemble_tpu_torch.types import NOTFOUND

#: latency-record fields excluded from every ``total`` sum so the
#: breakdown stays additive (batched_host.py:100-107): the metadata
#: fields plus the flight recorder's derived marks ('enqueue' and the
#: per-arm resolve / enqueue attribution)
DERIVED_MARKS = ("k", "total") + obs.flightrec.DERIVED_MARKS

#: per-entry field extractor for the per-op SLO fold
_OP_SLO_FIELDS = operator.attrgetter("kind", "n", "t_sub", "t_enq")


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


def _wide_to_packed_layout(res: eng.KvResult, g: int, w: int,
                           e: int) -> eng.KvResult:
    """A wide ``[G, E, W]`` result in the packed ``[G*W, E]`` layout,
    lane-major per group (batched_host.py:305-319), so the pack and the
    unpacks serve both step flavours; the settle routes rows back to op
    order through the plan's ``map_g * W + map_w``."""
    def t(x):
        return x.transpose(1, 2).reshape(g * w, e)
    return res._replace(
        committed=t(res.committed), get_ok=t(res.get_ok),
        found=t(res.found), value=t(res.value),
        obj_vsn=res.obj_vsn.transpose(1, 2).reshape(g * w, e, 2),
        quorum_ok=t(res.quorum_ok))


def mesh_ens_shards(engine) -> int:
    """Number of 'ens' shards the SHARD-WISE pack applies to
    (batched_host.py:221-233): >1 only for a mesh engine whose 'peer'
    axis is unsharded (each device then holds whole rows, so its pack
    needs nothing from another device).  0 = not shard-wise (single
    engines included)."""
    mesh = getattr(engine, "mesh", None)
    if mesh is None or int(mesh.shape["peer"]) != 1:
        return 0
    n = int(mesh.shape["ens"])
    return n if n > 1 else 0


def _pack_local(won: torch.Tensor, res: eng.KvResult, want_vsn: bool,
                active_idx: Optional[torch.Tensor] = None,
                wide: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The single engine's pack: :func:`_pack_results_body` of the step's
    results (a wide ``(G, W)`` step's in the packed layout first)."""
    if wide is not None:
        res = _wide_to_packed_layout(res, wide[0], wide[1],
                                     res.committed.shape[1])
    return _pack_results_body(won, res, want_vsn, active_idx=active_idx)


def _shard_result(res: eng.KvResult, shard) -> eng.KvResult:
    return eng.KvResult(*(f.blocks[shard] for f in res))


def _pack_shardwise(won, res: eng.KvResult, want_vsn: bool,
                    active_idx: Optional[np.ndarray] = None,
                    wide: Optional[Tuple[int, int]] = None
                    ) -> List[torch.Tensor]:
    """The SHARD-WISE pack (batched_host.py:236-287): one
    :func:`_pack_local` per ens shard, on that shard's device, over its
    own ``[K, e_loc]`` results.  ``active_idx`` is ``[n_shards, A_loc]``
    host int32, each row a shard's LOCAL active columns (pad 0, ignored
    by the unpack).  Returns the per-shard packed vectors in shard order;
    :func:`unpack_results_sharded` inverts their concatenation."""
    out = []
    for n, shard in enumerate(sorted(won.blocks)):
        w = won.blocks[shard]
        aidx = None
        if active_idx is not None:
            aidx = torch.from_numpy(active_idx[n]).to(w.device)
        with (torch.cuda.device(w.device) if w.is_cuda
              else contextlib.nullcontext()):
            out.append(_pack_local(w, _shard_result(res, shard), want_vsn,
                                   aidx, wide))
    return out


def _make_gathered_packer(device: torch.device):
    """The pack of a mesh with a sharded peer axis (batched_host.py:
    164-189): the results gather to ``device`` and pack once there."""
    def pack(won, res, want_vsn, active_idx=None, wide=None):
        won_g = won.gather(device)
        res_g = eng.KvResult(*(f.gather(device) for f in res))
        if active_idx is not None:
            active_idx = torch.as_tensor(active_idx).to(device)
        return _pack_local(won_g, res_g, want_vsn, active_idx, wide)
    return pack


def _select_packer(engine):
    """The pack matching the engine's placement (batched_host.py:
    290-302): the plain pack for a single engine, the shard-wise one for
    an 'ens'-sharded mesh with an unsharded peer axis, the gathered one
    for the rest."""
    mesh = getattr(engine, "mesh", None)
    if mesh is None:
        return _pack_local
    if mesh_ens_shards(engine):
        return _pack_shardwise
    return _make_gathered_packer(engine.device)


class _Events:
    """The events after a shard-wise launch's per-device copies, waited
    on as one."""

    def __init__(self, events: List[Any]) -> None:
        self.events = events

    def synchronize(self) -> None:
        for ev in self.events:
            ev.synchronize()


def unpack_results_sharded(flat: np.ndarray, e: int, m: int, k: int,
                           want_vsn: bool, n_shards: int,
                           shard_active: Optional[List[np.ndarray]] = None,
                           a_width: int = 0):
    """Invert the shard-wise pack (batched_host.py:431-464): ``n_shards``
    :func:`_pack_results_body` blocks in shard order, each over a
    contiguous ``e_loc = E / n_shards`` column slice and compacted
    through its LOCAL active list (``shard_active[s]``, <= ``a_width``
    entries; None = every shard at full width).  Each block unpacks
    through :func:`unpack_results` and the full-width planes join along
    E, so everything downstream (mirror scatter, WAL, wide routing)
    reads the layout of a single engine."""
    e_loc = e // n_shards
    nb = packed_nbytes(e_loc, m, k, want_vsn,
                       a_width if shard_active is not None else None)
    parts = []
    for s in range(n_shards):
        act = None if shard_active is None else shard_active[s]
        parts.append(unpack_results(
            flat[s * nb:(s + 1) * nb], e_loc, m, k, want_vsn, active=act,
            a_width=0 if shard_active is None else a_width))

    def cat(i, axis):
        if parts[0][i] is None:
            return None
        return np.concatenate([p[i] for p in parts], axis=axis)
    return (cat(0, 0), cat(1, 0), cat(2, 0), cat(3, 1), cat(4, 1),
            cat(5, 1), cat(6, 1), cat(7, 1))


def _clone_state(state):
    """A rollback copy of the engine state (a mesh state clones its
    shards)."""
    if isinstance(state, eng.EngineState):
        return eng.EngineState(*(t.clone() for t in state))
    return state.clone()


class _LocalEngine:
    """The default engine adapter (batched_host.py:494-515): the engine
    module's functions.  A subclass that overrides one of them (a test's
    failure injector) slots in through the service's ``engine``
    argument.  ``gather_state`` / ``shard_state`` are the identity here;
    a mesh engine maps its sharded state to and from one state."""

    init_state = staticmethod(eng.init_state)
    full_step = staticmethod(eng.full_step)
    full_step_sliced = staticmethod(eng.full_step_sliced)
    full_step_wide = staticmethod(eng.full_step_wide)
    full_step_wide_sliced = staticmethod(eng.full_step_wide_sliced)
    exchange_step = staticmethod(eng.exchange_step)
    verify_trees = staticmethod(eng.verify_trees)
    rebuild_trees = staticmethod(eng.rebuild_trees)
    reset_rows = staticmethod(eng.reset_rows)
    reconfig_step = staticmethod(eng.reconfig_step)

    @staticmethod
    def keep_rows(state: eng.EngineState, rows: np.ndarray):
        """Before :meth:`exchange_step`: a function that undoes it.  On the
        card the exchange steps the rows' planes in place, so those are
        kept (:func:`engine.keep_rows`); on the CPU it returns new
        tensors and there is nothing to keep."""
        if state.obj_epoch.device.type != "cuda":
            return lambda: None
        return eng.keep_rows(state, rows)

    @staticmethod
    def gather_state(state: eng.EngineState) -> eng.EngineState:
        return state

    @staticmethod
    def shard_state(state: eng.EngineState) -> eng.EngineState:
        return state


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
    #: rounds in the packed layout (a wide launch's G*W, else k)
    k_eff: int
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
    #: wide launch: its WidePlan over the live columns ``live`` (None:
    #: the scalar scan) and plane width W
    plan: Any = None
    live: Optional[np.ndarray] = None
    w_b: int = 0
    #: flush path: the (ensemble, taken ops) pairs this launch serves
    taken: Any = None
    #: slab enqueue path: the flush's pending-slab record (ent_col,
    #: ent_row0, ent_len run descriptors, the taken round count, each
    #: entry's first slab row, and the per-entry SLO stamp columns, None
    #: with obs off) — the completion slab gathers through it
    lanes: Any = None
    #: execute_async path: the client future and its op count, and the
    #: host planes its WAL records come from (None: nothing to log)
    exec_fut: Optional[Future] = None
    exec_ops: int = 0
    exec_wal: Any = None
    #: shard-wise mesh pack (:func:`mesh_ens_shards` > 0): the payload
    #: is ``n_shards`` per-shard blocks; ``shard_active`` holds each
    #: shard's LOCAL active columns when the launch compacted (None =
    #: every shard at full width)
    n_shards: int = 0
    shard_active: Any = None
    #: the rollback snapshot (CPU launches only; None = donated): the
    #: pre-launch state, leader mirror and leases
    snapshot: Any = None
    #: the leader mirror at enqueue: watchers hear the settle's changes
    #: against it
    leader_snapshot: Any = None
    #: the launch's latency record (seconds per mark; the settle adds
    #: its marks and the total), its obs flush id (0 with obs off), the
    #: enqueue's start (the per-op SLO join stamp) and the packed bytes
    rec: Any = None
    flush_id: int = 0
    t_join: float = 0.0
    payload_nbytes: int = 0
    #: the round's quorum confirmations ([E], set at resolve) for
    #: subclass resolve hooks: a replication group's delta entries ship
    #: them so replica lanes renew leases as a re-executed launch would
    quorum_np: Any = None
    #: replication group (:mod:`.repgroup`): the launch's stream seq, its
    #: put-lane metadata, the corruption count before it, and the exact
    #: host inputs it ships (None outside a group leader)
    grp_seq: int = 0
    grp_meta: Any = None
    grp_corr0: int = 0
    grp_ship: Any = None


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


class WallRuntime:
    """Minimal real-time runtime for driving the service outside a
    simulator: ``now`` is the monotonic clock.  It has no event loop,
    so it only serves caller-driven services: construct the service with
    ``tick=None`` and call ``flush()``."""

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
    #: enqueue time (the queue-wait mark) and, for the per-op SLO ring,
    #: the API-entry submit time (0 = use t_enq)
    t_enq: float = 0.0
    t_sub: float = 0.0


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
    t_enq: float = 0.0
    t_sub: float = 0.0

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
                          self.want_vsn, head_n, self.t_enq, self.t_sub)
        t = _PendingBatch(self.kind, self.slot[head_n:],
                          self.handle[head_n:], self.fut,
                          self.pos[head_n:], cut(self.keys, head_n, None),
                          cut(self.gen, head_n, None),
                          cut(self.exp_e, head_n, None),
                          cut(self.exp_s, head_n, None), self.accum,
                          self.want_vsn, self.n - head_n, self.t_enq,
                          self.t_sub)
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
    keys are deleted).  ``tick`` is the flush cadence on the runtime's
    clock (lower = lower latency, higher = bigger batches), and a queue
    that reaches ``max_ops_per_tick`` rounds flushes on the next runtime
    turn; ``tick=None`` disables the timer and the caller drives
    :meth:`flush` (the only mode :class:`WallRuntime` serves).
    ``dynamic=True`` starts with every row free: :meth:`create_ensemble`
    and :meth:`destroy_ensemble` manage named rows, and ops on a free
    row fail.  The engine state lives on
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
                 n_slots: int = 128, tick: Optional[float] = 0.005,
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
                 wal_compact_records: int = 1 << 18,
                 dynamic: bool = False,
                 wide: bool = False,
                 validate_wide: bool = False,
                 resolve_shards: int = 1) -> None:
        self.runtime = runtime
        self.config = config if config is not None else Config()
        self.n_ens, self.n_peers, self.n_slots = n_ens, n_peers, n_slots
        self.tick = tick
        self.max_k = max_ops_per_tick
        self.engine = engine if engine is not None else _LocalEngine()
        mesh = getattr(self.engine, "mesh", None)
        if mesh is not None:
            # a mesh places the state; the service's own tensors live
            # on its first device
            want = None if device is None else torch.device(device)
            if want is not None and (want.type != mesh.device.type or (
                    want.index is not None
                    and want.index != mesh.device.index)):
                raise ValueError(f"device={device!r}, but the mesh's "
                                 f"first device is {mesh.device}")
            self.device = mesh.device
        else:
            self.device = resolve_device(device)
        #: the packed-result program matching the engine's placement,
        #: and the shard count of the shard-wise mesh pack (0 = none)
        self._pack = _select_packer(self.engine)
        self._mesh_shards = mesh_ens_shards(self.engine)
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
        #: elections THIS host requested, membership only via reconfigs
        #: it issued) — election planning costs zero device round trips
        self.leader_np = np.full((n_ens,), -1, dtype=np.int32)
        self.member_np = np.ones((n_ens, n_peers), dtype=bool)
        #: the membership-change pipeline (batched_host.py:775-786): a
        #: requested change is QUEUED while an earlier one is still
        #: joint on the device, DESIRED until its joint view installs,
        #: PENDING until the joint view collapses, then live in
        #: ``member_np``
        self._queued_view_np = np.ones((n_ens, n_peers), dtype=bool)
        self._queued_mask = np.zeros((n_ens,), dtype=bool)
        self._desired_view_np = np.ones((n_ens, n_peers), dtype=bool)
        self._desired_mask = np.zeros((n_ens,), dtype=bool)
        self._pending_view_np = np.ones((n_ens, n_peers), dtype=bool)
        self._pending_mask = np.zeros((n_ens,), dtype=bool)
        #: won elections per row (reset when the row is recycled)
        self.elections_np = np.zeros((n_ens,), dtype=np.int64)
        #: dynamic rows (batched_host.py:929-945): a named ensemble maps
        #: to a physical row; ``dynamic=True`` starts with every row
        #: free (no members, no elections), rows popped from the end of
        #: ``_free_rows``
        self.dynamic = dynamic
        self._live = np.full((n_ens,), not dynamic, dtype=bool)
        self._free_rows: List[int] = (
            list(range(n_ens - 1, -1, -1)) if dynamic else [])
        self._ens_names: Dict[Any, int] = {}
        self._row_name: Dict[int, Any] = {}
        if dynamic:
            self.member_np[:] = False
            self.state = self.engine.reset_rows(
                self.state,
                torch.ones((n_ens,), dtype=torch.bool, device=self.device),
                torch.zeros((n_ens, n_peers), dtype=torch.bool,
                            device=self.device))
        #: leader-status watchers per ensemble (watch_leader), and the
        #: watcher exceptions contained by _safe_notify
        self._leader_watchers: Dict[int, List[Any]] = {}
        self.watcher_errors = 0
        #: the timer and the burst trigger's queued flush (_maybe_kick);
        #: stop() disarms both
        self._timer: Optional[Timer] = None
        self._kick_pending = False
        self._stopped = False
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
        #: front-end backpressure events, counted by whatever server
        #: fronts this service (:class:`..svcnode.ServiceServer`): a
        #: client stalled at the per-connection in-flight cap, or
        #: dropped because its reply buffer passed the write cap
        self.svc_backpressure: Dict[str, int] = {
            "inflight_stalls": 0, "write_buf_drops": 0}
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
        #: opt-in wide rounds (the reference's RETPU_WIDE=1,
        #: batched_host.py:958-970): a flush whose host op planes schedule
        #: into <= 2 conflict-free wide rounds launches through
        #: ``full_step_wide`` (:mod:`..ops.schedule`); ``validate_wide``
        #: (its RETPU_VALIDATE_WIDE=1) checks each plan's precondition on
        #: the host first.  ``wide_launches`` counts launches that took it.
        self._wide = bool(wide)
        self._validate_wide = bool(validate_wide)
        self.wide_launches = 0
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
        #: sharded host passes (the reference's RETPU_RESOLVE_SHARDS,
        #: batched_host.py:1132-1147): above 1 the pending-slab pack, the
        #: completion-slab gather and the mirror scatter split by
        #: contiguous run-descriptor / column ranges over a small thread
        #: pool (the C++ passes release the GIL).  Chunks touch disjoint
        #: plane cells and mirror rows and concatenate in chunk order, so
        #: the result is state-identical to 1.  The pool is made on the
        #: first sharded pass and shut down in :meth:`stop`.
        self._resolve_shards = max(1, int(resolve_shards))
        self._resolve_pool: Optional[ThreadPoolExecutor] = None
        self.sharded_flushes = 0
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
            if savelib.read(meta_path) is None:
                savelib.write(meta_path, pickle.dumps(
                    {"shape": (n_ens, n_peers, n_slots), "dynamic": dynamic,
                     "hash_format": hashk.HASH_FORMAT}, protocol=4))
            self._wal = ServiceWAL.open_gen(
                data_dir, self._current_ckpt(data_dir), wal_sync,
                native=self._wal_native)
        self._init_obs()
        self._schedule()

    def _init_obs(self) -> None:
        """The observability plane (batched_host.py:1024-1220): the
        latency records, the metrics registry and its collectors, the
        flight recorder, the per-op SLO ring, the build counters, the
        tenant ledgers, the flush-admission caps and the runtime
        controller.  ``RETPU_OBS=0`` (read here, once) short-circuits
        every hot-path record; the instruments are built either way."""
        n_ens = self.n_ens
        #: per-launch latency records (bounded; see latency_breakdown)
        self.lat_records: "deque[Dict[str, float]]" = deque(maxlen=1024)
        self._obs = obs.enabled()
        self.obs_registry = obs.MetricsRegistry()
        self.flight = obs.FlightRecorder(name="svc")
        self._h_flush = self.obs_registry.histogram(
            "retpu_flush_total_ms",
            "settled launch wall time (all marks summed)")
        #: the per-op SLO ring (None with obs off or RETPU_SLO_RING=0)
        #: and the client-perceived latency histogram it feeds
        self._slo = (obs.OpSloRing()
                     if self._obs and obs.opslo.ring_capacity()
                     else None)
        self._h_op = self.obs_registry.histogram(
            "retpu_op_latency_ms",
            "client-perceived op latency (submit to ack; "
            "mirror-served leased reads included)",
            label_name="kind")
        #: library builds (the port's counterpart of the reference's
        #: XLA compiles), by phase: "warmup" inside warmup(), else
        #: "serve"; the recent ones ride the flight dumps
        self._compile_log: "deque[Dict[str, Any]]" = deque(maxlen=64)
        self._in_warmup = False
        self._c_compile = self.obs_registry.counter(
            "retpu_compile_events_total",
            "library builds (nvcc / g++) while this service ran",
            label_name="phase")
        self._c_compile_ms = self.obs_registry.counter(
            "retpu_compile_ms_total",
            "wall ms spent in those builds", label_name="phase")
        if self._obs:
            build.add_listener(self._on_compile_event)
        #: F1's (bytes, int32 ops) per warmed (K, A) bucket
        self._step_costs: Dict[str, Dict[str, float]] = {}
        #: per-tenant ledgers [E] (a tenant is a row; named via
        #: _row_name / set_tenant_label): ops, committed rounds, put
        #: payload bytes, launches the row was active in, and an
        #: op-latency histogram [E, B]
        self.tenant_ops = np.zeros((n_ens,), np.int64)
        self.tenant_commits = np.zeros((n_ens,), np.int64)
        self.tenant_bytes = np.zeros((n_ens,), np.int64)
        self.tenant_rounds = np.zeros((n_ens,), np.int64)
        self._tenant_lat = np.zeros(
            (n_ens, len(obs.MS_BUCKETS) + 1), np.int64)
        self._lat_edges = np.asarray(obs.MS_BUCKETS)
        self._tenant_labels: Dict[int, Any] = {}
        self._launches_total = 0
        #: flush admission caps (None: the uncapped take path) and
        #: their per-row token buckets
        self._admission_caps: Optional[Dict[int, int]] = None
        self._admission_tokens: Dict[int, float] = {}
        #: the runtime controller: always built (its gauges register),
        #: acting only when armed
        self.controller = obs.RuntimeController(self)
        self._autotune = self.controller.enabled
        self._register_obs_metrics()

    @property
    def grid_occupancy(self) -> float:
        """Mean packed-grid occupancy over the launches settled so far
        (the reference's ``stats()["grid_occupancy"]``)."""
        return (self._occ_sum / self._occ_launches
                if self._occ_launches else 1.0)

    def set_pipeline_depth(self, depth: int) -> int:
        """Change the launch pipeline depth (the controller's depth
        knob, batched_host.py:2223-2238); every in-flight launch settles
        first.  Returns the old depth."""
        depth = max(1, int(depth))
        old = self.pipeline_depth
        if depth != old:
            self._drain_launches()
            self.pipeline_depth = depth
            self._uploads = _Uploads(self.device, depth + 1)
            self._emit("svc_autotune",
                       {"knob": "pipeline_depth", "old": old,
                        "new": depth})
        return old

    def set_admission_caps(self,
                           caps: Optional[Dict[int, int]]) -> None:
        """Install (or clear, with None) per-row flush-admission round
        caps — the tenant guard's knob (batched_host.py:2240-2256).
        Each capped row gets a token bucket: refill = cap per flush,
        burst 2x cap.  ``None`` / empty restores the uncapped take
        path."""
        caps = {int(e): max(1, int(c))
                for e, c in caps.items()} if caps else None
        self._admission_caps = caps
        # fresh buckets start full: the first capped flush admits a
        # full cap
        self._admission_tokens = (
            {e: float(c) for e, c in caps.items()} if caps else {})
        self._emit("svc_autotune",
                   {"knob": "admission_caps",
                    "new": dict(caps) if caps else None})

    def set_autotune(self, enabled: bool) -> None:
        """Arm / disarm the runtime controller for this service
        (``RETPU_AUTOTUNE``, svcnode's ``--autotune``;
        batched_host.py:2258-2282).  Disarming clears any admission
        caps it installed."""
        enabled = bool(enabled)
        if enabled == self._autotune:
            return
        self._autotune = enabled
        self.controller.enabled = enabled
        if enabled:
            # the heal target is the configuration at arm time
            self._autotune_base_depth = int(self.pipeline_depth)
            self._autotune_base_window = int(
                getattr(self, "repl_window", 1))
        if not enabled and self._admission_caps:
            self.controller.guard.throttled.clear()
            self.set_admission_caps(None)
        self._emit("svc_autotune",
                   {"knob": "autotune", "new": enabled})

    # -- dynamic ensemble lifecycle ----------------------------------------

    def create_ensemble(self, name: Any,
                        view: Optional[np.ndarray] = None
                        ) -> Optional[int]:
        """Create a named ensemble on a free row (batched_host.py:
        1226-1264, manager.erl:157-166): reset the row on the device
        (objects, trees, leader cleared; the ballot epoch stays
        monotone), install ``view`` (default all peers) and register the
        name.  Returns the row, or None when the name is taken or no row
        is free.  In-flight launches settle first."""
        assert self.dynamic, "construct with dynamic=True"
        self._drain_launches()
        if name in self._ens_names or not self._free_rows:
            return None
        row = self._free_rows.pop()
        view = (np.ones((self.n_peers,), bool) if view is None
                else np.asarray(view, bool))
        assert view.any(), "an ensemble needs at least one member"
        mask = np.zeros((self.n_ens,), bool)
        mask[row] = True
        view_e = np.zeros((self.n_ens, self.n_peers), bool)
        view_e[row] = view
        self.state = self.engine.reset_rows(
            self.state, torch.from_numpy(mask).to(self.device),
            torch.from_numpy(view_e).to(self.device))
        self.member_np[row] = view
        self._live[row] = True
        self.leader_np[row] = -1
        self.lease_until[row] = 0.0
        self._ens_names[name] = row
        self._row_name[row] = name
        self._reset_row_host(row)
        if self._wal is not None:
            self._wal.log([(("mem", row), (name, view.tolist()))])
        self._emit("svc_create_ensemble", {"name": name, "row": row})
        return row

    def destroy_ensemble(self, name: Any) -> bool:
        """Tear down a named ensemble and recycle its row
        (batched_host.py:1266-1311): queued ops and parked retries fail,
        payloads release, the device row is wiped and the row returns to
        the free pool; with a WAL the row's membership record empties
        and its ``kv`` records are deleted.  False for an unknown name.
        In-flight launches settle first."""
        assert self.dynamic, "construct with dynamic=True"
        self._drain_launches()
        row = self._ens_names.pop(name, None)
        if row is None:
            return False
        # the name's labelled series die with the tenant (the row reset
        # below sees only the fallback label), unless a sibling row
        # still serves under it
        self._drop_tenant_series(row)
        del self._row_name[row]
        for op in self.queues[row]:
            self._fail_entry(row, op)
        self.queues[row] = []
        self._queue_rounds[row] = 0
        self._active.discard(row)
        self._purge_retries(row)
        mask = np.zeros((self.n_ens,), bool)
        mask[row] = True
        self.state = self.engine.reset_rows(
            self.state, torch.from_numpy(mask).to(self.device),
            torch.zeros((self.n_ens, self.n_peers), dtype=torch.bool,
                        device=self.device))
        self.member_np[row] = False
        self._live[row] = False
        self.leader_np[row] = -1
        self.lease_until[row] = 0.0
        self._reset_row_host(row)
        self._free_rows.append(row)
        if self._wal is not None:
            # the dead tenant's kv records must not replay into the
            # recycled row
            self._wal.log([(("mem", row), (None, [False] * self.n_peers))])
            self._wal.delete([("kv", row, s) for s in range(self.n_slots)])
        self._emit("svc_destroy_ensemble", {"name": name, "row": row})
        return True

    def resolve_ensemble(self, name: Any) -> Optional[int]:
        """Name → row (the manager's directory read)."""
        return self._ens_names.get(name)

    def _reset_row_host(self, row: int) -> None:
        """Clear a row's keyed-store mirrors, releasing its payloads, and
        the per-row control state a recycled tenant must not inherit
        (batched_host.py:1318-1363): the fast-read and inline slabs, the
        queued-write counts, the membership pipeline, the watchers and
        the failure-detector marks — and the row's tenant ledger and
        labelled registry series (a label a sibling row still serves
        under survives)."""
        for h in self.slot_handle[row].values():
            self._release_handle(h)
        self.key_slot[row] = {}
        self.free_slots[row] = list(range(self.n_slots))
        self.slot_gen[row] = {}
        self.slot_handle[row] = {}
        self._inline_slots[row] = set()
        self._inline_np[row] = False
        self._queued_handle_writes[row] = [0] * self.n_slots
        self._recycle_pending[row] = []
        self._slot_vsn_ok[row] = False
        self._inline_value_ok[row] = False
        self._pending_writes[row] = [0] * self.n_slots
        self._corrupt_rows[row] = False
        self.elections_np[row] = 0
        self._leader_watchers.pop(row, None)
        self._desired_mask[row] = False
        self._queued_mask[row] = False
        self._pending_mask[row] = False
        self.up[row] = True
        self._up_dev = None
        self._drop_tenant_series(row)
        self.tenant_ops[row] = 0
        self.tenant_commits[row] = 0
        self.tenant_bytes[row] = 0
        self.tenant_rounds[row] = 0
        self._tenant_lat[row] = 0
        self._tenant_labels.pop(row, None)

    def _dead(self, ens: int) -> bool:
        """Ops addressed to a free or destroyed row fail fast."""
        return self.dynamic and not self._live[ens]

    # -- client API --------------------------------------------------------

    def kput(self, ens: int, key: Any, value: Any) -> Future:
        """Quorum-replicated write; resolves ('ok', vsn) or 'failed'
        (no slot / no quorum this flush)."""
        fut = Future()
        if self._dead(ens):
            fut.resolve("failed")
            return fut
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
        t_sub = time.perf_counter()  # the per-op SLO submit stamp
        n = len(keys)
        if n != len(values):
            raise ValueError(
                f"kput_many: {n} keys vs {len(values)} values")
        if self._dead(ens) or n == 0:
            fut.resolve(["failed"] * n)
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
                gen_l, accum=accum, n=m, t_sub=t_sub))
        return fut

    def kupdate_many(self, ens: int, keys: List[Any],
                     expected_vsns: List[Tuple[int, int]],
                     values: List[Any]) -> Future:
        """Vectorized CAS batch (the kupdate / kput_once semantics per
        key, batched_host.py:1467-1530): commit ``values[i]`` iff
        ``keys[i]``'s current version equals ``expected_vsns[i]``
        ((0, 0) = create-if-missing).  One future, per-key
        ('ok', new_vsn) | 'failed' in key order."""
        fut = Future()
        t_sub = time.perf_counter()  # the per-op SLO submit stamp
        n = len(keys)
        if n != len(values) or n != len(expected_vsns):
            raise ValueError(
                f"kupdate_many: {n} keys vs {len(expected_vsns)} vsns "
                f"vs {len(values)} values")
        if self._dead(ens) or n == 0:
            fut.resolve(["failed"] * n)
            return fut
        accum = _BatchAccum(n)
        slot: List[int] = []
        pos: List[int] = []
        exp_e: List[int] = []
        exp_s: List[int] = []
        live_keys: List[Any] = []
        miss_pos: List[int] = []
        ks = self.key_slot[ens]
        fs = self.free_slots[ens]
        for i, (key, vsn) in enumerate(zip(keys, expected_vsns)):
            s = ks.get(key)
            if s is None:
                if not fs:
                    miss_pos.append(i)
                    continue
                s = fs.pop()
                ks[key] = s
            slot.append(s)
            pos.append(i)
            exp_e.append(int(vsn[0]))
            exp_s.append(int(vsn[1]))
            live_keys.append(key)
        m = len(slot)
        handle = self._alloc_handles(m)
        self.values.update(zip(handle, (values[i] for i in pos)))
        sg = self.slot_gen[ens]
        gen: List[int] = []
        for s in slot:
            g = sg.get(s, 0) + 1
            sg[s] = g
            gen.append(g)
        qh = self._queued_handle_writes[ens]
        for s in slot:
            qh[s] += 1
        if miss_pos:
            accum.fill(fut, miss_pos, ["failed"] * len(miss_pos),
                       self._safe_resolve)
        if live_keys:
            self._push(ens, _PendingBatch(
                eng.OP_CAS, slot, handle, fut, pos, live_keys, gen,
                exp_e, exp_s, accum, n=m, t_sub=t_sub))
        return fut

    def kdelete_many(self, ens: int, keys: List[Any]) -> Future:
        """Vectorized tombstone writes (batched_host.py:1532-1582): one
        future, per-key ('ok', vsn) | ('ok', NOTFOUND) (no such key) |
        'failed' in key order.  Committed slots recycle like a scalar
        :meth:`kdelete`."""
        fut = Future()
        t_sub = time.perf_counter()  # the per-op SLO submit stamp
        n = len(keys)
        if self._dead(ens) or n == 0:
            fut.resolve(["failed"] * n)
            return fut
        accum = _BatchAccum(n)
        slot: List[int] = []
        gen: List[int] = []
        pos: List[int] = []
        live_keys: List[Any] = []
        miss_pos: List[int] = []
        sg = self.slot_gen[ens]
        ks = self.key_slot[ens]
        for i, key in enumerate(keys):
            s = ks.get(key)
            if s is None:
                miss_pos.append(i)
                continue
            slot.append(s)
            pos.append(i)
            gen.append(sg.get(s, 0))
            live_keys.append(key)
        if miss_pos:
            accum.fill(fut, miss_pos, [("ok", NOTFOUND)] * len(miss_pos),
                       self._safe_resolve)
        if live_keys:
            m = len(live_keys)
            self._push(ens, _PendingBatch(
                eng.OP_PUT, slot, [0] * m, fut, pos, live_keys, gen,
                accum=accum, n=m, t_sub=t_sub))
            # a deferred recycle per committed tombstone, keyed off the
            # batch's result list (the _recycle_on_ok discipline)
            keyslots = list(zip(live_keys, slot, gen, pos))

            def recycle(results):
                if not isinstance(results, list):
                    return
                for key, s, g, p in keyslots:
                    r = results[p]
                    if isinstance(r, tuple) and r[0] == "ok":
                        self._queue_recycle(ens, (key, s, g))
            fut.add_waiter(recycle)
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
        t_sub = time.perf_counter()  # the per-op SLO submit stamp
        n = len(keys)
        if self._dead(ens) or n == 0:
            fut.resolve(["failed"] * n)
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
            if self._count_fast(ens, reason):
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
                want_vsn=want_vsn, n=m, t_sub=t_sub))
        return fut

    def kget(self, ens: int, key: Any) -> Future:
        """Linearizable read; resolves ('ok', value|NOTFOUND) or
        'failed'.  Served from the leader's committed host mirror — no
        device round — while the fast path's conditions hold;
        otherwise the read rides an ``OP_GET`` round."""
        fut = Future()
        if self._dead(ens):
            fut.resolve("failed")
            return fut
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
        if self._dead(ens):
            fut.resolve("failed")
            return fut
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
        if self._dead(ens):
            fut.resolve("failed")
            return fut
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
        if self._dead(ens):
            fut.resolve("failed")
            return fut
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
        if self._dead(ens):
            fut.resolve("failed")
            return fut
        slot = self._slot_for(ens, key, allocate=False)
        if slot is None:
            fut.resolve(("ok", NOTFOUND))
            return fut
        op = _PendingOp(eng.OP_PUT, slot, 0, fut, key,   # 0 = tombstone
                        self.slot_gen[ens].get(slot, 0))
        self._push(ens, op)
        self._recycle_on_ok(fut, ens, key, slot)
        return fut

    # -- version-preserving bulk install (tenant handoff) -------------------

    def install_objs(self, ens: int,
                     items: List[Tuple[Any, Tuple[int, int], Any]]
                     ) -> List[Any]:
        """Install keyed objects WITH their versions
        (batched_host.py:1753-1905), the version-continuity half of a
        placement move: a re-ingest through ``kput`` would mint fresh
        versions and void every outstanding CAS token.

        ``items``: ``[(key, (epoch, seq), payload), ...]``.  Applied
        synchronously: slots and handles allocate on the host, the
        objects land in EVERY replica lane of the row, the row's trees
        rebuild, and its ballot epoch rises to the max installed epoch
        (see :meth:`_install_lead` for the leader).  Logged to the WAL
        with the real versions.  Returns per item ``("ok", (epoch,
        seq))`` or ``"failed"`` (no slot)."""
        self._drain_launches()  # installs splice device state directly
        results, applied = self._allocate_install(ens, items)
        if applied:
            self._apply_installed(ens, applied, self._install_lead(ens))
        return results

    def _install_lead(self, ens: int) -> int:
        """The install's leadership decision, made ONCE (a replication
        group ships it): a leaderless row gets its first view member,
        declared at the installed epoch (no election, so the CAS tokens
        survive); a row with a leader keeps it (-1)."""
        return (int(np.argmax(self.member_np[ens]))
                if int(self.leader_np[ens]) < 0 else -1)

    def _allocate_install(self, ens: int, items):
        """The host half: slots and handles for the installable items
        (separate, so a group leader can ship the exact allocation)."""
        results: List[Any] = []
        applied: List[Tuple] = []
        for key, (ve, vs), payload in items:
            slot = self._slot_for(ens, key, allocate=True)
            if slot is None:
                results.append("failed")
                continue
            handle = self._alloc_handle()
            self.values[handle] = payload
            applied.append((key, int(slot), int(handle), int(ve),
                            int(vs), payload))
            results.append(("ok", (int(ve), int(vs))))
        return results, applied

    def _apply_installed(self, ens: int, applied: List[Tuple],
                         lead: int = -1,
                         extra_records: Optional[List[Tuple]] = None
                         ) -> None:
        """Device, mirror and WAL application of an allocation from
        :meth:`_allocate_install` (verbatim on a group's replicas).
        ``lead`` is :meth:`_install_lead`'s decision (-1 = keep);
        ``extra_records`` replaces :meth:`_wal_extra_records` in the
        install's durability barrier (a replica passes its own group
        meta).  A slot installed twice keeps its last item, as the
        reference's in-order scatter does."""
        ens = int(ens)
        # the planes in place on the state's device; a mesh state is
        # gathered, written, and placed back
        st = self.engine.gather_state(self.state)
        dev = st.epoch.device
        last: Dict[int, int] = {}
        for i, a in enumerate(applied):
            last[int(a[1])] = i
        pick = sorted(last.values())
        slots = np.asarray([applied[i][1] for i in pick], np.int64)
        eps = np.asarray([a[3] for a in applied], np.int32)
        sqs = np.asarray([a[4] for a in applied], np.int32)
        hds = np.asarray([a[2] for a in applied], np.int32)
        s_t = torch.from_numpy(slots).to(dev)
        for plane, vals in ((st.obj_epoch, eps), (st.obj_seq, sqs),
                            (st.obj_val, hds)):
            row = plane[ens]  # [M, S] view: the writes land in place
            row[:, s_t] = torch.from_numpy(
                np.ascontiguousarray(vals[pick])).to(dev)[None, :]
        # Version continuity needs NO epoch change on first touch: raise
        # the row's ballot epoch to the max installed epoch and its seq
        # counter past the installed seqs (batched_host.py:1845-1868).
        row_max = int(eps.max()) if len(eps) else 0
        st.epoch[ens].clamp_(min=row_max)
        st.obj_seq_ctr[ens].clamp_(min=int(sqs.max()) if len(sqs) else 0)
        if lead >= 0:
            st.leader[ens] = lead
        mask = torch.zeros((self.n_ens, self.n_peers), dtype=torch.bool,
                           device=self.device)
        mask[ens] = True
        self.state = self.engine.rebuild_trees(self.engine.shard_state(st),
                                               mask)
        for key, slot, handle, ve, vs, payload in applied:
            self._inline_slots[ens].discard(slot)
            self._inline_np[ens, slot] = False
            self._inline_value_ok[ens, slot] = False
            self._slot_vsn_np[ens, slot] = (ve, vs)
            self._slot_vsn_ok[ens, slot] = True
            old = self.slot_handle[ens].pop(slot, 0)
            if old and old != handle:
                # values only, never the handle pool: the numbers are the
                # allocating leader's
                self.values.pop(old, None)
            self.values[handle] = payload
            self.slot_handle[ens][slot] = handle
            if handle >= self._next_handle:
                self._next_handle = handle + 1
            self.key_slot[ens][key] = slot
        if lead >= 0:
            self.leader_np[ens] = lead
            self.lease_until[ens] = 0.0
        self._up_dev = None
        if self._wal is not None:
            recs = [(("kv", ens, slot),
                     (key, handle, ve, vs, payload, False))
                    for key, slot, handle, ve, vs, payload in applied]
            self._wal.log(recs + (extra_records
                                  if extra_records is not None
                                  else self._wal_extra_records()))

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
        if self._dead(ens):
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
                                or tries_left <= 1 \
                                or self._dead(ens):
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
                    elif tries_left > 1 and not self._dead(ens):
                        # retried CAS losses: write races plus
                        # transient quorum failures (indistinguishable
                        # from 'failed'); a destroyed row stops retrying
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
        if self._dead(ens) or n == 0:
            fut.resolve(["failed"] * n)
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
                            or retries <= 1 or self._dead(ens):
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
        return self._count_fast(ens, reason), res

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

    def _count_fast(self, ens: int, reason: Optional[str]) -> bool:
        """Account one fast-path attempt; True = hit (serve now)."""
        if reason is None:
            self.read_fastpath_hits += 1
            # a mirror-served read is a served op
            self.ops_served += 1
            if self._obs:
                # a served read is a tenant op, with one lowest-bucket
                # latency sample (a mirror hit is microseconds) when the
                # SLO ring is on (batched_host.py:2376-2396)
                self.tenant_ops[ens] += 1
                if self._slo is not None:
                    self._tenant_lat[ens, 0] += 1
                    child = self._h_op.labels(obs.opslo.KIND_NAMES[
                        obs.opslo.KIND_FAST_READ])
                    child.counts[0] += 1
                    child.count += 1
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

    def _purge_retries(self, ens: int) -> None:
        """Fail and drop parked retries addressed to a destroyed row
        (batched_host.py:2476-2487): a thunk firing after the row is
        recycled would run the dead tenant's mod-fun against the new
        tenant."""
        keep: List[Tuple[int, int, Future, Any]] = []
        for at, e, fut, thunk in self._retry_at:
            if e == ens:
                self._safe_resolve(fut, "failed")
            else:
                keep.append((at, e, fut, thunk))
        self._retry_at = keep

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
        """Trace a mod-fun exception (called inside its ``except``) as
        ``svc_kmodify_error``, rate-limited to one traceback per second;
        suppressed counts ride the next one."""
        now = time.monotonic()
        if now - self._kmodify_err_at >= 1.0:
            import traceback
            self._kmodify_err_at = now
            self._emit("svc_kmodify_error",
                       {"error": traceback.format_exc(limit=8),
                        "suppressed": self._kmodify_err_dropped})
            self._kmodify_err_dropped = 0
        else:
            self._kmodify_err_dropped += 1

    def set_peer_up(self, ens: int, peer: int, up: bool) -> None:
        """Failure-detector input (the host's nodedown/suspend signal)."""
        self.up[ens, peer] = up
        self._up_dev = None

    # -- leader watchers ----------------------------------------------------

    def watch_leader(self, ens: int, fn) -> None:
        """Leader-status watcher for one ensemble (batched_host.py:
        2515-2525, peer.erl:212-218): ``fn(ens, old_leader, new_leader)``
        fires at once with the current status (old == new) and then after
        any launch or membership change that moved the leader (-1 =
        none).  A raising watcher is contained; remove it with
        :meth:`unwatch_leader`."""
        self._leader_watchers.setdefault(ens, []).append(fn)
        cur = int(self.leader_np[ens])
        self._safe_notify(fn, ens, cur, cur)

    def unwatch_leader(self, ens: int, fn) -> bool:
        """Deregister a leader watcher (stop_watching); True iff it was
        registered."""
        fns = self._leader_watchers.get(ens)
        if fns is None or fn not in fns:
            return False
        fns.remove(fn)
        if not fns:
            del self._leader_watchers[ens]
        return True

    def _safe_notify(self, fn, *args) -> None:
        """Run a watcher, containing its exception: counted in
        ``watcher_errors`` and traced as ``svc_watcher_error``."""
        try:
            fn(*args)
        except Exception:
            import traceback
            self.watcher_errors += 1
            self._emit("svc_watcher_error",
                       {"error": traceback.format_exc(limit=8)})

    def _notify_leader_changes(self, old: np.ndarray) -> None:
        """Tell the watchers of every row whose leader moved from
        ``old`` (batched_host.py:2549-2557)."""
        if not self._leader_watchers:
            return
        changed = np.nonzero(old != self.leader_np)[0]
        for e in changed.tolist():
            # a snapshot: a watcher may watch or unwatch from its callback
            for fn in list(self._leader_watchers.get(e, ())):
                self._safe_notify(fn, e, int(old[e]),
                                  int(self.leader_np[e]))

    # -- membership ---------------------------------------------------------

    def update_members(self, sel: np.ndarray,
                       new_view: np.ndarray) -> np.ndarray:
        """Batched joint-consensus membership change for the ensembles in
        ``sel [E]`` to ``new_view [E, M]`` (batched_host.py:2571-2698,
        peer.erl:655-672, 751-774): one reconfig launch installs the
        joint view where a live leader's commit quorum holds (and
        collapses views left joint by earlier calls), and, only when
        something was proposed, a second launch collapses the fresh
        installs.  Each launch is one kernel R1 on CUDA (the gates, the
        install and the collapse) and its results come back to the host
        at once.

        Returns ``changed [E]``: ensembles whose membership reached its
        in-flight view during this call.  A change that cannot commit
        yet stays in flight and every later call advances it (an
        all-False ``sel`` is a pure retry); a request for an ensemble
        still joint on the device is queued behind that change.  A
        leader that left its membership (or is down) is deposed, and the
        next flush elects; watchers hear it.  With a WAL the changed rows
        are logged before the call returns.  In-flight launches settle
        first.  On the CPU a failed launch restores the state; on CUDA
        the reconfig steps the state in place (the donated contract)."""
        self._drain_launches()
        sel = np.asarray(sel, bool)
        if self.dynamic:
            sel = sel & self._live  # free rows have no membership
        new_view = np.asarray(new_view, bool)
        # an ensemble already joint on the device keeps its in-flight
        # view until that collapses; the new request waits, queued
        accept = sel & ~self._pending_mask
        defer = sel & self._pending_mask
        self._desired_view_np = np.where(accept[:, None], new_view,
                                         self._desired_view_np)
        self._desired_mask = self._desired_mask | accept
        self._queued_view_np = np.where(defer[:, None], new_view,
                                        self._queued_view_np)
        self._queued_mask = self._queued_mask | defer
        dev = self.device
        up_j = self._up_device()
        # proposing is leader work: only ensembles with a live leader
        # install; leaderless ones keep the change desired
        idx = np.arange(self.n_ens)
        leader = self.leader_np
        leader_ok = np.zeros((self.n_ens,), bool)
        has = leader >= 0
        leader_ok[has] = self.up[idx[has], leader[has]]
        propose = self._desired_mask & ~self._pending_mask & leader_ok
        dv_j = torch.from_numpy(self._desired_view_np).to(dev)
        snapshot = self.state
        try:
            state, installed, collapsed1 = self.engine.reconfig_step(
                self.state, torch.from_numpy(propose).to(dev), dv_j, up_j)
            if propose.any():
                state, _, collapsed2 = self.engine.reconfig_step(
                    state, torch.zeros((self.n_ens,), dtype=torch.bool,
                                       device=dev), dv_j, up_j)
                collapsed2 = collapsed2.cpu().numpy()
            else:
                collapsed2 = np.zeros((self.n_ens,), bool)
            self.state = state
            installed_now = propose & installed.cpu().numpy()
            collapsed1 = collapsed1.cpu().numpy()
        except BaseException:
            # a CPU reconfig makes new planes, so the request stays
            # desired and a later call retries cleanly; a CUDA one steps
            # the planes in place and the snapshot is that same state
            self.state = snapshot
            raise
        # collapses land in either launch: views left joint by earlier
        # calls in the first, fresh installs in the second
        collapsed = collapsed1 | collapsed2
        self._pending_view_np = np.where(installed_now[:, None],
                                         self._desired_view_np,
                                         self._pending_view_np)
        self._pending_mask = self._pending_mask | installed_now
        self._desired_mask = self._desired_mask & ~installed_now
        changed = self._pending_mask & collapsed
        self.member_np = np.where(changed[:, None],
                                  self._pending_view_np, self.member_np)
        self._pending_mask = self._pending_mask & ~changed
        promote = self._queued_mask & changed
        self._desired_view_np = np.where(promote[:, None],
                                         self._queued_view_np,
                                         self._desired_view_np)
        self._desired_mask = self._desired_mask | promote
        self._queued_mask = self._queued_mask & ~promote
        # a leader no longer in (or not up in) its membership forces an
        # election on the next flush
        still_ok = np.zeros((self.n_ens,), bool)
        still_ok[has] = self.member_np[idx[has], leader[has]] & \
            self.up[idx[has], leader[has]]
        dropped = changed & has & ~still_ok
        self.leader_np = np.where(dropped, -1, leader)
        self.lease_until[dropped] = 0.0
        self._notify_leader_changes(leader)
        # committed membership rows persist before the caller sees them
        if self._wal is not None and changed.any():
            self._wal.log([(("mem", int(e)),
                            (self._row_name.get(int(e)),
                             self.member_np[e].tolist()))
                           for e in np.nonzero(changed)[0]])
        return changed

    # -- the timer ----------------------------------------------------------

    def stop(self) -> None:
        """Cancel the timer and any burst kick still deferred, and shut
        the sharded passes' pool down (batched_host.py:2700-2707, where a
        kick deferred before the stop still flushes once after it)."""
        self._stopped = True
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if self._resolve_pool is not None:
            self._resolve_pool.shutdown(wait=True)
            self._resolve_pool = None

    # -- sharded host passes (batched_host.py:2708-2737) --------------------

    def _shard_bounds(self, n: int) -> Optional[List[Tuple[int, int]]]:
        """Contiguous ``[lo, hi)`` chunks partitioning ``n`` run
        descriptors (or taken columns) over the pool, or None when
        sharding is off or pointless (the single-threaded path).  A
        descriptor's run never splits, so chunks touch disjoint plane
        cells."""
        s = self._resolve_shards
        if s <= 1 or n <= 1:
            return None
        s = min(s, n)
        step = -(-n // s)
        return [(lo, min(lo + step, n)) for lo in range(0, n, step)]

    def _shard_map(self, fn, bounds: List[Tuple[int, int]]) -> list:
        """``fn(lo, hi)`` over every chunk, the first on the calling
        thread and the rest on the pool, results in chunk order (which
        every sharded site's concatenation relies on)."""
        if self._resolve_pool is None:
            self._resolve_pool = ThreadPoolExecutor(
                max_workers=self._resolve_shards,
                thread_name_prefix="retpu-resolve")
        futs = [self._resolve_pool.submit(fn, lo, hi)
                for lo, hi in bounds[1:]]
        out = [fn(*bounds[0])]
        out.extend(f.result() for f in futs)
        return out

    def _maybe_kick(self, ens: int) -> None:
        """The burst trigger (batched_host.py:3237-3261): a queue that
        just reached a full launch's depth flushes on the next runtime
        turn (deferred, never inside the enqueue) instead of waiting for
        the tick; the kick re-arms while queues stay non-empty, so a
        deeper burst drains whole.  Timer-driven services only."""
        if self.tick is None or self._kick_pending or self._stopped:
            return
        if self._queue_rounds[ens] < self.max_k:
            return
        self._kick_pending = True

        def kick() -> None:
            self._kick_pending = False
            if self._stopped:
                return
            self.flush()
            if self._active:
                self._kick_pending = True
                self.runtime.defer(kick)
        self.runtime.defer(kick)

    def _schedule(self) -> None:
        if self.tick is None:
            return
        self._timer = self.runtime.schedule(self.tick, self._on_tick)

    def _on_tick(self) -> None:
        try:
            self.flush()
        finally:
            self._schedule()

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
        """Device-resident planes skip the WAL: say so once per service
        (the flag, ``stats()["execute_unlogged"]`` and a trace event,
        batched_host.py:5058-5068)."""
        if self._wal is not None and not self._dev_exec_unlogged:
            self._dev_exec_unlogged = True
            self._emit("svc_execute_unlogged", {
                "reason": "device-resident op planes skip the WAL;"
                          " RPO is the checkpoint cadence"})

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
        caps = self._admission_caps
        admit: Optional[Dict[int, int]] = None
        if not caps:
            k = min(self.max_k,
                    max((self._queue_rounds[e] for e in active),
                        default=0))
        else:
            # flush admission (batched_host.py:5172-5194): a capped row
            # contributes at most its token-bucket allowance (refill =
            # cap per flush, burst 2x) to the depth choice and the take
            tokens = self._admission_tokens
            admit = {}
            k = 0
            for e in active:
                qr = self._queue_rounds[e]
                cap = caps.get(e)
                if cap is not None:
                    t = min(tokens.get(e, float(cap)) + cap, 2.0 * cap)
                    tokens[e] = t
                    qr = min(qr, int(t))
                admit[e] = qr
                if qr > k:
                    k = qr
            k = min(self.max_k, k)
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

        t_pack0 = time.perf_counter()
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
        #: per-entry SLO stamp columns, collected off the pending entries
        #: at enqueue time (batched_host.py:5259-5264)
        tsub_l: List[float] = []
        tenq_l: List[float] = []
        for e in sorted(active):
            q = self.queues[e]
            # a flush-admission cap lowers the row's take below k
            limit = k if admit is None else min(k, admit.get(e, k))
            ops: List[Any] = []
            rounds = idx = 0
            while idx < len(q) and rounds < limit:
                op = q[idx]
                if rounds + op.n <= limit:
                    ops.append(op)
                    rounds += op.n
                    idx += 1
                else:
                    # K cap (or the row's admission limit) lands inside a
                    # batch: take the head rounds now; the tail (same
                    # Future/accumulator) leads the next flush.
                    head, tail = op.split(limit - rounds)
                    ops.append(head)
                    rounds = limit
                    q[idx] = tail
                    break
            self.queues[e] = q[idx:]
            self._queue_rounds[e] -= rounds
            if admit is not None and e in self._admission_tokens:
                self._admission_tokens[e] = max(
                    0.0, self._admission_tokens[e] - rounds)
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
                    tsub_l.append(op.t_sub)
                    tenq_l.append(op.t_enq)
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
        pack_mark = None
        if use_slab and lane_n:
            # the pack (batched_host.py:5346-5405): one C++ traversal of
            # the runs, or the numpy pack
            ec = np.asarray(ent_col, np.int32)
            er = np.asarray(ent_row0, np.int32)
            el = np.asarray(ent_len, np.int32)
            ek = np.asarray(ent_kind, np.int32)
            lane_arrays = [np.asarray(x, np.int32)
                           for x in (slot_l, val_l, expe_l, exps_l)]
            if self._native_enqueue is not None:
                # a chunk's runs write disjoint [K, E] cells (rows
                # [er, er + el) of their columns); its lanes start at its
                # first run's slab offset.  Sharded (batched_host.py:
                # 5359-5386), the chunks run on the pool.
                def pack_chunk(lo: int, hi: int) -> None:
                    a0 = offs[lo]
                    a1 = offs[hi] if hi < len(offs) else lane_n
                    self._native_enqueue.pack(
                        k, self.n_ens, ec[lo:hi], er[lo:hi], el[lo:hi],
                        ek[lo:hi], *(x[a0:a1] for x in lane_arrays),
                        kind, slot, val, exp_e, exp_s)
                bounds = self._shard_bounds(len(ec))
                if bounds is not None:
                    self._shard_map(pack_chunk, bounds)
                    self.sharded_flushes += 1
                else:
                    pack_chunk(0, len(ec))
                self.native_enqueue_flushes += 1
                pack_mark = "enqueue_native"
            else:
                enqueue_native.pack_plain(
                    k, self.n_ens, ec, er, el, ek, *lane_arrays,
                    kind, slot, val, exp_e, exp_s)
                self.fallback_enqueue_flushes += 1
                pack_mark = "enqueue_fallback"
            lanes = (ec, er, el, lane_n, offs,
                     (ent_kind, ent_col, ent_len, tsub_l, tenq_l)
                     if self._obs else None)
        pack_dt = time.perf_counter() - t_pack0
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
                                      entries=taken, elect=elect,
                                      cand=cand)
        except BaseException:
            # A failed device launch must not orphan the taken ops:
            # fail them all, then let the error reach the flush() caller.
            for e, ops in taken:
                for op in ops:
                    self._fail_entry(e, op)
            raise
        fl.taken = taken
        fl.lanes = lanes
        if pack_mark is not None:
            # derived mark (outside the total; its time is already in
            # queue_wait): the lane build and plane pack, per pack arm
            fl.rec[pack_mark] = pack_dt
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
        """Enqueue one entry and arm the burst trigger.  Writes register
        in the per-slot pending-write index here — the one choke point
        every keyed write passes — and deregister when they resolve or
        fail."""
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
            if self._obs and op.kind in (eng.OP_PUT, eng.OP_CAS):
                self._obs_note_put_bytes(
                    ens, op.handle if isinstance(op, _PendingBatch)
                    else (op.handle,))
        op.t_enq = time.perf_counter()
        self.queues[ens].append(op)
        self._queue_rounds[ens] += op.n
        self._active.add(ens)
        self._maybe_kick(ens)

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
                        entries: Optional[List[Tuple[int,
                                                     List[Any]]]] = None,
                        elect: Optional[np.ndarray] = None,
                        cand: Optional[np.ndarray] = None,
                        lease_ok: Optional[np.ndarray] = None
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

        With ``wide`` on, host planes that schedule into at most two
        conflict-free wide rounds (:meth:`_wide_plan`) launch through
        ``full_step_wide`` (sliced: ``full_step_wide_sliced``) on the
        plan's ``[G, width, W]`` planes; the scheduler moves ops only
        within their column, so the active set is the same.

        On the CPU the launch first snapshots the state, the leader
        mirror and the leases; a failure here restores them
        (:meth:`_rollback_launch`), and so does one at settle.

        ``entries`` (the flush's taken (ensemble, ops) pairs) is unused
        here; the replication group's override ships their key and
        payload metadata.  ``elect`` / ``cand`` / ``lease_ok`` may come
        precomputed, so a wrapper that replicates the launch ships the
        very vectors it consumes."""
        del entries
        if elect is None:
            elect, cand = self._election_inputs()
        now = self.runtime.now
        if lease_ok is None:
            lease_ok = self.lease_until > now
        t0 = time.perf_counter()
        e = self.n_ens
        step, step_wide, step_sliced, step_wide_sliced = self._step_fns()
        host_planes = not isinstance(kind, torch.Tensor)
        # the live columns: those holding ops or elections (the rest are
        # NOOP rows, which neither compaction nor the wide plan carries)
        live = (np.flatnonzero((kind != eng.OP_NOOP).any(axis=0) | elect)
                if k and host_planes else None)
        plan = self._wide_plan(kind, slot, val, k, exp_e, exp_s, live)
        wide = plan is not None
        active = pad = shard_active = None
        a_width = 0
        sliced = False
        if self._compact and live is not None and live.size \
                and self._mesh_shards:
            # compaction per ens shard (batched_host.py:3460-3481): each
            # shard packs the busiest shard's pow2 bucket of its own LOCAL
            # columns; the step keeps the full grid
            per_shard, a_loc = schedule.shard_active_columns(
                live, e, self._mesh_shards, A_BUCKET_MIN)
            if a_loc < e // self._mesh_shards:
                active = live.astype(np.int32)
                a_width = a_loc
                shard_active = per_shard
                pad = np.zeros((self._mesh_shards, a_loc), np.int32)
                for si, p in enumerate(per_shard):
                    pad[si, :p.size] = p
        elif self._compact and live is not None:
            cols = live
            if cols.size:
                a_b = A_BUCKET_MIN
                while a_b < cols.size:
                    a_b <<= 1
                if a_b < e:
                    active = cols.astype(np.int32)
                    a_width = a_b
                    have = step_wide_sliced if wide else step_sliced
                    sliced = (have is not None
                              and e >= SLICE_MIN_E and a_b * 4 <= e)
                    pad = np.full((a_b,), e if sliced else 0, np.int32)
                    pad[:cols.size] = active
        width = a_width if sliced else e
        a_n = 0 if active is None else active.size
        ups = self._uploads
        ups.begin()

        def plane(name: str, src: np.ndarray, dtype: torch.dtype,
                  fill: int = 0):
            """Upload a [K, E] host plane, column-sliced when sliced (a
            device-resident plane is used as it is).  A wide launch's
            plane is the plan's [G, live, W], laid straight into the
            upload buffer: its first columns when sliced (the live
            columns are the active ones), else the live columns of a
            full-width plane whose idle lanes hold ``fill``."""
            if not host_planes:
                return src
            buf = ups.buffer(name, (src.shape[0], width) + src.shape[2:],
                             dtype)
            out = buf.numpy()
            if sliced:
                out[:, :a_n] = src if wide else src[:, active]
                out[:, a_n:] = 0
            elif wide:
                out[...] = fill
                out[:, live] = src
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

        if wide:
            ops = (plan.kind, plan.slot, plan.val, plan.exp_epoch,
                   plan.exp_seq)
            g_b, _, w_b = plan.kind.shape
            lanes: Tuple[int, ...] = (g_b, width, w_b)
        else:
            ops = (kind, slot, val, exp_e, exp_s)
            g_b = w_b = 0
            lanes = (k, width)
        kind_j = plane("kind", ops[0], torch.int32)
        slot_j = plane("slot", ops[1], torch.int32, fill=-1)
        val_j = plane("val", ops[2], torch.int32)
        exp_e_j = None if ops[3] is None else plane("exp_e", ops[3],
                                                    torch.int32)
        exp_s_j = None if ops[4] is None else plane("exp_s", ops[4],
                                                    torch.int32)
        # the lease plane travels contiguous [K, width] ([G, width, W]):
        # F1 refuses broadcast views
        lease_buf = ups.buffer("lease", lanes, torch.bool)
        lease_np = lease_buf.numpy()
        row = lease_ok[active] if sliced else lease_ok
        if wide:
            row = row[:, None]
        lease_np[:, :row.shape[0]] = row
        lease_np[:, row.shape[0]:] = False
        lease_j = ups.upload(lease_buf)
        elect_j = vector("elect", elect, torch.bool)
        cand_j = vector("cand", cand, torch.int32)
        aidx_j = None
        if shard_active is not None:
            aidx_j = pad
        elif active is not None and not sliced:
            abuf = ups.buffer("aidx", (a_width,), torch.int32)
            abuf.numpy()[...] = pad
            aidx_j = ups.upload(abuf)
        up_j = self._up_device()
        t1 = time.perf_counter()
        # the rollback snapshot (batched_host.py:3586-3598): the CPU
        # step updates the object and tree planes in place, so they are
        # cloned; CUDA launches keep the donated contract and no copy
        snapshot = None if self._donate else (
            _clone_state(self.state), self.leader_np.copy(),
            self.lease_until.copy())
        try:
            args = (elect_j, cand_j, kind_j, slot_j, val_j, lease_j, up_j)
            if sliced:
                fn = step_wide_sliced if wide else step_sliced
                state, won, res = fn(self.state, pad, *args,
                                     exp_epoch=exp_e_j, exp_seq=exp_s_j)
            else:
                fn = step_wide if wide else step
                state, won, res = fn(self.state, *args, exp_epoch=exp_e_j,
                                     exp_seq=exp_s_j)
            k_eff = k
            if wide:
                k_eff = g_b * w_b
                self.wide_launches += 1
            self.state = state
            # a sliced launch's planes are already A-wide; pack-gather
            # hands the pack the index
            flat = self._pack(won, res, want_vsn, active_idx=aidx_j,
                              wide=(g_b, w_b) if wide else None)
            host = done = None
            if isinstance(flat, list):
                flat, host, done = self._copy_parts(flat)
            elif self._copy_stream is not None:
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
        t2 = time.perf_counter()
        if sliced:
            self.sliced_launches += 1
        return _InFlightLaunch(
            flat=flat, host=host, done=done, k=k, want_vsn=want_vsn,
            elect=elect, cand=cand, now=now, k_eff=k_eff,
            kind_np=kind if host_planes else None,
            op_slot_np=slot if host_planes else None,
            active=active, a_width=a_width, sliced=sliced, plan=plan,
            live=live if wide else None, w_b=w_b,
            n_shards=self._mesh_shards, shard_active=shard_active,
            snapshot=snapshot, leader_snapshot=self.leader_np,
            rec={"h2d": t1 - t0, "dispatch": t2 - t1},
            flush_id=obs.next_flush_id() if self._obs else 0,
            t_join=t0)

    def _copy_parts(self, parts: List[torch.Tensor]):
        """A shard-wise launch's per-shard packed vectors to the host,
        each into its slice of ONE buffer in shard order — no
        cross-device gather.  On the card every copy runs on its device's
        current stream after its pack and the launch waits on all of
        their events; on the CPU the parts join at once.  Returns
        ``(flat, host, done)`` for the in-flight record."""
        if not parts[0].is_cuda:
            return torch.cat(parts), None, None
        ups = self._uploads
        host = ups.buffer("out", (sum(p.numel() for p in parts),),
                          torch.uint8)
        events, off = [], 0
        for p in parts:
            with torch.cuda.device(p.device):
                host[off:off + p.numel()].copy_(p, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record()
            events.append(ev)
            off += p.numel()
        done = _Events(events)
        ups.end(done)
        return parts, host, done

    def _step_fns(self) -> Tuple[Any, Any, Any, Any]:
        """The engine's (full_step, full_step_wide, full_step_sliced,
        full_step_wide_sliced) programs (batched_host.py:3324-3383).  An
        engine subclass that overrides a plain step but inherits its
        sliced form must not have its override bypassed: a sliced step
        is trusted only when the class (or instance) that defines the
        plain step defines it too; otherwise launches keep the full grid
        (None).  An engine without ``full_step_wide`` gets None there and
        never launches wide."""
        e = self.engine

        def definer(attr):
            for c in type(e).__mro__:
                if attr in c.__dict__:
                    return c
            return None

        def sliced(name: str, plain_name: str):
            fn = getattr(e, name, None)
            if (fn is not None and name not in getattr(e, "__dict__", {})
                    and definer(name) is not definer(plain_name)):
                return None
            return fn
        return (e.full_step, getattr(e, "full_step_wide", None),
                sliced("full_step_sliced", "full_step"),
                sliced("full_step_wide_sliced", "full_step_wide"))

    def _wide_plan(self, kind, slot, val, k: int, exp_e, exp_s,
                   live: Optional[np.ndarray]
                   ) -> Optional[schedule.WidePlan]:
        """Schedule host ``[K, E]`` planes into conflict-free wide rounds
        when ``wide`` is on and the plan has at most two groups (the
        warmed shapes); None keeps the scalar scan (batched_host.py:
        3877-3910).  Device-resident planes keep the scalar scan.

        The schedule is column by column, so it runs on the ``live``
        columns only and the plan stays in that form: ``[G, live, W]``
        planes and ``[K, live]`` maps.  The reference plans over every
        column; an idle column there is NOOP lanes, which the launch
        lays as the fill of its full-width planes.

        A wide flush runs its ops in (group, lane) order: per-slot order
        is kept (the g-th same-slot op runs in group g), while commit
        seqs across DIFFERENT slots may interleave otherwise than the
        scalar scan's k order — a valid serialization with exactly the
        reference's freedom (key-hashed workers complete distinct keys in
        unspecified relative order, peer.erl:1220-1225)."""
        if (not self._wide or k <= 1 or live is None
                or getattr(self.engine, "full_step_wide", None) is None):
            return None
        zeros = np.zeros((k, live.size), np.int32)
        plan = schedule.schedule_wide(
            kind[:, live], slot[:, live], val[:, live],
            None,  # the lease rides an [E] broadcast
            zeros if exp_e is None else exp_e[:, live],
            zeros if exp_s is None else exp_s[:, live], max_groups=2)
        if plan is not None and self._validate_wide:
            # checked at full width, so a fault names its ensemble
            g, _, w = plan.kind.shape

            def lay(part: np.ndarray, fill: int) -> np.ndarray:
                out = np.full((g, self.n_ens, w), fill, np.int32)
                out[:, live] = part
                return out
            eng.validate_wide_plane(lay(plan.kind, eng.OP_NOOP),
                                    lay(plan.slot, -1))
        return plan

    def _rollback_launch(self, snapshot) -> None:
        """Restore the pre-launch state and host mirrors after a failed
        launch (batched_host.py:3667-3685): a mirror claiming a leader
        the restored state does not have would suppress re-election.  A
        donated launch (CUDA, ``snapshot`` None) has no rollback; the
        state stays as the failure left it, traced as
        ``svc_state_poisoned``."""
        if snapshot is None:
            self._emit("svc_state_poisoned",
                       {"reason": "donated launch failed; no rollback "
                                  "snapshot survives buffer donation"})
            return
        self.state, self.leader_np, self.lease_until = snapshot

    def _launch_resolve(self, fl: _InFlightLaunch,
                        wait_key: str = "device_d2h"):
        """RESOLVE half of a launch (batched_host.py:3667-3880): wait for
        the packed result, unpack it to full-width planes, apply the
        leader and lease mirrors, and run the anti-entropy exchange for
        rows it flagged corrupt — on the CURRENT state, which at depth 2
        already holds the next launch's step, so a flagged row is
        repaired before any later result is acked.  Returns np result
        planes ``(committed, get_ok, found, value, vsn)`` (None planes
        for k == 0; vsn None unless asked).  A failure here rolls the
        launch back as a failed enqueue does (CPU launches).

        The launch's latency record gains ``wait_key`` (``device_d2h`` at
        depth 1: the device round and copy; ``inflight_wait`` in the
        pipeline: the part of them the overlap did not hide), the
        per-arm ``resolve_native`` / ``resolve_fallback`` share,
        ``unpack`` and ``exchange``, and lands in :attr:`lat_records`."""
        rec = fl.rec
        t2 = time.perf_counter()
        try:
            flat = self._fetch_packed(fl)
            rec[wait_key] = time.perf_counter() - t2
            t3 = time.perf_counter()
            e, m = self.n_ens, self.n_peers
            # the native arm (batched_host.py:3728-3744): one C++ pass
            # scatters a compacted payload into full-width planes.  A full-
            # width payload has nothing to scatter, and there numpy's byte-
            # wise unpackbits beats the pass's bit loop (3.0-4.8 against
            # 1.7-2.1 ms per call on the H100 machine's host, PERF.md §6), so
            # the arm unpacks it with numpy: the same bytes either way.
            # Election-only launches (k == 0) take the oracle's unpack, as in
            # the reference.
            k_eff = fl.k_eff
            if fl.n_shards:
                # a shard-wise mesh payload: per-shard blocks, unpacked
                # block by block in Python (batched_host.py:3718-3726;
                # the C++ unpack walks one block)
                planes8 = unpack_results_sharded(
                    flat, e, m, k_eff, fl.want_vsn, fl.n_shards,
                    shard_active=fl.shard_active, a_width=fl.a_width)
                self.fallback_resolve_flushes += 1
                arm_key = "resolve_fallback"
            elif self._native_resolve is not None and k_eff:
                if fl.active is not None:
                    planes8 = self._native_resolve.unpack(
                        flat, e, m, k_eff, fl.want_vsn, fl.active,
                        fl.a_width, fl.sliced)
                else:
                    planes8 = unpack_results(flat, e, m, k_eff, fl.want_vsn)
                self.native_resolve_flushes += 1
                arm_key = "resolve_native"
            else:
                planes8 = unpack_results(flat, e, m, k_eff, fl.want_vsn,
                                         active=fl.active, a_width=fl.a_width,
                                         sliced=fl.sliced)
                self.fallback_resolve_flushes += 1
                arm_key = "resolve_fallback"
            (won_np, quorum_ok, corrupt_np, committed, get_ok, found, value,
             vsn) = planes8
            if fl.plan is not None:
                # the [G*W, E] rows back to the caller's [K, E] op order
                # (batched_host.py:3775-3782), over the live columns only
                # (the rest hold no op); NOOP rows read unrelated lanes,
                # so they get the scalar scan's NOOP results (all false,
                # zero value and vsn)
                live = fl.live
                fli = fl.plan.map_g * fl.w_b + fl.plan.map_w
                act = fl.kind_np[:, live] != eng.OP_NOOP

                def route(x: np.ndarray) -> np.ndarray:
                    out = np.zeros(act.shape[:1] + x.shape[1:], x.dtype)
                    a = act.reshape(act.shape + (1,) * (x.ndim - 2))
                    out[:, live] = np.where(a, x[fli, live],
                                            x.dtype.type(0))
                    return out
                committed, get_ok, found, value = (
                    route(committed), route(get_ok), route(found),
                    route(value))
                if vsn is not None:
                    vsn = route(vsn)
            # the resolve half's per-arm share (a derived mark: unpack
            # here, the mirror scatter and WAL encode add theirs)
            rec[arm_key] = rec.get(arm_key, 0.0) + (time.perf_counter() - t3)
            self.payload_bytes += int(flat.nbytes)
            self.payload_bytes_full_width += packed_nbytes(e, m, k_eff,
                                                           fl.want_vsn)
            # a shard-wise launch packs a_width columns PER SHARD
            self._occ_sum += (fl.a_width * max(fl.n_shards, 1) / e
                              if fl.active is not None else 1.0)
            self._occ_launches += 1
            if self._obs:
                fl.payload_nbytes = int(flat.nbytes)
                self._launches_total += 1
                # device-round share: the rows this launch carried
                if fl.active is not None:
                    self.tenant_rounds[fl.active] += 1
                else:
                    self.tenant_rounds[self._live] += 1
            # Host mirror: a won election installed our candidate.
            self.leader_np = np.where(won_np, fl.cand, self.leader_np)
            fl.quorum_np = quorum_ok
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
                tx = time.perf_counter()
                self.corruptions += int(corrupt_np.sum())
                run = corrupt_np.any(1)
                self._corrupt_rows |= run
                self.state, diverged, synced = self.engine.exchange_step(
                    self.state, torch.from_numpy(run).to(self.device),
                    self._up_device())
                synced_np = synced.cpu().numpy()
                self.repairs += int(diverged.cpu().numpy()[synced_np].sum())
                self._corrupt_rows &= ~(run & synced_np)
                self._emit("svc_exchange", {"ensembles": int(run.sum())})
                rec["exchange"] = time.perf_counter() - tx
            self.flushes += 1
            rec["unpack"] = (time.perf_counter() - t3
                             - rec.get("exchange", 0.0))
        except BaseException:
            self._rollback_launch(fl.snapshot)
            raise
        # A won election bumped the row's ballot epoch: the next device
        # access of each object re-versions it, so the row's vsn mirror
        # is stale — drop it (plain value reads stay fast).
        if won_np.any():
            self._slot_vsn_ok[won_np] = False
            self.elections_np[won_np] += 1
        # watchers hear a successful launch's leader changes only (a
        # failed one rolled the mirror back above)
        self._notify_leader_changes(fl.leader_snapshot)
        self._emit("svc_launch", {
            "k": fl.k, "elections": int(fl.elect.sum()),
            "won": int(won_np.sum()),
            "corrupt_replicas": (int(corrupt_np.sum()) if fl.k else 0),
        })
        # the launch's record; the flush settle adds queue_wait, wal and
        # resolve.  'enqueue' (h2d + dispatch) is derived, outside the
        # total.
        rec["k"] = fl.k
        rec["enqueue"] = rec.get("h2d", 0.0) + rec.get("dispatch", 0.0)
        rec["total"] = sum(v for c, v in rec.items()
                           if c not in DERIVED_MARKS)
        self.lat_records.append(rec)
        return committed, get_ok, found, value, vsn

    def _launch(self, kind: np.ndarray, slot: np.ndarray, val: np.ndarray,
                k: int, want_vsn: bool,
                exp_e: Optional[np.ndarray] = None,
                exp_s: Optional[np.ndarray] = None,
                elect: Optional[np.ndarray] = None,
                cand: Optional[np.ndarray] = None,
                lease_ok: Optional[np.ndarray] = None):
        """One SYNCHRONOUS launch: the two halves back to back (the bulk
        :meth:`execute` path, a group leader's heartbeat), fed to the obs
        plane as it settles.  ``elect`` / ``cand`` / ``lease_ok`` as in
        :meth:`_launch_enqueue`."""
        fl = self._launch_enqueue(kind, slot, val, k, want_vsn, exp_e,
                                  exp_s, None, elect, cand, lease_ok)
        out = self._launch_resolve(fl)
        if self._obs:
            self._obs_flush_settled(fl)
        return out

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
        rec = fl.rec
        wait_key = ("inflight_wait" if self.pipeline_depth > 1
                    else "device_d2h")
        try:
            planes = self._launch_resolve(fl, wait_key=wait_key)
        except BaseException:
            self._abandon_launch(fl)
            raise
        if fl.exec_fut is not None:
            return self._settle_execute(fl, planes)
        taken = fl.taken or []
        # The durability barrier: committed writes reach the WAL (synced
        # per wal_sync) BEFORE any future resolves.  If the WAL write
        # fails, the commits stand on the device (the bookkeeping runs)
        # but their clients get 'failed' — an unacked commit is an
        # allowed outcome, a lost acked one is not.  A degraded service
        # neither logs nor acks writes; its reads still serve.
        wal_err: Optional[BaseException] = None
        degraded = self._storage_degraded is not None
        t_wal = time.perf_counter()
        if self._wal is not None and not degraded:
            try:
                self._log_wal(taken, planes, rec=rec)
            except Exception as exc:
                wal_err = exc
        t_res = time.perf_counter()
        served = self._resolve_flush(fl, planes,
                                     ack=wal_err is None and not degraded)
        t_end = time.perf_counter()
        # finish the record: the oldest op's queue wait, the WAL barrier,
        # the future fan-out (batched_host.py:5703-5713)
        oldest = min((op.t_enq for _e, ops in taken for op in ops
                      if op.t_enq), default=t_wal)
        rec["queue_wait"] = max(0.0, t_wal - oldest - rec.get("total", 0.0))
        rec["wal"] = t_res - t_wal
        rec["resolve"] = t_end - t_res
        rec["total"] = sum(v for c, v in rec.items()
                           if c not in DERIVED_MARKS)
        if self._obs:
            self._obs_flush_settled(fl)
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
        t_res = time.perf_counter()
        self.ops_served += fl.exec_ops
        self._safe_resolve(fl.exec_fut, (committed, get_ok, found, value))
        fl.rec["resolve"] = time.perf_counter() - t_res
        fl.rec["total"] = sum(v for c, v in fl.rec.items()
                              if c not in DERIVED_MARKS)
        if self._obs:
            self._obs_flush_settled(fl)
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
        the decision is kept in ``_storage_degraded`` (``health()["storage"]``)
        and traced as ``svc_storage_degraded``.  Recovery is a
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
        # the subclass hook first (a replicated leader steps down and
        # rewrites the mode), so the journaled record says what happened
        self._on_storage_degraded()
        self._emit("svc_storage_degraded", dict(self._storage_degraded))

    def _on_storage_degraded(self) -> None:
        """Subclass seam, called once when the storage plane degrades
        (batched_host.py:5633-5637): the single service has no group
        role to shed."""

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
                self._compact_wal(idle)
        if (self.scrub_every_flushes
                and self.flushes - self._scrubbed_at_flush
                >= self.scrub_every_flushes):
            self.scrub()
        self._fire_idle_retries()

    def _compact_wal(self, idle: bool) -> None:
        """Fold the WAL into a fresh checkpoint, timed and marked: an
        ``svc_compaction`` latency record and trace event
        (batched_host.py:5513-5530)."""
        records = self._wal.count
        t0 = time.perf_counter()
        self.save()
        dt = time.perf_counter() - t0
        self.wal_compactions += 1
        self.wal_compaction_ms_last = dt * 1e3
        self.wal_compaction_ms_total += dt * 1e3
        self.lat_records.append({"svc_compaction": dt})
        self._emit("svc_compaction",
                   {"ms": round(dt * 1e3, 3), "records": records,
                    "idle": idle})

    def _emit(self, kind: str, payload: Any) -> None:
        """Feed the runtime's tracing hook (utils.trace.Tracer) when
        one is installed; free otherwise."""
        tr = getattr(self.runtime, "trace", None)
        if tr is not None:
            tr(kind, payload)

    def latency_breakdown(self) -> Dict[str, Dict[str, float]]:
        """Per-component launch-latency percentiles (ms) over the
        recent flushes: where a commit's latency actually goes —
        queue_wait (enqueue → launch), h2d (input build + upload),
        dispatch (async enqueue of the step/pack/transfer), then
        EITHER device_d2h (depth-1: device math + packed result
        fetch, serial) OR inflight_wait (pipelined: the part of the
        device round + transfer the overlap failed to hide — this
        shrinking below device_d2h is the pipeline working), unpack,
        exchange (corruption-triggered), wal (durability barrier),
        resolve (future fan-out).  'enqueue' is a derived mark
        (h2d + dispatch — the whole enqueue half) excluded from the
        'total' sum, as are 'resolve_native'/'resolve_fallback' (the
        resolve half's per-arm share — unpack + mirror scatter + WAL
        encode attributed to whichever arm ran, ARCHITECTURE §12)
        and 'enqueue_native'/'enqueue_fallback' (the slab enqueue
        path's lane-build + op-plane-pack share, already inside
        queue_wait, attributed to whichever pack arm ran — §12b).
        ``svc_compaction`` (the deferred WAL fold, a rare EVENT rather than a per-launch component) is reported
        over its own occurrences only — averaging it into 1000+
        launch records would both hide the pause (p99 = 0) and
        inject zero samples into every launch component.  This is
        what makes the BASELINE p99 target analyzable before and
        after a platform change (VERDICT r2)."""
        recs = list(self.lat_records)
        out: Dict[str, Dict[str, float]] = {}
        events = [r for r in recs if "svc_compaction" in r]
        recs = [r for r in recs if "svc_compaction" not in r]
        if events:
            vals = np.asarray([r["svc_compaction"]
                               for r in events]) * 1e3
            out["svc_compaction"] = {
                "p50_ms": float(np.percentile(vals, 50)),
                "p99_ms": float(np.percentile(vals, 99)),
                "mean_ms": float(vals.mean())}
        if not recs:
            return out
        comps = sorted({c for r in recs for c in r if c != "k"})
        for c in comps:
            vals = np.asarray([r.get(c, 0.0) for r in recs]) * 1e3
            out[c] = {"p50_ms": float(np.percentile(vals, 50)),
                      "p99_ms": float(np.percentile(vals, 99)),
                      "mean_ms": float(vals.mean())}
        return out

    def stats(self) -> Dict[str, Any]:
        """Observability snapshot (the get_info/count_quorum analog
        for the scale path)."""
        wal_stats = (self._wal.stats() if self._wal is not None
                     else None)
        return {
            "flushes": self.flushes,
            "ops_served": self.ops_served,
            "svc_backpressure": dict(self.svc_backpressure),
            "corruptions_detected": self.corruptions,
            "replicas_repaired": self.repairs,
            "live_payloads": len(self.values),
            "ensembles_with_leader": int((self.leader_np >= 0).sum()),
            "membership_changes_in_flight": int(
                (self._desired_mask | self._pending_mask
                 | self._queued_mask).sum()),
            "queued_ops": sum(self._queue_rounds),
            "execute_unlogged": self._dev_exec_unlogged,
            "wide_launches": self.wide_launches,
            "pipeline_depth": self.pipeline_depth,
            "launches_in_flight": len(self._inflight),
            "rmw_conflicts": self.rmw_conflicts,
            "rmw_device_fastpath": self.rmw_device_fastpath,
            "rmw_enqueue_coalesced": self.rmw_enqueue_coalesced,
            # lease-protected read fast path: mirror-served reads vs
            # device-round fallbacks (by reason), and what fraction of
            # live ensembles hold a margin-valid lease right now
            "read_fastpath_hits": self.read_fastpath_hits,
            "read_fastpath_misses": self.read_fastpath_misses,
            "read_fastpath_miss_reasons": dict(
                self.read_fastpath_miss_reasons),
            "lease_valid_fraction": self._lease_valid_fraction(),
            # active-column compaction: packed d2h bytes actually
            # moved vs the full-width [K, E] layout, and the mean
            # packed-grid occupancy (a_width / E; 1.0 = uncompacted)
            "payload_bytes": self.payload_bytes,
            "payload_bytes_full_width": self.payload_bytes_full_width,
            "grid_occupancy": (self._occ_sum / self._occ_launches
                               if self._occ_launches else 1.0),
            # WAL-compaction pauses (deferred off the hot path; the
            # svc_compaction latency mark carries the same numbers
            # into latency_breakdown())
            "svc_compaction": {
                "count": self.wal_compactions,
                "last_ms": round(self.wal_compaction_ms_last, 3),
                "total_ms": round(self.wal_compaction_ms_total, 3),
            },
            # storage-recovery plane (ARCHITECTURE §15): the WAL
            # store's corruption-handling evidence plus the
            # degradation decision — same payload as health().  One
            # stats() call feeds both keys: each takes the WAL lock,
            # which the flush path holds across the fsync barrier
            "storage": self._storage_health_section(wal_stats),
            "wal": wal_stats,
            # observability plane (docs/ARCHITECTURE.md §11): the
            # full registry exports via the svcnode `metrics` verb;
            # stats() carries the headline plus per-tenant
            # attribution so existing stats consumers see both
            "obs_enabled": self._obs,
            "flight_anomalies": self.flight.anomalies,
            "tenants": self.tenant_stats(top=8),
            # native single-pass resolve kernel (ARCHITECTURE §12):
            # which arm each settled flush's resolve half ran on —
            # the per-flush split rides the resolve_native /
            # resolve_fallback latency marks
            "native_resolve": {
                "enabled": self._native_resolve is not None,
                "flushes": self.native_resolve_flushes,
                "fallback_flushes": self.fallback_resolve_flushes,
            },
            # slab enqueue half (ARCHITECTURE §12): which pack arm
            # each flush's op planes were scattered by (C++ kernel vs
            # numpy lanes; both zero when RETPU_NATIVE_ENQUEUE=0
            # pinned the per-entry oracle pack), and the completion
            # slab's one-wake-per-flush ledger
            "native_enqueue": {
                "slab_path": self._enq_slab,
                "kernel": self._native_enqueue is not None,
                "flushes": self.native_enqueue_flushes,
                "fallback_flushes": self.fallback_enqueue_flushes,
            },
            "completion_slab": {
                "wakes": self.completion_wakes,
                "rows": self.completion_rows,
            },
            # sharded resolve/enqueue workers (ARCHITECTURE §16):
            # pool width and how many flushes actually chunked
            "resolve_shards": {
                "shards": self._resolve_shards,
                "sharded_flushes": self.sharded_flushes,
            },
        }

    def _lease_valid_fraction(self) -> float:
        """Fraction of live ensembles whose lease is margin-valid on
        the monotonic clock right now — the fast path's best-case
        coverage (stats observability for the read router)."""
        live = self._live
        if not live.any():
            return 0.0
        horizon = self.runtime.now + self._read_margin
        return float((self.lease_until[live] > horizon).mean())

    def health(self, ens: Optional[int] = None) -> Dict[str, Any]:
        """Ensemble-health snapshot — the scale path's analog of the
        reference's cluster status / ``get_info`` surface, sourced
        ENTIRELY from host mirrors (leader_np, lease_until, the
        corruption flags, the committed-vsn slab): zero device
        rounds, callable on a loaded service at verb rate.

        ``ens=None`` answers the service level: per-row aggregates
        (leadered/electing/corrupt/lease-valid row counts, total
        election churn) plus the service depths a capacity dashboard
        needs — WAL record depth, queued device rounds, launches in
        flight, per-slot pending writes, live payload handles.

        ``ens=N`` answers one row: leader, margin-valid lease (and
        raw remaining seconds), election churn, corrupt flag, queue
        depth, pending writes, live keys, and the row's COMMITTED
        epoch/seq high-water (the max (epoch, seq) over the
        committed-vsn mirror — the host-visible analog of the ballot
        epoch; rows whose mirror was invalidated by a fresh election
        report the pre-election watermark until their next device
        read re-mirrors).

        Everything is plain ints/floats/strings — the svcnode
        ``("health",)`` verb ships it through the restricted wire
        codec verbatim."""
        now = self.runtime.now
        horizon = now + self._read_margin
        if ens is not None:
            assert 0 <= ens < self.n_ens, f"bad ensemble {ens}"
            vsn_row = self._slot_vsn_np[ens]
            ok_row = self._slot_vsn_ok[ens]
            if ok_row.any():
                epochs = vsn_row[ok_row]
                hi = epochs[np.lexsort((epochs[:, 1], epochs[:, 0]))][-1]
                committed = (int(hi[0]), int(hi[1]))
            else:
                committed = (0, 0)
            return {
                "ens": int(ens),
                "live": bool(self._live[ens]),
                "leader": int(self.leader_np[ens]),
                "members": [bool(b) for b in self.member_np[ens]],
                "lease_valid": bool(self.lease_until[ens] > horizon),
                "lease_remaining_s": round(
                    max(0.0, float(self.lease_until[ens]) - now), 6),
                "elections": int(self.elections_np[ens]),
                "corrupt": bool(self._corrupt_rows[ens]),
                "committed_epoch": committed[0],
                "committed_seq": committed[1],
                "queued_ops": int(self._queue_rounds[ens]),
                "pending_writes": (self.n_slots
                                   - self._pending_writes[ens]
                                   .count(0)),
                "live_keys": len(self.key_slot[ens]),
                "tenant": self.tenant_label(ens),
            }
        live = self._live
        elect, _cand = self._election_inputs()
        fp = faults.active_plan()
        out = {
            "schema": "retpu-health-v1",
            "n_ens": int(self.n_ens),
            "live_ensembles": int(live.sum()),
            "ensembles_with_leader": int(
                ((self.leader_np >= 0) & live).sum()),
            "electing": int((elect & live).sum()),
            "lease_valid_fraction": round(
                self._lease_valid_fraction(), 4),
            "corrupt_rows": int(self._corrupt_rows.sum()),
            "elections_total": int(self.elections_np.sum()),
            "wal_records": (int(self._wal.count)
                            if self._wal is not None else None),
            "queued_ops": int(sum(self._queue_rounds)),
            "launches_in_flight": len(self._inflight),
            "pending_writes": int(sum(
                self.n_slots - row.count(0)
                for row in self._pending_writes)),
            "live_payloads": len(self.values),
            "flushes": int(self.flushes),
            "ops_served": int(self.ops_served),
            # the runtime controller's section (ARCHITECTURE §14):
            # always present — `enabled: false` on a stock service —
            # so a dashboard's queries keep their shape when the
            # controller arms, the fault-gauge discipline
            "controller": self.controller.health_section(),
            # storage-recovery plane (ARCHITECTURE §15): always
            # present (degraded: false on a healthy disk) — same
            # constant-shape discipline as the controller section
            "storage": self._storage_health_section(),
        }
        if fp is not None:
            # active fault-injection plan (docs/ARCHITECTURE.md §13):
            # surfaced so an operator reading the health verb can
            # distinguish a running nemesis (injected drops / RTT /
            # fsync delay) from a real outage.  Absent entirely when
            # no plan is armed — a clean box shows a clean verb.
            out["injected"] = fp.describe()
        return out

    def _storage_health_section(self, wal_stats: Optional[Dict[str,
                                Any]] = None) -> Dict[str, Any]:
        """The health verb's storage-recovery section (§15): the
        degradation decision (or its absence), WAL error counts and
        the store's corruption-handling evidence — constant shape so
        dashboard queries survive a disk incident arming it.
        ``wal_stats`` lets a caller that already paid the WAL-lock
        round (stats()) pass it in; the default path reads the
        LOCK-FREE evidence counters so a health scrape never blocks
        behind a flush's fsync barrier."""
        if wal_stats is None:
            wal_stats = (self._wal.evidence()
                         if self._wal is not None else {})
        wal_stats = wal_stats or {}
        return {
            "degraded": self._storage_degraded is not None,
            "mode": (self._storage_degraded or {}).get("mode"),
            "reason": (self._storage_degraded or {}).get("errno"),
            "at_flush": (self._storage_degraded or {}).get("at_flush"),
            "wal_errors": int(self.wal_storage_errors),
            "wal_quarantines": int(wal_stats.get("quarantines", 0)),
            "wal_truncations": int(wal_stats.get("truncations", 0)),
        }

    # -- observability plane (docs/ARCHITECTURE.md §11) ---------------------

    def _register_obs_metrics(self) -> None:
        """Hook this service's counters into its metrics registry.

        Everything the hot path already maintains as a plain
        attribute exports through a COLLECTOR (read at export time —
        no double-writing on the flush path); only genuinely new
        instruments (the flush histogram, per-tenant planes) record
        directly."""
        self.obs_registry.collect(self._obs_service_collect)
        self.obs_registry.collect(self._obs_tenant_collect)
        self.obs_registry.collect(self._obs_cost_collect)
        self.obs_registry.collect(self._obs_fault_collect)
        self.obs_registry.collect(self.controller.collect)
        # live device memory: torch's allocator on the service's card,
        # NaN on the CPU (no allocator stats), never a forged 0
        self.obs_registry.gauge(
            "retpu_backend_mem_bytes",
            "bytes the torch allocator holds on the service's device "
            "(NaN on the CPU)", fn=self._backend_mem_bytes)
        self.obs_registry.collect(self._obs_device_mem_collect)

    def _obs_device_mem_collect(self) -> Dict[str, Any]:
        """Per-device memory family (mesh plane telemetry): one
        sample per local device, so an 'ens'-shard imbalance shows up
        as a device-labeled outlier instead of averaging away in the
        default-device gauge."""
        return {
            "retpu_backend_mem_bytes_per_device": obs.registry.family(
                "gauge",
                "bytes the torch allocator holds per visible card "
                "(NaN on the CPU)",
                self._backend_mem_bytes_per_device(), label="device"),
        }

    def _obs_cost_collect(self) -> Dict[str, Any]:
        """Per-bucket F1 cost gauges captured at warmup (labels are
        step buckets: ``k8``, ``k8_a16``, ...): the int32 ops and the
        bytes one step of the bucket needs (``cuda_engine.step_work``,
        the counts PERF.md's bound uses)."""
        return {
            "retpu_step_cost_flops": obs.registry.family(
                "gauge", "F1 int32 ops per step of the bucket",
                {b: c.get("flops") for b, c in
                 self._step_costs.items()
                 if c.get("flops") is not None}, label="bucket"),
            "retpu_step_cost_bytes": obs.registry.family(
                "gauge", "F1 bytes moved per step of the bucket",
                {b: c.get("bytes_accessed") for b, c in
                 self._step_costs.items()
                 if c.get("bytes_accessed") is not None},
                label="bucket"),
        }

    def _obs_fault_collect(self) -> Dict[str, Any]:
        """Injected-fault gauges (docs/ARCHITECTURE.md §13): always
        registered — zeros on a clean box — so a dashboard's queries
        don't change shape when a nemesis arms, and a nonzero
        ``retpu_fault_active`` is the one-glance nemesis flag."""
        def fam(typ, help, val):
            return obs.registry.family(typ, help, {None: val})

        fp = faults.plan()
        c = (fp.counters() if fp is not None else {})
        return {
            "retpu_fault_active": fam(
                "gauge", "1 while a fault-injection plan with live "
                "rules is armed in this process",
                int(fp is not None and fp.active())),
            "retpu_fault_dropped_frames_total": fam(
                "counter", "frames blackholed by injected "
                "directional drops", c.get("dropped_frames", 0)),
            "retpu_fault_delayed_frames_total": fam(
                "counter", "frames delayed by injected per-link RTT",
                c.get("delayed_frames", 0)),
            "retpu_fault_delay_injected_ms_total": fam(
                "counter", "total injected per-link delay",
                c.get("delay_injected_ms", 0.0)),
            "retpu_fault_reordered_frames_total": fam(
                "counter", "adjacent frame pairs swapped by injected "
                "reorder", c.get("reordered_frames", 0)),
            "retpu_fault_fsync_delays_total": fam(
                "counter", "WAL fsync barriers delayed by injection",
                c.get("fsync_delays", 0)),
            "retpu_fault_fsync_delay_injected_ms_total": fam(
                "counter", "total injected fsync delay",
                c.get("fsync_delay_injected_ms", 0.0)),
            # storage fault plane + recovery evidence (§15): same
            # always-registered discipline — zeros on a clean box
            "retpu_fault_storage_errors_total": fam(
                "counter", "injected EIO/ENOSPC storage errors "
                "raised on write/fsync paths",
                c.get("storage_errors_injected", 0)),
            "retpu_fault_torn_writes_total": fam(
                "counter", "injected torn (truncated mid-record) "
                "writes", c.get("torn_writes_injected", 0)),
            "retpu_fault_corrupt_reads_total": fam(
                "counter", "injected bit-flip read corruptions",
                c.get("corrupt_reads_injected", 0)),
            "retpu_recovery_degraded": fam(
                "gauge", "1 while the service is storage-degraded "
                "(read-only / stepped down after WAL EIO/ENOSPC)",
                int(self._storage_degraded is not None)),
            "retpu_recovery_wal_errors_total": fam(
                "counter", "WAL OSErrors observed on the ack path",
                self.wal_storage_errors),
            "retpu_recovery_wal_quarantined_total": fam(
                "counter", "unreplayable WAL logs quarantined aside "
                "(.corrupt.<n>)",
                (self._wal.evidence().get("quarantines", 0)
                 if self._wal is not None else 0)),
        }

    def _flight_extras(self) -> Dict[str, Any]:
        """Flight-dump sections beyond the flush ring (schema v2):
        the per-op SLO tail (slowest acked entries with their stage
        splits), the recent compile events, and — while a fault plan
        is armed — the injected-fault state (so an anomaly dump
        captured mid-nemesis indicts the nemesis, not the code)."""
        fp = faults.active_plan()
        return {
            "slow_ops": (self._slo.slowest(5)
                         if self._slo is not None else []),
            "compile_events": list(self._compile_log),
            "injected_faults": (fp.describe()
                                if fp is not None else {}),
            # the controller's newest journaled decisions: an anomaly
            # captured while the control loop was moving knobs shows
            # WHICH knob moved, and why, next to the flush it hit
            "controller_decisions": self.controller.flight_section(),
        }

    def _obs_service_collect(self) -> Dict[str, Any]:
        def fam(typ, help, val):
            # the collector-family shape lives in obs.registry.family
            return obs.registry.family(typ, help, {None: val})

        occ = (self._occ_sum / self._occ_launches
               if self._occ_launches else 1.0)
        return {
            "retpu_flushes_total": fam(
                "counter", "settled device launches", self.flushes),
            "retpu_ops_served_total": fam(
                "counter", "client ops resolved (fast reads included)",
                self.ops_served),
            "retpu_corruptions_total": fam(
                "counter", "integrity-gate detections",
                self.corruptions),
            "retpu_repairs_total": fam(
                "counter", "replicas the exchange healed",
                self.repairs),
            "retpu_read_fastpath_hits_total": fam(
                "counter", "mirror-served leased reads",
                self.read_fastpath_hits),
            "retpu_read_fastpath_misses_total": fam(
                "counter", "fast-path fallbacks to the device round",
                self.read_fastpath_misses),
            "retpu_svc_backpressure_total": obs.registry.family(
                "counter", "front-end backpressure events (inflight-"
                "cap stalls, slow-reader write-buffer drops)",
                dict(self.svc_backpressure), label="kind"),
            "retpu_rmw_conflicts_total": fam(
                "counter", "host-path kmodify CAS retries",
                self.rmw_conflicts),
            "retpu_rmw_device_fastpath_total": fam(
                "counter", "single-round device RMW commits",
                self.rmw_device_fastpath),
            "retpu_payload_bytes_total": fam(
                "counter", "packed d2h bytes actually fetched",
                self.payload_bytes),
            "retpu_payload_bytes_full_width_total": fam(
                "counter", "what the full-width [K, E] layout would "
                "have moved", self.payload_bytes_full_width),
            "retpu_wal_compactions_total": fam(
                "counter", "WAL folds into a fresh checkpoint",
                self.wal_compactions),
            "retpu_wide_launches_total": fam(
                "counter", "launches through the wide scheduler",
                self.wide_launches),
            "retpu_flight_anomalies_total": fam(
                "counter", "flight-recorder trigger firings (flush "
                "> 5x rolling p50)", self.flight.anomalies),
            "retpu_queued_ops": fam(
                "gauge", "device rounds currently queued",
                sum(self._queue_rounds[e] for e in self._active)),
            "retpu_launches_in_flight": fam(
                "gauge", "dispatched-but-unresolved launches",
                len(self._inflight)),
            "retpu_lease_valid_fraction": fam(
                "gauge", "live rows holding a margin-valid lease",
                round(self._lease_valid_fraction(), 4)),
            "retpu_grid_occupancy": fam(
                "gauge", "mean packed-grid occupancy (a_width / E)",
                round(occ, 4)),
            "retpu_live_payloads": fam(
                "gauge", "host payload-store entries",
                len(self.values)),
            "retpu_ensembles_with_leader": fam(
                "gauge", "rows with a live leader",
                int((self.leader_np >= 0).sum())),
            # process-global by construction (the span store is):
            # every service in the process exports the same counts,
            # which is what a scrape of any one of them should see
            "retpu_span_misses_total": obs.registry.family(
                "counter", "span-store lookups that missed, by "
                "reason (evicted = rolled off the bounded ring; "
                "unknown = this process never recorded the fid)",
                dict(obs.SPANS.misses), label="reason"),
        }

    # -- fleet-scope surfaces (docs/ARCHITECTURE.md §11) --------------------

    def _fleet_self_label(self) -> str:
        """This service's host label in fleet answers: the group
        identity peers dial it by when one exists, else
        hostname:pid — stable within a process, distinct across the
        fleet."""
        addr = getattr(self, "self_addr", None)
        if addr:
            return f"{addr[0]}:{addr[1]}"
        import socket as _socket
        return f"{_socket.gethostname()}:{os.getpid()}"

    def fleet_metrics(self, fmt: Optional[str] = None):
        """Fleet metrics: every host's registry under ``host``
        labels.  On a standalone service (the port has no replication
        group yet) the fleet is this host alone.  ``fmt="prometheus"``
        answers ONE merged scrape document."""
        label = self._fleet_self_label()
        if fmt == "prometheus":
            return obs.merge_prometheus(
                {label: self.obs_registry.render_prometheus()})
        return {"schema": "retpu-fleet-metrics-v1",
                "hosts": {label: self.obs_registry.snapshot()},
                "clock": {}}

    def fleet_health(self) -> Dict[str, Any]:
        """Fleet health: every host's ``health()`` section keyed by
        host label (standalone: this host alone)."""
        return {"schema": "retpu-fleet-health-v1",
                "hosts": {self._fleet_self_label(): self.health()},
                "clock": {}}

    def fleet_timeline(self, flush_id: int) -> Dict[str, Any]:
        """Clock-aligned cross-host ``obs.timeline``: on a standalone
        service the local record on a trivial axis (in-process
        replica lanes share the store, so their roles ride along);
        the replicated override pulls subprocess replicas' records
        and maps them through the per-link offsets."""
        tl = obs.SPANS.timeline(int(flush_id))
        sides = {} if (not tl or tl.get("miss")) else \
            {r: s for r, s in tl.items() if r != "flush_id"}
        out = obs.align_timeline(int(flush_id), sides, {},
                                 self._fleet_self_label())
        if tl and tl.get("miss"):
            out["miss"] = tl["miss"]
        return out

    def set_tenant_label(self, ens: int, label: Any) -> None:
        """Name a row for per-tenant attribution (dynamic rows are
        already labeled by their create_ensemble name)."""
        self._tenant_labels[int(ens)] = label

    def tenant_label(self, ens: int) -> str:
        lbl = self._tenant_labels.get(ens)
        if lbl is None:
            lbl = self._row_name.get(ens)
        return str(lbl) if lbl is not None else f"ens{ens}"

    def _drop_tenant_series(self, row: int) -> None:
        """Drop ``row``'s labeled registry series on recycle — unless
        another row still serves under the same label.  A tenant
        spanning several ensemble rows is ONE tenant in every export
        (``_tenant_groups``), so recycling one of its rows must not
        reset the survivors' live counters."""
        lbl = self.tenant_label(row)
        for e in set(self._tenant_labels) | set(self._row_name):
            if e != row and 0 <= e < self.n_ens \
                    and self.tenant_label(e) == lbl:
                return
        self.obs_registry.remove_labeled(lbl)

    def _tenant_groups(self, top: int = 16
                       ) -> "List[Tuple[str, List[int]]]":
        """Label -> rows worth exporting: every NAMED tenant plus the
        top-N rows by op count, capped at 64 LABELS ranked by ops (a
        10k-row service exports dozens of tenants, not 10k — and the
        cap keeps the noisy ones, not the lowest row indices).  Rows
        sharing a label group together: a tenant spanning several
        ensemble rows is ONE tenant in every export."""
        rows = set(self._tenant_labels) | set(self._row_name)
        if top and self.tenant_ops.any():
            hot = np.argsort(self.tenant_ops)[-top:]
            rows.update(int(e) for e in hot if self.tenant_ops[e] > 0)
        groups: Dict[str, List[int]] = {}
        for e in rows:
            if 0 <= e < self.n_ens:
                groups.setdefault(self.tenant_label(e), []).append(e)
        ranked = sorted(
            groups.items(),
            key=lambda kv: (-int(self.tenant_ops[kv[1]].sum()),
                            kv[0]))
        return [(lbl, sorted(rr)) for lbl, rr in ranked[:64]]

    def _tenant_pctl(self, rows: List[int], q: float) -> float:
        """Bucket-resolution quantile (ms) over a tenant's (possibly
        multi-row) op-latency histogram — obs.Histogram's estimator."""
        counts = self._tenant_lat[rows].sum(axis=0)
        return obs.registry.percentile_from_counts(
            counts.tolist(), self._lat_edges, q)

    def tenant_stats(self, top: int = 16) -> Dict[str, Dict[str, Any]]:
        """Per-tenant attribution snapshot: ops, committed rounds,
        put payload bytes, device-round share (fraction of this
        service's launches the tenant's rows were active in), and
        p50/p99 op latency — the noisy-neighbor evidence surface."""
        out: Dict[str, Dict[str, Any]] = {}
        launches = max(self._launches_total, 1)
        for lbl, rows in self._tenant_groups(top):
            out[lbl] = {
                "rows": rows,
                "ops": int(self.tenant_ops[rows].sum()),
                "commits": int(self.tenant_commits[rows].sum()),
                "put_bytes": int(self.tenant_bytes[rows].sum()),
                "device_rounds": int(self.tenant_rounds[rows].sum()),
                "device_round_share": round(
                    float(self.tenant_rounds[rows].sum()) / launches,
                    4),
                "p50_ms": round(self._tenant_pctl(rows, 0.5), 3),
                "p99_ms": round(self._tenant_pctl(rows, 0.99), 3),
            }
        return out

    def _obs_tenant_collect(self) -> Dict[str, Any]:
        groups = self._tenant_groups()
        launches = max(self._launches_total, 1)

        def fam(typ, help, per_group):
            return obs.registry.family(
                typ, help, {lbl: per_group(rows)
                            for lbl, rows in groups})

        return {
            "retpu_tenant_ops_total": fam(
                "counter", "keyed + fast-read ops per tenant",
                lambda rr: int(self.tenant_ops[rr].sum())),
            "retpu_tenant_commits_total": fam(
                "counter", "committed device rounds per tenant",
                lambda rr: int(self.tenant_commits[rr].sum())),
            "retpu_tenant_put_bytes_total": fam(
                "counter", "put payload bytes per tenant",
                lambda rr: int(self.tenant_bytes[rr].sum())),
            "retpu_tenant_device_rounds_total": fam(
                "counter", "launches the tenant's rows were active in",
                lambda rr: int(self.tenant_rounds[rr].sum())),
            "retpu_tenant_device_round_share": fam(
                "gauge", "fraction of this service's launches",
                lambda rr: round(
                    float(self.tenant_rounds[rr].sum()) / launches,
                    4)),
            "retpu_tenant_op_p50_ms": fam(
                "gauge", "tenant op latency p50 (each entry charged "
                "its measured submit-to-ack time, per-op SLO ring)",
                lambda rr: round(self._tenant_pctl(rr, 0.5), 3)),
            "retpu_tenant_op_p99_ms": fam(
                "gauge", "tenant op latency p99 (each entry charged "
                "its measured submit-to-ack time, per-op SLO ring)",
                lambda rr: round(self._tenant_pctl(rr, 0.99), 3)),
        }

    def _obs_account_taken(self, taken, committed,
                           t_settle: Optional[float] = None,
                           rec: Optional[Dict[str, float]] = None,
                           fid: int = 0,
                           t_join: float = 0.0,
                           ent_meta=None) -> None:
        """Per-tenant + per-op attribution for one resolved flush:
        ONE pass over the taken entries (C-level attrgetter per
        entry) feeding vectorized folds — O(|entries|) appends, not
        per-op Python dicts.

        The per-op SLO ring records each entry's REAL client-
        perceived submit→ack latency (an entry's ops share its
        stamps — batch granularity within an entry, entry granularity
        within the flush; the join/settle/ack times are the flush's,
        shared); the fold targets are the per-kind
        ``retpu_op_latency_ms`` histogram, the per-tenant ``[E, B]``
        plane, and the span store (the flush's slowest entry attaches
        under ``slow_ops`` with its stage split, so
        ``obs.timeline(fid)`` resolves a tail op to queue wait vs
        flush vs ack).  Leased fast reads contribute their own
        samples from the hit hook.  ``t_settle`` is when the flush's
        outcome was known (on a replicated leader: AFTER the host
        quorum — ack stamps land after quorum settle by
        construction); ``rec`` is the launch's latency record,
        consulted for the slow entry's dominating flush mark."""
        now = time.perf_counter()
        rows: List[int] = [e for e, _ops in taken]
        if not rows:
            return
        if ent_meta is not None:
            # stamps sourced from the ENQUEUE-time pending slab (the
            # slab path collects the per-entry columns while the
            # flush walk builds its op lanes) — the settle fold never
            # re-walks entries whose futures are completion-slab rows
            kk_l, enss, nn_l, ts_l, te_l = ent_meta
        else:
            cols: List[Tuple] = []  # (kind, n, t_sub, t_enq)/entry
            enss = []
            fields = _OP_SLO_FIELDS
            for e, ops in taken:
                cols.extend(map(fields, ops))
                enss.extend([e] * len(ops))
            if cols:
                kk_l, nn_l, ts_l, te_l = zip(*cols)
            else:
                kk_l = nn_l = ts_l = te_l = ()
        rr = np.asarray(rows, np.int64)
        if committed is not None:
            np.add.at(self.tenant_commits, rr,
                      committed[:, rr].sum(axis=0).astype(np.int64))
        if not enss:
            return
        w = np.asarray(nn_l, np.int64)
        ee = np.asarray(enss, np.int64)
        np.add.at(self.tenant_ops, ee, w)
        if self._slo is None:
            return
        folded = self._slo.record_flush(
            kk_l, enss, nn_l, ts_l, te_l, fid,
            t_join if t_join else (t_settle or now),
            t_settle if t_settle else now, now)
        if folded is None:
            return
        _phys, lat_ms = folded
        bidx = np.searchsorted(self._lat_edges, lat_ms)
        # per-tenant: each entry's ops charged the entry's own
        # client-perceived latency (replacing PR 6's flush-oldest
        # upper bound with the measured per-entry value)
        np.add.at(self._tenant_lat, (ee, bidx), w)
        # per-kind registry histogram: fold bucket counts per kind
        # present in this flush (<= 5 kinds, B buckets — bounded)
        kk = np.asarray(kk_l, np.int16)
        nb = len(self._lat_edges) + 1
        for kcode in np.unique(kk):
            sel = kk == kcode
            child = self._h_op.labels(
                obs.opslo.KIND_NAMES[int(kcode)])
            counts = np.bincount(bidx[sel], weights=w[sel],
                                 minlength=nb)
            ccounts = child.counts
            for bi in np.nonzero(counts)[0]:
                ccounts[bi] += int(counts[bi])
            child.count += int(w[sel].sum())
            child.sum += float((lat_ms[sel] * w[sel]).sum())
        # tail attachment: the flush's slowest entry joins the span
        # record under its flush_id, with the launch's dominating
        # mark riding along when the record is at hand.  Built from
        # THIS call's locals, never from the ring row — a flush wider
        # than the ring capacity recycles physical rows within one
        # record_flush, and reading the row back would attach a
        # different entry's identity to the tail sample.
        i = int(np.argmax(lat_ms))
        t_sub_i = ts_l[i] if ts_l[i] > 0.0 else te_l[i]
        tj = t_join if t_join else (t_settle or now)
        tst = t_settle if t_settle else now
        slow = {
            "kind": obs.opslo.KIND_NAMES[int(kk_l[i])],
            "ens": int(enss[i]),
            "n": int(nn_l[i]),
            "flush_id": int(fid),
            "ms": round(max(0.0, now - t_sub_i) * 1e3, 3),
            "stages_ms": {
                "assign": round(max(0.0, te_l[i] - t_sub_i) * 1e3, 3),
                "queue_wait": round(max(0.0, tj - te_l[i]) * 1e3, 3),
                "flush": round(max(0.0, tst - tj) * 1e3, 3),
                "ack": round(max(0.0, now - tst) * 1e3, 3),
            },
        }
        if rec is not None:
            marks = {c: v for c, v in rec.items()
                     if isinstance(v, (int, float))
                     and c not in obs.flightrec.META_FIELDS}
            if marks:
                slow["flush_mark"] = max(marks, key=marks.get)
        if fid:
            obs.SPANS.record(fid, "leader", [], slow_ops=[slow])

    def _obs_note_put_bytes(self, ens: int, handles) -> None:
        """Attribute queued put payload bytes to the row's tenant
        (handles may include 0 = tombstone and -1-style sentinels —
        both length-less)."""
        values = self.values
        total = 0
        for h in handles:
            if h and h > 0:
                v = values.get(h)
                try:
                    total += len(v)
                except TypeError:
                    pass
        if total:
            self.tenant_bytes[ens] += total

    def _obs_flush_settled(self, fl: _InFlightLaunch) -> None:
        """Feed one settled launch into the obs plane: the flush
        histogram, the leader span record (joined with replica spans
        by flush_id), and the flight-recorder ring + anomaly
        trigger."""
        rec = fl.rec
        total = rec.get("total", 0.0)
        self._h_flush.record(total * 1e3)
        # (re-)attach the dump extras provider: tests replace the
        # recorder to lower its trigger thresholds, and the per-op
        # tail + compile-event sections must survive that
        self.flight.extras = self._flight_extras
        obs.SPANS.record(
            fl.flush_id, "leader",
            # META_FIELDS (incl. the derived 'enqueue' = h2d +
            # dispatch) are identity/derived, not spans — including
            # them would double-count a summed timeline
            [(c, v) for c, v in rec.items()
             if c not in obs.flightrec.META_FIELDS],
            k=fl.k, a_width=fl.a_width, total_s=total,
            payload_bytes=fl.payload_nbytes,
            # the fleet-timeline alignment anchor: this role's spans
            # lay out sequentially ENDING here (record time on THIS
            # process's monotonic clock — the clock the per-link
            # offset estimates map between)
            t_mono=time.monotonic())
        self.flight.record({
            "flush_id": fl.flush_id, "t": time.time(),
            "k": fl.k, "a_width": fl.a_width,
            "payload_bytes": fl.payload_nbytes,
            "queued_rounds": sum(self._queue_rounds[e]
                                 for e in self._active),
            "in_flight": len(self._inflight),
            **rec})
        if self._autotune:
            # the runtime controller's cadence: one counted flush,
            # one integer compare; evaluations run every
            # RETPU_AUTOTUNE_CADENCE settled flushes (§14).  Inside
            # the obs-gated settle hook on purpose: the controller
            # CONSUMES the obs plane, so RETPU_OBS=0 starves it too.
            self.controller.tick(fl.flush_id)

    def _backend_mem_bytes(self) -> float:
        """Bytes torch's allocator holds on the service's card (export
        time only); NaN on the CPU, which keeps no allocator stats."""
        if self.device.type != "cuda":
            return float("nan")
        return float(torch.cuda.memory_allocated(self.device))

    def _backend_mem_bytes_per_device(self) -> Dict[str, float]:
        """:meth:`_backend_mem_bytes` for every visible card and every
        card a mesh engine's shards sit on, keyed by index ({"0": NaN}
        for a CPU service) — an 'ens'-shard imbalance shows here and not
        in the default-device gauge (batched_host.py:206-218)."""
        if self.device.type != "cuda":
            return {"0": float("nan")}
        idx = set(range(torch.cuda.device_count()))
        mesh = getattr(self.engine, "mesh", None)
        if mesh is not None:
            idx |= {mesh.devices[i][j].index
                    for i, j in mesh.local_shards()}
        return {str(i): float(torch.cuda.memory_allocated(i))
                for i in sorted(idx)}

    def _on_compile_event(self, ev: Dict[str, Any]) -> None:
        """One library finished building (:func:`..ops.build.
        add_listener`): count it by phase — "warmup" inside
        :meth:`warmup`, else "serve" (a first use that paid its build
        inside a client's latency) — and keep it for the flight dumps."""
        phase = "warmup" if self._in_warmup else "serve"
        self._c_compile.labels(phase).inc()
        self._c_compile_ms.labels(phase).inc(ev.get("compile_ms", 0.0))
        self._compile_log.append({**ev, "phase": phase})

    # -- warmup: the builds, the pinned slots, one launch per bucket -------

    def _a_ladder(self) -> List[Optional[int]]:
        """Active-column bucket widths a launch can pack at: full width
        (None) plus, with compaction on, the pow2 ladder from
        ``A_BUCKET_MIN`` strictly below E (batched_host.py:4783-4798) —
        below the LOCAL width E / n_shards for a shard-wise mesh, which
        buckets per shard."""
        ladder: List[Optional[int]] = [None]
        if self._compact:
            top = self.n_ens // max(self._mesh_shards, 1)
            b = A_BUCKET_MIN
            while b < top:
                ladder.append(b)
                b <<= 1
        return ladder

    def warmup(self, buckets=None, capture_costs=None) -> None:
        """Pay every first-use cost before serving (batched_host.py:
        4800-4975): the port's counterpart of the reference's compile is
        a library build and a first launch.  Builds the libraries the
        service launches (:func:`..ops.build.build_all`: the CUDA
        kernels on a card, the host library on the native arms),
        allocates the pinned upload slots of every pipeline slot at the
        widest launch, and launches the step once per (K, A) bucket — K
        in {0, 1, 2, 4, ..., max_k}, A the :meth:`_a_ladder` — on a
        THROWAWAY state, never ``self.state``: the sliced step where the
        launch path would slice, else the pack-gather pack, plus the
        full-width packs with and without versions.  With ``wide`` on it
        also launches the wide step at every (G, W) the gate admits (G in
        {1, 2}, pow2 W up to the flush depth's pow2) with its A ladder,
        and sizes the pinned slots for the widest wide launch
        (batched_host.py:4959-4976).

        ``buckets``: optional ``(k, a_width)`` pairs (a_width None = full
        width) restricting the A grid; the K ladder always runs in full.
        A shard-wise mesh warms each bucket as ``[n_shards, A_loc]``
        per-shard index rows (batched_host.py:4930-4934).
        ``capture_costs``: F1's op and byte counts per bucket
        (``retpu_step_cost_flops`` / ``_bytes``): None = the deepest
        full-width bucket only, True = every bucket, False = none.
        Builds during the call count under ``phase="warmup"``."""
        self._in_warmup = True
        try:
            self._warmup(buckets, capture_costs)
        finally:
            self._in_warmup = False

    def _warmup(self, buckets, capture_costs) -> None:
        from riak_ensemble_tpu_torch.ops.cuda_engine import step_work

        e, m, s = self.n_ens, self.n_peers, self.n_slots
        dev = self.device
        if dev.type == "cuda":
            build.build_all(host=self._wal_native)
        by_k: Optional[Dict[int, List[Optional[int]]]] = None
        if buckets is not None:
            by_k = {}
            for kb, aw in buckets:
                by_k.setdefault(int(kb), []).append(aw)
        ladder = self._a_ladder()
        step, step_wide, step_sliced, step_wide_sliced = self._step_fns()
        wide = self._wide and step_wide is not None
        # the wide gate admits G in {1, 2} and pow2 W up to the flush
        # depth's pow2 (batched_host.py:4959-4976)
        w_max = 1 << (max(self.max_k, 1) - 1).bit_length()
        rounds = max(self.max_k, 2 * w_max if wide else 0)
        if self._uploads.pinned:
            # every slot's buffers at the widest launch (a wide plan's
            # G*W rounds included): no first flush pays a pinned
            # allocation
            widest = max((a for a in ladder if a is not None), default=0)
            for _ in range(len(self._uploads._slots)):
                ups = self._uploads
                ups.begin()
                for name in ("kind", "slot", "val", "exp_e", "exp_s"):
                    ups.buffer(name, (rounds, e), torch.int32)
                ups.buffer("lease", (rounds, e), torch.bool)
                ups.buffer("elect", (e,), torch.bool)
                ups.buffer("cand", (e,), torch.int32)
                ups.buffer("aidx", (widest,), torch.int32)
                ups.buffer("out", (packed_nbytes(e, m, rounds, True),),
                           torch.uint8)
        st = self.engine.init_state(e, m, s, device=dev)
        v = int(st.view_mask.shape[1])
        if self._mesh_shards and dev.type == "cuda":
            # the shard-wise pack copies into one host buffer per launch
            for _ in range(len(self._uploads._slots)):
                self._uploads.begin()
                self._uploads.buffer("out", (self._mesh_shards * (
                    packed_nbytes(e // self._mesh_shards, m, rounds,
                                  True)),), torch.uint8)
        elect = torch.zeros((e,), dtype=torch.bool, device=dev)
        cand = torch.zeros((e,), dtype=torch.int32, device=dev)
        up = torch.ones((e, m), dtype=torch.bool, device=dev)

        def cost(key: str, k: int, rows: int, a: int) -> None:
            nbytes, ops = step_work(rows, m, s, v, k, a)
            self._step_costs[key] = {"flops": float(ops),
                                     "bytes_accessed": float(nbytes)}

        def warm_widths(k_eff: int, won, res, gw=None) -> None:
            """The A ladder of one K bucket (a wide (G, W) one when
            ``gw``): the sliced step where the launch path would slice,
            else the pack-gather pack."""
            nonlocal st
            widths = ([] if k_eff == 0 else
                      by_k.get(k_eff, []) if by_k is not None else ladder)
            have = step_wide_sliced if gw else step_sliced
            for aw in widths:
                if aw is None:
                    continue
                if self._mesh_shards:
                    self._pack(won, res, True, active_idx=np.zeros(
                        (self._mesh_shards, aw), np.int32), wide=gw)
                elif have is not None and e >= SLICE_MIN_E \
                        and aw * 4 <= e:
                    # all pads: every row index is E, so nothing is
                    # stepped and the state stays as it was
                    aidx = np.full((aw,), e, np.int32)
                    shape = (gw[0], aw, gw[1]) if gw else (k_eff, aw)
                    kind_a = torch.zeros(shape, dtype=torch.int32,
                                         device=dev)
                    st, won_a, res_a = have(
                        st, aidx, elect[:aw], cand[:aw], kind_a, kind_a,
                        kind_a, kind_a.bool(), up, exp_epoch=kind_a,
                        exp_seq=kind_a)
                    if gw:
                        res_a = _wide_to_packed_layout(res_a, gw[0], gw[1],
                                                       aw)
                    _pack_results_body(won_a, res_a, True)
                    if self._obs and capture_costs and not gw:
                        cost(f"k{k_eff}_a{aw}", k_eff, aw, aw)
                else:
                    aidx_t = torch.zeros((aw,), dtype=torch.int32,
                                         device=dev)
                    self._pack(won, res, True, active_idx=aidx_t, wide=gw)

        k = 0
        while True:
            kind = torch.zeros((k, e), dtype=torch.int32, device=dev)
            lease = torch.zeros((k, e), dtype=torch.bool, device=dev)
            st, won, res = step(st, elect, cand, kind, kind, kind, lease,
                                up, exp_epoch=kind, exp_seq=kind)
            if (self._obs and capture_costs is not False
                    and (capture_costs or k >= self.max_k)):
                cost(f"k{k}", k, e, e)
            self._pack(won, res, True)
            self._pack(won, res, False)
            warm_widths(k, won, res)
            if k >= self.max_k:
                break
            k = 1 if k == 0 else k * 2
        if wide:
            for g in (1, 2):
                w = 1
                while w <= w_max:
                    kind = torch.zeros((g, e, w), dtype=torch.int32,
                                       device=dev)
                    st, won, res = step_wide(
                        st, elect, cand, kind, kind, kind, kind.bool(), up,
                        exp_epoch=kind, exp_seq=kind)
                    self._pack(won, res, True, wide=(g, w))
                    self._pack(won, res, False, wide=(g, w))
                    warm_widths(g * w, won, res, gw=(g, w))
                    w *= 2
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

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
        bad = node_bad.cpu().numpy() | leaf_bad.cpu().numpy()  # [E, M]
        found = int(bad.sum())
        if not found:
            return {"replicas_damaged": 0, "replicas_healed": 0,
                    "ensembles_swept": 0}
        run = bad.any(1)
        self.corruptions += found
        snapshot = self.state
        # on the card the exchange steps the run rows in place: keep them
        restore = self.engine.keep_rows(snapshot, np.flatnonzero(run))
        try:
            self.state, diverged, synced = self.engine.exchange_step(
                self.state, torch.from_numpy(run).to(self.device),
                self._up_device())
            node_bad2, leaf_bad2 = self.engine.verify_trees(self.state)
            still = (node_bad2.cpu().numpy() | leaf_bad2.cpu().numpy()) & bad
        except BaseException:
            restore()
            self.state = snapshot
            raise
        healed = found - int(still.sum())
        self.repairs += int(
            diverged.cpu().numpy()[synced.cpu().numpy()].sum())
        self._corrupt_rows = np.where(run, still.any(1), self._corrupt_rows)
        self._emit("svc_scrub", {"damaged": found, "healed": healed})
        return {"replicas_damaged": found, "replicas_healed": healed,
                "ensembles_swept": int(run.sum())}

    def _safe_resolve(self, fut: Future, result: Any) -> None:
        """Resolve a client future, containing waiter exceptions so one
        client's callback cannot abort the resolve loop."""
        try:
            fut.resolve(result)
        except Exception:
            import traceback
            self.waiter_errors += 1
            self._emit("svc_waiter_error",
                       {"error": traceback.format_exc(limit=8)})

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
                       planes, ack: bool, ack_reads: bool = True,
                       native_mirrors: bool = False) -> None:
        """Resolve one batch entry from result-plane column slices.
        Every committed write updates the fast path's mirrors before
        its result is handed to the client; with ``native_mirrors`` the
        C++ pass already wrote this flush's ``_slot_vsn`` /
        ``_inline_value`` slabs, so only the Python-owned bookkeeping
        runs here.  ``ack=False`` (the WAL write failed) keeps the
        committed writes' bookkeeping but resolves them 'failed';
        ``ack_reads=False`` fails the reads too."""
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
                if ok and ack_reads:
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
                            ack_reads: bool, native_mirrors: bool) -> int:
        """Resolve every taken entry through the flush's COMPLETION SLAB
        (batched_host.py:6134-6229): each result plane is gathered through
        the flush's runs ONCE (``[R]`` records, R = taken rounds), the
        lanes become Python lists once, and each entry resolves from its
        row segment.  Exactly one wake per flush.  Results and mirror
        slabs equal the per-op loops'."""
        committed, get_ok, found, value, vsn = planes
        ent_col, ent_row0, ent_len, n_rows, offs = lanes[:5]
        k, e = committed.shape
        if self._native_enqueue is not None:
            bounds = self._shard_bounds(len(ent_col))
            args = (_u8view(committed), _u8view(get_ok), _u8view(found),
                    np.ascontiguousarray(value, np.int32),
                    np.ascontiguousarray(vsn, np.int32))

            def gather(lo: int, hi: int):
                """Runs [lo, hi): the C++ gather (which releases the
                GIL) and the lists of its records (which hold it)."""
                a0 = offs[lo]
                a1 = offs[hi] if hi < len(ent_col) else n_rows
                g = self._native_enqueue.gather(
                    k, e, ent_col[lo:hi], ent_row0[lo:hi], ent_len[lo:hi],
                    *args, a1 - a0)
                # (epoch, seq) as tuples of ints, not R two-int lists:
                # the GC untracks such tuples, while R live lists survive
                # into the old generation and bring its full collections
                # sooner
                return g, [a.tolist() for a in g[:4]] + [
                    list(zip(*g[4].T.tolist()))]
            if bounds is not None:
                # the sharded gather (batched_host.py:6151-6185): chunk
                # [lo, hi) covers slab rows [offs[lo], offs[hi]); records
                # and lists concatenate in chunk order, element-equal to
                # the one-pass gather
                chunks = self._shard_map(gather, bounds)
                got = tuple(np.concatenate([c[0][i] for c in chunks])
                            for i in range(5))
                lists = [sum((c[1][i] for c in chunks), [])
                         for i in range(5)]
            else:
                got, lists = gather(0, len(ent_col))
        else:
            got = enqueue_native.gather_plain(
                k, e, ent_col, ent_row0, ent_len, committed, get_ok, found,
                value, vsn, n_rows)
            lists = [a.tolist() for a in got[:4]] + [
                list(zip(*got[4].T.tolist()))]
        ok_l, gok_l, fnd_l, val_l, vs_l = lists
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
                        ack, ack_reads, native_mirrors, got, off)
                else:
                    self._resolve_scalar_slab(
                        e, op, ok_l[off], gok_l[off], fnd_l[off],
                        val_l[off], tuple(vs_l[off]), ack, ack_reads,
                        native_mirrors)
                served += op.n
        return served

    def _resolve_batch_slab(self, e: int, op: _PendingBatch, comm_l,
                            gok_l, fnd_l, val_l, vs_l, ack: bool,
                            ack_reads: bool, native_mirrors: bool,
                            np_lanes, off: int) -> None:
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
            if not ack_reads:
                gok_l = [False] * n
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
                             ack_reads: bool, native_mirrors: bool
                             ) -> None:
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
        elif gok and ack_reads:  # OP_GET
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
                       ack: bool = True, ack_reads: bool = True) -> int:
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
        reads still serve (batched_host.py:6484-6500).  ``ack_reads=False``
        fails the reads too: a replication group passes it when the HOST
        quorum was lost, where a read would be a minority leader's."""
        # the per-op SLO settle stamp: when this flush's outcome is known
        t_settle = time.perf_counter() if self._obs else 0.0
        taken, lanes = fl.taken or [], fl.lanes
        committed, get_ok, found, value, vsn = planes
        if committed is None:  # k == 0: election-only launch, no ops
            assert not taken, "ops taken but no result planes"
            self._drain_recycles()
            return 0
        native_mirrors = False
        if self._native_resolve is not None and taken:
            t0 = time.perf_counter()
            cols = np.fromiter((e for e, _ops in taken), np.int32,
                               len(taken))
            kcounts = np.fromiter((sum(op.n for op in ops)
                                   for _e, ops in taken), np.int32,
                                  len(taken))
            def scatter(lo: int, hi: int) -> None:
                self._native_resolve.scatter_mirrors(
                    self.n_ens, self.n_slots, fl.kind_np, fl.op_slot_np,
                    committed, get_ok, found, value, vsn, cols[lo:hi],
                    kcounts[lo:hi], ack_reads,
                    (eng.OP_PUT, eng.OP_CAS, eng.OP_GET, eng.OP_RMW),
                    self._slot_vsn_np, self._slot_vsn_ok,
                    self._inline_value_np, self._inline_value_ok,
                    self._inline_np)
            bounds = self._shard_bounds(len(cols))
            if bounds is not None:
                # the sharded mirror scatter (batched_host.py:6539-6567):
                # chunks split the taken COLUMNS, each column is taken at
                # most once, so chunks write disjoint mirror rows
                self._shard_map(scatter, bounds)
            else:
                scatter(0, len(cols))
            native_mirrors = True
            fl.rec["resolve_native"] = (fl.rec.get("resolve_native", 0.0)
                                        + time.perf_counter() - t0)
        if lanes is not None and taken:
            served = self._resolve_taken_slab(taken, planes, lanes, ack,
                                              ack_reads, native_mirrors)
            self.ops_served += served
            if self._obs:
                self._obs_account_taken(taken, committed, t_settle,
                                        fl.rec, fl.flush_id, fl.t_join,
                                        ent_meta=lanes[5])
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
                                        ack_reads, native_mirrors)
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
                elif get_ok_l[j][e] and ack_reads:
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
        if self._obs and taken:
            self._obs_account_taken(taken, committed, t_settle, fl.rec,
                                    fl.flush_id, fl.t_join)
        self._drain_recycles()
        return served

    # -- durability: the WAL barrier, checkpoints, restore -------------------

    def _wal_extra_records(self) -> List[Tuple[Any, Any]]:
        """Records a subclass persists in the SAME durability barrier as
        a flush's committed writes (one log call, one sync;
        batched_host.py:5756-5762): the replication group rides its
        (epoch, seq) meta here, so a leader restart never reads its own
        data-bearing position as an older one."""
        return []

    def _log_wal(self, taken, planes, rec=None) -> None:
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
                and self._log_wal_native(taken, planes, rec)):
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
            self._wal.log(recs + self._wal_extra_records())

    def _log_wal_native(self, taken, planes, rec=None) -> bool:
        """The single-pass WAL encode (batched_host.py:5834-5930): gather
        the flush's write lanes and joined key / payload arenas, pickle
        every record in one C++ pass (:meth:`.resolve_native.
        NativeResolve.wal_encode`) and append the arena verbatim
        (:meth:`.wal.ServiceWAL.log_arena`).  Returns False when a lane
        lies outside the pass's subset — a scalar write, a key that is
        not a str, a payload that is neither bytes nor None, a non-ASCII
        key, or a record of 64 KiB or more — and the caller's Python walk
        then logs EVERY record, so the order within the flush holds.  The
        encode's time joins ``rec``'s ``resolve_native`` mark."""
        t0 = time.perf_counter()
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
        if rec is not None:
            rec["resolve_native"] = (rec.get("resolve_native", 0.0)
                                     + time.perf_counter() - t0)
        if len(idx):
            self._wal.log_arena(arena, idx, self._wal_extra_records())
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
                       for e, s, v, ve, vs in zip(*cols)]
                      + self._wal_extra_records())

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
            "desired_view": self._desired_view_np,
            "desired_mask": self._desired_mask,
            "queued_view": self._queued_view_np,
            "queued_mask": self._queued_mask,
            "pending_view": self._pending_view_np,
            "pending_mask": self._pending_mask,
            "up": self.up,
            "dynamic": self.dynamic,
            "live": self._live,
            "free_rows": self._free_rows,
            "ens_names": self._ens_names,
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
        ``data_dir=path`` to keep logging.  Leases start expired.  The
        persisted ``dynamic`` mode wins; a ``dynamic`` argument that
        contradicts it raises."""
        n = cls._current_ckpt(path)
        d = os.path.join(path, f"ckpt.{n}")
        raw = savelib.read(os.path.join(d, "host"))
        if raw is None:
            meta_raw = savelib.read(os.path.join(path, "META"))
            if meta_raw is None:
                raise FileNotFoundError(f"no service checkpoint at {path}")
            meta = pickle.loads(meta_raw)
            kw = cls._merge_dynamic(kw, bool(meta.get("dynamic", False)))
            svc = cls(runtime, *meta["shape"], **kw)
            svc._replay_wal_from(path, 0)
            return svc
        host = pickle.loads(raw)
        kw = cls._merge_dynamic(kw, bool(host["dynamic"]))
        n_ens, n_peers, n_slots = host["shape"]
        svc = cls(runtime, n_ens, n_peers, n_slots, **kw)
        svc.state = svc.engine.shard_state(
            checkpoint.load_state(d, svc.device))
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
        svc._desired_view_np = np.asarray(host["desired_view"])
        svc._desired_mask = np.asarray(host["desired_mask"])
        svc._queued_view_np = np.asarray(host["queued_view"])
        svc._queued_mask = np.asarray(host["queued_mask"])
        svc._pending_view_np = np.asarray(host["pending_view"])
        svc._pending_mask = np.asarray(host["pending_mask"])
        svc.up = np.asarray(host["up"])
        svc._up_dev = None
        if host["dynamic"]:
            svc._live = np.asarray(host["live"])
            svc._free_rows = list(host["free_rows"])
            svc._ens_names = dict(host["ens_names"])
            svc._row_name = {r: n_ for n_, r in svc._ens_names.items()}
        svc._replay_wal_from(path, n)
        return svc

    @staticmethod
    def _merge_dynamic(kw: Dict[str, Any], persisted: bool
                       ) -> Dict[str, Any]:
        """The persisted lifecycle mode wins at restore
        (batched_host.py:2934-2948): a static image restored as dynamic
        would free every row, a dynamic one restored as static would drop
        the name directory, so a contradicting ``dynamic`` raises."""
        if "dynamic" in kw and bool(kw["dynamic"]) != persisted:
            raise ValueError(
                f"restore: service was persisted with "
                f"dynamic={persisted}; cannot restore with "
                f"dynamic={kw['dynamic']}")
        kw = dict(kw)
        kw["dynamic"] = persisted
        return kw

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
        (batched_host.py:2965-3100).  A ``("mem", row)`` record is the
        row's newest committed membership: it becomes the row's single
        view and clears its in-flight membership pipeline; with dynamic
        rows a non-empty record names a live tenant and an empty one a
        destroyed row, and the free pool is rebuilt after the walk.
        Objects land on every replica at their committed (epoch, seq);
        ballot epochs rise to at least the newest installed object
        epoch, so the restart's elections propose higher; every replica's
        tree rebuilds over its store; the fast read mirrors
        (``_slot_vsn``, the inline mirrors) are set from the replayed
        records, and leaders and leases are cleared."""
        recs = wal.records()
        if not recs:
            return
        e_, m_, s_ = self.n_ens, self.n_peers, self.n_slots
        st = self.engine.gather_state(self.state)
        obj_epoch = st.obj_epoch.cpu().numpy().copy()
        obj_seq = st.obj_seq.cpu().numpy().copy()
        obj_val = st.obj_val.cpu().numpy().copy()
        epoch = st.epoch.cpu().numpy().copy()
        view_mask = st.view_mask.cpu().numpy().copy()
        #: ens -> slot -> replayed owner key (None: tombstoned or bulk);
        #: checkpoint-era mappings that disagree are dropped below
        owners: Dict[int, Dict[int, Any]] = {}
        for key, value in recs:
            if key[0] == "mem":
                ens = key[1]
                name, row_l = value
                row = np.asarray(row_l, bool)
                self.member_np[ens] = row
                view_mask[ens] = False
                view_mask[ens, 0] = row
                self._pending_mask[ens] = False
                self._desired_mask[ens] = False
                self._queued_mask[ens] = False
                if self.dynamic:
                    old_name = self._row_name.pop(ens, None)
                    if old_name is not None:
                        self._ens_names.pop(old_name, None)
                    if row.any() and name is not None:
                        self._ens_names[name] = ens
                        self._row_name[ens] = name
                    self._live[ens] = bool(row.any())
                    if not row.any():
                        self._reset_row_host(ens)
                continue
            if key[0] != "kv":
                # other record kinds (a replication group's ("grp",)
                # meta) are not state; their owner reads them
                continue
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
        dev = st.epoch.device
        state = self.engine.shard_state(st._replace(
            epoch=torch.from_numpy(epoch).to(dev),
            view_mask=torch.from_numpy(view_mask).to(dev),
            obj_epoch=torch.from_numpy(obj_epoch).to(dev),
            obj_seq=torch.from_numpy(obj_seq).to(dev),
            obj_val=torch.from_numpy(obj_val).to(dev)))
        self.state = self.engine.rebuild_trees(
            state, torch.ones((e_, m_), dtype=torch.bool,
                              device=self.device))
        self._up_dev = None
        self.leader_np = np.full((e_,), -1, dtype=np.int32)
        self.lease_until[:] = 0.0
        if self.dynamic:
            self._free_rows = [r for r in range(e_ - 1, -1, -1)
                               if not self._live[r]]
