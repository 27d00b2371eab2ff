"""Batched consensus engine — the ballot matrix as torch tensors.

Port of the main-path part of ``riak_ensemble_tpu/ops/engine.py``: the
state layout (:class:`EngineState`, :class:`KvResult`, identical field
names, dtypes and shapes), the Merkle path kernels, the election step,
the K/V round with its whole RMW table, the K-round scan, the fused
:func:`full_step` the service launches once per flush, its sliced form
on the active rows only (:func:`full_step_sliced`), the wide rounds over
``[G, E, W]`` conflict-free op planes (:func:`kv_step_scan_wide`,
:func:`full_step_wide`, :func:`full_step_wide_sliced`,
:func:`validate_wide_plane`), the anti-entropy
exchange (:func:`verify_trees`, :func:`exchange_step`), row recycling
(:func:`reset_rows`) and joint-consensus reconfiguration
(:func:`reconfig_propose`, :func:`reconfig_transition`,
:func:`reconfig_step`).
Semantics are the reference's, bit for bit; the docstrings there carry
the protocol citations (riak_ensemble_peer.erl / msg.erl /
synctree.erl) and are not repeated at length here.

What differs from the reference, and why:

- The reference's ``axis_name`` (peer-axis ``psum`` / ``pmax`` /
  ``axis_index`` under ``shard_map``) is the ``axis`` argument: None
  (the default) reduces over the trailing local peer axis alone; a
  peer-axis object (:class:`..parallel.mesh.ThreadPeerAxis`,
  :class:`..parallel.distributed.DistPeerAxis`) with ``sum``, ``max``
  and ``index`` folds in the other peer shards' partials.  With an
  axis the steps run their plain torch versions, on the card too, and
  the quorum predicate is :func:`.quorum.quorum_met_batch` over the
  collectives — as the reference runs its ``jnp`` path with
  collectives, never its Pallas kernel, under a sharded peer axis
  (engine.py:478-482).
- uint32 tree planes (``tree_leaf``/``tree_node``) are int32 tensors
  holding the same bits (:mod:`.u32`).
- Every integer reduction names ``dtype=torch.int32`` and every factory
  names ``torch.int32``: torch widens int sums to int64 where JAX (x64
  off) stays int32.
- On a CUDA state :func:`full_step`, :func:`full_step_sliced`,
  :func:`kv_step_scan`, :func:`kv_step` and their wide forms are ONE
  launch of kernel F1 (:mod:`.cuda_engine`):
  election, context, all K rounds and the epoch adoption, with the
  quorum predicate inside, updating every state plane IN PLACE.  On a
  CPU state they run the plain versions below (:func:`full_step_plain`,
  :func:`full_step_sliced_plain`, :func:`kv_step_scan_plain` and the
  ``*_wide*_plain`` twins), where
  ``lax.scan`` is a Python loop whose
  rounds update the object and tree planes IN PLACE.  Either way a
  caller that needs its input state afterwards passes a copy.
- The quorum predicate (:func:`_quorum_met`, used by the plain step
  and :func:`elect_step`) is kernel K1 on CUDA tensors and K1's plain
  version on CPU tensors.  On a CUDA state the anti-entropy exchange is
  ONE launch of kernel X1 (:mod:`.cuda_exchange`) and each reconfig op
  ONE launch of kernel R1 (:mod:`.cuda_reconfig`), K1's predicate inside
  each; both step the state's planes in place.  Their plain versions
  (:func:`exchange_step_plain`, :func:`reconfig_step_plain`, ...) are
  the CPU path.
- ``.at[].set(mode="drop")`` scatters become gather → ``where`` →
  ``scatter_`` in which a lane that must not write lands where it
  changes nothing (:func:`_set_lanes`), exact for the wide rounds'
  W lanes as for one.
- Nothing inside a round reads the device from the host (no ``.item``,
  boolean-mask indexing or ``nonzero``), so on CUDA the K loop only
  enqueues kernels.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from riak_ensemble_tpu_torch import funref
from riak_ensemble_tpu_torch.device import DeviceLike, resolve_device
from riak_ensemble_tpu_torch.ops import (
    cuda_engine, cuda_exchange, cuda_reconfig)
from riak_ensemble_tpu_torch.ops import hash as hashk
from riak_ensemble_tpu_torch.ops import quorum as quorum_lib
from riak_ensemble_tpu_torch.ops.cuda_quorum import (
    quorum_met_e, quorum_met_eplain)
from riak_ensemble_tpu_torch.ops.quorum import views_to_mask

I32 = torch.int32

# Op kinds for kv_step (engine.py:87-106).
OP_NOOP = 0
OP_GET = 1
OP_PUT = 2
#: compare-and-swap: commit ``val`` iff the slot's current version
#: equals (exp_epoch, exp_seq); expecting (0, 0) on an absent slot is
#: create-if-missing (do_kupdate / do_kput_once semantics).
OP_CAS = 3
#: device read-modify-write: fun code in the ``exp_epoch`` plane
#: (funref.RMW_*), int32 operand in ``val``; read, fun and commit in
#: one round.
OP_RMW = 4

RMW_ADD = funref.RMW_ADD
RMW_SUB = funref.RMW_SUB
RMW_MAX = funref.RMW_MAX
RMW_MIN = funref.RMW_MIN
RMW_SET = funref.RMW_SET
RMW_BAND = funref.RMW_BAND
RMW_BOR = funref.RMW_BOR
RMW_BXOR = funref.RMW_BXOR
RMW_PIA = funref.RMW_PIA

MERGE_ADD = funref.MERGE_ADD
MERGE_MAX = funref.MERGE_MAX
MERGE_MIN = funref.MERGE_MIN
MERGE_AND = funref.MERGE_AND
MERGE_OR = funref.MERGE_OR

#: Merkle trie fan-out (the reference's width-16 trie, synctree.erl:88).
TREE_WIDTH = 16

_INT32_MIN = -(1 << 31)


def _select(conds, vals, default: torch.Tensor) -> torch.Tensor:
    """``jnp.select``: the value of the FIRST true condition, else
    ``default`` (built back to front so earlier conditions win)."""
    out = default
    for c, v in zip(reversed(conds), reversed(vals)):
        out = torch.where(c, v, out)
    return out


def merge_vals(cur: torch.Tensor, mcls: torch.Tensor,
               operand: torch.Tensor) -> torch.Tensor:
    """Fold each merged cell's coalesced ``operand`` into the lane's own
    current value ``cur`` by merge class (engine.py:131-147)."""
    return _select(
        [mcls == MERGE_ADD, mcls == MERGE_MAX, mcls == MERGE_MIN,
         mcls == MERGE_AND],
        [cur + operand, torch.maximum(cur, operand),
         torch.minimum(cur, operand), cur & operand],
        cur | operand)


class EngineState(NamedTuple):
    """Ballot + replicated-store + integrity state for E ensembles x M
    peers (engine.py:154-183).  ``tree_leaf``/``tree_node`` hold uint32
    hash lanes as int32 bit patterns."""

    epoch: torch.Tensor        # [E, M] int32  per-peer current epoch
    fact_seq: torch.Tensor     # [E, M] int32  per-peer fact seq
    leader: torch.Tensor       # [E]    int32  leader peer idx, -1 none
    view_mask: torch.Tensor    # [E, V, M] bool  joint-consensus views
    view_vsn: torch.Tensor     # [E] int32  bumps on every views change
    pend_vsn: torch.Tensor     # [E] int32  vsn of the adopted pending change
    commit_vsn: torch.Tensor   # [E] int32  pend_vsn as of the last collapse
    obj_seq_ctr: torch.Tensor  # [E]    int32  leader per-epoch obj counter
    obj_epoch: torch.Tensor    # [E, M, S] int32  replica store: obj epochs
    obj_seq: torch.Tensor      # [E, M, S] int32  replica store: obj seqs
    obj_val: torch.Tensor      # [E, M, S] int32  replica store: payloads
    tree_leaf: torch.Tensor    # [E, M, S, LANES] uint32 bits (int32)
    tree_node: torch.Tensor    # [E, M, U, LANES] uint32 bits (int32)


class KvResult(NamedTuple):
    committed: torch.Tensor    # [E] bool  put/rewrite/tombstone reached quorum
    get_ok: torch.Tensor       # [E] bool  read served (lease or epoch quorum)
    found: torch.Tensor        # [E] bool  read found an object
    value: torch.Tensor        # [E] int32 read payload (0 if not found)
    obj_vsn: torch.Tensor      # [E, 2] int32 (epoch, seq) of the read/put obj
    quorum_ok: torch.Tensor    # [E] bool  leader up + epoch quorum this round
    tree_corrupt: torch.Tensor  # [E, M] bool replica failed the integrity gate


# ---------------------------------------------------------------------------
# Merkle trie layout + path kernels (the synctree on the data path)


@functools.lru_cache(maxsize=None)
def tree_sizes(n_slots: int) -> Tuple[int, ...]:
    """Upper-level sizes leafward→root for an ``n_slots``-leaf trie
    (width 16; short levels padded with zero hashes)."""
    sizes = []
    n = n_slots
    while n > 1:
        n = -(-n // TREE_WIDTH)
        sizes.append(n)
    if not sizes:
        sizes = [1]
    return tuple(sizes)


@functools.lru_cache(maxsize=None)
def _tree_offsets(n_slots: int) -> Tuple[Tuple[int, ...], int]:
    sizes = tree_sizes(n_slots)
    offs, total = [], 0
    for n in sizes:
        offs.append(total)
        total += n
    return tuple(offs), total


def _fold_blocks(x: torch.Tensor) -> torch.Tensor:
    """Fold ``[..., n, LANES]`` into ``[..., ceil(n/16), LANES]`` parent
    hashes, zero-padding the last (short) block."""
    n = x.shape[-2]
    nb = -(-n // TREE_WIDTH)
    pad = nb * TREE_WIDTH - n
    if pad:
        zeros = torch.zeros(x.shape[:-2] + (pad, hashk.LANES), dtype=I32,
                            device=x.device)
        x = torch.cat([x, zeros], dim=-2)
    return hashk.fold(x.reshape(x.shape[:-2] + (nb, TREE_WIDTH,
                                                hashk.LANES)))


def build_uppers(leaves: torch.Tensor) -> torch.Tensor:
    """Bottom-up rebuild of the upper levels from ``[..., S, LANES]``
    leaves → flat ``[..., U, LANES]`` (the ``rehash`` role)."""
    outs = []
    cur = leaves
    for _ in tree_sizes(leaves.shape[-2]):
        cur = _fold_blocks(cur)
        outs.append(cur)
    return torch.cat(outs, dim=-2) if len(outs) > 1 else outs[0]


def _gather_children(arr: torch.Tensor, parent_idx: torch.Tensor,
                     n: int) -> torch.Tensor:
    """Gather the 16 children of ``parent_idx [E, W]`` from a
    per-replica level array ``arr [E, Ml, n, LANES]`` →
    ``[E, Ml, W, 16, LANES]`` (zero-padded beyond ``n``, matching
    :func:`_fold_blocks`)."""
    e, w = parent_idx.shape
    ml = arr.shape[1]
    idx = (parent_idx[..., None] * TREE_WIDTH
           + torch.arange(TREE_WIDTH, dtype=I32,
                          device=arr.device))                # [E, W, 16]
    valid = idx < n
    idxc = idx.clamp(0, n - 1).reshape(e, 1, w * TREE_WIDTH, 1)
    g = torch.gather(arr, 2, idxc.to(torch.int64).expand(
        e, ml, w * TREE_WIDTH, hashk.LANES))
    g = g.reshape(e, ml, w, TREE_WIDTH, hashk.LANES)
    return torch.where(valid[:, None, :, :, None], g, 0)


def _take_lanes(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(plane, idx, axis=2)`` for a per-replica plane
    ``[E, Ml, n(, LANES)]`` and lane indices ``[E, W]`` →
    ``[E, Ml, W(, LANES)]``."""
    e, ml = plane.shape[:2]
    w = idx.shape[1]
    ix = idx.to(torch.int64)[:, None, :]
    if plane.dim() == 4:
        ix = ix[..., None].expand(e, ml, w, plane.shape[3])
    else:
        ix = ix.expand(e, ml, w)
    return torch.gather(plane, 2, ix)


def _set_lanes(plane: torch.Tensor, idx: torch.Tensor, new: torch.Tensor,
               mask: torch.Tensor) -> None:
    """IN PLACE: ``plane[e, m, idx[e, w]] = new[e, m, w]`` where
    ``mask[e, m, w]`` — the reference's ``.at[].set(mode="drop")`` with
    masked-off lanes aimed out of bounds (engine.py:388-393, 399-400,
    825-826).  torch's ``index_put`` raises on an out-of-range index and
    a boolean select would sync the host, so every lane scatters, and a
    masked-off lane is made harmless instead: in an (e, m) row with a
    live lane it aims at the row's FIRST live lane with that lane's
    value; in a row with none it writes back the value it gathers.  Two
    lanes that meet at one index then carry one value, so CUDA's
    unordered scatter is deterministic even when a NOOP, invalid or pad
    lane clips onto a live lane's slot (W > 1); live lanes meet only
    where they carry equal values (distinct slots, or path parents
    refolded from the same children).  ``new``/``mask`` broadcast to
    ``[E, Ml, W(, LANES)]``."""
    e, ml = plane.shape[:2]
    w = idx.shape[1]
    mask = mask.expand(e, ml, w)
    ix = idx.to(torch.int64)[:, None, :].expand(e, ml, w)
    live = mask.any(-1, keepdim=True)                        # [E, Ml, 1]
    first = mask.to(torch.uint8).argmax(-1, keepdim=True)    # [E, Ml, 1]
    tgt = torch.where(mask | ~live, ix, torch.gather(ix, 2, first))
    if plane.dim() == 4:
        lanes = plane.shape[3]
        tgt = tgt[..., None].expand(e, ml, w, lanes)
        new = new.expand(e, ml, w, lanes)
        mask, live = mask[..., None], live[..., None]
        first = first[..., None].expand(e, ml, 1, lanes)
    else:
        new = new.expand(e, ml, w)
    cur = torch.gather(plane, 2, tgt)
    head = torch.gather(new, 2, first)
    plane.scatter_(2, tgt, torch.where(mask, new,
                                       torch.where(live, head, cur)))


def _verify_path(tree_leaf: torch.Tensor, tree_node: torch.Tensor,
                 slot: torch.Tensor) -> torch.Tensor:
    """Root-ward path verification for W slots per ensemble: recompute
    each stored parent on the paths from its stored children and
    compare (``get_path``/``verify_hash``, synctree.erl:302-340).
    ``slot [E, W]`` → ``[E, Ml, W]`` bool — replica's tree corrupted
    on lane w's path."""
    s = tree_leaf.shape[-2]
    offs, _ = _tree_offsets(s)
    sizes = tree_sizes(s)
    e, ml = tree_leaf.shape[:2]
    bad = torch.zeros((e, ml, slot.shape[1]), dtype=torch.bool,
                      device=slot.device)
    child_arr, child_n, idx = tree_leaf, s, slot
    for off, n in zip(offs, sizes):
        pidx = idx // TREE_WIDTH                             # [E, W]
        expect = hashk.fold(_gather_children(child_arr, pidx, child_n))
        level = tree_node[:, :, off:off + n]
        stored = _take_lanes(level, pidx)                    # [E,Ml,W,L]
        bad = bad | (expect != stored).any(-1)
        child_arr, child_n, idx = level, n, pidx
    return bad


def _write_path(tree_leaf: torch.Tensor, tree_node: torch.Tensor,
                slot: torch.Tensor, new_leaf: torch.Tensor,
                mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """IN PLACE on ``tree_leaf``/``tree_node``: set lane w's leaf to
    ``new_leaf [E, W, LANES]`` on replicas in ``mask [E, Ml, W]`` and
    recompute their root-ward paths (``update_hash`` + ``update_path``,
    peer.erl:1731-1738).  Non-writing replicas' nodes keep their bits.
    Only the touched (slot, path) positions move — scatters, not
    full-plane rewrites.  Lanes sharing a parent recompute it from the
    same post-scatter children, so duplicate in-range targets carry
    identical values and CUDA's unordered scatter is safe."""
    s = tree_leaf.shape[-2]
    offs, _ = _tree_offsets(s)
    sizes = tree_sizes(s)
    _set_lanes(tree_leaf, slot, new_leaf[:, None], mask)
    child_arr, child_n, idx = tree_leaf, s, slot
    for off, n in zip(offs, sizes):
        pidx = idx // TREE_WIDTH                             # [E, W]
        parent = hashk.fold(_gather_children(child_arr, pidx, child_n))
        _set_lanes(tree_node, off + pidx, parent, mask)
        child_arr, child_n = tree_node[:, :, off:off + n], n
        idx = pidx
    return tree_leaf, tree_node


def init_state(n_ensembles: int, n_peers: int, n_slots: int,
               n_views: int = 2,
               views: Optional[Sequence[Sequence[int]]] = None,
               device: DeviceLike = None) -> EngineState:
    """Fresh state: no leader, epoch 0, empty stores, trees built over
    the empty stores (every leaf = hash of the absent object).

    ``views`` is a list of views (each a list of peer indices) applied
    to every ensemble; default one view of all peers.  Runs on CUDA
    unless ``device="cpu"`` (raises when CUDA is absent and the CPU
    was not asked for).  Every plane is materialised (the reference
    broadcasts): the rounds update them in place."""
    dev = resolve_device(device)
    e, m, s, v = n_ensembles, n_peers, n_slots, n_views
    if views is None:
        vm = np.zeros((v, m), dtype=bool)
        vm[0, :] = True
    else:
        assert len(views) <= v
        vm = views_to_mask(views, v, m)
    zero = torch.zeros((), dtype=I32, device=dev)
    empty_leaf = hashk.obj_leaf_hash(zero, zero, zero)           # [LANES]
    leaves = empty_leaf.expand(s, hashk.LANES)
    uppers = build_uppers(leaves)                                # [U, LANES]

    def zeros(*shape):
        return torch.zeros(shape, dtype=I32, device=dev)
    return EngineState(
        epoch=zeros(e, m),
        fact_seq=zeros(e, m),
        leader=torch.full((e,), -1, dtype=I32, device=dev),
        view_mask=torch.as_tensor(vm, device=dev).expand(e, v, m)
        .contiguous(),
        view_vsn=zeros(e),
        pend_vsn=zeros(e),
        commit_vsn=zeros(e),
        obj_seq_ctr=zeros(e),
        obj_epoch=zeros(e, m, s),
        obj_seq=zeros(e, m, s),
        obj_val=zeros(e, m, s),
        tree_leaf=leaves.expand(e, m, s, hashk.LANES).contiguous(),
        tree_node=uppers.expand((e, m) + tuple(uppers.shape)).contiguous(),
    )


# ---------------------------------------------------------------------------
# Peer-axis reductions (the reference's psum / pmax / axis_index,
# engine.py:446-462, quorum.py:104-111)


def _psum(x: torch.Tensor, axis) -> torch.Tensor:
    """int32 sum over the trailing local peer axis, then over the peer
    shards when ``axis`` is given (``reduce_peers``)."""
    s = x.sum(-1, dtype=I32)
    return s if axis is None else axis.sum(s)


def _pmax(x: torch.Tensor, axis) -> torch.Tensor:
    m = x.amax(-1)
    return m if axis is None else axis.max(m)


def _pany(x: torch.Tensor, axis) -> torch.Tensor:
    """Any over the peer axis of a bool ``[..., Ml]``: the reference's
    ``reduce_peers(x.astype(int32)) > 0``."""
    return x.any(-1) if axis is None else _psum(x, axis) > 0


def _global_peer_idx(m_local: int, device: torch.device,
                     axis) -> torch.Tensor:
    """Global peer indices of the local peer slice ([Ml] int32)."""
    idx = torch.arange(m_local, dtype=I32, device=device)
    return idx if axis is None else idx + axis.index * m_local


# ---------------------------------------------------------------------------
# Quorum + latest-object reductions over the peer axis


def _quorum_met(ack: torch.Tensor, heard: torch.Tensor,
                view_mask: torch.Tensor, axis=None) -> torch.Tensor:
    """Majority in EVERY active view (msg.erl:377-418), through K1 (or,
    over a sharded peer axis, :func:`.quorum.quorum_met_batch` with the
    axis's collectives and no self term, engine.py:497-503).

    ack [E, Ml] or [E, W, Ml] bool (epoch-matching up members — the
    caller's own vote already included); heard, same shape (up members
    — heard-but-not-acking peers are nacks); view_mask [E, V, Ml] bool
    → [E] / [E, W] bool.  The 3-D round call flattens the lane axis
    into K1's rows and hands it the UNWIDENED mask (K1 reads row r's
    mask at r // W) instead of materialising the reference's
    ``[E, W, V, M]`` broadcast (engine.py:489-491)."""
    nack = heard & ~ack
    if axis is not None:
        vm = view_mask if ack.dim() == 2 else view_mask[:, None].expand(
            ack.shape[:2] + view_mask.shape[1:])
        self_idx = torch.full(ack.shape[:-1], -1, dtype=I32,
                              device=ack.device)
        return quorum_lib.quorum_met_batch(ack, nack, vm, self_idx,
                                           axis=axis) == quorum_lib.MET
    if ack.dim() == 2:
        return quorum_met_e(ack, nack, view_mask) == quorum_lib.MET
    e, w, ml = ack.shape
    res = quorum_met_e(ack.reshape(e * w, ml), nack.reshape(e * w, ml),
                       view_mask, w)
    return (res == quorum_lib.MET).reshape(e, w)


def _latest_among(pe: torch.Tensor, ps: torch.Tensor, pv: torch.Tensor,
                  ok: torch.Tensor, axis=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Batched ``get_latest_obj`` (peer.erl:1623-1662): the newest
    (epoch, seq) object among the replicas in ``ok``, via a three-stage
    masked max-reduce over the trailing peer axis.  Returns (epoch,
    seq, val, found)."""
    exists = ps > 0                                          # seq>=1 once written
    h = ok & exists
    emax = _pmax(torch.where(h, pe, -1), axis)
    smax = _pmax(torch.where(h & (pe == emax[..., None]), ps, -1), axis)
    on_max = h & (pe == emax[..., None]) & (ps == smax[..., None])
    vmax = _pmax(torch.where(on_max, pv, _INT32_MIN), axis)
    found = smax > 0
    return (emax.clamp_min(0), smax.clamp_min(0),
            torch.where(found, vmax, 0), found)


# ---------------------------------------------------------------------------
# Election kernel


def elect_step(state: EngineState, elect: torch.Tensor, cand: torch.Tensor,
               up: torch.Tensor, axis=None
               ) -> Tuple[EngineState, torch.Tensor]:
    """Batched two-phase leader election for the ensembles in ``elect``
    (engine.py:534-578).  elect [E] bool; cand [E] int32 candidate; up
    [E, Ml] bool.  Phase 1: NextEpoch = max(heard epochs)+1, every
    heard member acks; phase 2 on quorum: members adopt NextEpoch, fact
    seq and the per-epoch obj counter reset.  ``cand`` is a GLOBAL
    peer index.  Returns (state', won)."""
    e, ml = state.epoch.shape
    gidx = _global_peer_idx(ml, up.device, axis)
    member = state.view_mask.any(1)                          # [E, Ml]
    heard = up & member
    next_epoch = _pmax(torch.where(heard, state.epoch, -1), axis) + 1
    ack = heard
    # The candidate must itself be an up member (it leads the round).
    cand_heard = _pany((gidx[None, :] == cand[:, None]) & heard, axis)
    won = (_quorum_met(ack, heard, state.view_mask, axis)
           & elect & (cand >= 0) & cand_heard)

    adopt = won[:, None] & heard                             # [E, Ml]
    epoch = torch.where(adopt, next_epoch[:, None], state.epoch)
    fact_seq = torch.where(adopt, 0, state.fact_seq)
    leader = torch.where(won, cand, state.leader)
    obj_seq_ctr = torch.where(won, 0, state.obj_seq_ctr)
    return state._replace(epoch=epoch, fact_seq=fact_seq, leader=leader,
                          obj_seq_ctr=obj_seq_ctr), won


# ---------------------------------------------------------------------------
# K/V kernel


class _KvCtx(NamedTuple):
    """Loop-invariant K/V round context (depends only on ballot state
    and the ``up`` mask, which no K/V round mutates)."""

    heard: torch.Tensor        # [E, Ml] up members
    leader_up: torch.Tensor    # [E] the leader itself is up (it serves ops)
    lead_epoch: torch.Tensor   # [E] proposal epoch (leader's epoch)
    epoch_ok: torch.Tensor     # [E] epoch-check round reached quorum
    n_member: torch.Tensor     # [E] member count (for all_or_quorum)


def _kv_context(state: EngineState, up: torch.Tensor, axis=None) -> _KvCtx:
    e, ml = state.epoch.shape
    gidx = _global_peer_idx(ml, up.device, axis)             # [Ml]
    is_leader = gidx[None, :] == state.leader[:, None]       # [E, Ml]
    has_leader = state.leader >= 0                           # [E]
    member = state.view_mask.any(1)
    heard = up & member
    lead_epoch = _psum(torch.where(is_leader, state.epoch, 0), axis)
    # Every op is served BY the leader; a down leader serves nothing.
    leader_up = _pany(is_leader & heard, axis)
    # Epoch-check acks: shared by put replication and non-leased reads.
    ack = heard & (state.epoch == lead_epoch[:, None])
    epoch_ok = (_quorum_met(ack, heard, state.view_mask, axis)
                & has_leader & leader_up)
    n_member = _psum(member, axis)
    return _KvCtx(heard=heard, leader_up=leader_up & has_leader,
                  lead_epoch=lead_epoch, epoch_ok=epoch_ok,
                  n_member=n_member)


def _kv_round(state: EngineState, ctx: _KvCtx, kind: torch.Tensor,
              slot: torch.Tensor, val: torch.Tensor, lease_ok: torch.Tensor,
              exp_epoch: Optional[torch.Tensor] = None,
              exp_seq: Optional[torch.Tensor] = None, axis=None
              ) -> Tuple[EngineState, KvResult]:
    """One WIDE K/V protocol round (engine.py:629-864) for ``[E, W]`` op
    lanes whose valid slots are distinct within each row (the scheduler's
    precondition; W = 1 is the scalar round).  Lanes see the pre-round
    state, integrity verdicts included, and commit seqs in lane order.
    Updates the object and tree planes of ``state`` IN PLACE and returns
    them with the round's result (``tree_corrupt`` OR'd over the lanes,
    ``[E, Ml]``)."""
    e, ml = state.epoch.shape
    s = state.obj_epoch.shape[-1]
    heard = ctx.heard                                        # [E, Ml]
    heard3 = heard[:, :, None]                               # [E, Ml, 1]
    leader_up = ctx.leader_up[:, None]                       # [E, 1]
    lead_epoch = ctx.lead_epoch[:, None]
    epoch_ok = ctx.epoch_ok[:, None]
    if exp_epoch is None:
        exp_epoch = torch.zeros_like(kind)
    if exp_seq is None:
        exp_seq = torch.zeros_like(kind)

    is_put = kind == OP_PUT
    is_get = kind == OP_GET
    is_cas = kind == OP_CAS
    is_rmw = kind == OP_RMW
    active = is_put | is_get | is_cas | is_rmw
    slot_valid = (slot >= 0) & (slot < s)                    # [E, W]
    slot_c = slot.clamp(0, s - 1)

    # Per-replica object at each lane's slot: ONE gather per plane
    # (invalid slots read the absent object).
    sv = slot_valid[:, None, :]
    pe = torch.where(sv, _take_lanes(state.obj_epoch, slot_c), 0)
    ps = torch.where(sv, _take_lanes(state.obj_seq, slot_c), 0)
    pv = torch.where(sv, _take_lanes(state.obj_val, slot_c), 0)

    # Integrity gate (tree-is-truth): the object must match its leaf,
    # and the slot's root-ward path must verify.
    leaf = _take_lanes(state.tree_leaf, slot_c)              # [E,Ml,W,L]
    leaf_ok = (leaf == hashk.obj_leaf_hash(pe, ps, pv)).all(-1)
    path_bad = _verify_path(state.tree_leaf, state.tree_node, slot_c)
    replica_ok = heard3 & leaf_ok & ~path_bad                # [E, Ml, W]
    tree_corrupt = ((path_bad | ~leaf_ok) & heard3
                    & (active & slot_valid)[:, None, :]).any(-1)

    # Peer-axis reductions run on the transposed [E, W, Ml] layout.
    ok_t = replica_ok.transpose(1, 2)                        # [E, W, Ml]

    # Read: newest object among valid replicas (hash extra-check).
    # ``obj_found`` is "some object exists" (possibly a tombstone,
    # val == 0); ``found`` is the client-visible hit.
    rd_epoch, rd_seq, rd_val, obj_found = _latest_among(
        pe.transpose(1, 2), ps.transpose(1, 2), pv.transpose(1, 2), ok_t,
        axis)
    found = obj_found & (rd_val != 0)
    n_ok = _psum(ok_t, axis)                                 # [E, W]
    all_ok = n_ok == ctx.n_member[:, None]

    get_gate = is_get & leader_up & (lease_ok | epoch_ok)
    stale = obj_found & (rd_epoch != lead_epoch)
    # Stale-epoch rewrite (update_key): needs the quorum either way.
    rewrite = get_gate & stale & epoch_ok
    # Notfound with no object anywhere: serve without writing when every
    # member answered valid notfound; otherwise commit a tombstone at
    # the current epoch, which additionally needs a QUORUM of hash-valid
    # notfound answers (non-valid heard replicas count as nacks).
    nf = get_gate & ~obj_found
    nf_quorum = _quorum_met(ok_t, heard[:, None, :].expand_as(ok_t),
                            state.view_mask, axis)           # [E, W]
    nf_write = nf & slot_valid & ~all_ok & epoch_ok & nf_quorum
    get_ok = ((get_gate & obj_found & (~stale | rewrite))
              | (nf & (all_ok | ~slot_valid | nf_write)))

    # Commit path (put, CAS, rewrite, notfound tombstone).  CAS compares
    # against the slot's CURRENT version atomically within this round;
    # (0, 0) matches a tombstone, or true absence with nf_quorum.
    put_commit = is_put & epoch_ok & slot_valid
    exp_absent = (exp_epoch == 0) & (exp_seq == 0)
    vsn_match = ((obj_found & (rd_epoch == exp_epoch)
                  & (rd_seq == exp_seq))
                 | (exp_absent & obj_found & (rd_val == 0))
                 | (exp_absent & ~obj_found & nf_quorum))
    cas_commit = is_cas & epoch_ok & slot_valid & vsn_match

    # Device RMW (OP_RMW): fn(cur, operand) committed in THIS round.
    # int32 +/- wrap on the card and the CPU as in XLA.
    fn = exp_epoch                                           # [E, W]
    cur = torch.where(obj_found, rd_val, 0)
    new_rmw = _select(
        [fn == RMW_ADD, fn == RMW_SUB, fn == RMW_MAX, fn == RMW_MIN,
         fn == RMW_SET, fn == RMW_BAND, fn == RMW_BOR, fn == RMW_BXOR],
        [cur + val, cur - val, torch.maximum(cur, val),
         torch.minimum(cur, val), val, cur & val, cur | val, cur ^ val],
        val)                          # RMW_PIA commits the operand
    rmw_absent = ((obj_found & (rd_val == 0))
                  | (~obj_found & nf_quorum))
    rmw_known = obj_found | nf_quorum
    rmw_commit = (is_rmw & epoch_ok & slot_valid
                  & torch.where(fn == RMW_PIA, rmw_absent, rmw_known))

    commit = (put_commit | cas_commit | rewrite | nf_write
              | rmw_commit)                                  # [E, W]
    wval = torch.where(is_put | is_cas, val,
                       torch.where(is_rmw, new_rmw,
                                   torch.where(rewrite, rd_val, 0)))

    # Commit seqs advance in lane order (obj_sequence, peer.erl:1776-1791).
    ranks = torch.cumsum(commit.to(I32), dim=1, dtype=I32)   # [E, W]
    new_seq = state.obj_seq_ctr[:, None] + ranks

    # Read repair (maybe_repair, peer.erl:1518-1536).
    plain_read = get_ok & obj_found & ~rewrite               # [E, W]
    divergent = heard3 & ((pe != rd_epoch[:, None, :])
                          | (ps != rd_seq[:, None, :])
                          | ~leaf_ok | path_bad)
    repair = plain_read[:, None, :] & divergent              # [E, Ml, W]

    w_epoch = torch.where(commit, lead_epoch, rd_epoch)      # [E, W]
    w_seq = torch.where(commit, new_seq, rd_seq)
    w_val = torch.where(commit, wval, rd_val)
    do_write = (commit[:, None, :] & heard3) | repair        # [E, Ml, W]

    # In-place scatters of the touched slot columns (the reference's
    # aliased scan carry); lanes that must not write keep their bits.
    _set_lanes(state.obj_epoch, slot_c, w_epoch[:, None, :], do_write)
    _set_lanes(state.obj_seq, slot_c, w_seq[:, None, :], do_write)
    _set_lanes(state.obj_val, slot_c, w_val[:, None, :], do_write)
    obj_seq_ctr = state.obj_seq_ctr + ranks[:, -1]

    # Synchronous tree maintenance: leaves + root-ward paths, same round.
    new_leaf = hashk.obj_leaf_hash(w_epoch, w_seq, w_val)    # [E, W, L]
    _write_path(state.tree_leaf, state.tree_node, slot_c, new_leaf,
                do_write)

    # Version reported for any served object INCLUDING tombstones.
    out_epoch = torch.where(commit, lead_epoch,
                            torch.where(get_ok & obj_found, rd_epoch, 0))
    out_seq = torch.where(commit, new_seq,
                          torch.where(get_ok & obj_found, rd_seq, 0))
    res = KvResult(
        committed=commit,
        get_ok=get_ok,
        found=found & get_ok,
        # reads report the winning value; a committed RMW reports the
        # value it COMPUTED
        value=torch.where(rmw_commit, new_rmw,
                          torch.where(get_ok & found, rd_val, 0)),
        obj_vsn=torch.stack([out_epoch, out_seq], -1),
        quorum_ok=ctx.epoch_ok[:, None].expand(commit.shape),
        tree_corrupt=tree_corrupt,
    )
    return state._replace(obj_seq_ctr=obj_seq_ctr), res


def _adopt_epochs(state: EngineState, ctx: _KvCtx) -> EngineState:
    """Follower epoch catch-up at the END of the launch (the
    ``following({commit, Fact})`` adoption, peer.erl:794-836)."""
    heal = (ctx.heard & ctx.leader_up[:, None]
            & (state.epoch < ctx.lead_epoch[:, None]))
    return state._replace(
        epoch=torch.where(heal, ctx.lead_epoch[:, None], state.epoch))


def kv_step(state: EngineState, kind: torch.Tensor, slot: torch.Tensor,
            val: torch.Tensor, lease_ok: torch.Tensor, up: torch.Tensor,
            exp_epoch: Optional[torch.Tensor] = None,
            exp_seq: Optional[torch.Tensor] = None
            ) -> Tuple[EngineState, KvResult]:
    """One K/V protocol round per ensemble (engine.py:868-918): kind,
    slot, val, exp_epoch, exp_seq [E] int32; lease_ok [E] bool; up
    [E, Ml] bool.  It is the K = 1 :func:`kv_step_scan` with the round
    axis squeezed (one F1 launch on CUDA).  Updates ``state`` in
    place."""
    def one(t):
        return None if t is None else t[None]
    state, res = kv_step_scan(state, kind[None], slot[None], val[None],
                              lease_ok[None], up, one(exp_epoch),
                              one(exp_seq))
    return state, KvResult(*(p[0] for p in res))


def _empty_results(e: int, ml: int, w: Optional[int],
                   device: torch.device) -> KvResult:
    """Stacked results of a zero-round scan (the ``[0, E]`` shapes
    ``lax.scan`` gives; ``[0, E, W]`` for a wide scan)."""
    lanes = (0, e) if w is None else (0, e, w)
    b = torch.zeros(lanes, dtype=torch.bool, device=device)
    return KvResult(
        committed=b, get_ok=b, found=b,
        value=torch.zeros(lanes, dtype=I32, device=device),
        obj_vsn=torch.zeros(lanes + (2,), dtype=I32, device=device),
        quorum_ok=b,
        tree_corrupt=torch.zeros((0, e, ml), dtype=torch.bool,
                                 device=device))


def kv_step_scan(state: EngineState, kind: torch.Tensor, slot: torch.Tensor,
                 val: torch.Tensor, lease_ok: torch.Tensor, up: torch.Tensor,
                 exp_epoch: Optional[torch.Tensor] = None,
                 exp_seq: Optional[torch.Tensor] = None, axis=None
                 ) -> Tuple[EngineState, KvResult]:
    """K sequential K/V rounds per ensemble (engine.py:945-979):
    kind/slot/val/lease_ok (and exp_epoch/exp_seq) ``[K, E]``, up
    ``[E, Ml]`` held fixed.  One F1 launch without the election for a
    CUDA state, :func:`kv_step_scan_plain` for a CPU state or a sharded
    peer ``axis``.  Updates ``state`` in place; results are stacked
    ``[K, E]``."""
    if axis is not None or state.epoch.device.type == "cpu":
        return kv_step_scan_plain(state, kind, slot, val, lease_ok, up,
                                  exp_epoch, exp_seq, axis)
    _, res = cuda_engine.engine_step(state, None, None, kind, slot, val,
                                     lease_ok, up, exp_epoch, exp_seq)
    return state, KvResult(*res)


def kv_step_scan_plain(state: EngineState, kind: torch.Tensor,
                       slot: torch.Tensor, val: torch.Tensor,
                       lease_ok: torch.Tensor, up: torch.Tensor,
                       exp_epoch: Optional[torch.Tensor] = None,
                       exp_seq: Optional[torch.Tensor] = None, axis=None
                       ) -> Tuple[EngineState, KvResult]:
    """:func:`kv_step_scan` as torch ops — F1's plain version: the wide
    scan of one lane per round (:func:`kv_step_scan_wide_plain` on
    ``[K, E, 1]`` planes, the reference's ``kind[:, None]`` rounds) with
    the lane axis squeezed.  The rounds update the obj_* and tree_*
    planes of ``state`` IN PLACE (the scan carry); the returned state
    shares those tensors."""
    def lane(t):
        return None if t is None else t[..., None]
    state, res = kv_step_scan_wide_plain(
        state, lane(kind), lane(slot), lane(val), lane(lease_ok), up,
        lane(exp_epoch), lane(exp_seq), axis)
    return state, res._replace(
        committed=res.committed[..., 0], get_ok=res.get_ok[..., 0],
        found=res.found[..., 0], value=res.value[..., 0],
        obj_vsn=res.obj_vsn[:, :, 0], quorum_ok=res.quorum_ok[..., 0])


def kv_step_scan_wide(state: EngineState, kind: torch.Tensor,
                      slot: torch.Tensor, val: torch.Tensor,
                      lease_ok: torch.Tensor, up: torch.Tensor,
                      exp_epoch: Optional[torch.Tensor] = None,
                      exp_seq: Optional[torch.Tensor] = None, axis=None
                      ) -> Tuple[EngineState, KvResult]:
    """G sequential WIDE rounds of W conflict-free lanes per ensemble
    (engine.py:983-1027): kind/slot/val/lease_ok (and exp_epoch /
    exp_seq) ``[G, E, W]``; results stacked ``[G, E, W]``
    (``tree_corrupt [G, E, Ml]``).  Within every ``[g, e]`` row the
    slots of valid ops must be DISTINCT (the scheduler's precondition,
    :func:`validate_wide_plane` checks concrete planes).  One F1 launch
    in its wide mode for a CUDA state, :func:`kv_step_scan_wide_plain`
    for a CPU state or a sharded peer ``axis``.  Updates ``state`` in
    place."""
    if axis is not None or state.epoch.device.type == "cpu":
        return kv_step_scan_wide_plain(state, kind, slot, val, lease_ok, up,
                                       exp_epoch, exp_seq, axis)
    _, res = cuda_engine.engine_step(state, None, None, kind, slot, val,
                                     lease_ok, up, exp_epoch, exp_seq)
    return state, KvResult(*res)


def kv_step_scan_wide_plain(state: EngineState, kind: torch.Tensor,
                            slot: torch.Tensor, val: torch.Tensor,
                            lease_ok: torch.Tensor, up: torch.Tensor,
                            exp_epoch: Optional[torch.Tensor] = None,
                            exp_seq: Optional[torch.Tensor] = None, axis=None
                            ) -> Tuple[EngineState, KvResult]:
    """:func:`kv_step_scan_wide` as torch ops — F1's plain version in
    wide mode: :func:`_kv_context`, a Python loop of wide rounds (the
    reference's ``lax.scan``) updating the obj_* and tree_* planes IN
    PLACE, then :func:`_adopt_epochs`."""
    ctx = _kv_context(state, up, axis)
    g, e, w = kind.shape
    if g == 0:
        return _adopt_epochs(state, ctx), _empty_results(
            e, state.epoch.shape[1], w, kind.device)
    if exp_epoch is None:
        exp_epoch = torch.zeros_like(kind)
    if exp_seq is None:
        exp_seq = torch.zeros_like(kind)
    outs = []
    for j in range(g):
        state, r = _kv_round(state, ctx, kind[j], slot[j], val[j],
                             lease_ok[j], exp_epoch[j], exp_seq[j], axis)
        outs.append(r)
    res = KvResult(*(torch.stack(planes) for planes in zip(*outs)))
    return _adopt_epochs(state, ctx), res


def validate_wide_plane(kind, slot) -> None:
    """Check the wide rounds' conflict-free precondition on CONCRETE
    ``[G, E, W]`` planes (engine.py:1030-1062): within one ``[g, e]``
    row, ops with kind != OP_NOOP and slot >= 0 must target distinct
    slots — the scheduler's chaining rule exactly, stricter than the
    kernel's write gate (which also needs slot < S).  Raises ValueError
    naming the first offending (group, ensemble, slot).  Host-side only;
    the service runs it with ``validate_wide=True``."""
    kind = np.asarray(kind)
    slot = np.asarray(slot)
    g, e, w = kind.shape
    valid = (kind != OP_NOOP) & (slot >= 0)
    # sentinel-out non-writing lanes (distinct negatives never collide
    # with a real slot), then look for duplicates per row
    s = np.where(valid, slot, -1 - np.arange(w))
    s_sorted = np.sort(s, axis=-1)
    dup = (s_sorted[..., 1:] == s_sorted[..., :-1]).any(-1)
    if dup.any():
        gi, ei = np.argwhere(dup)[0]
        row = slot[gi, ei][valid[gi, ei]]
        vals, counts = np.unique(row, return_counts=True)
        raise ValueError(
            f"wide plane violates the conflict-free precondition: "
            f"group {gi}, ensemble {ei} has duplicate valid slot "
            f"{int(vals[counts > 1][0])} (kv_step_scan_wide docstring)")


def full_step(state: EngineState, elect: torch.Tensor, cand: torch.Tensor,
              kind: torch.Tensor, slot: torch.Tensor, val: torch.Tensor,
              lease_ok: torch.Tensor, up: torch.Tensor,
              exp_epoch: Optional[torch.Tensor] = None,
              exp_seq: Optional[torch.Tensor] = None, axis=None
              ) -> Tuple[EngineState, torch.Tensor, KvResult]:
    """Election round (where needed) followed by K K/V rounds, fused
    (engine.py:1386-1404) — the step the service launches per flush:
    one F1 launch for a CUDA state, :func:`full_step_plain` for a CPU
    state or a sharded peer ``axis``.  Updates ``state`` in place."""
    if axis is not None or state.epoch.device.type == "cpu":
        return full_step_plain(state, elect, cand, kind, slot, val,
                               lease_ok, up, exp_epoch, exp_seq, axis)
    won, res = cuda_engine.engine_step(state, elect, cand, kind, slot, val,
                                       lease_ok, up, exp_epoch, exp_seq)
    return state, won, KvResult(*res)


def full_step_plain(state: EngineState, elect: torch.Tensor,
                    cand: torch.Tensor, kind: torch.Tensor,
                    slot: torch.Tensor, val: torch.Tensor,
                    lease_ok: torch.Tensor, up: torch.Tensor,
                    exp_epoch: Optional[torch.Tensor] = None,
                    exp_seq: Optional[torch.Tensor] = None, axis=None
                    ) -> Tuple[EngineState, torch.Tensor, KvResult]:
    """:func:`full_step` as torch ops — F1's plain version and oracle:
    :func:`elect_step`, then :func:`kv_step_scan_plain`.  Its ballot
    planes are new tensors, its object and tree planes are updated in
    place."""
    state, won = elect_step(state, elect, cand, up, axis)
    state, res = kv_step_scan_plain(state, kind, slot, val, lease_ok, up,
                                    exp_epoch=exp_epoch, exp_seq=exp_seq,
                                    axis=axis)
    return state, won, res


def full_step_wide(state: EngineState, elect: torch.Tensor,
                   cand: torch.Tensor, kind: torch.Tensor,
                   slot: torch.Tensor, val: torch.Tensor,
                   lease_ok: torch.Tensor, up: torch.Tensor,
                   exp_epoch: Optional[torch.Tensor] = None,
                   exp_seq: Optional[torch.Tensor] = None, axis=None
                   ) -> Tuple[EngineState, torch.Tensor, KvResult]:
    """:func:`full_step` with ``[G, E, W]`` conflict-free op planes
    (engine.py:1421-1437; the precondition of
    :func:`kv_step_scan_wide`): one F1 launch in wide mode for a CUDA
    state, :func:`full_step_wide_plain` for a CPU state or a sharded
    peer ``axis``.  Updates ``state`` in place."""
    if axis is not None or state.epoch.device.type == "cpu":
        return full_step_wide_plain(state, elect, cand, kind, slot, val,
                                    lease_ok, up, exp_epoch, exp_seq, axis)
    won, res = cuda_engine.engine_step(state, elect, cand, kind, slot, val,
                                       lease_ok, up, exp_epoch, exp_seq)
    return state, won, KvResult(*res)


def full_step_wide_plain(state: EngineState, elect: torch.Tensor,
                         cand: torch.Tensor, kind: torch.Tensor,
                         slot: torch.Tensor, val: torch.Tensor,
                         lease_ok: torch.Tensor, up: torch.Tensor,
                         exp_epoch: Optional[torch.Tensor] = None,
                         exp_seq: Optional[torch.Tensor] = None, axis=None
                         ) -> Tuple[EngineState, torch.Tensor, KvResult]:
    """:func:`full_step_wide` as torch ops — wide F1's plain version:
    :func:`elect_step`, then :func:`kv_step_scan_wide_plain`."""
    state, won = elect_step(state, elect, cand, up, axis)
    state, res = kv_step_scan_wide_plain(state, kind, slot, val, lease_ok,
                                         up, exp_epoch=exp_epoch,
                                         exp_seq=exp_seq, axis=axis)
    return state, won, res


# ---------------------------------------------------------------------------
# Active-column SLICED full step (the shrunk [K, A] launch grid)


def full_step_sliced(state: EngineState, active_idx: np.ndarray,
                     elect: torch.Tensor, cand: torch.Tensor,
                     kind: torch.Tensor, slot: torch.Tensor,
                     val: torch.Tensor, lease_ok: torch.Tensor,
                     up: torch.Tensor,
                     exp_epoch: Optional[torch.Tensor] = None,
                     exp_seq: Optional[torch.Tensor] = None
                     ) -> Tuple[EngineState, torch.Tensor, KvResult]:
    """:func:`full_step` on the ACTIVE COLUMNS ONLY (engine.py:1481-1521):
    ``active_idx [A]`` (a host int32 array: the active rows in ascending
    order, then padding entries equal to E) selects the rows, ``elect`` /
    ``cand`` are ``[A]``, the op planes ``[K, A]``, ``up`` stays ``[E, M]``.
    Results come back A-wide.  Idle rows get neither epoch adoption nor
    the lease-renewing ``quorum_ok`` — the reference's semantics.  Pad
    lanes must carry NOOP rounds and no election, as the service builds
    them.  One sliced F1 launch for a CUDA state (rows stepped in place),
    :func:`full_step_sliced_plain` for a CPU state."""
    if state.epoch.device.type == "cpu":
        return full_step_sliced_plain(state, active_idx, elect, cand, kind,
                                      slot, val, lease_ok, up, exp_epoch,
                                      exp_seq)
    won, res = cuda_engine.engine_step(state, elect, cand, kind, slot, val,
                                       lease_ok, up, exp_epoch, exp_seq,
                                       active_idx=active_idx)
    return state, won, KvResult(*res)


def full_step_wide_sliced(state: EngineState, active_idx: np.ndarray,
                          elect: torch.Tensor, cand: torch.Tensor,
                          kind: torch.Tensor, slot: torch.Tensor,
                          val: torch.Tensor, lease_ok: torch.Tensor,
                          up: torch.Tensor,
                          exp_epoch: Optional[torch.Tensor] = None,
                          exp_seq: Optional[torch.Tensor] = None
                          ) -> Tuple[EngineState, torch.Tensor, KvResult]:
    """:func:`full_step_sliced` with ``[G, A, W]`` conflict-free wide op
    planes (engine.py:1523-1542; the active-set contract of the scalar
    sliced step): one sliced F1 launch in wide mode for a CUDA state,
    :func:`full_step_wide_sliced_plain` for a CPU state."""
    if state.epoch.device.type == "cpu":
        return full_step_wide_sliced_plain(state, active_idx, elect, cand,
                                           kind, slot, val, lease_ok, up,
                                           exp_epoch, exp_seq)
    won, res = cuda_engine.engine_step(state, elect, cand, kind, slot, val,
                                       lease_ok, up, exp_epoch, exp_seq,
                                       active_idx=active_idx)
    return state, won, KvResult(*res)


def _sliced_plain(step_plain, state: EngineState, active_idx, elect, cand,
                  kind, slot, val, lease_ok, up, exp_epoch, exp_seq):
    """The reference's ``_slice_columns`` / step / ``_scatter_columns``
    around ``step_plain``: gather every state plane and ``up`` at the
    clipped index (a pad, index E, reads a copy of row E - 1), step the
    gathered rows, and copy the real rows back into ``state``'s planes IN
    PLACE, dropping the pads."""
    e = state.epoch.shape[0]
    dev = state.epoch.device
    idx = torch.as_tensor(np.asarray(active_idx), device=dev).to(torch.int64)
    idx_c = idx.clamp(0, e - 1)
    sub = EngineState(*(torch.index_select(t, 0, idx_c) for t in state))
    sub, won, res = step_plain(sub, elect, cand, kind, slot, val, lease_ok,
                               torch.index_select(up, 0, idx_c), exp_epoch,
                               exp_seq)
    keep = torch.nonzero(idx < e).squeeze(1)
    rows = idx.index_select(0, keep)
    for full, part in zip(state, sub):
        full.index_copy_(0, rows, part.index_select(0, keep))
    return state, won, res


def full_step_sliced_plain(state: EngineState, active_idx,
                           elect: torch.Tensor, cand: torch.Tensor,
                           kind: torch.Tensor, slot: torch.Tensor,
                           val: torch.Tensor, lease_ok: torch.Tensor,
                           up: torch.Tensor,
                           exp_epoch: Optional[torch.Tensor] = None,
                           exp_seq: Optional[torch.Tensor] = None
                           ) -> Tuple[EngineState, torch.Tensor, KvResult]:
    """:func:`full_step_sliced` as torch ops — sliced F1's plain version
    and oracle: :func:`full_step_plain` on the gathered rows
    (:func:`_sliced_plain`)."""
    return _sliced_plain(full_step_plain, state, active_idx, elect, cand,
                         kind, slot, val, lease_ok, up, exp_epoch, exp_seq)


def full_step_wide_sliced_plain(state: EngineState, active_idx,
                                elect: torch.Tensor, cand: torch.Tensor,
                                kind: torch.Tensor, slot: torch.Tensor,
                                val: torch.Tensor, lease_ok: torch.Tensor,
                                up: torch.Tensor,
                                exp_epoch: Optional[torch.Tensor] = None,
                                exp_seq: Optional[torch.Tensor] = None
                                ) -> Tuple[EngineState, torch.Tensor,
                                           KvResult]:
    """:func:`full_step_wide_sliced` as torch ops: :func:`full_step_wide_plain`
    on the gathered rows (:func:`_sliced_plain`)."""
    return _sliced_plain(full_step_wide_plain, state, active_idx, elect,
                         cand, kind, slot, val, lease_ok, up, exp_epoch,
                         exp_seq)


# ---------------------------------------------------------------------------
# Result-plane compaction and row recycling


def gather_result_columns(res: KvResult,
                          active_idx: torch.Tensor) -> KvResult:
    """Gather the per-round ensemble axis of the CLIENT result planes
    down to the active column set — ``[K, E] → [K, A]``
    (engine.py:1067-1095).  ``quorum_ok`` and ``tree_corrupt`` stay
    full width."""
    idx = active_idx.to(torch.int64)

    def take(x):
        return torch.index_select(x, 1, idx)
    return res._replace(
        committed=take(res.committed), get_ok=take(res.get_ok),
        found=take(res.found), value=take(res.value),
        obj_vsn=take(res.obj_vsn))


# ---------------------------------------------------------------------------
# Integrity maintenance (the anti-entropy exchange and its sweep)


def verify_trees(state: EngineState, axis=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full integrity sweep per replica (engine.py:1099-1115): recompute
    every upper level from the stored leaves and every leaf from the
    stored object.  Per replica, so a sharded peer ``axis`` needs no
    collective.  Returns ``(node_bad [E, Ml], leaf_bad [E, Ml])``."""
    del axis
    node_bad = (build_uppers(state.tree_leaf)
                != state.tree_node).any(-1).any(-1)
    expect_leaf = hashk.obj_leaf_hash(state.obj_epoch, state.obj_seq,
                                      state.obj_val)
    leaf_bad = (expect_leaf != state.tree_leaf).any(-1).any(-1)
    return node_bad, leaf_bad


def rebuild_trees(state: EngineState, mask: torch.Tensor) -> EngineState:
    """Rebuild replicas' trees from their object stores
    (engine.py:1117-1127); ``mask [E, Ml]`` selects replicas."""
    leaves = hashk.obj_leaf_hash(state.obj_epoch, state.obj_seq,
                                 state.obj_val)
    m4 = mask[:, :, None, None]
    tree_leaf = torch.where(m4, leaves, state.tree_leaf)
    tree_node = torch.where(m4, build_uppers(tree_leaf), state.tree_node)
    return state._replace(tree_leaf=tree_leaf, tree_node=tree_node)


def _pmax2(x: torch.Tensor, axis) -> torch.Tensor:
    """Max over the peer axis (axis 1) of ``[E, Ml, S]`` → ``[E, S]``."""
    m = x.amax(1)
    return m if axis is None else axis.max(m)


def exchange_step_plain(state: EngineState, run: torch.Tensor,
                        up: torch.Tensor, axis=None
                        ) -> Tuple[EngineState, torch.Tensor, torch.Tensor]:
    """:func:`exchange_step` as torch ops (engine.py:1139-1219), new
    tensors on any device, the gate through K1's plain version (over a
    sharded peer ``axis``, the collective path): the CPU path, the
    sharded axis's path, and the oracle X1 is held against."""
    member = state.view_mask.any(1)
    heard = up & member
    met = (_quorum_met_plain(heard, heard, state.view_mask) if axis is None
           else _quorum_met(heard, heard, state.view_mask, axis))
    adopt = run & met                                        # [E]

    # Source validity is the object's leaf; a replica whose upper tree
    # is corrupt still vouches for its objects and gets its tree rebuilt.
    leaf_ok = (hashk.obj_leaf_hash(state.obj_epoch, state.obj_seq,
                                   state.obj_val)
               == state.tree_leaf).all(-1)                   # [E, Ml, S]
    node_ok = (build_uppers(state.tree_leaf)
               == state.tree_node).all(-1).all(-1)           # [E, Ml]
    h = heard[:, :, None] & leaf_ok & (state.obj_seq > 0)
    emax = _pmax2(torch.where(h, state.obj_epoch, -1), axis)  # [E, S]
    on_e = h & (state.obj_epoch == emax[:, None, :])
    smax = _pmax2(torch.where(on_e, state.obj_seq, -1), axis)
    on_max = on_e & (state.obj_seq == smax[:, None, :])
    vmax = _pmax2(torch.where(on_max, state.obj_val, _INT32_MIN), axis)
    found = smax > 0                                         # [E, S]
    w_epoch = torch.where(found, emax, 0)[:, None, :]
    w_seq = torch.where(found, smax, 0)[:, None, :]
    w_val = torch.where(found, vmax, 0)[:, None, :]

    gate = adopt[:, None] & heard                            # [E, Ml]
    tgt = gate[:, :, None] & found[:, None, :]               # [E, Ml, S]
    mismatch = ((state.obj_epoch != w_epoch) | (state.obj_seq != w_seq)
                | (state.obj_val != w_val))
    diverged = (((mismatch | ~leaf_ok) & gate[:, :, None]).any(-1)
                | (~node_ok & gate))
    obj_epoch = torch.where(tgt, w_epoch, state.obj_epoch)
    obj_seq = torch.where(tgt, w_seq, state.obj_seq)
    obj_val = torch.where(tgt, w_val, state.obj_val)

    # Leaves refresh only where a winner was adopted or the leaf was
    # already valid: rehashing a damaged no-winner leaf would bless it.
    leaves = hashk.obj_leaf_hash(obj_epoch, obj_seq, obj_val)
    fix_leaf = tgt | (leaf_ok & gate[:, :, None])
    tree_leaf = torch.where(fix_leaf[..., None], leaves, state.tree_leaf)
    tree_node = torch.where(gate[:, :, None, None], build_uppers(tree_leaf),
                            state.tree_node)
    return (state._replace(obj_epoch=obj_epoch, obj_seq=obj_seq,
                           obj_val=obj_val, tree_leaf=tree_leaf,
                           tree_node=tree_node), diverged, adopt)


def exchange_step(state: EngineState, run: torch.Tensor, up: torch.Tensor,
                  axis=None
                  ) -> Tuple[EngineState, torch.Tensor, torch.Tensor]:
    """Whole-store anti-entropy (engine.py:1139-1219, the tree exchange
    of riak_ensemble_exchange.erl:67-98): for every slot of the
    ensembles in ``run [E]`` that reach a majority of up members, the
    newest hash-valid object among the up replicas wins and every up
    replica adopts it; adopters rebuild their trees.  A slot with no
    hash-valid holder is left as it is.  Returns ``(state', diverged
    [E, Ml], synced [E])``.

    On a CUDA state it is ONE launch of kernel X1
    (:mod:`.cuda_exchange`), which steps the object and tree planes of
    the run rows IN PLACE (``state'`` is ``state``; rows outside ``run``
    keep every plane bit for bit); a caller that must roll back keeps
    those rows first (:func:`keep_rows`).  On a CPU state it is
    :func:`exchange_step_plain`, whose planes are new tensors, so
    ``state`` stays as it was.  Over a sharded peer ``axis`` it is the
    torch body with the axis's collectives, new tensors, on the card
    too."""
    if axis is None and state.obj_epoch.device.type == "cuda":
        diverged, synced = cuda_exchange.exchange_step(state, run, up)
        return state, diverged, synced
    return exchange_step_plain(state, run, up, axis)


def keep_rows(state: EngineState, rows: np.ndarray):
    """Before a step that may write the object and tree planes of ``rows``
    (host int indices) IN PLACE — :func:`exchange_step` on the card: a
    gather of those rows' planes, and a function that writes them back
    into ``state``."""
    dev = state.obj_epoch.device
    idx = torch.as_tensor(np.asarray(rows, dtype=np.int64), device=dev)
    names = ("obj_epoch", "obj_seq", "obj_val", "tree_leaf", "tree_node")
    kept = [getattr(state, n).index_select(0, idx) for n in names]

    def restore() -> None:
        for n, t in zip(names, kept):
            getattr(state, n).index_copy_(0, idx, t)
    return restore


def reset_rows(state: EngineState, mask: torch.Tensor,
               new_view: torch.Tensor) -> EngineState:
    """Recycle ensemble rows for fresh ensembles (engine.py:1220-1259):
    clear the object store, trees, leader, seq counters and the views
    list of the rows in ``mask [E]``, install ``new_view [E, M]`` as
    their single view; the ballot ``epoch`` stays monotone per row.
    The reference rebuilds the masked replicas' trees over their cleared
    stores; every such tree is the empty store's, so its leaves and
    upper levels are written as those constants (the same bits), without
    hashing the whole store on every create and destroy."""
    s = state.obj_epoch.shape[-1]
    zero = torch.zeros((), dtype=I32, device=mask.device)
    empty_leaf = hashk.obj_leaf_hash(zero, zero, zero)       # [LANES]
    empty_uppers = build_uppers(empty_leaf.expand(s, hashk.LANES))
    m4 = mask[:, None, None, None]
    head_view = torch.cat(
        [new_view[:, None, :],
         torch.zeros_like(state.view_mask[:, 1:, :])], dim=1)
    m1 = mask[:, None]
    m3 = mask[:, None, None]
    st = state._replace(
        fact_seq=torch.where(m1, 0, state.fact_seq),
        leader=torch.where(mask, -1, state.leader),
        view_mask=torch.where(m3, head_view, state.view_mask),
        view_vsn=torch.where(mask, state.view_vsn + 1, state.view_vsn),
        pend_vsn=torch.where(mask, 0, state.pend_vsn),
        commit_vsn=torch.where(mask, 0, state.commit_vsn),
        obj_seq_ctr=torch.where(mask, 0, state.obj_seq_ctr),
        obj_epoch=torch.where(m3, 0, state.obj_epoch),
        obj_seq=torch.where(m3, 0, state.obj_seq),
        obj_val=torch.where(m3, 0, state.obj_val),
        tree_leaf=torch.where(m4, empty_leaf, state.tree_leaf),
        tree_node=torch.where(m4, empty_uppers, state.tree_node),
    )
    return st


# ---------------------------------------------------------------------------
# Membership reconfiguration (joint consensus)


def _quorum_met_plain(ack: torch.Tensor, heard: torch.Tensor,
                      view_mask: torch.Tensor) -> torch.Tensor:
    """:func:`_quorum_met` through K1's plain version on any device —
    the quorum of the plain reconfig twins."""
    return quorum_met_eplain(ack, heard & ~ack,
                             view_mask) == quorum_lib.MET


def _reconfig_gate(state: EngineState, up: torch.Tensor, axis=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(heard [E, Ml], commit quorum in every CURRENT view [E]) — the
    try_commit gate on epoch-matching acks (engine.py:1262-1278), through
    K1's plain version, or over a sharded peer ``axis`` the collective
    path."""
    ml = state.epoch.shape[1]
    heard = up & state.view_mask.any(1)
    gidx = _global_peer_idx(ml, up.device, axis)
    is_leader = gidx[None, :] == state.leader[:, None]
    lead_epoch = _psum(torch.where(is_leader, state.epoch, 0), axis)
    ack = heard & (state.epoch == lead_epoch[:, None])
    met = (_quorum_met_plain(ack, heard, state.view_mask) if axis is None
           else _quorum_met(ack, heard, state.view_mask, axis))
    return heard, met & (state.leader >= 0)


def reconfig_propose_plain(state: EngineState, propose: torch.Tensor,
                           new_view: torch.Tensor, vsn: torch.Tensor,
                           up: torch.Tensor, axis=None
                           ) -> Tuple[EngineState, torch.Tensor]:
    """:func:`reconfig_propose` as torch ops, new tensors on any device
    (engine.py:1281-1328): cons ``new_view`` onto the views list where
    the commit gate holds in every current view, ``vsn > pend_vsn``, the
    view is non-empty and the list's last slot is free.  The CPU path,
    the sharded axis's path and R1's oracle for the install alone."""
    heard, commit_ok = _reconfig_gate(state, up, axis)
    tail_used = _pany(state.view_mask[:, -1, :], axis)
    install = (propose & commit_ok & _pany(new_view, axis) & ~tail_used
               & (vsn > state.pend_vsn))
    shifted = torch.cat([new_view[:, None, :], state.view_mask[:, :-1, :]],
                        dim=1)
    bump = install[:, None] & heard
    return state._replace(
        view_mask=torch.where(install[:, None, None], shifted,
                              state.view_mask),
        view_vsn=torch.where(install, state.view_vsn + 1, state.view_vsn),
        pend_vsn=torch.where(install, vsn, state.pend_vsn),
        fact_seq=torch.where(bump, state.fact_seq + 1, state.fact_seq),
    ), install


def reconfig_transition_plain(state: EngineState, run: torch.Tensor,
                              up: torch.Tensor, axis=None
                              ) -> Tuple[EngineState, torch.Tensor]:
    """:func:`reconfig_transition` as torch ops, new tensors on any
    device (engine.py:1331-1357): a joint ensemble in ``run`` whose
    commit gate holds in every view keeps only its head view and records
    ``commit_vsn = pend_vsn``.  The CPU path, the sharded axis's path and
    R1's oracle for the collapse alone."""
    heard, commit_ok = _reconfig_gate(state, up, axis)
    collapse = run & _pany(state.view_mask[:, 1:, :].any(1), axis) & commit_ok
    head_only = torch.cat([state.view_mask[:, :1, :],
                           torch.zeros_like(state.view_mask[:, 1:, :])],
                          dim=1)
    bump = collapse[:, None] & heard
    return state._replace(
        view_mask=torch.where(collapse[:, None, None], head_only,
                              state.view_mask),
        view_vsn=torch.where(collapse, state.view_vsn + 1, state.view_vsn),
        commit_vsn=torch.where(collapse, state.pend_vsn, state.commit_vsn),
        fact_seq=torch.where(bump, state.fact_seq + 1, state.fact_seq),
    ), collapse


_RECONFIG_PLANES = ("view_mask", "view_vsn", "pend_vsn", "commit_vsn",
                    "fact_seq")


def _stepped(state: EngineState, new: EngineState) -> EngineState:
    """A CUDA state takes the reconfig's planes IN PLACE, as F1 steps
    its planes (the donated contract); a CPU state gets the new
    tensors, so the caller's snapshot of the old ones stays valid.
    (The sharded peer axis's torch path, on the card.)"""
    if state.epoch.device.type == "cpu":
        return new
    for name in _RECONFIG_PLANES:
        getattr(state, name).copy_(getattr(new, name))
    return state


def _r1(state: EngineState, axis) -> bool:
    """Whether a reconfig op runs as kernel R1: a CUDA state with the
    peer axis unsharded."""
    return axis is None and state.epoch.device.type == "cuda"


def reconfig_propose(state: EngineState, propose: torch.Tensor,
                     new_view: torch.Tensor, vsn: torch.Tensor,
                     up: torch.Tensor, axis=None
                     ) -> Tuple[EngineState, torch.Tensor]:
    """Batched ``update_members`` + ``maybe_change_views``
    (engine.py:1281-1328, peer.erl:655-672, 1115-1135): propose [E]
    bool, new_view [E, Ml] bool, vsn [E] int32 (the pending change's
    version), up [E, Ml] bool.  Installs where a commit quorum holds in
    every current view, ``vsn > pend_vsn``, the view is non-empty and
    the list has a free slot: views = [new | views], ``view_vsn``
    bumps, ``pend_vsn`` adopts ``vsn``, ``fact_seq`` bumps on the
    replicas that heard it.  On CUDA one launch of kernel R1
    (:mod:`.cuda_reconfig`, ``run`` all false), the state stepped in
    place.  Returns (state', installed [E])."""
    if _r1(state, axis):
        installed, _ = cuda_reconfig.reconfig_step(
            state, propose, new_view, vsn, torch.zeros_like(propose), up)
        return state, installed
    new, install = reconfig_propose_plain(state, propose, new_view, vsn,
                                          up, axis)
    return _stepped(state, new), install


def reconfig_transition(state: EngineState, run: torch.Tensor,
                        up: torch.Tensor, axis=None
                        ) -> Tuple[EngineState, torch.Tensor]:
    """Batched ``maybe_transition`` / ``transition`` (engine.py:
    1331-1357, peer.erl:751-774): a joint ensemble in ``run`` with a
    commit quorum in EVERY view collapses to its head view and records
    ``commit_vsn = pend_vsn``.  On CUDA one launch of kernel R1 (no
    proposal), the state stepped in place.  Returns (state',
    collapsed [E])."""
    if _r1(state, axis):
        _, collapsed = cuda_reconfig.reconfig_step(state, None, None, None,
                                                   run, up)
        return state, collapsed
    new, collapse = reconfig_transition_plain(state, run, up, axis)
    return _stepped(state, new), collapse


def reconfig_step(state: EngineState, propose: torch.Tensor,
                  new_view: torch.Tensor, up: torch.Tensor, axis=None
                  ) -> Tuple[EngineState, torch.Tensor, torch.Tensor]:
    """One reconfig phase per ensemble (engine.py:1360-1384):
    ensembles in ``propose`` cons ``new_view`` at version
    ``pend_vsn + 1``, the rest transition if joint and able.  On CUDA
    ONE launch of kernel R1 (``vsn`` and ``run`` derived in the kernel),
    the state stepped in place: the propose and transition rows are
    disjoint and an install touches only its own row, so one pass per
    row gives the two steps' result.  Returns (state', installed [E],
    collapsed [E])."""
    if _r1(state, axis):
        installed, collapsed = cuda_reconfig.reconfig_step(
            state, propose, new_view, None, None, up)
        return state, installed, collapsed
    state, installed = reconfig_propose(state, propose, new_view,
                                        state.pend_vsn + 1, up, axis)
    state, collapsed = reconfig_transition(state, ~propose, up, axis)
    return state, installed, collapsed


def reconfig_step_plain(state: EngineState, propose: torch.Tensor,
                        new_view: torch.Tensor, up: torch.Tensor
                        ) -> Tuple[EngineState, torch.Tensor, torch.Tensor]:
    """:func:`reconfig_step` through K1's plain version, as new tensors
    on any device: the oracle R1 is held against."""
    state, installed = reconfig_propose_plain(state, propose, new_view,
                                              state.pend_vsn + 1, up)
    state, collapsed = reconfig_transition_plain(state, ~propose, up)
    return state, installed, collapsed
