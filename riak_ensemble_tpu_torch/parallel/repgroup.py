"""Replica quorum across OS-process failure domains — the scale path's
availability story.

Port of ``riak_ensemble_tpu/parallel/repgroup.py`` onto the port's own
service, wire codec, fault plane and obs plane; it imports nothing of
the JAX package, and its frames, entries, CRCs, snapshots and WAL
records are the reference's byte for byte, so a leader of either
package ships to replicas of the other.  What changed in the port:

- the replica's in-place delta apply (the object-plane scatter of the
  committed cells, the merge gather, the touched rows' tree rebuild, the
  tree-patch scatter) runs as Torch ops on the lane's device, where the
  reference ran compiled ``jnp`` programs; cells are unique per scatter
  (the run's last write per (ensemble, slot) wins on the host), so no
  device scatter carries an index twice, and nothing is padded;
- a full-plane entry re-executes through the service's launch halves,
  i.e. through kernel F1 on the card (its plain version on the CPU);
- :class:`ReplicatedService`, :class:`ReplicaServer` and :func:`main`
  run on CUDA unless ``device="cpu"`` (``--device cpu``) is given, and
  raise without a card;
- engine planes cross the wire as numpy with the reference's dtypes
  (the tree planes as uint32), and every host read of a device plane is
  a blocking copy on the lane's stream.

The reference's availability model is M peers on M *machines*: every
commit's quorum crosses node boundaries
(``riak_ensemble_msg.erl:132-142`` sends to remote pids; one process
hierarchy per node, ``doc/Readme.md:49-63``), so a machine dying
neither loses acked data nor stops service.  The batched service held
all M replica "lanes" of an ensemble in ONE process's device arrays —
durable (WAL) but not available across a host death.  This module
closes that gap with a **replication group**:

- **N host processes**, each holding a single-peer engine shard
  (``n_peers=1``) of ALL the group's ensembles plus its own
  :class:`~riak_ensemble_tpu_torch.parallel.wal.ServiceWAL`.  One host is
  the **leader** (the client-facing
  :class:`ReplicatedService`); the rest run :class:`ReplicaServer`.
- Every device launch the leader performs — the whole ``[K, E]`` op
  plane, the election vector, the lease vector — is **shipped to every
  replica host over the restricted wire codec** and applied through
  the same jitted kernels.  Identical inputs over identical state make
  the lanes bit-equal by induction (all-int32 kernels), which is what
  lets ONE batched protocol replace per-op consensus messages: the
  cross-host agreement is per *launch*, amortized over every op in it
  (the msg.erl fan-out/collect as one frame per host per flush).
- **The commit barrier is a host-level quorum of WAL-persisted
  acks**: each replica fsyncs the batch's committed records before
  acking, and the leader resolves client futures as 'ok' only when
  ``1 + acks >= majority(group)`` — otherwise every op in the flush
  resolves 'failed' while the device-side bookkeeping stands (the
  unacked-commit ambiguity the reference also allows under timeout).
- **Epoch/seq fencing** (the vertical-Paxos shape of the reference's
  epoch discipline, peer.erl:877-885): applies carry a group epoch and
  a batch sequence; a replica accepts seq N+1 at its promised epoch
  only.  Leader takeover = promise round to a majority (grants persist
  before they're answered), adopt the newest ``(epoch, seq)`` state
  among the grants, bump the epoch — after which the old leader's
  straggler applies are nacked and it steps down (the sc.erl
  partition premise, test/sc.erl:1012-1036).
- **Catch-up**: a restarted or diverged replica is re-synced with a
  full state snapshot (engine arrays + keyed host mirrors) pushed by
  the leader, then rides the apply stream again.  Divergence is
  *detected*, not assumed: every ack carries a CRC of the result
  planes and a mismatch marks the replica for re-sync (a cross-host
  integrity check the reference's disterl transport never had).

Determinism notes (why lanes stay bit-equal): election and lease
vectors are computed once by the leader and shipped verbatim (a
replica recomputing ``lease_ok`` from its own clock could disagree);
payload handles are allocated by the leader and ride in the frame;
all kernels are int32 (no float nondeterminism).  Physical corruption
on one host is by nature non-deterministic — it surfaces as a CRC
mismatch and heals through re-sync.

- **Dynamic host membership** (round 5): the group's member set is a
  config record ``(cver, hosts, joint)`` riding the SAME (epoch, seq)
  apply stream as data — grow, shrink, or replace hosts at runtime via
  ``update_members([(host, port), ...])``.  Joint consensus at host
  granularity: while ``joint`` is set, every commit (and every
  takeover) needs a majority of BOTH lists (the multi-view AND,
  msg.erl:377-418; update_members/transition,
  riak_ensemble_peer.erl:655-672,751-774); a joining host is never
  counted before its re-sync completes (synced-before-counted), and
  the collapse record only ships once a majority of the NEW set holds
  the full state.  Campaign safety follows Raft's
  latest-config-in-the-log rule: a candidate adopts the newest config
  among its grants/pulled state and re-validates its quorum under it —
  any committed config is held by at least one member of every
  majority the previous config admits.  Every ensemble's member set is
  the full host set.

Wire protocol (length-prefixed frames, :mod:`riak_ensemble_tpu_torch.wire`):

    leader -> replica
      ("hello", ge)                     handshake on (re)connect
      ("promise", ge)                   takeover prepare
      ("pull",)                         fetch full state (new leader)
      ("install", ge, seq, state, cfg)  push full state (re-sync)
      ("abatch", ge, [entry, ...])      coalesced launch batch; one
                                        raw frame, one cumulative ack.
                                        entry is either a changed-slot
                                        DELTA ("d", seq, k, nc, cols,
                                        counts, js, slots, vals,
                                        rmw_bits, quorum_bits, crc,
                                        meta, fid) or a FULL-plane
                                        fallback ("f", seq, k,
                                        want_vsn, elect, lease, kind,
                                        slot, val, exp_e, exp_s, meta,
                                        fid); meta = put-lane (round,
                                        ens, key, handle, payload)
                                        records; fid = the leader's
                                        obs flush_id (trailing term-
                                        header field, 0 when tracing
                                        is off) — replica apply spans
                                        record under it so one id
                                        names the flush end to end
      ("apply", ge, seq, k, want_vsn, elect, lease, kind, slot, val,
       exp_e, exp_s, meta)              legacy single full-plane
                                        launch (still served)
      ("cfg", ge, seq, cver, hosts, joint)  group-config record
      ("promote", peers, tick)          control: become the leader
      ("status",)                       control: role/epoch/seq
    replica -> leader
      ("helloed", promised, applied_ge, applied_seq)
      ("promised", granted, promised, applied_ge, applied_seq, cfg)
      ("state", ge, seq, state, cfg) | ("installed", ge, seq)
      ("applied", ge, seq, crc) | ("nack", why, promised, age, aseq)

Frames are pipelined per link (FIFO window): responses return in send
order over the replica's sequential per-connection loop.

Delta replication transport (round 6): the leader's resolve half knows
exactly which (ensemble, slot) rows a launch committed, so the common
apply frame ships ONLY those rows — the wire cost scales with what
changed, not with the [K, E] grid (the synctree
payload-proportional-to-change economics applied to the apply stream).
A replica applies a delta IN PLACE: scatter the committed cells into
its object planes, advance the per-ensemble seq counters, rebuild the
touched rows' trees — no device re-execution — and the result is
bit-equal to a full-plane re-execution by construction (commit
epochs/seqs are derivable: epoch is the replica's own ballot plane,
seqs are consecutive per column from its own obj_seq_ctr).  Launches
with elections, leader-side corruption/exchange, bulk device-resident
planes, or a delta-ineligible shape fall back to full-plane entries in
the same stream; re-syncs and install barriers ride ahead exactly as
before.  Entries coalesce: all launches settled by one flush (up to
``repl_window``) ship as ONE raw frame per link — one encode, one
scatter-gather write — and the replica applies the batch through one
mirror/WAL pass, answering one cumulative ack.
"""

from __future__ import annotations

import os
import queue
import socket
import struct
import sys
import threading
import time
import zlib
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from riak_ensemble_tpu_torch import faults, funref, obs, wire
from riak_ensemble_tpu_torch.config import Config
from riak_ensemble_tpu_torch.interop import UINT32_FIELDS
from riak_ensemble_tpu_torch.ops import engine as eng
from riak_ensemble_tpu_torch.ops import hash as hashk
from riak_ensemble_tpu_torch.parallel.batched_host import (
    BatchedEnsembleService, WallRuntime, _PendingBatch)
from riak_ensemble_tpu_torch.types import NOTFOUND

_HDR = struct.Struct(">I")
#: install frames carry full engine-state snapshots
_MAX_FRAME = 256 << 20


class DeposedError(RuntimeError):
    """This leader's group epoch was superseded — stop serving."""


# -- framing -----------------------------------------------------------------

def send_frame(sock: socket.socket, value: Any) -> None:
    payload = wire.encode(value)
    sock.sendall(_HDR.pack(len(payload)) + payload)


def recv_frame(sock: socket.socket) -> Any:
    head = _recv_exact(sock, _HDR.size)
    (length,) = _HDR.unpack(head)
    if length > _MAX_FRAME:
        raise wire.WireError(f"frame too large: {length}")
    return wire.decode(_recv_exact(sock, length))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


# -- plane / result codecs ---------------------------------------------------

def _pack_bool(v: np.ndarray) -> bytes:
    return np.packbits(np.asarray(v, bool)).tobytes()


def _unpack_bool(b: bytes, n: int) -> np.ndarray:
    return np.unpackbits(np.frombuffer(b, np.uint8), count=n).astype(bool)


def _pack_i32(v: Optional[np.ndarray]) -> Optional[bytes]:
    return None if v is None else np.asarray(v, np.int32).tobytes()


def _unpack_i32(b: Optional[bytes], shape) -> Optional[np.ndarray]:
    if b is None:
        return None
    return np.frombuffer(b, np.int32).reshape(shape).copy()


def result_crc(committed: Optional[np.ndarray],
               vsn: Optional[np.ndarray]) -> int:
    """CRC of the launch's commit/version outcome — the cross-host
    divergence detector carried in every ack."""
    crc = 0
    if committed is not None:
        crc = zlib.crc32(np.packbits(committed).tobytes(), crc)
    if vsn is not None:
        crc = zlib.crc32(np.ascontiguousarray(vsn).tobytes(), crc)
    return crc


# -- state snapshot ----------------------------------------------------------

def _host(t: torch.Tensor, name: str = "") -> np.ndarray:
    """A device plane as numpy with the reference's dtype (the tree
    planes back to uint32): one blocking copy on the lane's stream, so
    it sees every launch queued before it."""
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if name in UINT32_FIELDS else a


def _device_plane(raw: bytes, dt: str, shape, name: str,
                  device: torch.device) -> torch.Tensor:
    """Inverse of :func:`_host` for one wire plane: a fresh tensor on
    ``device`` (uint32 tree planes as their int32 bit patterns)."""
    a = np.frombuffer(raw, np.dtype(dt)).reshape(shape)
    if name in UINT32_FIELDS:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def dump_state(svc: BatchedEnsembleService) -> Tuple:
    """Full snapshot of one host's lane: every engine array plus the
    keyed host mirrors a promoted leader needs — including the
    dynamic-lifecycle directory (live rows, free pool, tenant names)
    when the group serves dynamic tenants.  Wire-safe (no pickle: the
    group transport keeps the no-code-on-decode trust model of the
    cluster transport)."""
    fields = []
    for name, arr in zip(eng.EngineState._fields, svc.state):
        a = _host(arr, name)
        fields.append((name, a.dtype.str, list(a.shape), a.tobytes()))
    host = (
        [list(ks.items()) for ks in svc.key_slot],
        [list(sh.items()) for sh in svc.slot_handle],
        list(svc.values.items()),
        int(svc._next_handle),
        _pack_i32(svc.leader_np),
        bool(svc.dynamic),
        _pack_bool(svc._live),
        list(svc._free_rows),
        list(svc._ens_names.items()),
        _pack_bool(svc.member_np.ravel()),
        [sorted(s) for s in svc._inline_slots],
    )
    return (tuple(fields), host)


def install_state(svc: BatchedEnsembleService, dump: Tuple) -> None:
    """Inverse of :func:`dump_state`: make this host's lane bit-equal
    to the dumped one.  Derived host structures (free slots, slot
    generations) are recomputed — they are per-process queue
    bookkeeping, not replicated state."""
    fields, host = dump
    if bool(host[5]) != svc.dynamic:
        # a mixed group would HALF-sync (directory dropped or stale):
        # fail BEFORE any mutation — a torn half-install would leave
        # snapshot arrays over stale derived mirrors (review r4)
        raise ValueError(
            f"lifecycle-mode mismatch: snapshot dynamic={bool(host[5])}"
            f" vs this lane dynamic={svc.dynamic} — every group host "
            "must run the same --dynamic setting")
    by_name = {name: (dt, shape, raw) for name, dt, shape, raw in fields}
    new = {}
    for name in eng.EngineState._fields:
        dt, shape, raw = by_name[name]
        new[name] = _device_plane(raw, dt, shape, name, svc.device)
    svc.state = eng.EngineState(**new)
    (key_slot, slot_handle, values, next_handle, leader_b, dynamic,
     live_b, free_rows, ens_names, member_b, *rest) = host
    inline = (rest[0] if rest
              else [[] for _ in range(svc.n_ens)])
    svc._inline_slots = [set(int(s) for s in row) for row in inline]
    svc._inline_np[:] = False
    for row, slots_ in enumerate(svc._inline_slots):
        if slots_:  # storage-class slab rides with the sets
            svc._inline_np[row, list(slots_)] = True
    svc.key_slot = [dict(pairs) for pairs in key_slot]
    svc.slot_handle = [{int(s): int(h) for s, h in pairs}
                       for pairs in slot_handle]
    svc.values = {int(h): v for h, v in values}
    svc._next_handle = int(next_handle)
    svc._free_handles = []
    svc.leader_np = _unpack_i32(leader_b, (svc.n_ens,))
    svc.member_np = _unpack_bool(member_b,
                                 svc.n_ens * svc.n_peers).reshape(
        svc.n_ens, svc.n_peers)
    if bool(dynamic):
        svc.dynamic = True
        svc._live = _unpack_bool(live_b, svc.n_ens)
        svc._free_rows = [int(r) for r in free_rows]
        svc._ens_names = dict(ens_names)
        svc._row_name = {r: n for n, r in svc._ens_names.items()}
    rebuild_derived(svc)


def rebuild_derived(svc: BatchedEnsembleService) -> None:
    """Recompute free-slot lists / slot generations from the keyed
    mirrors (used after install and before a replica checkpoints —
    replicas don't maintain them incrementally).  The read fast
    path's caches reset with them: the snapshot superseded whatever
    versions/inline values were mirrored (they repopulate lazily —
    each miss takes the device round, whose resolve re-mirrors).
    The pending-write index is NOT cleared: it tracks live queue
    entries, which survive an install and still resolve afterward."""
    for e in range(svc.n_ens):
        used = set(svc.key_slot[e].values())
        svc.free_slots[e] = [s for s in range(svc.n_slots)
                             if s not in used]
        svc.slot_gen[e] = {}
        svc._recycle_pending[e] = []
        svc._slot_vsn_ok[e] = False
        svc._inline_value_ok[e] = False


# -- incremental (Merkle) catch-up -------------------------------------------
#
# The full snapshot install ships EVERY engine array + host mirror per
# re-sync — O(state).  A restarted replica usually diverges in a
# handful of slots, and both sides already hold the device Merkle
# trees, so divergence is findable for O(width·height·diffs) traffic
# (synctree.erl:372-417, riak_ensemble_exchange.erl:67-98; the
# cross-process streamed form proven in synctree/remote_sync.py).  The
# catch-up protocol, leader-driven over the FIFO link:
#
#   ("troots",)        -> per-ensemble root hashes [E, LANES] (+ the
#                         replica's frozen (ge, seq) — the diff is only
#                         valid against a replica that is NACKING the
#                         apply stream; any state change voids it)
#   ("tleaves", rows)  -> leaf planes [n, S, LANES] for diverged rows
#   ("tpatch", ge, seq, expect, meta, patches)
#                      -> control-plane vectors (O(E), small) + the
#                         diverged slots' objects/keys/payloads only;
#                         guarded by expect == the replica's (ge, seq)
#                         at probe time — a mismatch nacks and the
#                         leader falls back to the full snapshot.
#
# The probe runs in a thread (never blocking the commit path); the
# patch itself is built in a flush preamble and re-diffs the CURRENT
# leader roots against the cached replica roots, so leader-side writes
# (epoch rewrites on reads included — any device mutation moves a
# root) between probe and patch are covered at row granularity.

#: per-ensemble control-plane vectors shipped whole with every patch
_META_FIELDS = ("epoch", "fact_seq", "leader", "view_mask", "view_vsn",
                "pend_vsn", "commit_vsn", "obj_seq_ctr")


def dump_meta(svc: BatchedEnsembleService) -> Tuple:
    """The per-ensemble control plane WITHOUT the O(keys) payload:
    ballot vectors, membership rows, dynamic directory."""
    vecs = []
    for name in _META_FIELDS:
        a = _host(getattr(svc.state, name), name)
        vecs.append((name, a.dtype.str, list(a.shape), a.tobytes()))
    host = (_pack_i32(svc.leader_np), bool(svc.dynamic),
            _pack_bool(svc._live), list(svc._free_rows),
            list(svc._ens_names.items()),
            _pack_bool(svc.member_np.ravel()), int(svc._next_handle))
    return (tuple(vecs), host)


def meta_dynamic(meta: Tuple) -> bool:
    """The lifecycle-mode flag carried by a :func:`dump_meta` tuple —
    checkable WITHOUT applying anything (handle_tpatch validates it
    before the first mutation)."""
    return bool(meta[1][1])


def install_meta(svc: BatchedEnsembleService, meta: Tuple) -> None:
    vecs, host = meta
    (leader_b, dynamic, live_b, free_rows, ens_names, member_b,
     next_handle) = host
    if bool(dynamic) != svc.dynamic:
        # validate BEFORE any mutation (ADVICE r5): assigning the
        # leader's control-plane vectors and THEN failing would leave
        # this lane holding them over its own object planes at its
        # old (ge, seq) — mixed state a campaign could serve from
        raise ValueError("lifecycle-mode mismatch in tree patch")
    new = {name: _device_plane(raw, dt, shape, name, svc.device)
           for name, dt, shape, raw in vecs}
    svc.state = svc.state._replace(**new)
    svc.leader_np = _unpack_i32(leader_b, (svc.n_ens,))
    svc.member_np = _unpack_bool(
        member_b, svc.n_ens * svc.n_peers).reshape(svc.n_ens,
                                                   svc.n_peers)
    if bool(dynamic):
        svc._live = _unpack_bool(live_b, svc.n_ens)
        svc._free_rows = [int(r) for r in free_rows]
        svc._ens_names = dict(ens_names)
        svc._row_name = {r: n for n, r in svc._ens_names.items()}
    svc._next_handle = max(svc._next_handle, int(next_handle))
    svc._up_dev = None


def _rebuild_rows(st: eng.EngineState, rows: np.ndarray) -> eng.EngineState:
    """:func:`..ops.engine.rebuild_trees` for the ensembles selected by
    ``rows [E, M]``, hashing only their stores: the selected rows' leaves
    and upper levels come out bit-equal to the whole-store rebuild's, and
    the rest stay as they are (written in place)."""
    idx_np = np.flatnonzero(np.asarray(rows, bool).any(axis=1))
    if not idx_np.size:
        return st
    idx = torch.from_numpy(idx_np).to(st.obj_epoch.device)
    sel = torch.from_numpy(np.asarray(rows, bool)[idx_np]).to(
        st.obj_epoch.device)[:, :, None, None]
    leaves = hashk.obj_leaf_hash(st.obj_epoch[idx], st.obj_seq[idx],
                                     st.obj_val[idx])
    st.tree_leaf[idx] = torch.where(sel, leaves, st.tree_leaf[idx])
    st.tree_node[idx] = torch.where(sel, eng.build_uppers(leaves),
                                    st.tree_node[idx])
    return st


def _put_cells(svc: BatchedEnsembleService, cells: np.ndarray) -> None:
    """Write cells ``[n, (e, s, epoch, seq, val)]`` into the lane's
    object planes in place, one ``index_put_`` per plane.  The cells
    must be unique per (e, s): a scatter that carried an index twice
    would have no defined winner on CUDA."""
    c = torch.from_numpy(np.ascontiguousarray(cells, np.int32)).to(
        svc.device)
    e_j, s_j = c[:, 0].long(), c[:, 1].long()
    st = svc.state
    # [E, S] views of the single-peer lane
    st.obj_epoch[:, 0].index_put_((e_j, s_j), c[:, 2])
    st.obj_seq[:, 0].index_put_((e_j, s_j), c[:, 3])
    st.obj_val[:, 0].index_put_((e_j, s_j), c[:, 4])


def _delta_scatter_cells(svc: BatchedEnsembleService,
                         cells: np.ndarray, ctr_np: np.ndarray,
                         rows: np.ndarray,
                         marks: Optional[Dict[str, float]] = None
                         ) -> None:
    """Land committed cells ``[n, (e, s, epoch, seq, val)]`` in the
    lane's object planes IN PLACE, then swap the per-ensemble seq
    counters and rebuild the touched rows' trees
    (repgroup.py:414-493's two compiled programs, as Torch ops; the
    rebuild hashes the touched rows only).  The
    caller's cells are unique per (e, s) (:func:`_put_cells`).
    ``marks`` (obs tracing) gets the scatter / rebuild split in seconds
    (dispatch times: nothing here waits for the device)."""
    t0 = time.perf_counter()
    st = svc.state
    if cells.shape[0]:
        _put_cells(svc, cells)
    if marks is not None:
        t1 = time.perf_counter()
        marks["scatter"] = t1 - t0
    st.obj_seq_ctr.copy_(torch.from_numpy(
        np.ascontiguousarray(ctr_np, np.int32)))
    svc.state = _rebuild_rows(st, rows)
    if marks is not None:
        marks["rebuild"] = time.perf_counter() - t1


def _merge_gather_cells(svc: BatchedEnsembleService, e_j: np.ndarray,
                        s_j: np.ndarray, mcls: np.ndarray,
                        ops: np.ndarray) -> np.ndarray:
    """Fold merged operands against the lane's PRE-RUN device values
    (repgroup.py:499-550): one gather of the cells' current values and
    :func:`..ops.engine.merge_vals` on the lane's device, read back
    blocking — the folded values feed the host walk's WAL records and
    mirrors."""
    dev = svc.device

    def t(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    cur = svc.state.obj_val[:, 0][t(e_j).long(), t(s_j).long()]
    return _host(eng.merge_vals(cur, t(mcls), t(ops))).astype(np.int32)


def warm_delta_apply(svc: BatchedEnsembleService) -> None:
    """First-touch the delta-apply ops on the lane's device before the
    first batch (repgroup.py:553-586): an empty cell scatter, a merge
    gather of cell (0, 0) and a tree rebuild with no row selected.  The
    port compiles nothing; this only moves the first calls' one-time
    costs out of an ack.  A no-op on state."""
    svc._in_warmup = True
    try:
        _delta_scatter_cells(
            svc, np.zeros((0, 5), np.int32),
            _host(svc.state.obj_seq_ctr).astype(np.int32),
            np.zeros((svc.n_ens, svc.n_peers), bool))
        z = np.zeros((1,), np.int32)
        _merge_gather_cells(svc, z, z, z, z)
    finally:
        svc._in_warmup = False


def tree_roots(svc: BatchedEnsembleService) -> np.ndarray:
    """Per-ensemble root hashes of the single-peer lane: [E, LANES]
    (the root is the LAST entry of the concatenated upper levels)."""
    return _host(svc.state.tree_node[:, 0, -1, :], "tree_node")


def tree_leaves(svc: BatchedEnsembleService,
                rows: Sequence[int]) -> np.ndarray:
    """Leaf planes for the given ensemble rows: [n, S, LANES] — one
    device gather, only the requested rows cross the link."""
    idx = torch.as_tensor(np.asarray(list(rows), np.int64),
                          device=svc.device)
    return _host(svc.state.tree_leaf[idx, 0], "tree_leaf")


class _TreeSync:
    """Leader-side catch-up state for one link (probe thread output +
    the cached replica tree the patch build re-diffs against)."""

    __slots__ = ("result", "expect", "remote_roots", "remote_leaves",
                 "bytes")

    def __init__(self) -> None:
        self.result: Optional[str] = None   # None=running|patch|full
        self.expect = (0, 0)
        self.remote_roots: Optional[np.ndarray] = None
        self.remote_leaves: Dict[int, np.ndarray] = {}
        self.bytes = 0


# -- group metadata persistence ----------------------------------------------

_GRP_KEY = ("grp",)

#: group configuration: (cver, hosts, joint) — cver a monotone config
#: version, hosts the committed member address list (None = legacy
#: implicit mode where group_size alone defines the quorum), joint the
#: incoming member list during a joint-consensus transition (commits
#: then need a majority of BOTH lists — msg.erl:377-418's multi-view
#: AND at host granularity).  Addresses are exact-match identities:
#: every group host must be listed with the same (host, port) string
#: everywhere.
GroupCfg = Tuple[int, Optional[Tuple], Optional[Tuple]]

NO_CFG: GroupCfg = (0, None, None)


def _norm_addrs(hosts) -> Optional[Tuple]:
    if hosts is None:
        return None
    return tuple((str(h), int(p)) for h, p in hosts)


def _norm_cfg(cfg) -> GroupCfg:
    if not cfg:
        return NO_CFG
    cver, hosts, joint = cfg
    return (int(cver), _norm_addrs(hosts), _norm_addrs(joint))


def load_group_meta(svc: BatchedEnsembleService
                    ) -> Tuple[int, int, int, GroupCfg]:
    """(promised_ge, applied_ge, applied_seq, cfg) from the WAL, or
    zeros/NO_CFG.  Pre-round-5 records (no cfg element) read as
    legacy implicit membership."""
    if svc._wal is None:
        return (0, 0, 0, NO_CFG)
    for key, value in svc._wal.records():
        if key == _GRP_KEY:
            cfg = _norm_cfg(value[3]) if len(value) > 3 else NO_CFG
            return (int(value[0]), int(value[1]), int(value[2]), cfg)
    return (0, 0, 0, NO_CFG)


def save_group_meta(svc: BatchedEnsembleService, promised: int,
                    applied_ge: int, applied_seq: int,
                    cfg: GroupCfg = NO_CFG) -> None:
    if svc._wal is not None:
        svc._wal.log([(_GRP_KEY,
                       (promised, applied_ge, applied_seq, cfg))])


# -- apply-frame construction ------------------------------------------------

def _entries_meta(entries, kind: np.ndarray, slot: np.ndarray,
                  values: Dict[int, Any]) -> List[Tuple]:
    """Put/CAS/RMW lane metadata for the replicas' WALs and keyed
    mirrors: (round j, ensemble e, key, handle, payload).  Mirrors
    the iteration order of ``_log_wal`` so rounds line up with the op
    planes.  RMW lanes carry (key, 0, None) — their committed value is
    device-computed, so the replica reads it from its OWN result
    planes (the kind plane says which rounds are RMW)."""
    meta: List[Tuple] = []
    if entries is None:
        return meta
    for e, ops in entries:
        j = -1
        for op in ops:
            if isinstance(op, _PendingBatch):
                if op.kind in (eng.OP_PUT, eng.OP_CAS):
                    for i in range(op.n):
                        h = int(op.handle[i])
                        key = op.keys[i] if op.keys is not None else None
                        meta.append((j + 1 + i, e, key, h,
                                     values.get(h) if h else None))
                elif op.kind == eng.OP_RMW:
                    for i in range(op.n):
                        key = op.keys[i] if op.keys is not None else None
                        meta.append((j + 1 + i, e, key, 0, None))
                j += op.n
                continue
            j += 1
            if op.kind in (eng.OP_PUT, eng.OP_CAS):
                meta.append((j, e, op.key, op.handle,
                             values.get(op.handle) if op.handle
                             else None))
            elif op.kind == eng.OP_RMW:
                meta.append((j, e, op.key, 0, None))
    return meta


def build_apply_frame(ge: int, seq: int, k: int, want_vsn: bool,
                      elect: np.ndarray, lease_ok: np.ndarray,
                      kind: np.ndarray, slot: np.ndarray,
                      val: np.ndarray, exp_e: Optional[np.ndarray],
                      exp_s: Optional[np.ndarray],
                      meta: List[Tuple]) -> Tuple:
    return ("apply", ge, seq, k, want_vsn, _pack_bool(elect),
            _pack_bool(lease_ok), _pack_i32(kind), _pack_i32(slot),
            _pack_i32(val), _pack_i32(exp_e), _pack_i32(exp_s), meta)


def record_digest(items) -> int:
    """Canonical digest for replicated admin records (the
    version-preserving install's allocation): int-coerced tuples
    through the wire codec.  ``repr`` of mixed numpy/int tuples is not
    a stable contract across Python/numpy versions (``np.int32(5)``
    reprs differently between numpy 1.x and 2.x); the wire encoding
    of plain ints is the format both ends already agree on."""
    return zlib.crc32(wire.encode(
        [tuple(int(x) for x in item) for item in items]))


# -- changed-slot delta entries ----------------------------------------------
#
# A delta entry carries, per ensemble column with commits, the
# committed cells in round order: the round index, the written slot
# and the written value.  Everything else a full-plane re-execution
# would have produced is DERIVABLE on the replica from its own
# (bit-equal) state: the commit epoch is its ballot plane's leader
# epoch, the commit seqs are consecutive from its obj_seq_ctr, a
# GET-rewrite's value is the slot's current value (it rides in the
# shipped vals plane anyway — the leader's result planes report it).
# Sections ship as wire.Raw buffers: native byte order (the same
# contract _pack_i32 frames always had), int16 round/slot indices
# (guarded: k and n_slots must fit), int32 elsewhere.

def _idx_dtype(bound: int):
    """Narrowest unsigned dtype holding indices < bound (byte count
    rides the entry so both ends agree)."""
    return np.uint8 if bound <= 256 else np.uint16


def build_delta_entry(seq: int, k: int, committed: Optional[np.ndarray],
                      value: Optional[np.ndarray],
                      kind: np.ndarray, slot: np.ndarray,
                      val: np.ndarray, quorum_ok: np.ndarray,
                      meta: List[Tuple],
                      n_slots: int = 65536,
                      fid: int = 0,
                      native: Any = None) -> Tuple[Tuple, int, int]:
    """Build one delta entry from the leader's resolved planes.

    Returns ``(entry, crc, delta_bytes)`` — the wire entry tuple, the
    CRC over its raw sections (the ack/integrity contract), and the
    section byte count (the shipped-bytes meter).  Index sections use
    the narrowest width that fits (round index by K, slot by S,
    column/count by E/K as uint16) — at a dense write batch the entry
    runs ~6-7 bytes per committed cell against the full planes' 20.
    ``fid`` is the leader's obs flush id, a trailing header field the
    replica tags its apply spans with (cross-process flush tracing);
    it rides outside the section CRC — tracing identity, not
    replicated state.

    ``native`` is the loaded resolve kernel
    (:mod:`riak_ensemble_tpu_torch.parallel.resolve_native`): one C pass
    then emits the committed-cell sections + CRC instead of the
    nonzero/lexsort/unique/packbits numpy pipeline — byte-identical
    output (the tests' contract), same wire entry either way."""
    j_dt = _idx_dtype(max(k, 1))
    s_dt = _idx_dtype(n_slots)
    nat = None
    if (native is not None and committed is not None
            and committed.any()):
        nat = native.delta_sections(
            k, committed.shape[1], committed, value, kind, slot, val,
            np.asarray(quorum_ok, bool),
            (eng.OP_PUT, eng.OP_CAS, eng.OP_RMW), j_dt, s_dt)
    if nat is not None:
        cols, counts, jj, slots, vals, rmw_b, q_b, crc = nat
        nbytes = sum(int(s.nbytes)
                     for s in (cols, counts, jj, slots, vals, rmw_b,
                               q_b))
        entry = ("d", int(seq), int(k), int(jj.size),
                 int(j_dt().nbytes), int(s_dt().nbytes),
                 wire.Raw(cols), wire.Raw(counts), wire.Raw(jj),
                 wire.Raw(slots), wire.Raw(vals), wire.Raw(rmw_b),
                 wire.Raw(q_b), crc, meta, int(fid))
        return entry, crc, nbytes
    if committed is not None and committed.any():
        jj, ee = np.nonzero(committed)
        order = np.lexsort((jj, ee))  # column-major, round order within
        jj = jj[order].astype(j_dt)
        slots = slot[committed][order].astype(s_dt)
        is_put = np.isin(kind[committed][order],
                         (eng.OP_PUT, eng.OP_CAS))
        vals = np.where(is_put, val[committed][order],
                        value[committed][order]).astype(np.int32)
        rmw = (kind[committed][order] == eng.OP_RMW)
        cols, counts = np.unique(ee[order], return_counts=True)
        cols = cols.astype(np.uint16)
        counts = counts.astype(np.uint16)
        rmw_b = np.packbits(rmw)
    else:
        jj = np.zeros((0,), j_dt)
        slots = np.zeros((0,), s_dt)
        vals = np.zeros((0,), np.int32)
        cols = np.zeros((0,), np.uint16)
        counts = np.zeros((0,), np.uint16)
        rmw_b = np.zeros((0,), np.uint8)
    q_b = np.packbits(np.asarray(quorum_ok, bool))
    sections = (cols, counts, jj, slots, vals, rmw_b, q_b)
    crc = 0
    nbytes = 0
    for s in sections:
        b = np.ascontiguousarray(s)
        crc = zlib.crc32(b.tobytes(), crc)
        nbytes += b.nbytes
    entry = ("d", int(seq), int(k), int(jj.size),
             int(j_dt().nbytes), int(s_dt().nbytes),
             wire.Raw(np.ascontiguousarray(cols)),
             wire.Raw(np.ascontiguousarray(counts)),
             wire.Raw(np.ascontiguousarray(jj)),
             wire.Raw(np.ascontiguousarray(slots)),
             wire.Raw(np.ascontiguousarray(vals)),
             wire.Raw(np.ascontiguousarray(rmw_b)),
             wire.Raw(np.ascontiguousarray(q_b)), crc, meta,
             int(fid))
    return entry, crc, nbytes


#: RMW fun code -> "folds into a merge cell" (ordered funs and every
#: non-RMW exp_epoch value read False; the exp_epoch plane only means
#: a fun code on OP_RMW rows, so callers AND with the kind mask)
_RMW_MERGEABLE = np.zeros(16, bool)
for _code in funref.MERGE_OF:
    _RMW_MERGEABLE[_code] = True
del _code


def build_comm_entry(seq: int, k: int, committed: Optional[np.ndarray],
                     value: Optional[np.ndarray],
                     kind: np.ndarray, slot: np.ndarray,
                     val: np.ndarray, exp_e: Optional[np.ndarray],
                     quorum_ok: np.ndarray, meta: List[Tuple],
                     n_slots: int = 65536, fid: int = 0,
                     native: Any = None
                     ) -> Optional[Tuple[Tuple, int, int, int, int]]:
    """Build a commutative-replication entry ("m") when the flush has
    qualifying columns, else None (the caller ships the plain delta —
    which keeps the RETPU_COMM_REPL=0 arm AND non-commutative traffic
    byte-identical by construction; docs/ARCHITECTURE.md §18).

    A column qualifies when EVERY committed cell in it is an OP_RMW
    whose fun is commutative/semilattice AND each of its slots sees a
    single merge class (sub normalizes into add; a max-then-add slot
    stays ordered).  Qualifying columns leave the ordered sections
    entirely and ship as per-(column, slot) COALESCED cells: the
    folded operand, the merge class, the rank of the slot's LAST
    committed op inside the column (its seq offset — version vectors
    land bit-equal to the sequenced apply) and that op's round index
    (the meta join for WAL/mirror keys).  ``m_nops`` per column
    advances the replica's seq counter by the ops the cells absorbed.

    Returns ``(entry, crc, nbytes, n_cells, n_ops)`` — crc is the
    ordered-half CRC chained with the merge-section CRC (the ack
    contract covers both)."""
    if committed is None or exp_e is None or not committed.any():
        return None
    is_rmw = committed & (kind == eng.OP_RMW)
    if not is_rmw.any():
        return None
    mergeable = is_rmw & _RMW_MERGEABLE[np.clip(exp_e, 0, 15)]
    per_col = committed.sum(axis=0)
    cand = (per_col > 0) & (per_col == mergeable.sum(axis=0))
    if not cand.any():
        return None
    m_cols: List[int] = []
    m_counts: List[int] = []
    m_nops: List[int] = []
    m_slots: List[int] = []
    m_funs: List[int] = []
    m_ops: List[int] = []
    m_rl: List[int] = []
    m_jl: List[int] = []
    qual = np.zeros(committed.shape[1], bool)
    n_ops_total = 0
    fold = None
    if native is not None:
        fold = native.comm_fold(committed, exp_e, slot, val, cand)
    for c in np.nonzero(cand)[0].tolist():
        if fold is not None:
            col = fold.get(c)
            if col is None:
                continue
            cells, nops = col
        else:
            rows = np.nonzero(committed[:, c])[0]
            # slot -> [merge class, folded operand, last rank, last j]
            # in first-seen slot order (dicts preserve insertion)
            cells_d: Dict[int, List[int]] = {}
            ok = True
            for rank, j in enumerate(rows.tolist()):
                code = int(exp_e[j, c])
                s = int(slot[j, c])
                v = int(val[j, c])
                mcls = funref.MERGE_OF[code]
                cell = cells_d.get(s)
                if cell is None:
                    cells_d[s] = [mcls, funref.fold_seed(code, v),
                                  rank, j]
                elif cell[0] != mcls:
                    ok = False  # mixed classes on one slot: ordered
                    break
                else:
                    cell[1] = funref.fold_operand(code, cell[1], v)
                    cell[2] = rank
                    cell[3] = j
            if not ok:
                continue
            nops = int(rows.size)
            cells = [(s, cl[0], cl[1], cl[2], cl[3])
                     for s, cl in cells_d.items()]
        qual[c] = True
        m_cols.append(int(c))
        m_counts.append(len(cells))
        m_nops.append(nops)
        n_ops_total += nops
        for s, mcls, acc, rank, j in cells:
            m_slots.append(s)
            m_funs.append(mcls)
            m_ops.append(acc)
            m_rl.append(rank)
            m_jl.append(j)
    if not qual.any():
        return None
    # ordered half: the SAME delta builder over the non-merge columns
    # (native path and byte layout untouched)
    d_entry, d_crc, d_bytes = build_delta_entry(
        seq, k, committed & ~qual[None, :], value, kind, slot, val,
        quorum_ok, meta, n_slots=n_slots, fid=fid, native=native)
    j_dt = _idx_dtype(max(k, 1))
    s_dt = _idx_dtype(n_slots)
    sections = (np.asarray(m_cols, np.uint16),
                np.asarray(m_counts, np.uint16),
                np.asarray(m_nops, np.uint16),
                np.asarray(m_slots, s_dt),
                np.asarray(m_funs, np.uint8),
                np.asarray(m_ops, np.int32),
                np.asarray(m_rl, j_dt),
                np.asarray(m_jl, j_dt))
    mcrc = 0
    mbytes = 0
    for s in sections:
        b = np.ascontiguousarray(s)
        mcrc = zlib.crc32(b.tobytes(), mcrc)
        mbytes += b.nbytes
    entry = (("m",) + d_entry[1:14] + (len(m_slots),)
             + tuple(wire.Raw(np.ascontiguousarray(s))
                     for s in sections)
             + (mcrc, meta, int(fid)))
    return (entry, _crc_chain(d_crc, mcrc), d_bytes + mbytes,
            len(m_slots), n_ops_total)


def build_full_entry(seq: int, k: int, want_vsn: bool,
                     elect: np.ndarray, lease_ok: np.ndarray,
                     kind: np.ndarray, slot: np.ndarray,
                     val: np.ndarray, exp_e: Optional[np.ndarray],
                     exp_s: Optional[np.ndarray],
                     meta: List[Tuple],
                     fid: int = 0) -> Tuple[Tuple, int]:
    """Full-plane fallback entry (re-executed by the replica through
    the plain launch halves — elections, corruption/exchange rounds
    and delta-ineligible shapes).  Planes ride as Raw buffers so even
    the fallback never concatenates them into an intermediate bytes.
    ``fid`` = the leader's obs flush id (see build_delta_entry).
    Returns ``(entry, plane_bytes)``."""

    def raw_i32(p):
        return (None if p is None
                else wire.Raw(np.ascontiguousarray(p, np.int32)))

    eb = np.packbits(np.asarray(elect, bool))
    lb = np.packbits(np.asarray(lease_ok, bool))
    nbytes = (eb.nbytes + lb.nbytes
              + sum(int(np.asarray(p).nbytes) for p in
                    (kind, slot, val) if p is not None)
              + sum(int(np.asarray(p).nbytes) for p in (exp_e, exp_s)
                    if p is not None))
    entry = ("f", int(seq), int(k), bool(want_vsn), wire.Raw(eb),
             wire.Raw(lb), raw_i32(kind), raw_i32(slot), raw_i32(val),
             raw_i32(exp_e), raw_i32(exp_s), meta, int(fid))
    return entry, nbytes


def full_plane_nbytes(k: int, n_ens: int, cas: bool) -> int:
    """What a full-plane entry's sections cost at [K, E]: the
    kind/slot/val planes (+ exp_e/exp_s only when the launch carried
    CAS expectations — matching what :func:`build_full_entry` would
    actually ship) + the elect/lease bit vectors — the denominator of
    the delta-savings meter."""
    planes = 5 if cas else 3
    return planes * k * n_ens * 4 + 2 * ((n_ens + 7) // 8)


def _crc_chain(acc: int, entry_crc: int) -> int:
    """Fold one entry's CRC into a batch's cumulative ack CRC (order-
    sensitive: a reordered or dropped entry cannot collide)."""
    return zlib.crc32(int(entry_crc).to_bytes(8, "big"), acc)


# -- replica-side apply ------------------------------------------------------

class ReplicaCore:
    """One host's lane + group metadata: the apply/install/promise
    logic shared by the standalone :class:`ReplicaServer` process and
    a :class:`ReplicatedService` acting as its own replica zero."""

    def __init__(self, svc: BatchedEnsembleService) -> None:
        self.svc = svc
        (self.promised, self.applied_ge, self.applied_seq,
         self.cfg) = load_group_meta(svc)
        self.last_crc = 0
        #: hook: the owning server mirrors config changes into its
        #: failover peer list (set by ReplicaServer)
        self.on_cfg = None
        #: commutative-lane early ack (docs/ARCHITECTURE.md §18): set
        #: per-frame by the owning server to a send-the-ack callable.
        #: A PURE-merge frame (every entry "m" with zero ordered
        #: cells, no grants) fires it right after its WAL sync —
        #: BEFORE the device scatter is even dispatched — because a
        #: crash between the two replays the run from the WAL's
        #: absolute-value records, the same recovery envelope the
        #: sequenced path already proves at replica_apply_pre_ack.
        self.early_ack = None
        self.early_acks = 0
        #: abatch frames this lane applied past the stream checks, and
        #: the seconds they took (validate, scatter or re-execution, WAL
        #: sync) — the replica-apply layer's metric in ``stats()``
        self.apply_batches = 0
        self.apply_s = 0.0
        #: follower-served leased reads (docs/ARCHITECTURE.md §16):
        #: this lane may answer keyed reads from its delta-maintained
        #: mirrors until ``serve_until`` (monotonic, this host's
        #: clock).  The window derives ONLY from lease grants the
        #: leader ships inside abatch frames — each grant names the
        #: highest ack seq the leader counted inside a quorum-
        #: confirmed settle, and the window anchors at THIS lane's
        #: own send time of that ack (causally before the leader's
        #: receive, so the window always expires inside the leader's
        #: write fence for this address).
        self.serve_until = 0.0
        self.confirmed_seq = 0
        #: (seq, anchor_t, touched-cols-or-None) acks awaiting their
        #: grant; None cols = a full-plane entry (blocks every
        #: ensemble until confirmed)
        self._flw_anchors: "deque[Tuple[int, float, Any]]" = deque()
        self._flw_anchor_top = 0
        self._flw_unconf: set = set()
        self._flw_unconf_all = False
        #: per-frame collector the apply paths feed touched ensemble
        #: columns into (None while the frame carries no grants —
        #: the follower-reads-off arm records nothing)
        self._flw_collect: Optional[set] = None
        self._flw_collect_all = False

    # -- follower-served leased reads (docs/ARCHITECTURE.md §16) --------

    def _flw_drop(self) -> None:
        """Revoke the serve window and every pending anchor — called
        BEFORE this lane grants a higher promise, acks a config
        record, installs a snapshot, or steps into leadership, so no
        follower-served read can outlive the fencing event."""
        self.serve_until = 0.0
        self._flw_anchors.clear()
        self._flw_anchor_top = self.applied_seq
        self._flw_unconf = set()
        self._flw_unconf_all = False

    def _flw_note_ack(self, cols: Any, grants: Any) -> None:
        """Record the ack about to go on the wire as a lease anchor
        (the anchor time is taken BEFORE the send, so it lower-bounds
        the leader's receive time), then consume any grant addressed
        to this lane.  A grant for seq G proves the leader counted
        our FIRST ack for G inside a quorum-confirmed settle within
        that batch's ack deadline, so [anchor(G), anchor(G)+lease) is
        strictly inside the leader's write fence for this address;
        re-acks of an already-anchored seq are ignored (only the
        first instance is provably the one the settle counted)."""
        now = time.monotonic()
        if self.applied_seq > self._flw_anchor_top:
            self._flw_anchors.append((self.applied_seq, now, cols))
            self._flw_anchor_top = self.applied_seq
        me = getattr(self.svc, "self_addr", None)
        g = -1
        if grants and me is not None:
            for h, p, s in grants:
                if (str(h), int(p)) == me:
                    g = int(s)
                    break
        if g >= 0:
            best = None
            while self._flw_anchors and self._flw_anchors[0][0] <= g:
                best = self._flw_anchors.popleft()
            if best is not None:
                self.serve_until = max(
                    self.serve_until,
                    best[1] + self.svc.config.lease())
            self.confirmed_seq = max(self.confirmed_seq, g)
        # visibility gate: ensembles touched by applied-but-not-yet-
        # confirmed entries must not serve — a follower read could
        # otherwise observe a write BEFORE the leader's own settle
        # acks it, and a later leader read might miss it (the
        # time-travel anomaly)
        self._flw_unconf_all = any(a[2] is None
                                   for a in self._flw_anchors)
        cols_u: set = set()
        if not self._flw_unconf_all:
            for a in self._flw_anchors:
                cols_u.update(a[2])
        self._flw_unconf = cols_u

    def _flw_serve_ok(self, ens: int) -> bool:
        """May this follower answer a keyed read of ensemble ``ens``
        from its mirrors right now?  Window valid (with the same
        safety margin the leader-side fast path applies) AND no
        applied-but-unconfirmed entry touches the ensemble."""
        now = time.monotonic()
        if now + self.svc._read_margin >= self.serve_until:
            return False
        if self._flw_unconf_all or ens in self._flw_unconf:
            return False
        return True

    def _obs_role(self) -> str:
        """This lane's span-store role: "replica" plus the lane tag
        (the address peers dial it by) when one exists — in-process
        multi-lane groups share the process-global store, and
        untagged roles would merge three lanes' spans into one
        indistinguishable record."""
        addr = getattr(self.svc, "self_addr", None)
        if addr:
            return f"replica@{addr[0]}:{addr[1]}"
        return "replica"

    def handle_promise(self, ge: int) -> Tuple:
        """Grant iff strictly newer; the grant persists BEFORE it is
        answered (a granted promise that didn't survive a crash would
        let a deposed leader commit after our restart)."""
        meta_lock = getattr(self.svc, "_meta_lock", None)
        import contextlib
        with (meta_lock if meta_lock is not None
              else contextlib.nullcontext()):
            if ge > self.promised:
                # read-lease fence (§16): every follower-served read
                # window this lane holds dies BEFORE the grant goes
                # out — the new leader's first write can't race a
                # stale-lease read
                self._flw_drop()
                self.promised = ge
                save_group_meta(self.svc, self.promised,
                                self.applied_ge, self.applied_seq,
                                self.cfg)
                return ("promised", True, self.promised,
                        self.applied_ge, self.applied_seq, self.cfg)
            return ("promised", False, self.promised, self.applied_ge,
                    self.applied_seq, self.cfg)

    def handle_apply(self, frame: Tuple) -> Tuple:
        """Legacy single full-plane apply (kept on the wire for
        compatibility; the leader now ships ``abatch`` frames)."""
        _, ge, seq = frame[:3]
        bad = self._check_stream(ge, seq)
        if bad is not None:
            return bad
        # legacy frames predate the trailing flush-id field: no
        # leader-side trace to join, record under fid 0 (dropped)
        crc = self._apply_full_entry(
            ge, ("f",) + tuple(frame[2:]) + (0,))
        return ("applied", ge, seq, crc)

    def _check_stream(self, ge: int, seq: int) -> Optional[Tuple]:
        """The (epoch, seq) stream discipline shared by every apply
        shape; None = accept, else the response to send."""
        if ge != self.promised or ge < self.applied_ge:
            return ("nack", "epoch", self.promised, self.applied_ge,
                    self.applied_seq)
        if seq == self.applied_seq and ge == self.applied_ge:
            # retransmit of the batch we just applied (ack was lost)
            return ("applied", ge, seq, self.last_crc)
        if seq != self.applied_seq + 1:
            return ("nack", "seq", self.promised, self.applied_ge,
                    self.applied_seq)
        return None

    def handle_abatch(self, frame: Tuple) -> Tuple:
        """Coalesced launch batch: delta entries apply in place
        through ONE device scatter + mirror/WAL pass per contiguous
        run; full-plane entries re-execute through the plain launch
        halves.  One cumulative ack (the chained per-entry CRCs)
        covers the whole frame."""
        _, ge, entries = frame[:3]
        # optional 4th field (follower-read leader): sorted
        # (host, port, seq) grant triples — absent on the wire when
        # the leader runs with follower reads off, which keeps that
        # arm's frames byte-identical to HEAD
        grants = frame[3] if len(frame) > 3 else None
        self._flw_collect = set() if grants is not None else None
        self._flw_collect_all = False
        if ge != self.promised or ge < self.applied_ge:
            return ("nack", "epoch", self.promised, self.applied_ge,
                    self.applied_seq)
        if not entries:
            if grants is not None:
                self._flw_note_ack(set(), grants)
            return ("applied", ge, self.applied_seq, self.last_crc)
        if ge == self.applied_ge \
                and int(entries[-1][1]) <= self.applied_seq:
            # retransmit of a fully-applied batch (ack was lost);
            # anything partially behind is a protocol break — nack
            # and let the leader re-sync
            if int(entries[-1][1]) == self.applied_seq:
                if grants is not None:
                    # a re-ack never re-anchors (dedup by seq inside
                    # _flw_note_ack) but grants riding the frame
                    # still confirm earlier anchors
                    self._flw_note_ack(set(), grants)
                return ("applied", ge, self.applied_seq, self.last_crc)
            return ("nack", "seq", self.promised, self.applied_ge,
                    self.applied_seq)
        t_apply = time.perf_counter()
        try:
            return self._apply_abatch(ge, entries, grants)
        finally:
            self.apply_batches += 1
            self.apply_s += time.perf_counter() - t_apply

    def _apply_abatch(self, ge: int, entries, grants) -> Tuple:
        """The apply loop of :meth:`handle_abatch` (timed there)."""
        combined = 0
        # §18 early-ack gate: a frame that is ONE pure-merge run (every
        # entry "m" with zero ordered cells) and carries no grants may
        # ack after its WAL sync, before the device scatter — the
        # validation + meta-coverage conditions are re-checked inside
        # the run apply, which owns the durability barrier
        early_ok = (self.early_ack is not None and grants is None
                    and all(e[0] == "m" and int(e[3]) == 0
                            for e in entries))
        i, n = 0, len(entries)
        while i < n:
            ent = entries[i]
            if int(ent[1]) != self.applied_seq + 1:
                if grants is not None:
                    self._flw_drop()
                return ("nack", "seq", self.promised, self.applied_ge,
                        self.applied_seq)
            if ent[0] == "f":
                crc = self._apply_full_entry(ge, ent)
                combined = _crc_chain(combined, crc)
                i += 1
            elif ent[0] in ("d", "m"):
                # group only the CONSECUTIVE-seq prefix: a gap inside
                # the run must stop it so the next top-of-loop check
                # nacks "seq" with the in-order prefix applied
                j, nxt = i, self.applied_seq + 1
                while j < n and entries[j][0] in ("d", "m") \
                        and int(entries[j][1]) == nxt:
                    j += 1
                    nxt += 1
                crcs = self._apply_delta_run(
                    ge, entries[i:j],
                    early=early_ok and i == 0 and j == n)
                if crcs is None:
                    if grants is not None:
                        self._flw_drop()
                    return ("nack", "crc", self.promised,
                            self.applied_ge, self.applied_seq)
                for c in crcs:
                    combined = _crc_chain(combined, c)
                i = j
            else:
                if grants is not None:
                    self._flw_drop()
                return ("nack", "bad-entry", self.promised,
                        self.applied_ge, self.applied_seq)
        if grants is not None:
            # anchor this ack before it hits the wire; a full-plane
            # entry anywhere in the frame gates EVERY ensemble until
            # the leader confirms it (cols=None)
            self._flw_note_ack(
                None if self._flw_collect_all else self._flw_collect,
                grants)
        return ("applied", ge, self.applied_seq, combined)

    def _apply_delta_run(self, ge: int, run: Sequence[Tuple],
                         early: bool = False) -> Optional[List[int]]:
        """Apply consecutive changed-slot delta entries IN PLACE — no
        device re-execution.  Everything the full launch would have
        produced is derived from this lane's own (bit-equal) state:
        commit epochs from its ballot plane, commit seqs consecutive
        from its obj_seq_ctr, the touched rows' trees rebuilt from the
        scattered objects.  The WHOLE run lands through one device
        scatter, one tree rebuild and one WAL sync (the batched apply
        economics).  Returns per-entry CRCs, or None on a section-CRC
        or shape violation (the leader re-syncs).

        "m" entries (§18) additionally carry merge sections: coalesced
        commutative/semilattice cells folded against this lane's OWN
        current value through the compiled merge gather — a cell whose
        slot was already written earlier in the run folds host-side
        from that value instead (the device still holds the pre-run
        plane until the single end-of-run scatter).  ``early=True``
        (a pure-merge frame) reorders the tail to WAL -> ack -> scatter
        and fires ``self.early_ack`` with the frame's cumulative CRC,
        provided every merge cell is covered by a meta row (its final
        value must be in the WAL for the pre-scatter ack to be
        durable)."""
        svc = self.svc
        e_n = svc.n_ens
        epoch_np = _host(svc.state.epoch[:, 0]).astype(np.int32)
        ctr_np = _host(svc.state.obj_seq_ctr).astype(np.int32)
        final: Dict[Tuple[int, int], Tuple[int, int, int]] = {}
        touched = np.zeros((e_n,), bool)
        recs: List[Tuple[Any, Any]] = []
        crcs: List[int] = []
        now = svc.runtime.now
        lease_s = svc.config.lease()
        def _buf(x):
            return x.buf if isinstance(x, wire.Raw) else x

        # Validation pass: decode + vet EVERY entry of the run before
        # touching any state.  A mid-run failure after entry-by-entry
        # mutation would leave this lane advertising an applied
        # position (promise grants, campaign ranking) whose effects
        # were never scattered or WAL-logged — a would-be promoter
        # could adopt a state that silently lost acked writes.  All-
        # or-nothing keeps the advertised position truthful.
        t_start = time.perf_counter()
        decoded = []
        meta_covered = True
        for ent in run:
            merge_b = None
            try:
                if ent[0] == "m":
                    (_, seq, _k, nc, jw, sw, cols_b, counts_b, jj_b,
                     slots_b, vals_b, rmw_b, q_b, crc_ship, mc,
                     mcols_b, mcounts_b, mnops_b, mslots_b, mfuns_b,
                     mops_b, mrl_b, mjl_b, mcrc_ship, meta, fid) = ent
                    merge_b = (mcols_b, mcounts_b, mnops_b, mslots_b,
                               mfuns_b, mops_b, mrl_b, mjl_b)
                else:
                    (_, seq, _k, nc, jw, sw, cols_b, counts_b, jj_b,
                     slots_b, vals_b, rmw_b, q_b, crc_ship, meta,
                     fid) = ent
            except ValueError:
                return None
            if int(jw) not in (1, 2) or int(sw) not in (1, 2):
                return None
            j_dt = np.uint8 if int(jw) == 1 else np.uint16
            s_dt = np.uint8 if int(sw) == 1 else np.uint16
            try:
                cols = np.frombuffer(_buf(cols_b), np.uint16)
                counts = np.frombuffer(_buf(counts_b), np.uint16)
                jj = np.frombuffer(_buf(jj_b), j_dt)
                slots = np.frombuffer(_buf(slots_b), s_dt)
                vals = np.frombuffer(_buf(vals_b), np.int32)
                rmwb = np.frombuffer(_buf(rmw_b), np.uint8)
                qb = np.frombuffer(_buf(q_b), np.uint8)
            except ValueError:
                return None
            crc = 0
            for b in (cols, counts, jj, slots, vals, rmwb, qb):
                crc = zlib.crc32(b.tobytes(), crc)
            nc = int(nc)
            if crc != int(crc_ship) or jj.size != nc \
                    or slots.size != nc or vals.size != nc \
                    or cols.size != counts.size \
                    or int(counts.sum()) != nc \
                    or rmwb.size < (nc + 7) // 8 \
                    or qb.size < (e_n + 7) // 8 \
                    or (nc and (int(cols.min()) < 0
                                or int(cols.max()) >= e_n
                                or int(slots.min()) < 0
                                or int(slots.max()) >= svc.n_slots)):
                return None
            # put-lane metadata feeds the mirror/WAL mutation loop
            # below: vet shape and ensemble range up front too
            try:
                meta = [(int(j), int(e), key, handle, payload)
                        for j, e, key, handle, payload in meta]
            except (ValueError, TypeError):
                return None
            if any(e < 0 or e >= e_n for _, e, _k2, _h, _p in meta):
                return None
            merge = None
            ecrc = int(crc_ship)
            if merge_b is not None:
                # merge sections (§18): own CRC, all-or-nothing with
                # the run; the entry's ack CRC chains both halves
                try:
                    mcols = np.frombuffer(_buf(merge_b[0]), np.uint16)
                    mcounts = np.frombuffer(_buf(merge_b[1]),
                                            np.uint16)
                    mnops = np.frombuffer(_buf(merge_b[2]), np.uint16)
                    mslots = np.frombuffer(_buf(merge_b[3]), s_dt)
                    mfuns = np.frombuffer(_buf(merge_b[4]), np.uint8)
                    mops = np.frombuffer(_buf(merge_b[5]), np.int32)
                    mrl = np.frombuffer(_buf(merge_b[6]), j_dt)
                    mjl = np.frombuffer(_buf(merge_b[7]), j_dt)
                except ValueError:
                    return None
                mcrc = 0
                for b in (mcols, mcounts, mnops, mslots, mfuns, mops,
                          mrl, mjl):
                    mcrc = zlib.crc32(b.tobytes(), mcrc)
                mc = int(mc)
                mc64 = mcols.astype(np.int64)
                if (mcrc != int(mcrc_ship) or mc < 1
                        or mslots.size != mc or mfuns.size != mc
                        or mops.size != mc or mrl.size != mc
                        or mjl.size != mc
                        or mcols.size != mcounts.size
                        or mcols.size != mnops.size
                        or int(mcounts.sum()) != mc
                        or int(mcols.max()) >= e_n
                        or int(mslots.max()) >= svc.n_slots
                        or int(mfuns.max()) > funref.MERGE_OR
                        or not bool((mcounts >= 1).all())
                        or not bool((mnops.astype(np.int64)
                                     >= mcounts).all())
                        or int(mjl.max()) >= max(int(_k), 1)
                        or (mcols.size > 1
                            and not bool((np.diff(mc64) > 0).all()))
                        or np.intersect1d(mcols, cols).size
                        or not bool((mrl.astype(np.int64)
                                     < np.repeat(
                                         mnops.astype(np.int64),
                                         mcounts)).all())):
                    return None
                merge = (mcols, mcounts, mnops, mslots, mfuns, mops,
                         mrl, mjl)
                ecrc = _crc_chain(int(crc_ship), mcrc)
                if meta_covered:
                    # early-ack durability precondition: every merge
                    # cell's final value must land in the WAL via its
                    # meta row
                    je = {(j, e) for j, e, _k2, _h, _p in meta}
                    ccol = np.repeat(mcols, mcounts)
                    meta_covered = all(
                        (int(mjl[x]), int(ccol[x])) in je
                        for x in range(mc))
            decoded.append((int(seq), ecrc, cols, counts,
                            jj, slots, vals, rmwb, qb, meta,
                            int(fid), merge))
        t_validated = time.perf_counter()
        # §18 merge resolution: walk the run in order simulating slot
        # state so each merged cell folds against the value the
        # SEQUENCED apply would have seen — the compiled gather+merge
        # covers first-touch cells (device still pre-run), chained
        # cells fold host-side from the walk.
        mvals: List[Optional[np.ndarray]] = [None] * len(decoded)
        if any(d[11] is not None for d in decoded):
            simst: Dict[Tuple[int, int], Tuple] = {}
            chains: List[Tuple[int, int, List[Tuple]]] = []
            for d_i, d in enumerate(decoded):
                (_seq, _ec, cols, counts, jj, slots, vals, rmwb, qb,
                 meta, _fid, merge) = d
                pos = 0
                for c_i, cnt in zip(cols.tolist(), counts.tolist()):
                    for r_i in range(cnt):
                        simst[(c_i, int(slots[pos + r_i]))] = \
                            ("v", int(vals[pos + r_i]))
                    pos += cnt
                if merge is None:
                    continue
                (mcols, mcounts, mnops, mslots, mfuns, mops, mrl,
                 mjl) = merge
                mv = np.zeros(mslots.size, np.int32)
                mvals[d_i] = mv
                ccol = np.repeat(mcols, mcounts).tolist()
                for x in range(mslots.size):
                    c_i = int(ccol[x])
                    s_i = int(mslots[x])
                    mcls = int(mfuns[x])
                    op = int(mops[x])
                    st_ = simst.get((c_i, s_i))
                    if st_ is None:
                        chain: List[Tuple] = [(d_i, x, mcls, op)]
                        chains.append((c_i, s_i, chain))
                        simst[(c_i, s_i)] = ("p", chain)
                    elif st_[0] == "v":
                        v = funref.merge_apply(mcls, st_[1], op)
                        mv[x] = v
                        simst[(c_i, s_i)] = ("v", v)
                    else:
                        st_[1].append((d_i, x, mcls, op))
            if chains:
                head_vals = _merge_gather_cells(
                    svc,
                    np.asarray([c for c, _s, _ch in chains], np.int32),
                    np.asarray([s for _c, s, _ch in chains], np.int32),
                    np.asarray([ch[0][2] for _c, _s, ch in chains],
                               np.int32),
                    np.asarray([ch[0][3] for _c, _s, ch in chains],
                               np.int32))
                for (c_i, s_i, chain), hv in zip(chains,
                                                 head_vals.tolist()):
                    v = int(hv)
                    d_i, x, _mcls, _op = chain[0]
                    mvals[d_i][x] = v
                    for d_i2, x2, mcls2, op2 in chain[1:]:
                        v = funref.merge_apply(mcls2, v, op2)
                        mvals[d_i2][x2] = v

        # Apply pass: nothing below can fail validation — mutations
        # land for the whole run or not at all.
        for d_i, (seq, crc_ship, cols, counts, jj, slots, vals, rmwb,
                  qb, meta, _fid, merge) in enumerate(decoded):
            # committed cells, column-grouped in round order: derive
            # each cell's (epoch, seq) exactly as the kernel assigns
            # them (obj_sequence: consecutive per column)
            cell: Dict[Tuple[int, int],
                       Tuple[int, int, int, bool, int]] = {}
            pos = 0
            for c_i, cnt in zip(cols.tolist(), counts.tolist()):
                ep = int(epoch_np[c_i])
                base = int(ctr_np[c_i])
                for r_i in range(cnt):
                    idx = pos + r_i
                    s_i = int(slots[idx])
                    vl = int(vals[idx])
                    rm = bool(rmwb[idx >> 3] & (0x80 >> (idx & 7)))
                    final[(c_i, s_i)] = (ep, base + r_i + 1, vl)
                    cell[(int(jj[idx]), c_i)] = (ep, base + r_i + 1,
                                                 vl, rm, s_i)
                ctr_np[c_i] = base + cnt
                touched[c_i] = True
                pos += cnt
            if merge is not None:
                # merged columns (§18): each cell lands its FOLDED
                # value at the seq of its slot's last absorbed op
                # (base + rank + 1 — bit-equal version vectors), and
                # the column's counter advances by every op the cells
                # absorbed, exactly as the sequenced kernel would
                (mcols, mcounts, mnops, mslots, mfuns, mops, mrl,
                 mjl) = merge
                mv = mvals[d_i]
                pos = 0
                for c_i, cnt, nops in zip(mcols.tolist(),
                                          mcounts.tolist(),
                                          mnops.tolist()):
                    ep = int(epoch_np[c_i])
                    base = int(ctr_np[c_i])
                    for r_i in range(cnt):
                        idx = pos + r_i
                        s_i = int(mslots[idx])
                        vl = int(mv[idx])
                        sq = base + int(mrl[idx]) + 1
                        final[(c_i, s_i)] = (ep, sq, vl)
                        cell[(int(mjl[idx]), c_i)] = (ep, sq, vl,
                                                      True, s_i)
                    ctr_np[c_i] = base + nops
                    touched[c_i] = True
                    pos += cnt
            # keyed WAL records + host mirrors: the same meta-driven
            # iteration the full-plane path runs
            for j, e, key, handle, payload in meta:
                hit = cell.get((int(j), int(e)))
                if hit is None:
                    continue  # that round didn't commit
                ep, sq, vl, rm, s_i = hit
                if rm:
                    recs.append((("kv", e, s_i),
                                 (key, vl, ep, sq, None, True)))
                    self._mirror_inline(e, key, s_i, vl, ep, sq)
                else:
                    recs.append((("kv", e, s_i),
                                 (key, handle, ep, sq, payload, False)))
                    self._mirror_write(e, key, s_i, handle, payload,
                                       ep, sq)
            # lease renewal from the shipped quorum bits (the full
            # path's quorum_ok renewal, on this lane's own clock)
            renew = _unpack_bool(qb.tobytes(), e_n)
            svc.lease_until[renew] = now + lease_s
            self.applied_ge, self.applied_seq = int(ge), int(seq)
            self.last_crc = int(crc_ship)
            crcs.append(int(crc_ship))
        if self._flw_collect is not None:
            # follower-read visibility gate: these ensembles now hold
            # applied-but-unconfirmed writes
            self._flw_collect.update(np.nonzero(touched)[0].tolist())
        t_applied = time.perf_counter()
        marks: Dict[str, float] = {}

        def _scatter() -> None:
            if final:
                cells = np.asarray(
                    [(e, s, ep, sq, vl)
                     for (e, s), (ep, sq, vl) in final.items()],
                    np.int32)
                rows = np.zeros((e_n, svc.n_peers), bool)
                rows[touched] = True
                _delta_scatter_cells(svc, cells, ctr_np, rows,
                                     marks=marks if svc._obs else None)

        def _wal_sync() -> None:
            if svc._wal is not None:
                svc._wal.log(recs)
                if svc._wal.count >= svc.wal_compact_records:
                    rebuild_derived(svc)
                    svc.save()
                    save_group_meta(svc, self.promised,
                                    self.applied_ge, self.applied_seq,
                                    self.cfg)

        # Durability barrier: one log()/sync covers every entry of the
        # run + the advanced group meta, BEFORE the cumulative ack.
        recs.append((_GRP_KEY, (self.promised, self.applied_ge,
                                self.applied_seq, self.cfg)))
        if (early and self.early_ack is not None and meta_covered
                and svc._wal is not None):
            # §18 early ack: WAL first, ack on the wire, THEN the
            # device scatter dispatch.  A crash between ack and
            # scatter replays every merged final from the WAL's
            # absolute-value records — the same recovery point the
            # sequenced path proves below; the scatter was async-
            # dispatched before the ack anyway (never completion-
            # barriered), so the client-visible guarantee is
            # unchanged, only the wire ack stops waiting for the
            # dispatch.
            t_scattered = time.perf_counter()
            _wal_sync()
            t_wal = time.perf_counter() - t_scattered
            faults.crashpoint("replica_apply_pre_ack")
            combined = 0
            for c in crcs:
                combined = _crc_chain(combined, c)
            self.early_acks += 1
            self.early_ack(("applied", int(ge),
                            int(self.applied_seq), combined))
            _scatter()
        else:
            _scatter()
            t_scattered = time.perf_counter()
            _wal_sync()
            t_wal = time.perf_counter() - t_scattered
            # §15 crash barrier: the run is durable, the ack is not
            # yet on the wire — the classic replica-crash recovery
            # point
            faults.crashpoint("replica_apply_pre_ack")
        if svc._obs:
            # replica half of the cross-process flush trace: every
            # entry's spans record under the LEADER's flush id (the
            # wire's trailing field), so obs.timeline(fid) joins this
            # lane's validate/scatter/rebuild/WAL time with the
            # leader's enqueue/build/ship spans.  Run-shared passes
            # (validate, the one coalesced scatter + WAL sync) are
            # charged to the run and marked with its size.
            n_run = len(decoded)
            # fleet alignment anchor: spans lay out ENDING at this
            # record-time stamp on THIS host's monotonic clock (the
            # clock the leader's per-link offset estimate maps from)
            t_mono = time.monotonic()
            for (seq, _c, _cols, _cnt, _jj, _s, _v, _r, _q, _m,
                 fid, _mg) in decoded:
                obs.SPANS.record(
                    fid, self._obs_role(),
                    [("validate", t_validated - t_start),
                     ("apply", t_applied - t_validated),
                     ("scatter", marks.get("scatter", 0.0)),
                     ("rebuild", marks.get("rebuild", 0.0)),
                     ("wal_sync", t_wal)],
                    seq=seq, run_entries=n_run, kind="delta",
                    t_mono=t_mono)
        return crcs

    def _apply_full_entry(self, ge: int, ent: Tuple) -> int:
        (_, seq, k, want_vsn, elect_b, lease_b, kind_b, slot_b,
         val_b, exp_e_b, exp_s_b, meta, fid) = ent
        # full-plane entries can touch any ensemble — gate every
        # follower read until the leader confirms this frame
        self._flw_collect_all = True
        t_start = time.perf_counter()
        svc = self.svc
        e_n = svc.n_ens
        elect = _unpack_bool(elect_b, e_n)
        lease_ok = _unpack_bool(lease_b, e_n)
        kind = _unpack_i32(kind_b, (k, e_n))
        slot = _unpack_i32(slot_b, (k, e_n))
        val = _unpack_i32(val_b, (k, e_n))
        exp_e = _unpack_i32(exp_e_b, (k, e_n))
        exp_s = _unpack_i32(exp_s_b, (k, e_n))
        cand = np.zeros((e_n,), np.int32)
        # unbound base calls: a ReplicatedService in the replica role
        # must apply through the PLAIN launch halves (its own
        # overrides would try to re-replicate / demand leadership).
        # Active-column compaction composes transparently: the active
        # set is a pure function of the shipped kind plane, so this
        # lane packs/unpacks the SAME [K, A] layout its leader did —
        # and the unpack scatters back to full-width planes, so the
        # apply-stream mirrors, WAL records and the ack CRC below are
        # layout-blind (bit-identical across lanes even if one side
        # disabled compaction via RETPU_COMPACT=0).
        fl = BatchedEnsembleService._launch_enqueue(
            svc, kind, slot, val, k, want_vsn=want_vsn,
            exp_e=exp_e, exp_s=exp_s, elect=elect, cand=cand,
            lease_ok=lease_ok)
        committed, _get_ok, _found, value, vsn = \
            BatchedEnsembleService._launch_resolve(svc, fl)
        crc = result_crc(committed, vsn)
        t_applied = time.perf_counter()

        # Durability barrier: this host's WAL carries every committed
        # record of the batch BEFORE the ack that lets the leader
        # count us toward the commit quorum.  One log() call = one
        # sync for batch + group meta.
        recs: List[Tuple[Any, Any]] = []
        committed_l = committed.tolist() if committed is not None else []
        for j, e, key, handle, payload in meta:
            if not committed_l[j][e]:
                continue
            ve, vs = (int(vsn[j, e, 0]), int(vsn[j, e, 1])) \
                if vsn is not None else (0, 0)
            if int(kind[j, e]) == eng.OP_RMW:
                # device RMW lane: this lane COMPUTED the committed
                # value itself (bit-equal by determinism; the CRC
                # pins it) — log a keyed inline record and mark the
                # slot device-native
                v = int(value[j, e]) if value is not None else 0
                recs.append((("kv", e, int(slot[j, e])),
                             (key, v, ve, vs, None, True)))
                self._mirror_inline(e, key, int(slot[j, e]), v,
                                    ve, vs)
                continue
            recs.append((("kv", e, int(slot[j, e])),
                         (key, handle, ve, vs, payload, False)))
            self._mirror_write(e, key, int(slot[j, e]), handle,
                               payload, ve, vs)
        self.applied_ge, self.applied_seq = int(ge), int(seq)
        self.last_crc = crc
        recs.append((_GRP_KEY, (self.promised, ge, seq, self.cfg)))
        if svc._wal is not None:
            svc._wal.log(recs)
            if svc._wal.count >= svc.wal_compact_records:
                rebuild_derived(svc)
                svc.save()
                # save() rotated to an EMPTY WAL generation: the group
                # meta must survive into it, or a crash before the
                # next apply restarts this host amnesiac about its
                # promise — an old-epoch leader could then count it
                # into a quorum while the new-epoch leader commits
                # elsewhere (review r4: split-brain via compaction).
                save_group_meta(svc, self.promised, ge, seq, self.cfg)
        # §15 crash barrier: batch durable, ack not yet on the wire
        faults.crashpoint("replica_apply_pre_ack")
        if svc._obs:
            # the full-plane fallback's replica trace: one re-executed
            # launch, so "apply" covers the whole device round + local
            # resolve this lane ran under the leader's flush id
            obs.SPANS.record(
                fid, self._obs_role(),
                [("apply", t_applied - t_start),
                 ("wal_sync", time.perf_counter() - t_applied)],
                seq=int(seq), kind="full", t_mono=time.monotonic())
        return crc

    def _mirror_write(self, e: int, key: Any, slot: int, handle: int,
                      payload: Any, ve: int = 0, vs: int = 0) -> None:
        """Keep the keyed host mirrors live on the replica so a
        promoted leader can serve keyed ops — leased fast reads
        included (the vsn mirror rides along) — without a WAL
        rescan."""
        svc = self.svc
        svc._inline_slots[e].discard(slot)
        svc._inline_np[e, slot] = False
        svc._inline_value_ok[e, slot] = False
        svc._slot_vsn_np[e, slot] = (int(ve), int(vs))
        svc._slot_vsn_ok[e, slot] = True
        old = svc.slot_handle[e].pop(slot, 0)
        if old > 0 and old != handle:
            svc.values.pop(old, None)
        if handle:
            svc.values[handle] = payload
            svc.slot_handle[e][slot] = handle
            if key is not None:
                svc.key_slot[e][key] = slot
            if handle >= svc._next_handle:
                svc._next_handle = handle + 1
        else:
            if key is not None:
                svc.key_slot[e].pop(key, None)

    def _mirror_inline(self, e: int, key: Any, slot: int,
                       value: int, ve: int = 0, vs: int = 0) -> None:
        """Keyed mirror of a committed device RMW: the slot is
        device-native (value lives in the engine arrays; the -1
        slot_handle sentinel stands in for a live handle).  A
        computed 0 is the tombstone: the mapping DROPS, exactly like
        the host-delete mirror arm — the leader recycles the slot, so
        a retained replica mapping would alias the key onto whatever
        the recycled slot holds next (cross-key leak on promotion)."""
        svc = self.svc
        old = svc.slot_handle[e].pop(slot, 0)
        if old > 0:
            svc.values.pop(old, None)
        svc._slot_vsn_np[e, slot] = (int(ve), int(vs))
        svc._slot_vsn_ok[e, slot] = True
        if value:
            svc._inline_slots[e].add(slot)
            svc._inline_np[e, slot] = True
            svc._inline_value_np[e, slot] = int(value)
            svc._inline_value_ok[e, slot] = True
            svc.slot_handle[e][slot] = -1
            if key is not None:
                svc.key_slot[e][key] = slot
        else:
            svc._inline_slots[e].discard(slot)
            svc._inline_np[e, slot] = False
            svc._inline_value_ok[e, slot] = False
            if key is not None:
                svc.key_slot[e].pop(key, None)

    def handle_lcl(self, frame: Tuple) -> Tuple:
        """Replicated dynamic-lifecycle op (create/destroy ensemble):
        rides the SAME (epoch, seq) stream as applies — lifecycle
        mutates device rows and the tenant directory, so an
        unreplicated create would diverge the lanes.  Deterministic
        by the same induction: identical directories evolve
        identically, so row assignment and even failure outcomes
        (name taken, no capacity) match bit-for-bit."""
        _, ge, seq, kind, name, view_b = frame
        svc = self.svc
        if ge != self.promised or ge < self.applied_ge:
            return ("nack", "epoch", self.promised, self.applied_ge,
                    self.applied_seq)
        if seq == self.applied_seq and ge == self.applied_ge:
            return ("applied", ge, seq, self.last_crc)
        if seq != self.applied_seq + 1:
            return ("nack", "seq", self.promised, self.applied_ge,
                    self.applied_seq)
        # lifecycle records never carry grants and their mutations are
        # not anchor-gated — the read window dies with them (rare)
        self._flw_drop()
        if kind == "create":
            view = (None if view_b is None
                    else _unpack_bool(view_b, svc.n_peers))
            row = BatchedEnsembleService.create_ensemble(
                svc, name, view)
            crc = row if row is not None else -1
        else:
            ok = BatchedEnsembleService.destroy_ensemble(svc, name)
            crc = 1 if ok else 0
        self.applied_ge, self.applied_seq = ge, seq
        self.last_crc = crc
        save_group_meta(svc, self.promised, ge, seq, self.cfg)
        if svc._wal is not None \
                and svc._wal.count >= svc.wal_compact_records:
            rebuild_derived(svc)
            svc.save()
            save_group_meta(svc, self.promised, ge, seq, self.cfg)
        return ("applied", ge, seq, crc)

    def handle_install(self, frame: Tuple) -> Tuple:
        _, ge, seq, dump = frame[:4]
        if ge < self.promised:
            return ("nack", "epoch", self.promised, self.applied_ge,
                    self.applied_seq)
        # a snapshot install replaces the mirrors wholesale — any
        # outstanding read window is fenced out with it
        self._flw_drop()
        install_state(self.svc, dump)
        if len(frame) > 4:
            # the snapshot's config is part of the state at (ge, seq)
            self.set_cfg(_norm_cfg(frame[4]))
        self.promised = max(self.promised, ge)
        self.applied_ge, self.applied_seq = ge, seq
        self.last_crc = 0
        save_group_meta(self.svc, self.promised, ge, seq, self.cfg)
        if self.svc.data_dir is not None:
            # checkpoint the installed state so our own restart
            # restores it (save() rotates the WAL generation)
            self.svc.save()
            save_group_meta(self.svc, self.promised, ge, seq, self.cfg)
        return ("installed", ge, seq)

    def set_cfg(self, cfg: GroupCfg) -> None:
        self.cfg = cfg
        if self.on_cfg is not None:
            self.on_cfg(cfg)

    def handle_cfg(self, frame: Tuple) -> Tuple:
        """A group-config record riding the apply stream (the
        joint-consensus membership change, update_members
        peer.erl:655-672 / transition:751-774, at HOST granularity):
        same (epoch, seq) discipline as data applies, so every lane
        adopts each config at the same point in the op stream.  The
        ack CRC is the config version."""
        _, ge, seq, cver, hosts, joint = frame
        if ge != self.promised or ge < self.applied_ge:
            return ("nack", "epoch", self.promised, self.applied_ge,
                    self.applied_seq)
        if seq == self.applied_seq and ge == self.applied_ge:
            return ("applied", ge, seq, self.last_crc)
        if seq != self.applied_seq + 1:
            return ("nack", "seq", self.promised, self.applied_ge,
                    self.applied_seq)
        # read-lease fence (§16): no config record acks while this
        # lane could still serve reads under the OLD membership
        self._flw_drop()
        self.set_cfg((int(cver), _norm_addrs(hosts),
                      _norm_addrs(joint)))
        self.applied_ge, self.applied_seq = ge, seq
        self.last_crc = int(cver)
        save_group_meta(self.svc, self.promised, ge, seq, self.cfg)
        return ("applied", ge, seq, int(cver))

    def handle_pull(self) -> Tuple:
        rebuild_derived(self.svc)
        return ("state", self.applied_ge, self.applied_seq,
                dump_state(self.svc), self.cfg)

    def handle_inst(self, frame: Tuple) -> Tuple:
        """Replicated version-preserving install (tenant handoff on a
        repgroup owner): the LEADER's exact allocation
        (key, slot, handle, epoch, seq, payload) and leadership
        decision apply verbatim on this lane — independent
        allocation/leader choice could diverge the lanes.  Same
        (epoch, seq) stream discipline as data applies; the install's
        kv records and the advanced group meta land in ONE durability
        barrier (a crash between them must never advertise a
        regressed position over installed data)."""
        _, ge, seq, ens, lead, applied = frame
        if ge != self.promised or ge < self.applied_ge:
            return ("nack", "epoch", self.promised, self.applied_ge,
                    self.applied_seq)
        if seq == self.applied_seq and ge == self.applied_ge:
            return ("applied", ge, seq, self.last_crc)
        if seq != self.applied_seq + 1:
            return ("nack", "seq", self.promised, self.applied_ge,
                    self.applied_seq)
        applied = [tuple(a) for a in applied]
        crc = record_digest((a[1], a[2], a[3], a[4]) for a in applied)
        # version-preserving installs bypass the anchor gate — no
        # follower read may span one (rare: tenant handoff)
        self._flw_drop()
        self.applied_ge, self.applied_seq = int(ge), int(seq)
        self.last_crc = crc
        BatchedEnsembleService._apply_installed(
            self.svc, int(ens), applied, int(lead),
            extra_records=[(_GRP_KEY, (self.promised, int(ge),
                                       int(seq), self.cfg))])
        if self.svc._wal is not None \
                and self.svc._wal.count >= self.svc.wal_compact_records:
            rebuild_derived(self.svc)
            self.svc.save()
            save_group_meta(self.svc, self.promised, ge, seq, self.cfg)
        return ("applied", ge, seq, crc)

    # -- incremental (Merkle) catch-up ----------------------------------

    def handle_troots(self) -> Tuple:
        if self.svc.n_peers != 1:
            return ("error", "not-a-lane")
        return ("troots", self.applied_ge, self.applied_seq,
                tree_roots(self.svc).tobytes())

    def handle_tleaves(self, frame: Tuple) -> Tuple:
        _, rows = frame
        return ("tleaves", tree_leaves(self.svc,
                                       [int(r) for r in rows]).tobytes())

    def handle_tpatch(self, frame: Tuple) -> Tuple:
        """Targeted catch-up (the tree-exchange economics,
        synctree.erl:372-417 + exchange.erl:67-98): control-plane
        vectors + only the diverged slots' objects.  Valid ONLY
        against the exact frozen state the leader diffed — the
        ``expect`` guard nacks if this lane's (ge, seq) moved (it was
        applying after all, or a campaign intervened), and the leader
        falls back to the full snapshot."""
        _, ge, seq, expect, meta, patches = frame
        svc = self.svc
        if ge < self.promised:
            return ("nack", "epoch", self.promised, self.applied_ge,
                    self.applied_seq)
        if (self.applied_ge, self.applied_seq) != \
                (int(expect[0]), int(expect[1])):
            return ("nack", "seq", self.promised, self.applied_ge,
                    self.applied_seq)
        if meta_dynamic(meta) != svc.dynamic:
            # reject before the FIRST mutation — see install_meta
            raise ValueError("lifecycle-mode mismatch in tree patch")
        if patches:
            # one device scatter per plane: the LAST patch per (e, s)
            # wins, as the reference's in-order scatter does — a
            # duplicated index would have no defined winner on CUDA
            cells = np.asarray([p[:5] for p in patches], np.int64)
            _u, first_rev = np.unique(
                (cells[::-1, 0] * svc.n_slots + cells[::-1, 1]),
                return_index=True)
            _put_cells(svc, cells[len(cells) - 1 - first_rev].astype(
                np.int32))
            rows = np.zeros((svc.n_ens, svc.n_peers), bool)
            rows[np.unique([p[0] for p in patches])] = True
            svc.state = _rebuild_rows(svc.state, rows)
            for e, s, ep, sq, vl, key, handle, payload in patches:
                self._mirror_patch(int(e), int(s), key, int(handle),
                                   payload, int(ep), int(sq), int(vl))
        # control-plane vectors land LAST (ADVICE r5): an exception
        # anywhere above leaves this lane's (ge, seq) markers — and
        # its ballot/view vectors — untouched, so the replica is
        # still a consistently-frozen nacker and the leader's
        # full-install fallback heals it, instead of a lane holding
        # the leader's control plane over its own object planes.
        install_meta(svc, meta)
        rebuild_derived(svc)
        self.promised = max(self.promised, int(ge))
        self.applied_ge, self.applied_seq = int(ge), int(seq)
        self.last_crc = 0
        save_group_meta(svc, self.promised, ge, seq, self.cfg)
        if svc.data_dir is not None:
            # checkpoint, as the full install does: a restart must
            # restore the patched state (save() rotates the WAL)
            svc.save()
            save_group_meta(svc, self.promised, ge, seq, self.cfg)
        return ("installed", ge, seq)

    def _mirror_patch(self, e: int, s: int, key: Any, handle: int,
                      payload: Any, ep: int = 0, sq: int = 0,
                      vl: int = 0) -> None:
        """One patched slot's keyed host mirrors: adopt the leader's
        (key, handle, payload) — key None means the slot is empty on
        the leader, so any local mapping is dropped.  handle -1 is the
        leader's device-native (inline RMW) sentinel: the value rides
        the patched engine arrays, not the payload store (the read
        fast path's inline mirror adopts it from the patch's value
        plane).  The slot's committed (epoch, seq) rides into the vsn
        mirror so a later promotion serves leased kget_vsn from it."""
        svc = self.svc
        old = svc.slot_handle[e].pop(s, 0)
        if old > 0 and old != handle:
            svc.values.pop(old, None)
        stale = [k for k, sl in svc.key_slot[e].items()
                 if sl == s and k != key]
        for k in stale:
            svc.key_slot[e].pop(k, None)
        svc._slot_vsn_np[e, s] = (int(ep), int(sq))
        svc._slot_vsn_ok[e, s] = True
        if handle == -1:
            svc._inline_slots[e].add(s)
            svc._inline_np[e, s] = True
            svc._inline_value_np[e, s] = int(vl)
            svc._inline_value_ok[e, s] = True
            svc.slot_handle[e][s] = -1
            if key is not None:
                svc.key_slot[e][key] = s
            return
        svc._inline_slots[e].discard(s)
        svc._inline_np[e, s] = False
        svc._inline_value_ok[e, s] = False
        if handle:
            svc.values[handle] = payload
            svc.slot_handle[e][s] = handle
            if key is not None:
                svc.key_slot[e][key] = s
            if handle >= svc._next_handle:
                svc._next_handle = handle + 1


# -- leader-side peer link ---------------------------------------------------

class _Encoded:
    """A frame wire-encoded ONCE, shippable to many links (the apply
    fan-out encodes per flush, not per replica)."""

    __slots__ = ("payload",)

    def __init__(self, value: Any) -> None:
        p = wire.encode(value)
        self.payload = _HDR.pack(len(p)) + p


class _EncodedParts:
    """A raw frame encoded ONCE as scatter-gather parts: the length
    header + term section, then the bulk numpy buffers UNCOPIED (the
    arrays stay alive through the part references until every link's
    sender has written them).  One encode per flush, one ``sendmsg``
    per link."""

    __slots__ = ("parts", "nbytes")

    def __init__(self, value: Any) -> None:
        parts = wire.encode_parts(value)
        total = sum(memoryview(p).nbytes for p in parts)
        self.parts = [_HDR.pack(total)] + parts
        self.nbytes = total


def _send_parts(sock: socket.socket, parts) -> None:
    """Scatter-gather send: every part goes to the kernel straight
    from its owning buffer (one syscall in the common case; partial
    sends and IOV_MAX overflow re-slice and continue)."""
    views = [memoryview(p).cast("B") for p in parts]
    while views:
        sent = sock.sendmsg(views[:512])
        while views and sent >= views[0].nbytes:
            sent -= views[0].nbytes
            views.pop(0)
        if views and sent:
            views[0] = views[0][sent:]


class _Ticket:
    __slots__ = ("event", "result", "posted", "fired", "on_done")

    def __init__(self, on_done=None) -> None:
        self.event = threading.Event()
        self.result: Any = None
        #: send time (re-stamped by the sender as the frame goes on
        #: the wire) — lets the receiver's idle-timeout handling tell
        #: a genuinely-overdue response (posted >= IO_TIMEOUT ago)
        #: from a request that arrived DURING the blocked recv
        self.posted = time.monotonic()
        #: completion time, stamped in _fire — the (posted, fired)
        #: pair brackets the remote's handling stamp, which is what
        #: the fleet plane's NTP-midpoint clock-offset estimation
        #: consumes (obs.fleet.ClockOffset; zero until fired)
        self.fired = 0.0
        #: completion hook (the batch settle's shared condition),
        #: attached at creation — BEFORE the frame can complete, so a
        #: wakeup can never be missed
        self.on_done = on_done

    def _fire(self) -> None:
        self.fired = time.monotonic()
        self.event.set()
        cb = self.on_done
        if cb is not None:
            try:
                cb()
            except Exception:
                pass


class _PendingEntry:
    """One resolved-but-unsettled flush riding the replication
    pipeline: its stream seq, its ack-CRC contribution, its wire
    entry, and (once the service's resolve hook claims it) the launch
    record and result planes whose client futures resolve when the
    batch's host-quorum outcome is known.  The launch record carries
    what the reference kept here field by field (the taken ops, the
    host op planes, the latency record, the flush-join time and the
    slab lanes)."""

    __slots__ = ("seq", "crc", "entry", "fl", "planes", "ack",
                 "ack_reads", "shipped_at", "fid")

    def __init__(self, seq: int, crc: int, entry: Tuple,
                 shipped_at: float = 0.0, fid: int = 0) -> None:
        self.seq = seq
        self.crc = crc
        self.entry = entry
        #: obs flush id (cross-process tracing): the settle records
        #: the batch's ack span under it
        self.fid = fid
        #: the claimed launch record (None until the resolve hook
        #: claims this entry; heartbeat-style launches never do)
        self.fl: Any = None
        self.planes: Any = None
        self.ack = True
        self.ack_reads = True
        #: runtime.now when the flush was enqueued — the base of any
        #: host-lease grant its settle may issue (the quorum contact
        #: is no fresher than the ship; granting from settle-
        #: processing time would stretch the leased-read window by
        #: the whole settle delay)
        self.shipped_at = shipped_at


class _PendingShip:
    """One shipped batch (coalesced frame) awaiting its cumulative
    acks: member entries in seq order, one ticket per link, and a
    shared condition so the settle wakes on EVERY ack as it lands —
    the quorum decision fires at majority time, not after the slowest
    link (nor after a wait-links-in-list-order slow prefix)."""

    __slots__ = ("entries", "sends", "deadline", "crc", "first_seq",
                 "cond", "ship_t", "shipped_at")

    def __init__(self, entries: List[_PendingEntry],
                 deadline: float) -> None:
        self.entries = entries
        self.first_seq = entries[0].seq
        crc = 0
        for e in entries:
            crc = _crc_chain(crc, e.crc)
        self.crc = crc
        self.sends = []
        self.deadline = deadline
        self.cond = threading.Condition()
        self.ship_t = time.monotonic()
        self.shipped_at = max(e.shipped_at for e in entries)

    def _notify(self) -> None:
        with self.cond:
            self.cond.notify_all()

    def _acked_now(self) -> set:
        """Addresses whose cumulative ack already matches (cheap
        snapshot, re-evaluated per wakeup)."""
        acked = set()
        for link, t in self.sends:
            if not t.event.is_set():
                continue
            r = t.result
            if r is not None and r[0] == "applied" \
                    and int(r[3]) == self.crc and not link.needs_sync:
                acked.add((link.host, link.port))
        return acked

    def wait_quorum(self, quorum_eval) -> None:
        """Block until a majority ack is in, every ticket completed,
        or the deadline passes — whichever is first (ack latency =
        time to majority, not max over links)."""
        with self.cond:
            while True:
                if all(t.event.is_set() for _l, t in self.sends):
                    return
                if quorum_eval(self._acked_now()):
                    return
                remaining = self.deadline - time.monotonic()
                if remaining <= 0:
                    return
                self.cond.wait(remaining)


class PeerLink:
    """Leader's connection to one replica host: a sender thread owning
    a blocking socket plus a receiver thread matching responses to
    tickets **in FIFO order** — the windowed (pipelined) link.  Any
    number of frames may be outstanding; the replica handles one
    connection sequentially (``_serve_repl_conn``), so responses come
    back in send order and a simple deque pairs them.  Automatic
    reconnect with handshake; a connection drop fails every
    outstanding ticket (result None).  A link that has ever
    missed/failed anything is ``needs_sync`` until an install
    succeeds — conservative, because an out-of-date replica acking
    nothing is merely slow, while an out-of-date replica counted into
    a quorum is data loss.

    Round 4 shipped this link as lockstep (one outstanding frame), so
    replication could never overlap across flushes — the leader idled
    a full RTT + replica-apply per flush (VERDICT r4 weak #5).  The
    FIFO window keeps per-link ORDER (the correctness requirement:
    installs queued ahead of applies, applies in seq order) while
    letting flush N+1's ship ride behind flush N's outstanding ack.
    """

    RECONNECT_DELAY = 0.2
    #: one summarized drop/reconnect line per link per interval: an
    #: active nemesis (or a genuinely flapping link) produces drops
    #: at frame rate, and a log line per drop would bury stderr
    LOG_INTERVAL = 5.0

    def __init__(self, host: str, port: int, get_epoch,
                 local_label: str = faults.LOCAL) -> None:
        self.host, self.port = host, port
        #: fault-plane endpoint names: directional rules against this
        #: link address the replica side as "host:port" and the
        #: leader side as ``local_label`` (default ``faults.LOCAL``;
        #: a service with several leaders in ONE process — in-process
        #: nemesis groups — sets a distinct ``fault_label`` per
        #: service so rules can target one leader's links)
        self.label = f"{host}:{port}"
        self.local = str(local_label)
        self._get_epoch = get_epoch
        self.connected = False
        self.needs_sync = True
        #: connection failures observed on this link (stats surface)
        self.drops = 0
        #: successful re-establishments after the first connect
        self.reconnects = 0
        #: frames/responses the fault plane blackholed on this link
        self.injected_drops = 0
        self._ever_connected = False
        self._last_drop_log = 0.0
        self._drops_unlogged = 0
        #: at most one in-flight state snapshot; consumed (not waited
        #: on) by a later flush — installs never block the commit path
        self.install_ticket: Optional[_Ticket] = None
        #: the pipeline seq the install was queued AHEAD of (ADVICE
        #: r5): _settle_batch may consume the ticket only for batches
        #: at-or-after this seq — consuming an install posted by a
        #: LATER flush would clear needs_sync, the current entry's
        #: nack would re-set it, and the NEXT entry's legitimate
        #: matching ack would be discounted (one redundant full
        #: re-sync per occurrence)
        self.install_barrier = 0
        #: per-link clock-offset estimator (the fleet plane): every
        #: obsq sideband round-trip feeds it (posted/remote/fired
        #: stamps), and fleet timelines/dumps read the estimate +
        #: bound to place this replica's spans on the leader's axis
        self.clock = obs.ClockOffset()
        #: in-flight tree-diff catch-up (probe thread output)
        self.sync: Optional["_TreeSync"] = None
        #: one tree-diff attempt per connection: a failed patch falls
        #: back to the full snapshot instead of looping
        self.tried_tree = False
        self.remote_state: Tuple[int, int, int] = (0, 0, 0)
        self._q: "queue.Queue[Optional[Tuple[Tuple, _Ticket]]]" = \
            queue.Queue()
        self._sock: Optional[socket.socket] = None
        self._stop = False
        #: tickets sent and awaiting their (in-order) responses
        self._awaiting: "deque[_Ticket]" = deque()
        self._alock = threading.Lock()
        #: connection generation: a receiver bound to a dead socket
        #: must not fail tickets of the NEXT connection
        self._gen = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def post(self, frame: Tuple, on_done=None) -> _Ticket:
        t = _Ticket(on_done)
        self._q.put((frame, t))
        return t

    @staticmethod
    def wait(ticket: _Ticket, deadline: float) -> Any:
        if ticket.event.wait(max(0.0, deadline - time.monotonic())):
            return ticket.result
        return None

    def close(self) -> None:
        self._stop = True
        self._q.put(None)
        sock = self._sock
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    # -- sender -------------------------------------------------------------

    def _run(self) -> None:
        while not self._stop:
            item = self._q.get()
            if item is None:
                continue
            fp = faults.active_plan()
            if fp is not None \
                    and fp.should_swap(self.local, self.label):
                # bounded reorder: hold this frame and send the NEXT
                # queued one first (window of exactly two).  Tickets
                # ride their frames, so FIFO response pairing follows
                # the actual wire order; the replica's seq discipline
                # nacks the early frame and the re-sync path heals —
                # exactly the misordering the nemesis exists to drive.
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    self._send_one(item, fp)  # nothing to swap with
                    continue
                if nxt is None:
                    # close sentinel, not a frame: no swap happened —
                    # requeue it so the loop still terminates
                    self._q.put(None)
                    self._send_one(item, fp)
                    continue
                # only NOW did the wire order actually change
                fp.count_reorder(self.local, self.label)
                self._send_one(nxt, fp)
                self._send_one(item, fp)
                continue
            self._send_one(item, fp)

    def _send_one(self, item, fp) -> None:
        if item is None:
            # close sentinel consumed out of order (reorder stash):
            # put it back for the loop's own None handling
            self._q.put(None)
            return
        frame, ticket = item
        if fp is not None and fp.should_drop(self.local, self.label):
            # injected directional blackhole (leader→replica): the
            # frame never reaches the wire and the ticket never joins
            # _awaiting (pairing stays consistent).  Non-silent plans
            # fire the ticket unresolved NOW — the missed-ack outcome
            # at injection speed; silent plans leave it to the
            # caller's deadline (true blackhole timing).
            self.injected_drops += 1
            if not fp.silent:
                ticket._fire()
            return
        try:
            self._ensure_connected()
            # LOCAL capture: a concurrent receiver-side _drop sets
            # self._sock to None, and an AttributeError escaping
            # this try would kill the sender thread — a silently
            # dead link that never sends, fails, or resyncs again
            sock = self._sock
            if sock is None:
                raise ConnectionError("dropped mid-send")
            if fp is not None:
                # injected one-way request latency: sleeping the
                # sender delays this frame AND serializes behind it —
                # the in-order single-connection wire a slow link is
                d = fp.delay_s(self.local, self.label)
                if d > 0.0:
                    time.sleep(d)
            # append BEFORE send: the response cannot precede the
            # send, so the receiver always finds the ticket queued.
            # Re-stamp posted NOW — the ticket may have dwelled in
            # the sender queue behind a large install/patch
            # upload, and the receiver's overdue check must time
            # the wire wait, not the queue wait (a fresh request
            # read as overdue would drop a healthy link and force
            # the very re-sync the idle-timeout fix removed).
            with self._alock:
                ticket.posted = time.monotonic()
                self._awaiting.append(ticket)
            if isinstance(frame, _Encoded):
                sock.sendall(frame.payload)
            elif isinstance(frame, _EncodedParts):
                _send_parts(sock, frame.parts)
            else:
                send_frame(sock, frame)
        except (OSError, ConnectionError, wire.WireError,
                AttributeError):
            # the ticket may or may not have joined _awaiting;
            # _drop fails everything outstanding either way
            self._drop(fail_also=ticket)

    #: sentinel: the receive timed out before ANY byte arrived
    _IDLE = object()

    @classmethod
    def _recv_frame_or_idle(cls, sock: socket.socket):
        """``recv_frame`` that distinguishes an IDLE timeout (no byte
        of the next frame has arrived — benign on a quiet link) from a
        mid-frame timeout (bytes consumed, stream now desynced — a
        real failure).  Returns ``_IDLE`` for the former."""
        try:
            first = sock.recv(1)
        except socket.timeout:
            return cls._IDLE
        if not first:
            raise ConnectionError("peer closed")
        (length,) = _HDR.unpack(first + _recv_exact(sock,
                                                    _HDR.size - 1))
        if length > _MAX_FRAME:
            raise wire.WireError(f"frame too large: {length}")
        return wire.decode(_recv_exact(sock, length))

    def _recv_loop(self, sock: socket.socket, gen: int) -> None:
        while True:
            try:
                resp = self._recv_frame_or_idle(sock)
            except (OSError, ConnectionError, wire.WireError):
                if gen == self._gen:
                    self._drop()
                return
            if resp is self._IDLE:
                # Idle-socket timeout (IO_TIMEOUT with nothing in
                # flight): on a quiet link — a stepped-down ex-leader,
                # a leader with no client load and no heartbeat — this
                # fires every 120 s, and treating it as a link failure
                # forced a full re-sync reconnect each time (ADVICE
                # r5).  Benign when nothing is OVERDUE: no outstanding
                # response, or the oldest outstanding request was
                # posted DURING this blocked recv (its response hasn't
                # had IO_TIMEOUT to arrive yet — dropping would fail a
                # fresh request against a healthy peer).  A response
                # outstanding for a full IO_TIMEOUT (or a mid-frame
                # timeout) still drops the link — that peer really is
                # wedged; worst-case wedge detection is therefore
                # 2×IO_TIMEOUT.
                with self._alock:
                    oldest = (self._awaiting[0].posted
                              if self._awaiting else None)
                if gen != self._gen:
                    return
                if oldest is None or \
                        time.monotonic() - oldest < self.IO_TIMEOUT:
                    continue
                self._drop()
                return
            fp = faults.active_plan()
            if fp is not None:
                # injected one-way response latency (replica→leader):
                # sleep BEFORE pairing, so the ack lands late exactly
                # like a slow return path (later responses queue
                # behind it — the in-order wire again)
                d = fp.delay_s(self.label, self.local)
                if d > 0.0:
                    time.sleep(d)
            with self._alock:
                # a stale receiver (its connection already dropped and
                # replaced) must not consume the NEW connection's
                # tickets — the same off-by-one desync the reconnect
                # path guards against
                if gen != self._gen:
                    return
                t = self._awaiting.popleft() if self._awaiting else None
            if t is None:
                # a response with no outstanding request: protocol
                # corruption — drop the connection
                self._drop()
                return
            if fp is not None and fp.should_drop(self.label,
                                                 self.local):
                # injected directional blackhole on the RETURN path:
                # the request reached the replica (it may well have
                # applied!) but its ack vanishes — the genuinely
                # ambiguous asymmetry.  The ticket is consumed (the
                # pairing is real) but resolves to None: a missed
                # ack; silent plans don't even fire it.
                self.injected_drops += 1
                if not fp.silent:
                    t._fire()
                continue
            t.result = resp
            t._fire()

    #: per-operation socket timeout: generous enough for an install
    #: (state transfer + replica-side checkpoint), bounded so a
    #: SIGSTOP'd/partitioned peer can't wedge the worker forever
    IO_TIMEOUT = 120.0
    #: connect + HANDSHAKE budget: the whole establishment (TCP
    #: connect, hello, helloed) must finish inside this bound.  The
    #: handshake reply previously ran under IO_TIMEOUT (120 s) — a
    #: half-open peer (SYN accepted, nothing ever answers: a
    #: firewalled port, a SIGSTOP'd accept loop, a one-directional
    #: partition eating the response) wedged the sender thread for
    #: two minutes per attempt
    CONNECT_TIMEOUT = 10.0

    def _ensure_connected(self) -> None:
        if self.connected and self._sock is not None:
            return
        # (no separate injected-partition check here: _send_one — the
        # only caller — already short-circuits the same directional
        # drop rule before any socket work, so a dropped link never
        # reaches the connect path at all)
        # a FRESH connection must start with an EMPTY pairing queue:
        # a ticket whose send slipped in between a receiver-side
        # _drop clearing the deque and the socket actually dying can
        # linger here — if it survived into the new connection, the
        # first response would pop IT and desync every later
        # request/response pair on this link (off-by-one acks →
        # phantom CRC mismatches → a permanently unsyncable replica)
        with self._alock:
            dead = list(self._awaiting)
            self._awaiting.clear()
        for t in dead:
            t._fire()
        self._sock = socket.create_connection(
            (self.host, self.port), timeout=self.CONNECT_TIMEOUT)
        # handshake runs lockstep on the fresh socket BEFORE the
        # receiver thread attaches (so its response is consumed
        # here), under the CONNECT budget — only an ESTABLISHED link
        # earns the generous IO_TIMEOUT
        self._sock.settimeout(self.CONNECT_TIMEOUT)
        send_frame(self._sock, ("hello", self._get_epoch()))
        resp = recv_frame(self._sock)
        if resp[0] != "helloed":
            raise ConnectionError(f"bad handshake: {resp!r}")
        self._sock.settimeout(self.IO_TIMEOUT)
        self.remote_state = (int(resp[1]), int(resp[2]), int(resp[3]))
        self.connected = True
        if self._ever_connected:
            self.reconnects += 1
        self._ever_connected = True
        # any (re)connect is conservative: re-sync before counting
        self.needs_sync = True
        self.tried_tree = False
        self._gen += 1
        threading.Thread(target=self._recv_loop,
                         args=(self._sock, self._gen),
                         daemon=True).start()

    def _drop(self, fail_also: Optional[_Ticket] = None) -> None:
        if not self._stop:
            # a deliberate close() tears the socket down too — that
            # is not a link FAILURE; only live drops count and log
            self.drops += 1
            self._log_drop()
        self.connected = False
        self.needs_sync = True
        self._gen += 1  # detach any receiver bound to the old socket
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        with self._alock:
            dead = list(self._awaiting)
            self._awaiting.clear()
        for t in dead:
            t._fire()
        if fail_also is not None:
            fail_also._fire()
        if not self._stop:
            time.sleep(self.RECONNECT_DELAY)

    def _log_drop(self) -> None:
        """Rate-limited link-failure logging: at most one SUMMARIZED
        stderr line per link per LOG_INTERVAL, carrying the count of
        drops since the last line — an active nemesis (or a real
        flapping link) failing at frame rate cannot spam stderr,
        while a quiet link's first failure still logs immediately.
        The full history rides ``drops``/``reconnects``/
        ``injected_drops`` in stats()."""
        self._drops_unlogged += 1
        now = time.monotonic()
        if now - self._last_drop_log < self.LOG_INTERVAL:
            return
        n, self._drops_unlogged = self._drops_unlogged, 0
        self._last_drop_log = now
        try:
            print(f"[repgroup] link {self.label}: connection dropped "
                  f"({n} drop(s), {self.injected_drops} injected, "
                  f"{self.reconnects} reconnects since start; "
                  f"retrying)", file=sys.stderr, flush=True)
        except Exception:
            pass  # a broken stderr must never take the link down

    def link_stats(self) -> Dict[str, Any]:
        """Per-link observability row (wire-encodable plain data):
        liveness + failure counters, and — while a fault plan is
        active — the ``injected`` section that lets an operator tell
        a running nemesis from a real outage."""
        out = {
            "host": self.host,
            "port": int(self.port),
            "connected": bool(self.connected),
            "synced": not self.needs_sync,
            "drops": int(self.drops),
            "reconnects": int(self.reconnects),
            "injected_drops": int(self.injected_drops),
        }
        fp = faults.active_plan()
        if fp is not None:
            inj = fp.link_injected(self.local, self.label)
            ret = fp.link_injected(self.label, self.local)
            inj["return_dropping"] = ret.pop("dropping")
            inj["return_rtt_ms"] = ret["rtt_ms"]
            inj["return_drops"] = ret["drops"]
            out["injected"] = inj
        return out


# -- the replicated service (leader role) ------------------------------------

class ReplicatedService(BatchedEnsembleService):
    """A batched service whose commit barrier spans OS-process failure
    domains.

    Construct with ``peers=[(host, port), ...]`` (the OTHER replica
    hosts' replication ports) and call :meth:`takeover` to establish
    leadership before serving.  Without peers it behaves as a plain
    single-lane service (the replica role drives it through
    :class:`ReplicaCore` instead).

    The client surface (kput/kget/... and the vectorized/batch forms)
    is inherited unchanged — replication happens inside ``_launch``,
    and the host-quorum outcome gates future resolution through
    ``_resolve_flush`` exactly like the local WAL barrier does.

    The lane runs on the card unless ``device="cpu"`` is passed (a
    keyword of the base service); without a card it raises.
    """

    def __init__(self, runtime, n_ens: int, n_peers: int = 1,
                 n_slots: int = 128, group_size: int = 1,
                 peers: Sequence[Tuple[str, int]] = (),
                 ack_timeout: float = 2.0,
                 install_timeout: float = 60.0,
                 repl_window: int = 4,
                 self_addr: Optional[Tuple[str, int]] = None,
                 trust_host_lease: bool = False,
                 fault_label: Optional[str] = None,
                 follower_reads: Optional[bool] = None,
                 **kw) -> None:
        # the (runtime, n_ens, n_peers, n_slots) positional prefix
        # matches the base class so restore() reconstructs us from a
        # persisted shape; the lane is always single-peer (the OTHER
        # peers are the group's hosts)
        assert n_peers == 1, "a replication-group lane has n_peers=1"
        kw.setdefault("tick", None)
        super().__init__(runtime, n_ens, 1, n_slots, **kw)
        assert group_size >= 1
        self.group_size = group_size
        self.ack_timeout = ack_timeout
        self.install_timeout = install_timeout
        #: serializes promise grants against a takeover's commit point
        #: (a promise granted mid-campaign must never be regressed by
        #: the campaign's own meta write)
        self._meta_lock = threading.Lock()
        #: this host's identity in group-config member lists (the
        #: address OTHER hosts dial it by; exact-match comparison).
        #: None = legacy implicit membership: the leader counts itself
        #: toward every quorum and update_members (host form) is
        #: unavailable until an identity exists.
        self.self_addr = (None if self_addr is None
                          else (str(self_addr[0]), int(self_addr[1])))
        self.core = ReplicaCore(self)
        if self.core.cfg[1] is not None:
            # a persisted explicit config wins over the constructor's
            # group_size (the set may have grown/shrunk since)
            self.group_size = len(self.core.cfg[1])
        #: in-progress membership transition (leader-side driver state)
        self._cfg_txn: Optional[Dict[str, Any]] = None
        self._ge = self.core.applied_ge
        self._grp_seq = self.core.applied_seq
        self._deposed = False
        self._is_leader = False
        self._last_quorum_ok = True
        #: lease-protected fast reads on a replication group are
        #: LEADER-ONLY and additionally gated on a HOST-side lease:
        #: renewed only by a settle whose host quorum confirmed this
        #: leader's epoch, zeroed the moment a settle loses the
        #: quorum or a higher promise is observed (a deposed leader
        #: invalidates before its next ack).  OPT-IN
        #: (``trust_host_lease=True``): unlike the device-lane lease,
        #: host promises are not time-fenced — a candidate may be
        #: granted a takeover at any moment, so a superseded-but-live
        #: leader could serve up to ``config.lease()`` of leased
        #: reads before its next settle observes the fencing.  The
        #: default keeps the strict reads-need-the-host-quorum
        #: barrier; opt in when the deployment's promotion discipline
        #: waits out the lease (docs/ARCHITECTURE.md §9).
        self.trust_host_lease = bool(trust_host_lease)
        self._host_lease_until = 0.0
        #: follower-served leased reads (docs/ARCHITECTURE.md §16).
        #: OFF by default — the off arm ships 3-field abatch frames
        #: byte-identical to HEAD.  On: every abatch frame carries the
        #: per-address grant table, settles renew per-replica read
        #: leases, and settle quorums exclude nothing — but a write
        #: cannot ACK while a non-acking replica still holds an
        #: unexpired lease (the write barrier that makes replica
        #: reads linearizable).
        self._follower_reads = (
            bool(follower_reads) if follower_reads is not None
            else os.environ.get("RETPU_FOLLOWER_READS", "0") == "1")
        #: highest ack seq granted per replica address (ships in every
        #: frame) and the leader-side write fence per address:
        #: fence[a] = settle time + lease, an upper bound on the
        #: replica's own window (its anchor predates our settle)
        self._flw_grants: Dict[Tuple[str, int], int] = {}
        self._flw_fence: Dict[Tuple[str, int], float] = {}
        #: fault-plane endpoint name for THIS leader's side of its
        #: links (docs/ARCHITECTURE.md §13).  Default "local"; tests
        #: hosting several leaders in one process pass distinct
        #: labels so directional rules can target one leader's
        #: links.  Constructor-peer links are built right below, so a
        #: non-default label must arrive via this parameter (a bare
        #: attribute assignment only affects links attached LATER —
        #: attach_peers / promote / config growth).
        self.fault_label = (str(fault_label) if fault_label is not None
                            else faults.LOCAL)
        self._links: List[PeerLink] = [
            PeerLink(h, p, lambda: self._ge,
                     local_label=self.fault_label) for h, p in peers]
        #: replication window: resolved-but-unsettled flush entries,
        #: oldest first; at most repl_window deep before the ship path
        #: blocks on the head batch (per-flush quorum barrier stands —
        #: futures resolve only at settlement).  Distinct from the
        #: base service's pipeline_depth (the DEVICE launch pipeline).
        self.repl_window = max(1, int(repl_window))
        # the runtime controller was constructed in the base __init__
        # before this attribute existed: its heal target for the
        # window knob is THIS constructor-configured value
        self._autotune_base_window = self.repl_window
        self._pending_flushes: "deque[_PendingShip]" = deque()
        self._unclaimed: Optional[_PendingEntry] = None
        #: resolved entries awaiting their coalesced ship (all the
        #: entries one flush settles ride ONE frame per link)
        self._ship_buf: List[_PendingEntry] = []
        #: tickets of batches settled at majority whose stragglers'
        #: outcomes (needs_sync, depose nacks) still need bookkeeping
        self._stragglers: List[Tuple[PeerLink, _Ticket, int]] = []
        #: changed-slot delta shipping (RETPU_REPL_DELTA=0 pins the
        #: full-plane frames — the A/B arm and operational escape
        #: hatch); int16 round/slot indices bound the eligible shape
        self._repl_delta = os.environ.get(
            "RETPU_REPL_DELTA", "1") != "0"
        #: reentrancy guard: shipping may drain the launch pipeline,
        #: whose settles call back into _drain_pending
        self._shipping = False
        self._delta_shape_ok = (n_slots <= 32767
                                and self.max_k <= 32767)
        #: replication observability
        self.group_stats = {"applies": 0, "quorum_failures": 0,
                            "resyncs": 0, "depositions": 0,
                            "tree_resyncs": 0, "tree_resync_bytes": 0,
                            "repl_delta_entries": 0,
                            "repl_full_entries": 0,
                            "repl_frames": 0,
                            "repl_bytes_shipped": 0,
                            "repl_bytes_sections": 0,
                            "repl_bytes_full_equiv": 0,
                            "repl_encode_s": 0.0,
                            "repl_build_s": 0.0,
                            "repl_ack_s": 0.0,
                            "repl_acked_batches": 0,
                            "follower_lease_write_blocks": 0,
                            "follower_reads_served": 0,
                            "follower_reads_blocked": 0}
        #: commutative-lane counters (docs/ARCHITECTURE.md §18) —
        #: kept OUT of group_stats so their metric names are the
        #: documented ``retpu_repl_*`` family, not auto-prefixed
        #: ``retpu_group_*`` rows
        self.comm_stats = {"repl_merge_entries": 0,
                           "repl_merge_cells": 0,
                           "repl_merge_ops": 0,
                           "repl_early_acks": 0}
        # group-level metrics join the service's registry (the
        # svcnode `metrics` verb and the docs ratchet see one plane)
        self.obs_registry.collect(self._obs_group_collect)
        #: the standing fleet anomaly watchdog (obs/watchdog.py):
        #: ALWAYS constructed so the retpu_watchdog_*/clock-offset
        #: gauge families register; it TICKS only while armed
        #: (RETPU_WATCHDOG, default on) AND this lane leads with
        #: links — the bench's fleet_obs_overhead off arm flips the
        #: knob and builds a fresh service, like every obs knob
        self.watchdog = obs.AnomalyWatchdog(self)
        self._watchdog_armed = self.watchdog.enabled and self._obs
        #: one-off obsq pulls (fleet verbs + correlated dumps) —
        #: counted apart from the watchdog's STANDING pulls, so a
        #: triggered dump on a RETPU_WATCHDOG=0 service never reads
        #: as the walker having run (source="verb" vs "watchdog")
        self.fleet_verb_pulls = 0
        self.fleet_verb_pull_failures = 0
        self.obs_registry.collect(self.watchdog.collect)

    def _obs_group_collect(self) -> Dict[str, Any]:
        def fam(typ, help, val):
            # the collector-family shape lives in obs.registry.family
            return obs.registry.family(typ, help, {None: val})

        out = {
            "retpu_group_is_leader": fam(
                "gauge", "1 while this lane leads its group",
                int(self.is_leader)),
            "retpu_group_epoch": fam(
                "gauge", "group epoch", self._ge),
            "retpu_group_seq": fam(
                "gauge", "applied stream position", self._grp_seq),
            "retpu_group_peers_connected": fam(
                "gauge", "links currently connected",
                sum(l.connected for l in self._links)),
            "retpu_group_peers_synced": fam(
                "gauge", "links not needing re-sync",
                sum(not l.needs_sync for l in self._links)),
            "retpu_group_pipeline_pending": fam(
                "gauge", "resolved-but-unsettled flush entries",
                self._outstanding()),
        }
        for key, val in self.group_stats.items():
            # every group_stats entry is cumulative-monotone (the
            # *_s entries are summed seconds) — counters all, so
            # PromQL rate()/increase() semantics apply uniformly
            out[f"retpu_group_{key}"] = fam(
                "counter",
                "replication group stat (see stats()['group'])",
                round(val, 6) if isinstance(val, float) else val)
        # commutative replication lane (§18): always registered, so
        # the RETPU_COMM_REPL=0 arm exports the same (zeroed) names
        cs = self.comm_stats
        out["retpu_repl_merge_cells"] = fam(
            "counter", "coalesced merge cells shipped (§18)",
            cs["repl_merge_cells"])
        out["retpu_repl_early_acks"] = fam(
            "counter",
            "pure-commutative entries settled on early acks (§18)",
            cs["repl_early_acks"])
        out["retpu_repl_merge_coalesce_ratio"] = fam(
            "gauge", "committed RMW ops absorbed per merge cell",
            round(cs["repl_merge_ops"]
                  / max(cs["repl_merge_cells"], 1), 6))
        return out

    # -- fleet-scope observability (docs/ARCHITECTURE.md §11) ---------------

    #: bounded budget for a synchronous fleet pull (the verbs and the
    #: correlated-dump hook; the watchdog's standing pulls are
    #: harvest-next-window and never wait at all)
    FLEET_PULL_TIMEOUT = 2.0

    def _obsq_result(self, link: PeerLink, ticket: _Ticket):
        """Unwrap one completed obsq ticket: feeds the link's clock
        estimator from the (posted, remote, fired) stamp triple and
        returns the payload — None for drops/timeouts/non-answers."""
        r = ticket.result
        if (isinstance(r, tuple) and len(r) >= 3
                and r[0] == "obsr"):
            if ticket.fired:
                link.clock.update(ticket.posted, float(r[1]),
                                  ticket.fired)
            return r[2]
        return None

    def _fleet_pull(self, subop: str, *args,
                    deadline_s: Optional[float] = None
                    ) -> Dict[str, Any]:
        """Post one ``obsq`` sideband request to EVERY link and wait
        (bounded) for the answers: ``{host_label: payload-or-None}``.
        The request rides the link's FIFO window behind any
        outstanding applies — ordered like everything else on the
        wire, no second connection, no second trust model."""
        tickets = [(link, link.post(("obsq", subop) + args))
                   for link in self._links]
        deadline = time.monotonic() + (
            self.FLEET_PULL_TIMEOUT if deadline_s is None
            else deadline_s)
        out: Dict[str, Any] = {}
        for link, t in tickets:
            PeerLink.wait(t, deadline)
            payload = self._obsq_result(link, t) \
                if t.event.is_set() else None
            if payload is None:
                self.fleet_verb_pull_failures += 1
            out[link.label] = payload
        self.fleet_verb_pulls += len(tickets)
        return out

    def _clock_section(self) -> Dict[str, Any]:
        return {l.label: l.clock.section() for l in self._links}

    def fleet_metrics(self, fmt: Optional[str] = None):
        """One answer for the whole group: every replica's registry
        pulled over the obsq sideband next to this leader's own.
        ``fmt="prometheus"`` merges the per-host renders into ONE
        scrape document with ``host`` labels (§11) — the federated
        scrape; otherwise a dict of per-host snapshots plus the
        clock-offset estimates the pull refreshed."""
        if not self._links:
            return super().fleet_metrics(fmt)
        label = self._fleet_self_label()
        if fmt == "prometheus":
            sections = {label: self.obs_registry.render_prometheus()}
            sections.update(self._fleet_pull("prometheus"))
            return obs.merge_prometheus(sections)
        hosts = {label: self.obs_registry.snapshot()}
        for h, snap in self._fleet_pull("metrics").items():
            hosts[h] = snap
        return {"schema": "retpu-fleet-metrics-v1", "hosts": hosts,
                "clock": self._clock_section()}

    def fleet_health(self) -> Dict[str, Any]:
        if not self._links:
            return super().fleet_health()
        hosts = {self._fleet_self_label(): self.health()}
        hosts.update(self._fleet_pull("health"))
        return {"schema": "retpu-fleet-health-v1", "hosts": hosts,
                "clock": self._clock_section()}

    def fleet_timeline(self, flush_id: int) -> Dict[str, Any]:
        """The clock-aligned cross-host timeline: this process's
        record for ``flush_id`` merged with every replica's pulled
        record, each role's spans placed on the LEADER's monotonic
        axis through the per-link offset estimates (honest to the
        per-role ``bound_ms``)."""
        if not self._links:
            return super().fleet_timeline(flush_id)
        fid = int(flush_id)
        sides: Dict[str, Any] = {}
        local = obs.SPANS.timeline(fid)
        missing = True
        if local and not local.get("miss"):
            missing = False
            sides.update({r: s for r, s in local.items()
                          if r != "flush_id"})
        for _host, payload in self._fleet_pull(
                "timeline", [fid]).items():
            tl = payload.get(fid) if isinstance(payload, dict) \
                else None
            if not isinstance(tl, dict) or tl.get("miss"):
                continue
            missing = False
            for role, side in tl.items():
                if role != "flush_id" and role not in sides:
                    sides[role] = side
        out = obs.align_timeline(fid, sides, self._clock_section(),
                                 self._fleet_self_label())
        if missing and local and local.get("miss"):
            out["miss"] = local["miss"]
        return out

    def _obs_flush_settled(self, fl) -> None:
        super()._obs_flush_settled(fl)
        # the standing watchdog rides the same settle hook as the
        # controller (observe-only sibling): leader-with-links only —
        # a replica lane has no links to pull and no acks to audit
        if self._watchdog_armed and self._links and self.is_leader:
            self.watchdog.tick(fl.flush_id)

    def _flight_extras(self) -> Dict[str, Any]:
        """Correlated flight dumps (schema v4): on top of the base
        sections, pull every replica's span records for the fids in
        THIS ring (bounded wait — dump writes are already rate-
        limited to one per ``min_dump_interval_s``) so the dump that
        says "this flush was 8× p50" also says which host's
        wal_sync/apply held it, on one aligned clock."""
        out = super()._flight_extras()
        out["watchdog_findings"] = self.watchdog.flight_section()
        if not (self._links and self.is_leader):
            return out
        fids = [int(r["flush_id"]) for r in self.flight.records
                if r.get("flush_id")][-32:]
        if not fids:
            return out
        hosts: Dict[str, Any] = {}
        for host, payload in self._fleet_pull(
                "timeline", fids,
                deadline_s=self.FLEET_PULL_TIMEOUT).items():
            if isinstance(payload, dict):
                hosts[host] = {"spans": {int(f): tl for f, tl
                                         in payload.items()}}
            else:
                hosts[host] = {"unreachable": True}
        out["hosts"] = hosts
        out["clock_offsets"] = self._clock_section()
        return out

    # -- leadership ---------------------------------------------------------

    @property
    def is_leader(self) -> bool:
        return self._is_leader and not self._deposed

    def _fast_read_ok(self, ens: int, now: float):
        """Group-mode gate over the base lease fast path: replicas
        NEVER serve (leader-only), and a leader serves only inside a
        host-quorum lease — and only when the operator opted into
        trusting it (``trust_host_lease``); the default keeps every
        read behind the host-quorum round."""
        if self._links or self.group_size > 1:
            if not self.is_leader:
                return "not_leader"
            if not self.trust_host_lease:
                return "no_host_lease_trust"
            if self._host_lease_until <= now + self._read_margin:
                return "no_lease"
        return super()._fast_read_ok(ens, now)

    def attach_peers(self, peers: Sequence[Tuple[str, int]]) -> None:
        assert not self._links, "peers already attached"
        self._links = [PeerLink(h, p, lambda: self._ge,
                                local_label=self.fault_label)
                       for h, p in peers]

    def takeover(self, timeout: float = 30.0) -> bool:
        """Establish leadership: promise round to a majority, adopt
        the newest ``(epoch, seq)`` state among the grants, bump the
        group epoch.  Returns True on success; False when no majority
        granted (insufficient reachable replicas — the group cannot
        safely elect, exactly the minority-partition case)."""
        self._drain_launches()  # settle the device launch pipeline
        self._drain_pending(block_all=True)  # settle any prior reign
        deadline = time.monotonic() + timeout
        ge = max(self._ge, self.core.promised) + 1
        while time.monotonic() < deadline:
            # the campaign runs under the candidate's CURRENT config;
            # a grant (or the pulled state) carrying a newer config
            # re-runs the quorum check under THAT config below —
            # because configs ride the seq stream, any committed
            # config is held by at least one member of every majority
            # the old config admits (the Raft joint-consensus overlap
            # argument), so a stale candidate always discovers it
            self._ensure_cfg_links()
            tickets = [(l, l.post(("promise", ge))) for l in self._links]
            grants: List[Tuple[PeerLink, int, int, GroupCfg]] = []
            highest = ge
            for link, t in tickets:
                r = PeerLink.wait(t, min(deadline,
                                         time.monotonic()
                                         + self.ack_timeout))
                if r is None or r[0] != "promised":
                    continue
                granted, promised, age, aseq = r[1:5]
                rcfg = _norm_cfg(r[5]) if len(r) > 5 else NO_CFG
                highest = max(highest, int(promised))
                if granted:
                    grants.append((link, int(age), int(aseq), rcfg))
            # adopt the newest granted config (configs ride the seq
            # stream, so the best-by-(ge, seq) grant carries the max
            # cver among grants); self's own may still be newer
            best_cfg = max([self.core.cfg] + [g[3] for g in grants],
                           key=lambda c: c[0])
            if best_cfg[0] > self.core.cfg[0]:
                self.core.set_cfg(best_cfg)
                self._ensure_cfg_links()
            granted_addrs = {(g[0].host, g[0].port) for g in grants}
            if not self._campaign_quorum(granted_addrs):
                # keep trying until the deadline, always at a FRESH
                # epoch: this round's grants consumed the current one
                # (promises are strictly increasing), so re-proposing
                # it can never succeed (review r4)
                ge = max(highest, ge) + 1
                time.sleep(0.2)
                continue
            # adopt the newest state among the quorum (self included)
            best = max(grants, key=lambda g: (g[1], g[2]), default=None)
            if best is not None and \
                    (best[1], best[2]) > (self.core.applied_ge,
                                          self.core.applied_seq):
                link = best[0]
                t = link.post(("pull",))
                r = PeerLink.wait(t, time.monotonic()
                                  + self.install_timeout)
                if r is None or r[0] != "state":
                    # source died mid-pull; retry with a HIGHER epoch:
                    # the round's grants consumed this one (promises
                    # are strictly increasing), so re-proposing it
                    # could never gather a majority again (review r4)
                    ge += 1
                    continue
                age, aseq, dump = r[1], r[2], r[3]
                if len(r) > 4:
                    # the pulled state's config must be adopted (and
                    # its quorum re-validated) BEFORE the install
                    # mutates this lane — a failed check that had
                    # already installed would leave newer state under
                    # stale (applied_ge, applied_seq) markers, and the
                    # next winning round would reissue old seqs over it
                    pulled_cfg = _norm_cfg(r[4])
                    if pulled_cfg[0] > self.core.cfg[0]:
                        self.core.set_cfg(pulled_cfg)
                        self._ensure_cfg_links()
                        if not self._campaign_quorum(granted_addrs):
                            # re-campaign under the adopted config
                            # (fresh epoch)
                            ge = max(highest, ge) + 1
                            continue
                install_state(self, dump)
                self.core.applied_ge = int(age)
                self.core.applied_seq = int(aseq)
                # the source is NOT stale relative to us
                link.needs_sync = False
                link.remote_state = (ge, int(age), int(aseq))
            # Commit point, atomic vs concurrent promise grants: a
            # higher promise granted mid-campaign (another candidate
            # raced us) means we are already fenced — stand down
            # rather than regress the persisted promise.
            with self._meta_lock:
                if self.core.promised > ge:
                    return False
                self._ge = ge
                self._grp_seq = self.core.applied_seq
                self.core.promised = ge
                save_group_meta(self, ge, self.core.applied_ge,
                                self._grp_seq, self.core.cfg)
                self._deposed = False
                self._is_leader = True
                # a fresh reign starts lease-less: the first quorum-
                # confirmed settle grants the host read lease
                self._host_lease_until = 0.0
                # ...and grant-less: follower read leases issued by
                # the PREVIOUS reign are not ours to renew, and this
                # lane's own replica-role window dies with the reign
                self._flw_grants.clear()
                self._flw_fence.clear()
                self.core._flw_drop()
            # a persisted explicit config defines the quorum size now
            if self.core.cfg[1] is not None:
                self.group_size = len(self.core.cfg[1])
                # an interrupted transition resumes under this leader
                if self.core.cfg[2] is not None:
                    self._cfg_txn = {"new": list(self.core.cfg[2]),
                                     "joint_committed": False}
            # links whose promise reported our adopted (ge, seq) hold
            # bit-equal state (same applied prefix) — no re-sync
            for link, age, aseq, _rcfg in grants:
                if (age, aseq) == (self.core.applied_ge,
                                   self._grp_seq):
                    link.needs_sync = False
            if self._follower_reads:
                # §16 takeover fence: a member that did NOT grant our
                # promise may still hold a read lease from the old
                # reign (granting members dropped theirs inside
                # handle_promise, before the grant persisted).  Any
                # such lease anchors at an ack the OLD leader settled
                # within its batch deadline, so it expires within
                # ack_timeout + lease() of that settle — and no new
                # grant can issue once our majority promised (their
                # epoch nacks break the old leader's settle quorum).
                # Wait it out before this reign's first write acks.
                members = self._member_addrs() or [
                    (l.host, l.port) for l in self._links]
                ungranted = [a for a in members
                             if a != self.self_addr
                             and a not in granted_addrs]
                if ungranted:
                    time.sleep(self.ack_timeout + self.config.lease()
                               + self._read_margin)
            self._emit("grp_takeover", {"epoch": ge,
                                        "seq": self._grp_seq})
            return True
        return False

    # -- group configuration (dynamic host membership) ----------------------

    def _member_addrs(self) -> Optional[List[Tuple[str, int]]]:
        """The current committed member list, synthesized from links
        when running in legacy implicit mode (requires self_addr)."""
        if self.core.cfg[1] is not None:
            return list(self.core.cfg[1])
        if self.self_addr is None:
            return None
        return [self.self_addr] + [(l.host, l.port)
                                   for l in self._links]

    def _ensure_cfg_links(self) -> None:
        """Links must cover every address in the config (hosts and
        joint, minus self)."""
        _cver, hosts, joint = self.core.cfg
        self._ensure_cfg_links_for(
            list(hosts or ()) + [a for a in (joint or ())
                                 if a not in (hosts or ())])

    def _maj(self, members, voted) -> bool:
        votes = sum(1 for m in members
                    if m in voted or m == self.self_addr)
        return votes >= len(members) // 2 + 1

    def _quorum_from(self, acked_addrs) -> bool:
        """Commit quorum under the current config: legacy implicit
        mode counts acks against group_size (self included); explicit
        mode needs a majority of the member list, AND of the joint
        list during a transition (the multi-view AND)."""
        _cver, hosts, joint = self.core.cfg
        if hosts is None:
            return (1 + len(acked_addrs)) >= (self.group_size // 2 + 1)
        ok = self._maj(hosts, acked_addrs)
        if joint is not None:
            ok = ok and self._maj(joint, acked_addrs)
        return ok

    def _campaign_quorum(self, granted_addrs) -> bool:
        """Takeover quorum: same shape as the commit quorum (the
        overlap argument requires grant majorities and commit
        majorities to intersect per member list)."""
        return self._quorum_from(granted_addrs)

    def update_members(self, *args):
        """Membership change.

        **Host form** (replication group): ``update_members(hosts)``
        with ``hosts`` a sequence of ``(host, repl_port)`` addresses —
        the new member set, self_addr included if this leader stays a
        member.  Starts a joint-consensus transition (grow, shrink, or
        replace): the config record rides the apply stream, commits
        require majorities of BOTH old and new sets until the collapse
        record lands, and a joining host is never counted before its
        re-sync completes (the synced-before-counted rule).  The
        transition advances on subsequent flushes/heartbeats
        (:meth:`membership_status`); it is asynchronous, like the
        reference's update_members → leader_tick pipeline
        (peer.erl:655-672, 1199-1214).

        **View form** (single-lane mode only): the base class's
        ``update_members(sel, new_view)`` per-ensemble change.
        """
        if len(args) == 2:
            if self._links or self.group_size > 1:
                raise TypeError(
                    "per-ensemble views don't exist on a replication "
                    "group (the lane is single-peer); pass the new "
                    "host list: update_members([(host, port), ...])")
            return super().update_members(*args)
        (new_hosts,) = args
        new = [(str(h), int(p)) for h, p in new_hosts]
        if not self.is_leader:
            raise DeposedError("not the group leader")
        if self.self_addr is None:
            raise ValueError(
                "membership change needs this leader's identity: "
                "construct with self_addr=(host, port)")
        if self._cfg_txn is not None:
            raise RuntimeError(
                "a membership transition is already in progress")
        if len(new) < 1:
            raise ValueError("the group needs at least one member")
        current = self._member_addrs()
        if set(new) == set(current):
            return
        self._drain_launches()
        self._drain_pending(block_all=True)
        if self._follower_reads:
            # §16 config fence: no member may serve a follower read
            # under the OLD membership once config records start
            # acking.  Stop issuing grants (handle_cfg drops windows
            # on every acking member; _settle_batch won't grant while
            # _cfg_txn is set below) and wait out every outstanding
            # fence — after this, any lease we ever granted has
            # expired on the holder's clock too.
            self._flw_grants.clear()
            now_m = time.monotonic()
            wait = max([t - now_m for t in self._flw_fence.values()],
                       default=0.0)
            if wait > 0:
                time.sleep(wait + self._read_margin)
            self._flw_fence.clear()
        cver = self.core.cfg[0]
        if self.core.cfg[1] is None:
            # first explicit config: pin the CURRENT set at cver+1 so
            # every lane agrees what 'old' means before the joint
            # record references it
            if not self._commit_cfg(cver + 1, current, None):
                raise RuntimeError(
                    "no quorum to pin the current member set")
            cver += 1
        self._ensure_cfg_links_for(new)
        self._cfg_txn = {"new": new, "joint_committed": False}
        self._cfg_txn["joint_committed"] = \
            self._commit_cfg(cver + 1, current, new)
        self._advance_cfg()

    def _ensure_cfg_links_for(self, addrs) -> None:
        have = {(l.host, l.port) for l in self._links}
        for a in addrs:
            if a == self.self_addr or a in have:
                continue
            self._links.append(PeerLink(a[0], a[1],
                                        lambda: self._ge,
                                        local_label=self.fault_label))
            have.add(a)

    def membership_status(self) -> Dict[str, Any]:
        cver, hosts, joint = self.core.cfg
        return {"cver": cver,
                "hosts": None if hosts is None else list(hosts),
                "joint": None if joint is None else list(joint),
                "transition": self._cfg_txn is not None}

    def _replicate_record(self, frame: Tuple, crc: int) -> set:
        """Ship ONE synchronous replicated record (lifecycle, config,
        version-preserving install) and collect its acks: settle the
        pipeline, consume finished catch-up tickets, queue a snapshot
        ahead for any stale link (the write path's preamble
        discipline), post to the synced links, and return the acked
        address set — the caller judges the quorum and advances its
        own local state.  Shared by the three admin record kinds so
        the depose/needs-sync handling cannot drift between them."""
        enc = _Encoded(frame)
        snapshot = None
        for link in self._links:
            inst_t = link.install_ticket
            if inst_t is not None and inst_t.event.is_set():
                r = inst_t.result
                link.install_ticket = None
                if r is not None and r[0] == "installed":
                    link.needs_sync = False
                    link.tried_tree = False
                elif r is not None and r[0] == "nack" \
                        and int(r[2]) > self._ge:
                    self._note_depose(int(r[2]))
            if link.needs_sync and link.connected \
                    and link.install_ticket is None \
                    and link.sync is None:
                if snapshot is None:
                    snapshot = _Encoded(
                        ("install", self._ge, self._grp_seq,
                         dump_state(self), self.core.cfg))
                link.install_ticket = link.post(snapshot)
                # queued ahead of the NEXT stream record; only
                # settles at-or-after it may consume the ticket
                link.install_barrier = self._grp_seq + 1
                self.group_stats["resyncs"] += 1
        sends = [(l, l.post(enc)) for l in self._links
                 if not l.needs_sync]
        acked = set()
        deadline = time.monotonic() + self.ack_timeout
        for link, t in sends:
            r = PeerLink.wait(t, deadline)
            if r is not None and r[0] == "applied" \
                    and int(r[3]) == crc:
                acked.add((link.host, link.port))
            elif r is not None and r[0] == "nack" \
                    and r[1] == "epoch" and int(r[2]) > self._ge:
                self._note_depose(int(r[2]))
                link.needs_sync = True
            else:
                link.needs_sync = True
        self.group_stats["applies"] += 1
        return acked

    def _commit_cfg(self, cver: int, hosts, joint) -> bool:
        """Ship one config record through the apply stream and collect
        its acks synchronously (config changes are rare admin ops).
        The record is adopted locally FIRST — Raft's
        latest-config-in-the-log rule: the leader counts the commit
        under the config being written (for a joint record that is
        maj(old) AND maj(new); for the collapse record maj(new))."""
        self._drain_launches()
        self._drain_pending(block_all=True)
        seq = self._grp_seq + 1
        hosts_t = _norm_addrs(hosts)
        joint_t = _norm_addrs(joint)
        self._grp_seq = seq
        self.core.applied_ge = self._ge
        self.core.applied_seq = seq
        self.core.last_crc = int(cver)
        self.core.set_cfg((int(cver), hosts_t, joint_t))
        save_group_meta(self, self.core.promised, self._ge, seq,
                        self.core.cfg)
        acked = self._replicate_record(
            ("cfg", self._ge, seq, cver, hosts_t, joint_t), int(cver))
        ok = self._quorum_from(acked) and not self._deposed
        if not ok:
            self.group_stats["quorum_failures"] += 1
        self._emit("grp_cfg", {"cver": cver, "committed": ok,
                               "joint": joint_t is not None})
        return ok

    def _advance_cfg(self) -> None:
        """Drive an in-flight membership transition forward (called
        from flush/heartbeat, the leader_tick discipline): re-commit
        the joint record if its quorum was missed, then — once a
        majority of the NEW set is connected and fully synced — ship
        the collapse record, drop links to removed hosts, and adjust
        the quorum size.  A leader transitioning itself out steps
        down after the collapse commits (transition:756-774's
        shutdown-if-not-member)."""
        txn = self._cfg_txn
        if txn is None or not self.is_leader:
            return
        cver, hosts, joint = self.core.cfg
        if joint is None:
            # The collapse record is already adopted locally
            # (_commit_cfg adopts BEFORE counting — its quorum may
            # have been transiently missed, or a resumed transition
            # raced): the finalization must still run, or a leader
            # that transitioned itself out would keep serving and
            # removed links would never prune (review r5).
            self._finish_collapse()
            return
        if not txn["joint_committed"]:
            txn["joint_committed"] = self._commit_cfg(cver, hosts,
                                                      joint)
            if not txn["joint_committed"]:
                return
        # synced-before-counted collapse gate: a majority of the NEW
        # set must hold the full state (connected, not needs_sync)
        synced = {(l.host, l.port) for l in self._links
                  if l.connected and not l.needs_sync}
        if not self._maj(joint, synced):
            return
        if self._commit_cfg(cver + 1, joint, None):
            self._finish_collapse()

    def _finish_collapse(self) -> None:
        """Post-collapse finalization (idempotent): quorum size from
        the committed list, links to removed hosts pruned, and — the
        reference peer's shutdown-if-not-member (transition,
        peer.erl:756-774) — a leader that transitioned itself out
        steps down."""
        new = list(self.core.cfg[1])
        self._cfg_txn = None
        self.group_size = len(new)
        for link in list(self._links):
            if (link.host, link.port) not in new:
                link.close()
                self._links.remove(link)
        self._emit("grp_cfg_collapsed",
                   {"cver": self.core.cfg[0], "hosts": new})
        if self.self_addr is not None \
                and self.self_addr not in new:
            # transitioned out: stop serving (the reference peer
            # shuts down when not a member of the final view)
            self._is_leader = False
            self._deposed = True
            self._emit("grp_step_down", {"reason": "not-member"})

    # -- the replicated launch ----------------------------------------------

    def _launch_enqueue(self, kind, slot, val, k, want_vsn,
                        exp_e=None, exp_s=None, entries=None,
                        elect=None, cand=None, lease_ok=None):
        """Replicated ENQUEUE half: allocate the stream seq, capture
        the exact launch inputs for the ship, and dispatch the local
        launch through the base enqueue half.  The SHIP itself now
        rides the RESOLVE half (the delta transport needs the result
        planes to know what changed); the pipelined commit barrier is
        unchanged — acks are never awaited inline, and a
        ``pipeline_depth`` > 1 still overlaps device rounds with host
        resolve on a replication-group leader."""
        if not self._links and self.group_size == 1:
            return super()._launch_enqueue(kind, slot, val, k, want_vsn,
                                           exp_e, exp_s, entries, elect,
                                           cand, lease_ok)
        if not self.is_leader:
            raise DeposedError(
                "not the group leader (takeover() not run, or this "
                "epoch was superseded)")
        if elect is None:
            elect, cand = self._election_inputs()
        if lease_ok is None:
            lease_ok = self.lease_until > self.runtime.now

        # device-resident planes must be host arrays to ship
        if isinstance(kind, torch.Tensor):
            kind = _host(kind)
            slot = _host(slot)
            val = _host(val)
            exp_e = None if exp_e is None else _host(exp_e)
            exp_s = None if exp_s is None else _host(exp_s)
        seq = self._grp_seq + 1
        meta = _entries_meta(entries, kind, slot, self.values)
        corr0 = self.corruptions
        fl = super()._launch_enqueue(kind, slot, val, k, want_vsn,
                                     exp_e, exp_s, None, elect,
                                     cand, lease_ok)
        # the seq advances at ENQUEUE (later pipelined launches must
        # ship strictly increasing seqs); the core's applied position
        # advances only at resolve, in settle order.  An enqueue
        # failure consumed nothing — the stream has no gap.
        self._grp_seq = seq
        fl.grp_seq = seq
        fl.grp_meta = meta
        fl.grp_corr0 = corr0
        fl.grp_ship = (np.asarray(kind), np.asarray(slot),
                       np.asarray(val),
                       None if exp_e is None else np.asarray(exp_e),
                       None if exp_s is None else np.asarray(exp_s),
                       np.asarray(elect, bool),
                       np.asarray(lease_ok, bool))
        return fl

    def _launch_resolve(self, fl, wait_key="device_d2h"):
        """Replicated RESOLVE half: finish the local launch, build
        this flush's wire entry from the RESULT planes — the common
        changed-slot DELTA (payload proportional to what committed),
        or the full-plane fallback when the launch elected, hit
        corruption (its exchange mutated state beyond the results), or
        the shape is delta-ineligible — and buffer it for the
        coalesced ship.  Acks are NOT awaited here (the pipelined
        commit barrier, VERDICT r4 weak #5): the flush's client
        futures resolve only once its batch's host-quorum outcome is
        known (_settle_batch), while the NEXT flush's build, ship and
        local launch overlap this one's ack wait.  _resolve_flush
        claims this entry and attaches the futures/planes;
        heartbeat()-style direct launches leave taken=None."""
        if getattr(fl, "grp_ship", None) is None:
            # single-lane mode / replica role: the plain resolve
            return super()._launch_resolve(fl, wait_key)
        seq = fl.grp_seq
        try:
            out = super()._launch_resolve(fl, wait_key)
        except BaseException:
            # the local launch rolled back AFTER the stream consumed
            # this seq: nothing was shipped, but later ships arrive
            # with a seq gap — replicas nack and re-sync heals; mark
            # them now so the very next ship queues the install
            for link in self._links:
                link.needs_sync = True
            raise
        committed, _g, _f, value, vsn = out
        t0 = time.perf_counter()
        kind, slot, val, exp_e, exp_s, elect, lease_ok = fl.grp_ship
        meta = fl.grp_meta
        delta_ok = (self._repl_delta and self._delta_shape_ok
                    and self.n_peers == 1
                    and not bool(elect.any())
                    and self.corruptions == fl.grp_corr0)
        if delta_ok:
            comm = None
            if self._comm_repl:
                # §18 commutative fast lane: columns whose committed
                # cells are all mergeable RMWs ship coalesced merge
                # sections; anything else (including the knob-off
                # arm) falls through to the byte-identical plain
                # delta builder
                comm = build_comm_entry(
                    seq, fl.k, committed, value, kind, slot, val,
                    exp_e, fl.quorum_np, meta, n_slots=self.n_slots,
                    fid=fl.flush_id, native=self._native_resolve)
            if comm is not None:
                entry_t, crc, nbytes, n_cells, n_ops = comm
                self.comm_stats["repl_merge_entries"] += 1
                self.comm_stats["repl_merge_cells"] += n_cells
                self.comm_stats["repl_merge_ops"] += n_ops
            else:
                entry_t, crc, nbytes = build_delta_entry(
                    seq, fl.k, committed, value, kind, slot, val,
                    fl.quorum_np, meta, n_slots=self.n_slots,
                    fid=fl.flush_id, native=self._native_resolve)
            self.group_stats["repl_delta_entries"] += 1
        else:
            entry_t, nbytes = build_full_entry(
                seq, fl.k, fl.want_vsn, elect, lease_ok, kind, slot,
                val, exp_e, exp_s, meta, fid=fl.flush_id)
            crc = result_crc(committed, vsn)
            self.group_stats["repl_full_entries"] += 1
        self.group_stats["repl_bytes_sections"] += nbytes
        self.group_stats["repl_bytes_full_equiv"] += \
            full_plane_nbytes(fl.k, self.n_ens, cas=exp_e is not None)
        self.group_stats["repl_build_s"] += time.perf_counter() - t0
        fl.rec["repl_build"] = time.perf_counter() - t0
        self.core.applied_ge = self._ge
        self.core.applied_seq = seq
        self.core.last_crc = crc
        entry = _PendingEntry(seq, crc, entry_t, shipped_at=fl.now,
                              fid=fl.flush_id)
        self._ship_buf.append(entry)
        self._unclaimed = entry
        self.group_stats["applies"] += 1
        # Group meta persists via _wal_extra_records inside the flush's
        # own durability barrier (one sync, and atomically with the kv
        # records — a leader restart must never see data-bearing kv
        # records from a seq its meta doesn't cover, or takeover could
        # adopt an older replica state over its own acked writes).
        # Data-less launches (heartbeats, pure reads) skip it: adopting
        # a state that differs only by empty batches loses nothing.
        return out

    def _ship_now(self) -> None:
        """Coalesce every buffered entry into ONE raw frame and post
        it to every synced link — one encode, one scatter-gather write
        per replica per flush.  A link needing re-sync gets its
        catch-up queued INSTEAD of the batch (the catch-up lands the
        very state the batch produced, so sending both would
        double-apply); the ship never blocks on it — the outcome is
        consumed on a later ship/settle, and at most one install/patch
        is in flight per link (a slow replica must not stall every
        client future for install_timeout, nor accrue redundant
        snapshots — review r4).  Catch-up prefers the tree-diff patch
        (O(diffs)); the full snapshot remains the fallback for heavy
        divergence, non-frozen replicas, and any probe/patch failure.
        Catch-up state is dumped only with the launch pipeline drained
        (an enqueued-unresolved launch's effects are already in the
        device arrays, and a snapshot stamped behind them would make
        the next batch double-apply on the installed replica)."""
        if self._shipping or not self._ship_buf:
            return
        need_catchup = any(
            link.connected and link.install_ticket is None
            and (link.needs_sync or (link.sync is not None
                                     and link.sync.result is not None))
            for link in self._links)
        if need_catchup and self._inflight:
            self._shipping = True
            try:
                self._drain_launches()
            finally:
                self._shipping = False
        entries = self._ship_buf
        self._ship_buf = []
        first_seq = entries[0].seq
        t0 = time.perf_counter()
        if self._follower_reads:
            # §16: piggyback the grant table — each replica reads its
            # own row (the highest of ITS acks counted inside a
            # quorum-confirmed settle).  One shared encoding still
            # serves every link; sorted for deterministic bytes.
            grants = tuple(sorted(
                (h, p, s) for (h, p), s in self._flw_grants.items()))
            enc = _EncodedParts(
                ("abatch", self._ge, [e.entry for e in entries],
                 grants))
        else:
            enc = _EncodedParts(
                ("abatch", self._ge, [e.entry for e in entries]))
        self.group_stats["repl_encode_s"] += time.perf_counter() - t0
        self.group_stats["repl_frames"] += 1
        self.group_stats["repl_bytes_shipped"] += enc.nbytes
        batch = _PendingShip(entries,
                             time.monotonic() + self.ack_timeout)
        snapshot_frame = None
        synced_pos = self.core.applied_seq  # == entries[-1].seq

        def full_install(link) -> None:
            nonlocal snapshot_frame
            if snapshot_frame is None:
                snapshot_frame = _Encoded(
                    ("install", self._ge, synced_pos,
                     dump_state(self), self.core.cfg))
            link.install_ticket = link.post(snapshot_frame)
            link.install_barrier = synced_pos + 1  # next batch counts
            self.group_stats["resyncs"] += 1

        for link in self._links:
            inst_t = link.install_ticket
            if inst_t is not None and inst_t.event.is_set():
                r = inst_t.result
                link.install_ticket = None
                if r is not None and r[0] == "installed":
                    link.needs_sync = False
                    link.tried_tree = False
                elif r is not None and r[0] == "nack" \
                        and int(r[2]) > self._ge:
                    self._note_depose(int(r[2]))
            sync = link.sync
            if sync is not None and sync.result is not None \
                    and link.install_ticket is None \
                    and not self._inflight:
                # (a probe finishing between the drain above and here
                # stays pending one ship: patch/install state must be
                # dumped at the resolved position only)
                link.sync = None
                if sync.result == "patch" and link.connected:
                    patch = self._build_patch(sync)
                    sync.bytes += len(patch.payload)
                    link.install_ticket = link.post(patch)
                    link.install_barrier = synced_pos + 1
                    self.group_stats["tree_resyncs"] += 1
                    self.group_stats["tree_resync_bytes"] += sync.bytes
                elif link.connected:
                    full_install(link)
            elif link.needs_sync and link.connected \
                    and link.install_ticket is None \
                    and link.sync is None \
                    and not self._inflight:
                if self._tree_sync_eligible(link):
                    link.tried_tree = True
                    link.sync = _TreeSync()
                    threading.Thread(target=self._tree_sync_probe,
                                     args=(link, link.sync),
                                     daemon=True).start()
                else:
                    full_install(link)
            # a needs_sync link joins the batch as soon as the batch
            # starts PAST its queued catch-up (install_barrier <=
            # first_seq): the link's FIFO delivers the install/patch
            # first, the replica lands exactly at first_seq - 1, and
            # the batch applies cleanly — its ack becomes countable
            # the moment the settle consumes the install ticket (the
            # ADVICE r5 adjacency, kept under coalescing).  The ship
            # that QUEUED the catch-up must exclude it (that batch's
            # seqs are already inside the snapshot — sending both
            # would read as a diverged retransmit and loop the
            # re-sync); so must ships while a probe is still running
            # (the tree diff needs the replica frozen).
            if not link.needs_sync \
                    or (link.install_ticket is not None
                        and link.install_barrier <= first_seq):
                batch.sends.append(
                    (link, link.post(enc, on_done=batch._notify)))
            elif not link.connected and link.install_ticket is None \
                    and link.sync is None:
                # a dropped link reconnects by CONSUMING a queued
                # frame (the sender thread owns the socket); excluded
                # from the batch, it still needs a nudge or it would
                # never dial back in — the cheap handshake serves
                # (its response is consumed FIFO and ignored)
                link.post(("hello", self._ge))
        self._pending_flushes.append(batch)

    def _settle_execute(self, fl, planes):
        """Bulk execute_async resolves directly to its caller (no
        host-quorum gate, matching the sync ``execute`` contract on a
        replicated leader); the pending entry this launch stashed
        settles with nothing to claim — but it must still settle, or
        a pure execute_async workload would grow _pending_flushes
        unboundedly and defer the ack-side bookkeeping (needs_sync,
        depose detection) indefinitely."""
        self._unclaimed = None
        out = super()._settle_execute(fl, planes)
        self._drain_pending(down_to=self.repl_window)
        return out

    # -- incremental (Merkle) catch-up: leader side -------------------------

    #: skip to the full snapshot when more than this fraction of
    #: ensembles diverged (the patch would approach the snapshot's
    #: size with a chattier protocol)
    TREE_SYNC_MAX_DIFF = 0.5

    def _tree_sync_eligible(self, link: PeerLink) -> bool:
        """Tree-diff catch-up needs a FROZEN replica: one strictly
        behind this leader's applied position, so it nacks the apply
        stream and its state holds still between the probe and the
        patch (the expect guard catches the rest).  One attempt per
        connection; single-peer lanes only."""
        if self.n_peers != 1 or link.tried_tree:
            return False
        _prom, rge, rseq = link.remote_state
        return (rge, rseq) < (self.core.applied_ge,
                              self.core.applied_seq)

    def _tree_sync_probe(self, link: PeerLink,
                         sync: "_TreeSync") -> None:
        """Background diff descent against one frozen replica: roots
        for every ensemble, then leaf planes for the diverged rows
        only (O(width·height·diffs) traffic, synctree.erl:372-417).
        Never blocks the commit path — the flush preamble consumes
        ``sync.result``."""
        dbg = os.environ.get("RETPU_DEBUG_SYNC") == "1"
        try:
            if dbg:
                print(f"[sync] probe start {link.host}:{link.port}",
                      file=sys.stderr, flush=True)
            probe_budget = min(self.install_timeout, 15.0)
            t = link.post(("troots",))
            r = PeerLink.wait(t, time.monotonic() + probe_budget)
            if dbg:
                print(f"[sync] troots -> "
                      f"{None if r is None else r[0]}",
                      file=sys.stderr, flush=True)
            if r is None or r[0] != "troots":
                raise RuntimeError(f"troots: {r!r}")
            sync.expect = (int(r[1]), int(r[2]))
            sync.bytes += len(r[3])
            remote = np.frombuffer(r[3], np.uint32).reshape(
                self.n_ens, -1)
            sync.remote_roots = remote
            local = tree_roots(self)
            diff = np.nonzero((remote != local).any(axis=1))[0]
            if len(diff) > self.n_ens * self.TREE_SYNC_MAX_DIFF:
                sync.result = "full"
                return
            if len(diff):
                t = link.post(("tleaves",
                               [int(e) for e in diff]))
                r = PeerLink.wait(t, time.monotonic() + probe_budget)
                if r is None or r[0] != "tleaves":
                    raise RuntimeError(f"tleaves: {r!r}")
                sync.bytes += len(r[1])
                remote_l = np.frombuffer(r[1], np.uint32).reshape(
                    len(diff), self.n_slots, -1)
                for i, e in enumerate(diff):
                    sync.remote_leaves[int(e)] = remote_l[i]
            sync.result = "patch"
        except Exception:
            sync.result = "full"

    def _build_patch(self, sync: "_TreeSync") -> _Encoded:
        """Build the targeted patch in the flush preamble — atomic
        with the apply stream: it carries state @ self._grp_seq and is
        posted immediately ahead of the seq+1 apply, so a frozen
        replica lands exactly in sync (the same adjacency the full
        install relies on).  The diff re-checks the CURRENT leader
        roots against the replica's cached (frozen) tree, so every
        leader-side mutation since the probe — epoch rewrites on reads
        included — is covered: rows whose cached leaves are stale ship
        whole."""
        roots_now = tree_roots(self)
        diff_rows = np.nonzero(
            (roots_now != sync.remote_roots).any(axis=1))[0]
        pairs: List[Tuple[int, int]] = []
        if len(diff_rows):
            leaves_now = tree_leaves(self, diff_rows)
            for i, e in enumerate(diff_rows):
                cached = sync.remote_leaves.get(int(e))
                if cached is None:
                    slots = range(self.n_slots)
                else:
                    slots = np.nonzero(
                        (leaves_now[i] != cached).any(axis=1))[0]
                pairs += [(int(e), int(s)) for s in slots]
        patches: List[Tuple] = []
        if pairs:
            idx = torch.as_tensor(np.asarray(pairs, np.int64),
                                  device=self.device)
            e_j, s_j = idx[:, 0], idx[:, 1]
            eps = _host(self.state.obj_epoch[e_j, 0, s_j])
            sqs = _host(self.state.obj_seq[e_j, 0, s_j])
            vls = _host(self.state.obj_val[e_j, 0, s_j])
            rev: Dict[int, Dict[int, Any]] = {}
            for (e, s), ep, sq, vl in zip(pairs, eps, sqs, vls):
                r = rev.get(e)
                if r is None:
                    r = rev[e] = {sl: k for k, sl
                                  in self.key_slot[e].items()}
                key = r.get(s)
                handle = self.slot_handle[e].get(s, 0)
                payload = (self.values.get(handle)
                           if handle else None)
                patches.append((e, s, int(ep), int(sq), int(vl),
                                key, int(handle), payload))
        return _Encoded(("tpatch", self._ge, self._grp_seq,
                         sync.expect, dump_meta(self), patches))

    # -- pipelined ack settlement -------------------------------------------

    def _resolve_flush(self, fl, planes, ack: bool = True,
                       ack_reads: bool = True) -> int:
        """Defer resolution until the flush's host-quorum outcome is
        in (an ack may never outrun the host quorum — READS INCLUDED:
        a minority/deposed leader serving reads would break
        linearizability under partition).  The entry the immediately
        preceding ``_launch`` stashed claims the futures/planes; the
        drain settles entries strictly in flush order, blocking only
        when the pipeline is deeper than ``repl_window``."""
        entry = self._unclaimed
        if entry is None:
            # single-lane mode / replica role: the plain barrier
            return super()._resolve_flush(fl, planes, ack=ack,
                                          ack_reads=ack_reads)
        self._unclaimed = None
        entry.fl, entry.planes = fl, planes
        entry.ack, entry.ack_reads = ack, ack_reads
        self._drain_pending(down_to=self.repl_window)
        return 0

    def _outstanding(self) -> int:
        return (sum(len(b.entries) for b in self._pending_flushes)
                + len(self._ship_buf))

    def _drain_pending(self, block_all: bool = False,
                       down_to: Optional[int] = None) -> None:
        """Ship anything buffered, then settle pending batches
        oldest-first.  Non-blocking by default (a batch settles once
        a majority acked, every ticket completed, or its deadline
        passed); ``down_to=N`` blocks only until at most N flush
        entries remain outstanding (the steady-state ship path —
        draining to empty would collapse the very window the pipeline
        provides); ``block_all`` waits every batch out — used before a
        checkpoint/takeover/lifecycle op and by idle flushes so
        flush-until-done callers observe resolved futures."""
        self._reap_stragglers()
        if block_all or down_to is None \
                or self._outstanding() > down_to:
            self._ship_now()
        while self._pending_flushes:
            batch = self._pending_flushes[0]
            done = all(t.event.is_set() for _l, t in batch.sends)
            if not done:
                must_free = (down_to is not None
                             and self._outstanding() > down_to)
                if block_all or must_free:
                    batch.wait_quorum(self._quorum_from)
                elif not self._quorum_from(batch._acked_now()) \
                        and time.monotonic() < batch.deadline:
                    break
            self._pending_flushes.popleft()
            self._settle_batch(batch)

    def _account_ack(self, link: PeerLink, r: Any, crc: int,
                     acked: set) -> None:
        """Bookkeep one link's cumulative-ack outcome."""
        if r is None:
            link.needs_sync = True
        elif r[0] == "applied" and int(r[3]) == crc \
                and not link.needs_sync:
            acked.add((link.host, link.port))
        elif r[0] == "applied":
            # applied but diverged (CRC mismatch): physical
            # corruption or a missed batch — heal via re-sync
            link.needs_sync = True
        elif r[0] == "nack" and r[1] == "epoch":
            # Depose ONLY when the replica promised a genuinely
            # newer epoch.  A LOWER promised (a blank replacement
            # host, or one whose meta was lost) is merely stale —
            # deposing on it would let a dead disk take down a
            # healthy majority leader (review r4).  It re-syncs
            # instead (install raises its promise).
            if int(r[2]) > self._ge:
                self._note_depose(int(r[2]))
            link.needs_sync = True
        else:
            link.needs_sync = True

    def _reap_stragglers(self) -> None:
        """Bookkeep tickets of batches that settled at majority
        before every link answered: a late nack still marks its link
        for re-sync (and a late epoch nack still deposes) — nothing a
        slow socket reports is ever dropped, it just stops holding
        the settled batch's futures hostage."""
        if not self._stragglers:
            return
        still = []
        sink: set = set()
        for link, t, crc in self._stragglers:
            if not t.event.is_set():
                still.append((link, t, crc))
                continue
            self._account_ack(link, t.result, crc, sink)
        self._stragglers = still

    def _settle_batch(self, batch: "_PendingShip") -> None:
        """Count one batch's cumulative acks, decide its host-quorum
        outcome, and resolve every member entry's client futures
        accordingly (the per-flush barrier stands — the batch is the
        unit of ack, the entry stays the unit of resolution)."""
        acked = set()
        for link, apply_t in batch.sends:
            # a catch-up that completed BEFORE this settle makes the
            # link countable for LATER batches — consumable only when
            # it was queued ahead of this batch or earlier
            # (install_barrier <= first_seq): an install posted by a
            # LATER ship must stay pending for the settle that can
            # actually observe its effect (ADVICE r5)
            inst_t = link.install_ticket
            if inst_t is not None and inst_t.event.is_set() \
                    and link.install_barrier <= batch.first_seq:
                ri = inst_t.result
                link.install_ticket = None
                if ri is not None and ri[0] == "installed":
                    link.needs_sync = False
                    link.tried_tree = False
                elif ri is not None and ri[0] == "nack" \
                        and int(ri[2]) > self._ge:
                    self._note_depose(int(ri[2]))
            if not apply_t.event.is_set():
                # quorum settled without this link: its outcome is
                # bookkept when it lands (or its connection drops) —
                # a slow socket must not hold every future to the
                # deadline (max-of-links, not sum-of-slow-prefix)
                self._stragglers.append((link, apply_t, batch.crc))
                continue
            self._account_ack(link, apply_t.result, batch.crc, acked)
        q = self._quorum_from(acked) and not self._deposed
        if self._follower_reads:
            if q:
                # §16 WRITE BARRIER: a write must not ack while a
                # replica that did NOT ack it may still serve reads
                # under an unexpired lease — its mirrors would miss
                # the write and a follower read could return the
                # overwritten value AFTER the client saw the ack.
                # Settles fire at quorum, so a fence holder is often
                # just a straggler whose ack is milliseconds out:
                # WAIT for it (don't fail the batch), bounded by its
                # fence — a holder that cannot confirm (nack, dead
                # socket) stalls this ack at most lease(), the
                # classic price of leased reads.
                addr_t = {(l.host, l.port): t for l, t in batch.sends}
                blocked = False
                while True:
                    now_m = time.monotonic()
                    for a in [a for a, t in self._flw_fence.items()
                              if t <= now_m]:
                        del self._flw_fence[a]
                    missing = [a for a in self._flw_fence
                               if a not in acked]
                    if not missing:
                        break
                    if not blocked:
                        blocked = True
                        self.group_stats[
                            "follower_lease_write_blocks"] += 1
                    a = missing[0]
                    t = addr_t.get(a)
                    budget = max(0.0, self._flw_fence[a] - now_m)
                    if t is not None and not t.event.is_set():
                        if t.event.wait(budget):
                            for l2, t2 in batch.sends:
                                if t2 is t:
                                    self._account_ack(
                                        l2, t2.result, batch.crc,
                                        acked)
                                    break
                        continue
                    # the holder answered without a countable ack (or
                    # never got this batch): its mirrors provably miss
                    # the write — only fence expiry releases the ack
                    time.sleep(budget)
            now_m = time.monotonic()
            if q and now_m <= batch.deadline \
                    and self._cfg_txn is None:
                # grant/renew: each acking replica's lease window
                # anchors at ITS ack-send time, provably before this
                # settle — fence[a] (our clock) always outlasts the
                # replica's own window.  The deadline gate bounds
                # grant issuance to ack_timeout past the ship, which
                # is what lets a takeover wait out
                # ack_timeout + lease() + read_margin.  No grants
                # during a membership transition (handle_cfg drops
                # windows; new ones must wait for the new config).
                g_seq = batch.entries[-1].seq
                lease_s = self.config.lease()
                for a in acked:
                    self._flw_grants[a] = max(
                        self._flw_grants.get(a, 0), g_seq)
                    self._flw_fence[a] = now_m + lease_s
        self._last_quorum_ok = q
        # the HOST lease for leader-local fast reads: only a settle
        # whose host quorum confirmed this epoch renews it, and a
        # lost quorum revokes it BEFORE any of this batch's futures
        # resolve (the mirror updates below run under ack_reads=False
        # then — a minority leader serves nothing).  The grant is
        # based at the batch's newest enqueue time, not settle-
        # processing time (mirroring the device lane's fl.now
        # discipline): the quorum contact the acks prove is no
        # fresher than the ship, and a promoter waiting out lease()
        # counts from the fencing — a settle delayed in the pipeline
        # must not stretch the leased window past what those acks can
        # vouch for.  max() keeps a later-shipped batch's settle from
        # shrinking an earlier grant (settles process in FIFO ship
        # order anyway).
        if q:
            self._host_lease_until = max(
                self._host_lease_until,
                batch.shipped_at + self.config.lease())
            self.group_stats["repl_ack_s"] += \
                time.monotonic() - batch.ship_t
            self.group_stats["repl_acked_batches"] += 1
            for entry in batch.entries:
                # §18: pure-merge entries in a single-run frame are
                # the ones replicas could ack pre-scatter — the
                # quorum-confirmed settle is where that early path
                # becomes client-visible
                if entry.entry[0] == "m" and int(entry.entry[3]) == 0:
                    self.comm_stats["repl_early_acks"] += 1
        else:
            self._host_lease_until = 0.0
            self.group_stats["quorum_failures"] += 1
        if self._obs:
            # leader half of the replication trace: one ack span per
            # member flush (ship → host-quorum decision), joined with
            # the replica apply spans by flush id
            ack_s = time.monotonic() - batch.ship_t
            for entry in batch.entries:
                obs.SPANS.record(entry.fid, "leader",
                                 [("repl_ack", ack_s)],
                                 quorum_ok=q, seq=entry.seq)
        for entry in batch.entries:
            if entry.fl is not None:
                super()._resolve_flush(entry.fl, entry.planes,
                                       ack=entry.ack and q,
                                       ack_reads=entry.ack_reads and q)

    def flush(self) -> int:
        served = super().flush()
        # settle opportunistically under load; fully when idle (no new
        # work to overlap with), so flush-until-done callers and the
        # post-load read-back sweeps observe resolved futures
        self._drain_pending(block_all=not self._active)
        # on a replicated leader, client futures resolve in the
        # settle above (after the host quorum), so a kmodify chain's
        # follow-up CAS lands HERE — give it its launch cycle inside
        # the same flush call (the base flush's chain point saw
        # nothing: resolution was deferred past it)
        served += self._chain_flush()
        if self._cfg_txn is not None:
            self._advance_cfg()
        return served

    def save(self, path: Optional[str] = None) -> None:
        # the snapshot must see fully settled host mirrors (deferred
        # resolutions mutate slot_handle): drain the pipeline first
        if self._links:
            self._in_save = True
            try:
                while self._active:
                    super().flush()
                    self._drain_pending(block_all=True)
                self._drain_launches()
                self._drain_pending(block_all=True)
            finally:
                self._in_save = False
        super().save(path)

    def set_repl_window(self, window: int) -> int:
        """Retune the replication ack window at runtime (the ack-RTT
        actuator's second knob).  Shrinking first settles pending
        ship batches down to the new bound, so the per-flush quorum
        barrier and FIFO settle order are untouched — only how many
        resolved-but-unsettled flushes may coalesce ahead of the head
        batch changes.  Returns the previous window."""
        window = max(1, int(window))
        old = self.repl_window
        if window != old:
            if window < old:
                self._drain_pending(down_to=window)
            self.repl_window = window
            self._emit("svc_autotune",
                       {"knob": "repl_window", "old": old,
                        "new": window})
        return old

    def heartbeat(self) -> bool:
        """Drive replication liveness without client load: an empty
        apply (k=0, no elections) that reconnects and re-syncs lagging
        replicas and re-confirms the host quorum.  Busy leaders get
        this for free from real flushes; idle ones need the beat or a
        restarted replica would stay stale until the next client op.
        Returns the host-quorum outcome (the pipeline fully settled)."""
        # a direct sync launch must not overtake unsettled pipelined
        # launches (settles are strictly FIFO in seq order)
        self._drain_launches()
        z = np.zeros((0, self.n_ens), np.int32)
        elect, cand = self._election_inputs()
        lease_ok = self.lease_until > self.runtime.now
        self._launch(z, z, z, 0, want_vsn=True, exp_e=z, exp_s=z,
                     elect=elect, cand=cand, lease_ok=lease_ok)
        self._unclaimed = None  # nothing to resolve for the beat
        self._drain_pending(block_all=True)
        if self._cfg_txn is not None:
            self._advance_cfg()
        return self._last_quorum_ok

    def _wal_extra_records(self) -> List[Tuple[Any, Any]]:
        return [(_GRP_KEY, (self.core.promised, self._ge,
                            self._grp_seq, self.core.cfg))]

    def _note_depose(self, promised: int) -> None:
        if not self._deposed:
            self.group_stats["depositions"] += 1
            self._emit("grp_deposed", {"superseded_by": promised})
        self._deposed = True
        # a deposed leader invalidates its read lease BEFORE its next
        # ack — no leased read may outlive the observed fencing; the
        # follower-read grant table dies with the reign too (a deposed
        # leader can't settle a quorum, so it could never renew)
        self._host_lease_until = 0.0
        self._flw_grants.clear()
        self._flw_fence.clear()
        self.core.promised = max(self.core.promised, promised)

    def _on_storage_degraded(self) -> None:
        """A leader whose WAL disk died cannot take the durability
        barrier its acks promise — demote it through the existing
        step-down machinery (ARCHITECTURE §15): leadership drops, the
        host lease dies before any further ack, and a peer with a
        working disk can promote itself.  The decision is journaled
        (grp_step_down trace event, group_stats, and the base
        svc_storage_degraded record/health section/gauges)."""
        if self._is_leader:
            if self._storage_degraded is not None:
                self._storage_degraded["mode"] = "step_down"
            self._is_leader = False
            self._deposed = True
            self._host_lease_until = 0.0
            self.group_stats["storage_step_downs"] = \
                self.group_stats.get("storage_step_downs", 0) + 1
            self._emit("grp_step_down", {
                "reason": "wal-storage",
                "errno": (self._storage_degraded or {}).get("errno")})

    # -- replicated dynamic lifecycle ---------------------------------------

    def create_ensemble(self, name, view=None):
        """Dynamic tenant creation with the SAME host-quorum barrier
        as writes: the op rides the group (epoch, seq) stream, every
        lane applies it deterministically (identical directories →
        identical row assignment and failure outcomes), and the row
        is returned only after a host majority acked.  Raises on lost
        quorum — the local create stands (minority residue healed by
        re-sync on heal), but the caller must not act on it."""
        row, _ = self._lifecycle("create", name, view)
        return row

    def destroy_ensemble(self, name):
        _, ok = self._lifecycle("destroy", name, None)
        return ok

    def _lifecycle(self, kind: str, name, view):
        if not self._links and self.group_size == 1:
            if kind == "create":
                return super().create_ensemble(name, view), None
            return None, super().destroy_ensemble(name)
        if not self.is_leader:
            raise DeposedError("not the group leader")
        # lifecycle is synchronous: settle BOTH pipelines (device
        # launches, then replication acks) so the sync flags it reads
        # (and the acks it counts) are current
        self._drain_launches()
        self._drain_pending(block_all=True)
        seq = self._grp_seq + 1
        view_b = None if view is None else _pack_bool(
            np.asarray(view, bool))
        if kind == "create":
            row = super().create_ensemble(name, view)
            ok = None
            crc = row if row is not None else -1
        else:
            row = None
            ok = super().destroy_ensemble(name)
            crc = 1 if ok else 0
        self._grp_seq = seq
        self.core.applied_ge = self._ge
        self.core.applied_seq = seq
        self.core.last_crc = crc
        if self._wal is not None:
            save_group_meta(self, self.core.promised, self._ge, seq,
                            self.core.cfg)
        acked = self._replicate_record(
            ("lcl", self._ge, seq, kind, name, view_b), crc)
        if not self._quorum_from(acked) or self._deposed:
            self.group_stats["quorum_failures"] += 1
            raise RuntimeError(
                f"lifecycle {kind} {name!r}: no host quorum "
                f"({1 + len(acked)}/{self.group_size})")
        return row, ok

    def install_objs(self, ens, items):
        """Version-preserving install with the host-quorum barrier:
        the leader allocates (slots/handles) and decides leadership,
        ships the EXACT allocation through the (epoch, seq) stream
        (handle_inst applies it verbatim — independent allocation
        could diverge free-list orders across lanes), and raises on
        lost quorum like the lifecycle ops."""
        if not self._links and self.group_size == 1:
            return super().install_objs(ens, items)
        if not self.is_leader:
            raise DeposedError("not the group leader")
        self._drain_launches()
        self._drain_pending(block_all=True)
        results, applied = self._allocate_install(int(ens), items)
        if not applied:
            return results
        lead = self._install_lead(int(ens))
        crc = record_digest((a[1], a[2], a[3], a[4]) for a in applied)
        seq = self._grp_seq + 1
        self._grp_seq = seq
        self.core.applied_ge = self._ge
        self.core.applied_seq = seq
        self.core.last_crc = crc
        self._apply_installed(
            int(ens), applied, lead,
            extra_records=[(_GRP_KEY, (self.core.promised, self._ge,
                                       seq, self.core.cfg))])
        acked = self._replicate_record(
            ("inst", self._ge, seq, int(ens), lead,
             [list(a) for a in applied]), crc)
        if not self._quorum_from(acked) or self._deposed:
            self.group_stats["quorum_failures"] += 1
            raise RuntimeError(
                f"install_objs ens {ens}: no host quorum "
                f"({1 + len(acked)}/{self.group_size})")
        return results

    def stats(self) -> Dict[str, Any]:
        s = super().stats()
        s["group"] = {
            "leader": self.is_leader,
            "epoch": self._ge,
            "seq": self._grp_seq,
            "size": self.group_size,
            "peers_connected": sum(l.connected for l in self._links),
            "peers_synced": sum(not l.needs_sync for l in self._links),
            # per-link liveness/failure rows (drop counters + any
            # injected-fault view) — the flapping-link evidence the
            # rate-limited stderr line summarizes
            "links": [l.link_stats() for l in self._links],
            "link_drops": sum(l.drops for l in self._links),
            "link_injected_drops": sum(l.injected_drops
                                       for l in self._links),
            "repl_window": self.repl_window,
            "pipeline_pending": self._outstanding(),
            "repl_delta": self._repl_delta and self._delta_shape_ok,
            "comm_repl": bool(self._comm_repl),
            "trust_host_lease": self.trust_host_lease,
            "host_lease_valid": bool(
                self._host_lease_until
                > self.runtime.now + self._read_margin),
            **self.group_stats,
            **self.comm_stats,
            "repl_merge_coalesce_ratio": round(
                self.comm_stats["repl_merge_ops"]
                / max(self.comm_stats["repl_merge_cells"], 1), 6),
            # this host's replica-role apply work, and its process's
            # kernel launches (each wrapper's own count): how a replica
            # process shows that its full-plane entries ran F1
            "replica_apply_batches": self.core.apply_batches,
            "replica_apply_s": self.core.apply_s,
            "kernel_launches": _kernel_launches(),
        }
        return s

    def health(self, ens: Optional[int] = None) -> Dict[str, Any]:
        """The ensemble-health verb on a replicated leader carries a
        ``group`` section too (the host-quorum plane a dashboard
        needs next to the device-plane rows): role, group epoch/seq,
        link liveness/sync, pipeline depth outstanding, host-lease
        validity and the quorum-failure/deposition history — all
        host-side bookkeeping, zero device rounds (per-row queries
        pass through unchanged)."""
        out = super().health(ens)
        if ens is not None:
            return out
        out["group"] = {
            "leader": bool(self.is_leader),
            "epoch": int(self._ge),
            "seq": int(self._grp_seq),
            "size": int(self.group_size),
            "peers_connected": sum(l.connected for l in self._links),
            "peers_synced": sum(not l.needs_sync
                                for l in self._links),
            # per-link rows: connection drops + the injected-fault
            # section (satellite: an operator reading health must be
            # able to tell a running nemesis from a real outage)
            "links": [l.link_stats() for l in self._links],
            "pipeline_pending": int(self._outstanding()),
            "host_lease_valid": bool(
                self._host_lease_until
                > self.runtime.now + self._read_margin),
            "quorum_failures": int(
                self.group_stats.get("quorum_failures", 0)),
            "depositions": int(
                self.group_stats.get("depositions", 0)),
        }
        # the fleet watchdog's section (§11): always present on a
        # grouped service — `enabled: false` when disarmed — so a
        # dashboard's queries keep their shape, the controller-
        # section discipline
        out["watchdog"] = self.watchdog.health_section()
        return out

    def stop(self) -> None:
        self._drain_launches()
        self._drain_pending(block_all=True)
        super().stop()
        for link in self._links:
            link.close()




def _kernel_launches() -> Dict[str, int]:
    """This process's kernel launch counts (F1 and its sliced and wide
    modes, K1, K2), read from the wrappers' own counters."""
    from riak_ensemble_tpu_torch.ops import cuda_engine, cuda_quorum
    return {"F1": int(cuda_engine.engine_step_launches),
            "F1 sliced": int(cuda_engine.engine_step_sliced_launches),
            "F1 wide": int(cuda_engine.engine_step_wide_launches),
            "K1": int(cuda_quorum.quorum_launches),
            "K2": int(cuda_quorum.quorum_s_launches)}


# -- the replica host process ------------------------------------------------

class ReplicaServer:
    """One replica host: a threaded TCP server speaking the group
    protocol (promise/apply/install/pull) plus control commands
    (promote/status), and a client port that answers the svcnode frame
    protocol — ops are rejected with ("error", "not-leader") until
    this host is promoted, after which it serves exactly like a
    leader-born node (the in-place promotion path: its own lane
    already holds the replicated state, so promotion is a promise
    round plus adopting the newest grant, never a cold transfer)."""

    def __init__(self, n_ens: int, group_size: int, n_slots: int,
                 repl_port: int = 0, client_port: int = 0,
                 host: str = "127.0.0.1",
                 data_dir: Optional[str] = None,
                 config: Optional[Config] = None,
                 tick: float = 0.005,
                 ack_timeout: float = 2.0,
                 peers: Sequence[Tuple[str, int]] = (),
                 auto_failover: Optional[float] = None,
                 dynamic: bool = False,
                 advertise: Optional[Tuple[str, int]] = None,
                 trust_host_lease: bool = False,
                 follower_reads: Optional[bool] = None,
                 device: Any = None,
                 comm_repl: Optional[bool] = None) -> None:
        runtime = WallRuntime()
        # the commutative lane: the reference's RETPU_COMM_REPL knob
        # (read here, as each reference replica process reads it)
        if comm_repl is None:
            comm_repl = os.environ.get("RETPU_COMM_REPL", "1") != "0"
        if data_dir is not None and (
                os.path.exists(os.path.join(data_dir, "META"))
                or os.path.exists(os.path.join(data_dir, "CURRENT"))):
            dyn_kw = {"dynamic": True} if dynamic else {}
            self.svc = ReplicatedService.restore(
                runtime, data_dir, group_size=group_size,
                data_dir=data_dir, config=config,
                ack_timeout=ack_timeout,
                trust_host_lease=trust_host_lease,
                follower_reads=follower_reads, device=device,
                comm_repl=comm_repl, **dyn_kw)
        else:
            self.svc = ReplicatedService(
                runtime, n_ens, 1, n_slots, group_size=group_size,
                data_dir=data_dir, config=config,
                ack_timeout=ack_timeout, dynamic=dynamic,
                trust_host_lease=trust_host_lease,
                follower_reads=follower_reads, device=device,
                comm_repl=comm_repl)
        self.core = self.svc.core
        if self.svc.device.type == "cuda":
            # the libraries built and F1 first-launched before the first
            # frame (a CPU lane has nothing to build)
            self.svc.warmup()
            warm_delta_apply(self.svc)
        self.tick = tick
        self._lock = threading.RLock()
        self._stop = False
        self._flush_thread: Optional[threading.Thread] = None
        self._repl_srv = _ThreadedAcceptor(
            host, repl_port, self._serve_repl_conn)
        self._client_srv = _ThreadedAcceptor(
            host, client_port, self._serve_client_conn)
        self.repl_port = self._repl_srv.port
        self.client_port = self._client_srv.port
        #: this host's identity in group configs = the address peers
        #: DIAL it by.  Defaults to (bind host, bound repl port) —
        #: correct when every host binds the address others use; a
        #: wildcard/NAT'd bind must pass ``advertise`` (CLI:
        #: --advertise HOST:PORT) or membership comparisons would
        #: treat this node as a non-member of its own group
        self.svc.self_addr = (
            (str(advertise[0]), int(advertise[1]))
            if advertise is not None
            else (str(host), int(self.repl_port)))
        #: member flag: a host a collapse removed must not campaign
        #: (the Raft removed-server disruption rule); manual promote
        #: still works
        self._member = True
        self.core.on_cfg = self._apply_cfg
        if self.core.cfg[1] is not None:
            self._apply_cfg(self.core.cfg)
        #: automatic leader failover (the reference's peers self-elect
        #: on follower timeout, peer.erl's following -> probe ->
        #: election; here the follower signal is leader silence on the
        #: replication port): when ``auto_failover`` seconds pass with
        #: no leader-originated frame AND this host ranks first by
        #: (applied_ge, applied_seq, address) among reachable peers,
        #: it promotes itself — promise-round fencing makes duels
        #: safe, ranking merely avoids most of them.
        self.peer_addrs = [(str(h), int(p)) for h, p in peers]
        self.auto_failover = auto_failover
        self._host = host
        self._last_leader_contact = time.monotonic()
        #: stable random identity for election tie-breaks: the BIND
        #: host can differ from the address peers dial (wildcards,
        #: NAT), so ranking by exchanged ids — not addresses — is the
        #: only comparison both sides compute identically
        import random as _random
        self.node_id = _random.getrandbits(63)
        #: campaign flag: a takeover in progress must not hold the big
        #: lock across its network rounds (two campaigners would
        #: deadlock each other's promise handlers); applies are
        #: busy-nacked instead
        self._campaign = False
        if auto_failover is not None:
            assert self.peer_addrs, \
                "auto failover needs the peer address list"
            threading.Thread(target=self._failover_monitor,
                             daemon=True).start()

    # restore() classmethod inherits BatchedEnsembleService.restore,
    # which forwards **kw to the constructor — group_size rides along.

    @property
    def role(self) -> str:
        return "leader" if self.svc.is_leader else "replica"

    # -- replication port ---------------------------------------------------

    def _serve_repl_conn(self, sock: socket.socket) -> None:
        while not self._stop:
            try:
                frame = recv_frame(sock)
            except (ConnectionError, OSError, wire.WireError):
                return
            #: §18 early-ack outcome for THIS frame (reset every
            #: iteration: a stale entry must never suppress a reply)
            fired: List[bool] = []
            try:
                if frame and frame[0] == "promote":
                    # promotion runs OUTSIDE the big lock: a campaign
                    # holding it across network rounds would block
                    # this node's promise/status handlers — two
                    # campaigning nodes would deadlock each other's
                    # promise grants.  Concurrent applies are fenced
                    # by the campaign flag (busy-nacks) instead.
                    peers = [(str(h), int(p)) for h, p in frame[1]]
                    resp = self._promote(peers)
                elif frame and frame[0] == "obsq":
                    # fleet sideband: answered OUTSIDE the big lock —
                    # the payloads read thread-safe stores (the span
                    # store has its own lock) or monitoring-grade
                    # snapshots, and an obs pull must never queue
                    # behind a slow apply holding the lock (the
                    # response's monotonic stamp feeds the leader's
                    # clock-offset estimate; lock dwell would inflate
                    # the round-trip bound for nothing)
                    resp = self._handle_obsq(frame)
                else:
                    # §18 early ack: arm the core's pre-scatter send
                    # hook for abatch frames (under the big lock, so
                    # at most one frame's hook is live); ``fired``
                    # records the outcome so the reply path below
                    # never double-sends the ack
                    arm = (frame and frame[0] == "abatch"
                           and self.svc._comm_repl
                           and not self._campaign)

                    def _early(resp_t, _s=sock, _f=fired):
                        try:
                            send_frame(_s, resp_t)
                            _f.append(True)
                        except (ConnectionError, OSError):
                            _f.append(False)

                    with self._lock:
                        if arm:
                            self.core.early_ack = _early
                        try:
                            resp = self._handle_repl(frame)
                        finally:
                            self.core.early_ack = None
            except Exception:
                import traceback
                self.svc._emit("grp_replica_error",
                               {"error": traceback.format_exc(limit=8)})
                resp = ("error", "internal")
            if fired:
                if not fired[0]:
                    return  # the early send hit a dead socket
                continue  # ack already on the wire
            try:
                send_frame(sock, resp)
            except (ConnectionError, OSError):
                return

    def _handle_repl(self, frame: Tuple) -> Tuple:
        op = frame[0]
        if op in ("hello", "apply", "abatch", "install", "lcl", "cfg",
                  "tpatch", "inst"):
            # leader-originated traffic: the failover monitor's
            # liveness signal
            self._last_leader_contact = time.monotonic()
        if op == "hello":
            ge = int(frame[1])
            # a newer leader's handshake supersedes this host's own
            # leadership (the fencing a deposed leader observes)
            if ge > self.core.promised:
                self._step_down()
            return ("helloed", self.core.promised, self.core.applied_ge,
                    self.core.applied_seq)
        if op == "promise":
            ge = int(frame[1])
            if ge > self.core.promised:
                self._step_down()
                # granting a vote resets the election timer (the raft
                # discipline): the rival we just granted is about to
                # become leader — don't campaign over it
                self._last_leader_contact = time.monotonic()
            return self.core.handle_promise(ge)
        if op in ("apply", "abatch"):
            if self._campaign:
                # a campaign is installing/pulling state concurrently;
                # the leader treats this like any missed ack (re-sync)
                return ("nack", "busy", self.core.promised,
                        self.core.applied_ge, self.core.applied_seq)
            if self.svc.is_leader:
                # a live apply stream at a newer epoch deposes us;
                # at an older epoch it is nacked by the core
                if int(frame[1]) > self.core.promised:
                    self._step_down()
            if op == "abatch":
                return self.core.handle_abatch(frame)
            return self.core.handle_apply(frame)
        if op == "lcl":
            if self._campaign:
                return ("nack", "busy", self.core.promised,
                        self.core.applied_ge, self.core.applied_seq)
            if self.svc.is_leader and \
                    int(frame[1]) > self.core.promised:
                self._step_down()
            return self.core.handle_lcl(frame)
        if op == "cfg":
            if self._campaign:
                return ("nack", "busy", self.core.promised,
                        self.core.applied_ge, self.core.applied_seq)
            if self.svc.is_leader and \
                    int(frame[1]) > self.core.promised:
                self._step_down()
            return self.core.handle_cfg(frame)
        if op == "inst":
            if self._campaign:
                return ("nack", "busy", self.core.promised,
                        self.core.applied_ge, self.core.applied_seq)
            if self.svc.is_leader and \
                    int(frame[1]) > self.core.promised:
                self._step_down()
            return self.core.handle_inst(frame)
        if op == "install":
            if self._campaign:
                return ("nack", "busy", self.core.promised,
                        self.core.applied_ge, self.core.applied_seq)
            if int(frame[1]) >= self.core.promised:
                self._step_down()
            return self.core.handle_install(frame)
        if op == "pull":
            return self.core.handle_pull()
        if op == "troots":
            return self.core.handle_troots()
        if op == "tleaves":
            return self.core.handle_tleaves(frame)
        if op == "tpatch":
            if self._campaign:
                return ("nack", "busy", self.core.promised,
                        self.core.applied_ge, self.core.applied_seq)
            if int(frame[1]) >= self.core.promised:
                self._step_down()
            return self.core.handle_tpatch(frame)
        if op == "status":
            return ("status", self.role, self.core.promised,
                    self.core.applied_ge, self.core.applied_seq,
                    self.node_id)
        if op == "links":
            return ("links", [
                (l.host, l.port, bool(l.connected),
                 bool(l.needs_sync), bool(l.tried_tree),
                 None if l.sync is None else (l.sync.result or "…"),
                 l.install_ticket is not None,
                 list(l.remote_state))
                for l in self.svc._links])
        return ("error", "unknown-op")

    def _handle_obsq(self, frame: Tuple) -> Tuple:
        """The fleet sideband (docs/ARCHITECTURE.md §11): one
        ``("obsq", kind, ...)`` request per pull, answered
        ``("obsr", t_mono, payload)`` — the monotonic stamp is this
        HOST's clock while handling, the middle leg of the leader's
        NTP-midpoint offset estimate.  Every payload is
        read-only/monitoring-grade: registry snapshot or Prometheus
        text, the health section, or span-store records by flush id
        (structured misses included — "hasn't arrived yet" vs
        "rolled off"; a replica's per-fid evidence lives in its span
        store, since delta applies never ride its own launch path or
        flight ring)."""
        kind = frame[1]
        svc = self.svc
        try:
            if kind == "metrics":
                payload: Any = svc.obs_registry.snapshot()
            elif kind == "prometheus":
                payload = svc.obs_registry.render_prometheus()
            elif kind == "health":
                payload = svc.health()
            elif kind == "timeline":
                fids = [int(f) for f in frame[2]]
                payload = {f: obs.SPANS.timeline(f) for f in fids}
            else:
                return ("error", "unknown-op")
        except Exception:
            return ("error", "internal")
        return ("obsr", time.monotonic(), payload)

    def _apply_cfg(self, cfg) -> None:
        """Mirror a committed group config into this server's
        failover machinery: the peer address list tracks the member
        set (hosts + any joint incoming), the quorum size tracks the
        committed list, and a host the config no longer includes stops
        campaigning (a removed server disrupting elections is the
        classic reconfiguration hazard)."""
        _cver, hosts, joint = cfg
        if hosts is None:
            return
        members = list(hosts) + [a for a in (joint or ())
                                 if a not in hosts]
        me = self.svc.self_addr
        self.peer_addrs = [(str(h), int(p)) for h, p in members
                           if (str(h), int(p)) != me]
        self.svc.group_size = len(hosts)
        self._member = me in members
        if not self._member:
            self.svc._emit("grp_removed_from_group",
                           {"cver": _cver})

    def _step_down(self) -> None:
        if self.svc._is_leader:
            self.svc._is_leader = False
            self.svc._deposed = True
            # any replica-role read window predating our reign is
            # meaningless now (and a fresh one needs fresh grants)
            self.core._flw_drop()
            self.svc._emit("grp_step_down", {})

    def _promote(self, peers: List[Tuple[str, int]]) -> Tuple:
        if self._campaign:
            return ("error", "busy")
        self._campaign = True
        try:
            if not self.svc._links:
                self.svc.attach_peers(peers)
            rebuild_derived(self.svc)
            ok = self.svc.takeover()
        finally:
            self._campaign = False
        if not ok:
            return ("error", "no-majority")
        # Post-takeover heal: drive heartbeats until the reachable
        # replicas re-sync (bounded) — a fresh leader whose peers need
        # catch-up would otherwise fail its first client flushes on a
        # host quorum its installs are about to restore.  Bounded and
        # best-effort: a majority that never syncs surfaces as failed
        # client ops, exactly as before.
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            try:
                with self._lock:
                    self.svc.heartbeat()
                    g_synced = sum(not l.needs_sync
                                   for l in self.svc._links
                                   if l.connected)
                    need = self.svc.group_size // 2
                    if g_synced >= min(
                            need,
                            sum(l.connected
                                for l in self.svc._links)):
                        break
            except DeposedError:
                break
            time.sleep(0.1)
        if self._flush_thread is None:
            self._flush_thread = threading.Thread(
                target=self._flush_loop, daemon=True)
            self._flush_thread.start()
        return ("ok", self.svc._ge)

    # -- automatic leader failover ------------------------------------------

    def _failover_monitor(self) -> None:
        import random

        poll = max(0.2, self.auto_failover / 4.0)
        while not self._stop:
            time.sleep(poll)
            try:
                self._failover_check(poll, random)
            except Exception:
                # the monitor must outlive any single bad pass — a
                # dead monitor thread silently disables failover for
                # this node forever (review r4)
                import traceback
                self.svc._emit("grp_failover_error",
                               {"error": traceback.format_exc(
                                   limit=8)})
                self._last_leader_contact = time.monotonic()

    def _failover_check(self, poll: float, random) -> None:
        if self.svc.is_leader or not getattr(self, "_member", True):
            return
        if time.monotonic() - self._last_leader_contact \
                < self.auto_failover:
            return
        if not self._ranks_first():
            # a better-positioned candidate exists; give it a
            # cycle (its promotion will contact us)
            self._last_leader_contact = time.monotonic() \
                - self.auto_failover * 0.5
            return
        time.sleep(random.uniform(0.0, poll))  # duel jitter
        # re-check AFTER the jitter: a rival may have won meanwhile
        # (its promise/hello updated our contact clock) — usurping it
        # at a higher epoch would ping-pong leadership (review r4)
        if self.svc.is_leader or self._stop or \
                time.monotonic() - self._last_leader_contact \
                < self.auto_failover:
            return
        self.svc._emit("grp_auto_failover_attempt",
                       {"ge": self.core.promised})
        r = self._promote(self.peer_addrs)
        if r[0] != "ok":
            # no majority reachable (we may be the minority side
            # of a partition): back off a full window
            self._last_leader_contact = time.monotonic()

    def _ranks_first(self) -> bool:
        """True when this host holds the newest (applied_ge,
        applied_seq) among REACHABLE peers — ties broken by the
        EXCHANGED node ids (bind addresses aren't comparable: the
        name peers dial can differ from --host) — so at most one
        candidate per connected component normally attempts the
        promise round."""
        me = (self.core.applied_ge, self.core.applied_seq,
              self.node_id)
        for host, port in self.peer_addrs:
            try:
                with socket.create_connection((host, port),
                                              timeout=2.0) as s:
                    s.settimeout(5.0)
                    send_frame(s, ("status",))
                    r = recv_frame(s)
            except (OSError, ConnectionError, wire.WireError):
                continue
            if r[0] != "status":
                continue
            if r[1] == "leader":
                # a live leader exists; we were just out of touch
                self._last_leader_contact = time.monotonic()
                return False
            other = (int(r[3]), int(r[4]),
                     int(r[5]) if len(r) > 5 else 0)
            if other > me:
                return False
        return True

    HEARTBEAT_EVERY = 1.0

    def _flush_loop(self) -> None:
        last_beat = time.monotonic()
        while not self._stop:
            time.sleep(self.tick)
            if not self.svc.is_leader:
                continue
            try:
                with self._lock:
                    if self.svc._active or self.svc._pending_flushes \
                            or self.svc._ship_buf \
                            or self.svc._election_inputs()[0].any():
                        self.svc.flush()
                        last_beat = time.monotonic()
                    elif time.monotonic() - last_beat \
                            > self.HEARTBEAT_EVERY:
                        # idle: keep replica liveness/re-sync moving
                        self.svc.heartbeat()
                        last_beat = time.monotonic()
            except DeposedError:
                continue
            except Exception:
                import traceback
                self.svc._emit("grp_flush_error",
                               {"error": traceback.format_exc(limit=8)})

    # -- client port (svcnode frame protocol) -------------------------------

    def _serve_client_conn(self, sock: socket.socket) -> None:
        wlock = threading.Lock()

        def send(req_id, result) -> None:
            try:
                payload = wire.encode((req_id, result))
            except wire.WireError:
                payload = wire.encode((req_id, "failed"))
            with wlock:
                try:
                    sock.sendall(_HDR.pack(len(payload)) + payload)
                except (ConnectionError, OSError):
                    pass

        while not self._stop:
            try:
                msg = recv_frame(sock)
                req_id, op = msg[0], msg[1]
                args = tuple(msg[2:])
            except (ConnectionError, OSError, wire.WireError,
                    IndexError, TypeError):
                return
            if op == "stats":
                with self._lock:
                    send(req_id, self.svc.stats())
                continue
            if not self.svc.is_leader:
                if op in ("kget", "kget_vsn", "kget_many",
                          "kget_slab"):
                    # §16 follower-served leased reads: answer from
                    # this replica's delta-maintained mirrors when an
                    # unexpired leader-granted lease covers the
                    # ensemble; any miss falls back to not-leader
                    # (the client re-routes to the leader, exactly
                    # the pre-lease behavior)
                    try:
                        with self._lock:
                            r = self._follower_read(op, args)
                    except Exception:
                        r = None
                    if r is not None:
                        send(req_id, r)
                        continue
                send(req_id, ("error", "not-leader"))
                continue
            if op == "update_group_members":
                try:
                    with self._lock:
                        self.svc.update_members(
                            [(str(h), int(pt)) for h, pt in args[0]])
                        resp = ("ok", self.svc.membership_status())
                except DeposedError:
                    resp = ("error", "not-leader")
                except Exception as exc:
                    resp = ("error", f"failed: {exc}")
                send(req_id, resp)
                continue
            if op == "membership":
                with self._lock:
                    send(req_id, ("ok",
                                  self.svc.membership_status()))
                continue
            if op == "fleet":
                # fleet verbs (leader-routed like ops: only the
                # leader holds links to pull) — svcnode's frame
                # grammar, so GroupClient/ServiceClient speak it
                # against a promoted replica too.  NO big lock: the
                # pull blocks on replica round-trips, and holding the
                # lock would stall the flush loop behind it.
                try:
                    sub = args[0] if args else "health"
                    if sub == "metrics":
                        fmt = args[1] if len(args) > 1 else None
                        resp = self.svc.fleet_metrics(
                            "prometheus" if fmt == "prometheus"
                            else None)
                    elif sub == "health":
                        resp = self.svc.fleet_health()
                    elif sub == "timeline":
                        resp = self.svc.fleet_timeline(int(args[1]))
                    else:
                        resp = ("error", "bad-request")
                except Exception:
                    resp = ("error", "failed")
                send(req_id, resp)
                continue
            if op in ("create_ensemble", "destroy_ensemble",
                      "resolve_ensemble"):
                # synchronous replicated lifecycle (quorum-barriered)
                try:
                    with self._lock:
                        if op == "create_ensemble":
                            view = args[1] if len(args) > 1 else None
                            if args[0] in self.svc._ens_names:
                                # duplicate != capacity: an
                                # orchestrator reacting to
                                # "no-capacity" must not act on a
                                # false premise (review r4)
                                resp = ("error", "exists")
                            else:
                                row = self.svc.create_ensemble(
                                    args[0], view)
                                resp = (("ok", row)
                                        if row is not None
                                        else ("error", "no-capacity"))
                        elif op == "destroy_ensemble":
                            resp = (("ok",)
                                    if self.svc.destroy_ensemble(
                                        args[0])
                                    else ("error", "unknown"))
                        else:
                            row = self.svc.resolve_ensemble(args[0])
                            resp = (("ok", row) if row is not None
                                    else ("error", "unknown"))
                except DeposedError:
                    # deposed between the role check and the lock: the
                    # op was never dispatched — clients re-route
                    resp = ("error", "not-leader")
                except Exception:
                    resp = ("error", "failed")
                send(req_id, resp)
                continue
            try:
                with self._lock:
                    fut = self._dispatch(op, args)
            except Exception:
                send(req_id, ("error", "bad-request"))
                continue
            if fut is None:
                send(req_id, ("error", "unknown-op"))
                continue
            fut.add_waiter(
                lambda result, rid=req_id: send(rid, result))

    def _follower_read(self, op: str, args: tuple):
        """Serve one read verb off this REPLICA's host mirrors under
        the leader-granted lease (docs/ARCHITECTURE.md §16), or None
        when anything disqualifies it: lease lapsed/margin-expired,
        the ensemble carries applied-but-unconfirmed writes, or any
        requested key's mirror state is incomplete.  All-or-nothing
        per request — a partially-mirror-served batch would interleave
        two consistency regimes inside one reply."""
        svc = self.svc
        if not args:
            return None
        ens = args[0]
        if type(ens) is not int or not 0 <= ens < svc.n_ens:
            return None
        if not self.core._flw_serve_ok(ens):
            svc.group_stats["follower_reads_blocked"] += 1
            return None
        want_vsn = op == "kget_vsn"
        if op in ("kget", "kget_vsn"):
            keys = [args[1]]
        elif op == "kget_many":
            keys = list(args[1])
            want_vsn = bool(args[2]) if len(args) > 2 else False
        else:  # kget_slab
            from riak_ensemble_tpu_torch.svcnode import _slab_keys
            keys = _slab_keys(args[1], args[2])
            want_vsn = bool(args[3]) if len(args) > 3 else False
        nf = (("ok", NOTFOUND, (0, 0)) if want_vsn
              else ("ok", NOTFOUND))
        ks = svc.key_slot[ens]
        out = []
        for key in keys:
            slot = ks.get(key)
            if slot is None:
                out.append(nf)
                continue
            reason, r = svc._fast_read_result(ens, slot, want_vsn)
            if reason is not None:
                svc.group_stats["follower_reads_blocked"] += 1
                return None
            out.append(r)
        svc.group_stats["follower_reads_served"] += len(out)
        return out if op in ("kget_many", "kget_slab") else out[0]

    def _dispatch(self, op: str, args: tuple):
        svc = self.svc
        if args:
            ens = args[0]
            if type(ens) is not int or not 0 <= ens < svc.n_ens:
                raise ValueError(f"bad ensemble index {ens!r}")
        if op in ("kput_slab", "kget_slab"):
            # the proxy tier forwards whole op slabs here once this
            # host is promoted: same arena decode as svcnode's front
            # door (lazy import dodges the module cycle)
            from riak_ensemble_tpu_torch.svcnode import (_slab_keys,
                                                         _slab_vals)
            if op == "kput_slab":
                return svc.kput_many(ens, _slab_keys(args[1], args[2]),
                                     _slab_vals(args[3], args[4]))
            return svc.kget_many(
                ens, _slab_keys(args[1], args[2]),
                want_vsn=bool(args[3]) if len(args) > 3 else False)
        fns = {"kput": svc.kput, "kget": svc.kget,
               "kget_vsn": svc.kget_vsn, "kupdate": svc.kupdate,
               "kput_once": svc.kput_once, "kmodify": svc.kmodify,
               "kdelete": svc.kdelete,
               "ksafe_delete": svc.ksafe_delete,
               "kput_many": svc.kput_many, "kget_many": svc.kget_many,
               "kupdate_many": svc.kupdate_many,
               "kdelete_many": svc.kdelete_many}
        fn = fns.get(op)
        return None if fn is None else fn(*args)

    def stop(self) -> None:
        self._stop = True
        self._repl_srv.close()
        self._client_srv.close()
        self.svc.stop()


class _ThreadedAcceptor:
    """Minimal threaded TCP acceptor: one handler thread per
    connection (the group has a handful of peers, not thousands)."""

    def __init__(self, host: str, port: int, handler) -> None:
        self._handler = handler
        self._sock = socket.create_server((host, port))
        self.port = self._sock.getsockname()[1]
        self._closed = False
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            # daemon handler threads need no tracking: they die with
            # their connection (and the process)
            threading.Thread(target=self._run_conn, args=(conn,),
                             daemon=True).start()

    def _run_conn(self, conn: socket.socket) -> None:
        try:
            self._handler(conn)
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass


class GroupClient:
    """Leader-discovering client for a replication group: give it the
    hosts' CLIENT ports and it finds (and sticks to) the leader,
    re-discovering on connection loss or ``("error", "not-leader")``
    rejections — the role the reference's leader-routing client plays
    (riak_ensemble_client via the router's leader cache).

    Retry discipline mirrors the wire client's ambiguity rules:
    a **not-leader rejection is safely retried** (the op was never
    dispatched into a flush), while a ``DISCONNECTED`` mid-op result
    stays ambiguous and surfaces to the caller — auto-retrying a
    write whose first attempt may have committed would double-apply.
    """

    #: per-host TCP connect budget during discovery: a blackholed
    #: machine (the very failure this client routes around) must cost
    #: seconds, not the OS SYN-retry timeout
    CONNECT_TIMEOUT = 5.0

    def __init__(self, hosts, op_timeout: float = 30.0,
                 discover_timeout: float = 60.0) -> None:
        import asyncio

        from riak_ensemble_tpu_torch import svcnode

        self._svcnode = svcnode
        self.hosts = [(str(h), int(p)) for h, p in hosts]
        self.op_timeout = op_timeout
        self.discover_timeout = discover_timeout
        self._client = None
        self._leader_addr = None
        #: serializes discovery so concurrent ops on a fresh client
        #: can't each open (and leak) their own connection.  Ops
        #: themselves still pipeline on the shared connection; a
        #: leader change mid-overlap may turn a sibling op's result
        #: ambiguous (DISCONNECTED) — within the documented contract.
        self._dlock = asyncio.Lock()

    async def _discover(self, budget: Optional[float] = None):
        import asyncio

        deadline = time.monotonic() + (self.discover_timeout
                                       if budget is None else budget)
        async with self._dlock:
            if self._client is not None:  # a sibling already found it
                return self._client
            while time.monotonic() < deadline:
                for addr in self.hosts:
                    c = self._svcnode.ServiceClient(*addr)
                    try:
                        await asyncio.wait_for(c.connect(),
                                               self.CONNECT_TIMEOUT)
                        st = await c.call("stats", timeout=10.0)
                    except (OSError, ConnectionError,
                            asyncio.TimeoutError):
                        await c.close()
                        continue
                    if isinstance(st, dict) \
                            and st.get("group", {}).get("leader"):
                        self._client, self._leader_addr = c, addr
                        return c
                    await c.close()
                await asyncio.sleep(1.0)
        raise TimeoutError(
            f"no leader found among {self.hosts} within the budget")

    async def call(self, op: str, *args, retryable: bool = False):
        """One op against the current leader, re-discovering and
        retrying ONLY on safe-to-retry outcomes: not-leader
        rejections (never dispatched) always retry; 'failed' retries
        only for ``retryable`` ops (reads — side-effect-free, and a
        fresh leader legitimately answers 'failed' while re-syncing
        its quorum) and only within one op_timeout — a permanently
        dead ensemble also answers 'failed', and that must surface,
        not spin; ambiguous losses surface as DISCONNECTED.  The
        whole call is bounded by ~discover_timeout: nested discovery
        consumes the call's remaining budget, never a fresh one."""
        import asyncio

        deadline = time.monotonic() + self.discover_timeout
        failed_deadline = None
        while True:
            c = self._client
            if c is None:
                c = await self._discover(
                    max(1.0, deadline - time.monotonic()))
            try:
                r = await c.call(op, *args, timeout=self.op_timeout)
            except asyncio.TimeoutError:
                r = self._svcnode.ServiceClient.DISCONNECTED
            if r == ("error", "not-leader"):
                await self._drop(c)
                if time.monotonic() < deadline:
                    continue
            if retryable and r == "failed":
                now = time.monotonic()
                if failed_deadline is None:
                    failed_deadline = min(deadline,
                                          now + self.op_timeout)
                if now < failed_deadline:
                    await asyncio.sleep(0.5)
                    continue
            if r == self._svcnode.ServiceClient.DISCONNECTED:
                # ambiguous: hand it to the caller, but drop the
                # connection so the NEXT op re-discovers
                await self._drop(c)
            return r

    async def _drop(self, failed=None) -> None:
        """Compare-and-drop: only tear down the shared connection if
        it is STILL the one that failed — a stale result from an old
        connection must not close a freshly discovered healthy leader
        out from under sibling ops."""
        if failed is not None and self._client is not failed:
            await failed.close()
            return
        if self._client is not None:
            await self._client.close()
        self._client = None
        self._leader_addr = None

    async def close(self) -> None:
        await self._drop()

    # the common keyed surface
    async def kput(self, ens, key, value):
        return await self.call("kput", ens, key, value)

    async def kget(self, ens, key):
        return await self.call("kget", ens, key, retryable=True)

    async def kget_vsn(self, ens, key):
        return await self.call("kget_vsn", ens, key, retryable=True)

    async def kupdate(self, ens, key, vsn, value):
        return await self.call("kupdate", ens, key, tuple(vsn), value)

    async def kdelete(self, ens, key):
        return await self.call("kdelete", ens, key)

    async def kmodify(self, ens, key, fnref, default):
        return await self.call("kmodify", ens, key, tuple(fnref),
                               default)

    # group administration (leader-routed like any op)
    async def update_group_members(self, hosts):
        return await self.call(
            "update_group_members",
            tuple((str(h), int(p)) for h, p in hosts))

    async def membership(self):
        return await self.call("membership", retryable=True)


# -- CLI ---------------------------------------------------------------------

def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="replication-group replica host")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--repl-port", type=int, default=0)
    ap.add_argument("--client-port", type=int, default=0)
    ap.add_argument("--n-ens", type=int, default=64)
    ap.add_argument("--group-size", type=int, default=3)
    ap.add_argument("--n-slots", type=int, default=32)
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--peer", action="append", default=[],
                    metavar="HOST:PORT",
                    help="another replica host's replication port "
                         "(repeat per peer; required for "
                         "--auto-failover)")
    ap.add_argument("--dynamic", action="store_true",
                    help="dynamic tenant lifecycle (replicated "
                         "create/destroy over the group)")
    ap.add_argument("--advertise", default=None, metavar="HOST:PORT",
                    help="this host's identity in group-config member "
                         "lists (defaults to bind host + repl port; "
                         "required when binding wildcard/NAT'd "
                         "addresses)")
    ap.add_argument("--auto-failover", type=float, default=None,
                    metavar="SECONDS",
                    help="self-promote when no leader traffic for "
                         "this long and this host ranks first among "
                         "reachable peers")
    ap.add_argument("--trust-host-lease", action="store_true",
                    help="serve lease-protected fast reads when this "
                         "host leads (opt-in: trusts the host-quorum "
                         "lease between settles — see "
                         "docs/ARCHITECTURE.md §9)")
    ap.add_argument("--device", default=None,
                    help="the lane's torch device (default: the card; "
                         "'cpu' runs on the CPU)")
    ap.add_argument("--follower-reads", action="store_true",
                    help="serve kget* from this REPLICA's mirrors "
                         "under leader-granted epoch-fenced read "
                         "leases, and (as leader) grant them "
                         "(docs/ARCHITECTURE.md §16; also "
                         "RETPU_FOLLOWER_READS=1)")
    args = ap.parse_args(argv)

    from riak_ensemble_tpu_torch.config import fast_test_config

    peers = []
    for spec in args.peer:
        h, p = spec.rsplit(":", 1)
        peers.append((h, int(p)))
    adv = None
    if args.advertise:
        h, p = args.advertise.rsplit(":", 1)
        adv = (h, int(p))
    srv = ReplicaServer(
        args.n_ens, args.group_size, args.n_slots,
        repl_port=args.repl_port, client_port=args.client_port,
        host=args.host, data_dir=args.data_dir,
        config=fast_test_config() if args.fast else None,
        peers=peers, auto_failover=args.auto_failover,
        dynamic=args.dynamic, advertise=adv,
        trust_host_lease=args.trust_host_lease,
        follower_reads=args.follower_reads or None,
        device=args.device)
    print(f"repgroup replica repl={srv.repl_port} "
          f"client={srv.client_port}", flush=True)
    fp = faults.active_plan()
    if fp is not None:
        # a replica host started under fault-injection knobs is part
        # of a nemesis — say so once, loudly, so its injected fsync
        # delays / drops are never read as a real incident
        print(f"repgroup replica: FAULT INJECTION ACTIVE "
              f"{fp.describe()!r}", file=sys.stderr, flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
