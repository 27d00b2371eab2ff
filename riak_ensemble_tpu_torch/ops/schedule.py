"""Wide-round scheduling: pack a [K, E] op stream into [G, E, W]
conflict-free planes for :func:`engine.kv_step_scan_wide`.

A copy of ``riak_ensemble_tpu/ops/schedule.py`` (numpy only; the port
imports nothing of the JAX package, so it keeps its own copy, the
mesh's :func:`shard_active_columns` included).  The
reference serializes same-key ops through its key-hashed worker
(``riak_ensemble_peer:async/3``, peer.erl:1220-1225) while distinct
keys proceed concurrently.  Ops on distinct slots within an ensemble are
conflict-free (no lane reads or writes another lane's slot; a GET can
write too — rewrite/tombstone/repair — so GETs chain like writes), so
they share one wide round, and the g-th op on the SAME slot goes to
round g (occurrence-index chaining preserves per-slot order).

The wide execution applies groups sequentially and lanes logically in
lane order (seqs by in-round rank), so it equals running the ops
through scalar rounds in (group, lane) order — a valid serialization
that reorders only ops on DIFFERENT slots, exactly the freedom the
reference's per-key workers have.

Shapes are bucketed (pow2 G and W) so the service sees a handful of
plane shapes, not one per flush.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

from riak_ensemble_tpu_torch.ops.engine import OP_NOOP


class WidePlan(NamedTuple):
    """Scheduled planes + the result-routing map.

    kind/slot/val/lease_ok/exp_epoch/exp_seq: ``[G, E, W]`` (padding
    lanes are OP_NOOP at slot -1; ``lease_ok`` is None when the
    caller's lease is per-ensemble and rides an [E]-broadcast
    instead).  ``map_g``/``map_w``: ``[K, E]`` int32 — original op
    (k, e)'s group and lane, for routing ``KvResult[G, E, W]`` back
    to per-op order (NOOP padding maps to (0, 0); its routed result
    is meaningless and callers mask it).
    """

    kind: np.ndarray
    slot: np.ndarray
    val: np.ndarray
    lease_ok: Optional[np.ndarray]
    exp_epoch: np.ndarray
    exp_seq: np.ndarray
    map_g: np.ndarray
    map_w: np.ndarray


def _pow2_at_least(n: int) -> int:
    return 1 << (max(n, 1) - 1).bit_length()


def schedule_wide(kind: np.ndarray, slot: np.ndarray, val: np.ndarray,
                  lease_ok: Optional[np.ndarray],
                  exp_epoch: np.ndarray, exp_seq: np.ndarray,
                  max_width: int = 0,
                  max_groups: int = 0) -> Optional[WidePlan]:
    """Pack ``[K, E]`` planes into a :class:`WidePlan`.

    Vectorized (no per-op Python loop): occurrence indices come from a
    lexsort over (ensemble, slot, k) — an op's group is its rank among
    same-slot predecessors — and lane indices from a second lexsort
    over (ensemble, group, k).  O(K·E log(K·E)).

    ``max_width`` > 0 caps W (splitting overfull groups by spilling
    lanes to later groups would complicate ordering, so instead the
    cap simply falls back to W=1 scheduling when a flush is wider —
    callers use it to bound plane memory; 0 = no cap).

    ``max_groups`` > 0 returns None as soon as the duplicate chains
    run deeper than that many groups — the caller will take its
    scalar path, so the lane sort and plane packing (about two thirds
    of the scheduling cost) are skipped for those flushes.
    """
    k_depth, n_ens = kind.shape
    kind = np.ascontiguousarray(kind, np.int32)
    slot = np.ascontiguousarray(slot, np.int32)

    kk, ee = np.meshgrid(np.arange(k_depth, dtype=np.int32),
                         np.arange(n_ens, dtype=np.int32), indexing="ij")
    active = kind != OP_NOOP

    def _rank_in_runs(key_a: np.ndarray, key_b: np.ndarray) -> np.ndarray:
        """Rank of each element among same-(key_a, key_b) elements,
        in k order (lexsort + index-minus-run-start)."""
        order = np.lexsort((kk.ravel(), key_b.ravel(), key_a.ravel()))
        a_s = key_a.ravel()[order]
        b_s = key_b.ravel()[order]
        run_start = np.ones(order.size, bool)
        run_start[1:] = (a_s[1:] != a_s[:-1]) | (b_s[1:] != b_s[:-1])
        idx = np.arange(order.size)
        start_idx = np.maximum.accumulate(np.where(run_start, idx, 0))
        rank = np.empty(order.size, np.int32)
        rank[order] = (idx - start_idx).astype(np.int32)
        return rank.reshape(k_depth, n_ens)

    # Group = occurrence index among same-(e, slot) ACTIVE ops.  NOOP
    # padding and invalid-slot ops (slot < 0 — they can never write,
    # so they cannot conflict) get forced-unique negative keys: -1-k
    # is unique per row, and a real slot is never negative, so neither
    # can chain into anything.
    chain_slot = np.where(active & (slot >= 0), slot, -1 - kk)
    group = _rank_in_runs(ee, chain_slot)
    group[~active] = 0
    if max_groups and active.any() \
            and int(group[active].max()) + 1 > max_groups:
        return None  # deep duplicate chains: caller's scalar path

    # Lane = rank of k among ACTIVE ops in the same (e, group);
    # inactives share a sentinel group key, so they never dilute a
    # real group's lane numbering.
    lane = _rank_in_runs(ee, np.where(active, group, -1))
    lane[~active] = 0

    any_active = bool(active.any())
    n_groups = int(group[active].max()) + 1 if any_active else 1
    width = int(lane[active].max()) + 1 if any_active else 1
    if max_width and width > max_width:
        # Wider than the caller's memory budget: degenerate to the
        # sequential layout ([K, E, 1]), which is always legal — but
        # it has K groups, so a max_groups bound still applies (the
        # caller's warmed-program set must hold for EVERY returned
        # plan, not just the un-capped ones).
        if max_groups and k_depth > max_groups:
            return None
        group, lane = kk.copy(), np.zeros_like(kk)
        n_groups, width = k_depth, 1
    n_groups = _pow2_at_least(n_groups)
    width = _pow2_at_least(width)

    m = active
    def pack(plane: np.ndarray, fill: int) -> np.ndarray:
        out = np.full((n_groups, n_ens, width), fill, np.int32)
        out[group[m], ee[m], lane[m]] = np.asarray(plane, np.int32)[m]
        return out

    return WidePlan(
        kind=pack(kind, OP_NOOP), slot=pack(slot, -1), val=pack(val, 0),
        lease_ok=(None if lease_ok is None else
                  pack(np.asarray(lease_ok, np.int32), 0).astype(bool)),
        exp_epoch=pack(exp_epoch, 0), exp_seq=pack(exp_seq, 0),
        map_g=group, map_w=lane)


def route_results(plan: WidePlan, field: np.ndarray) -> np.ndarray:
    """Gather a ``[G, E, W, ...]`` result field back to the original
    ``[K, E, ...]`` op order."""
    ee = np.arange(plan.map_g.shape[1], dtype=np.int32)[None, :]
    return field[plan.map_g, ee, plan.map_w]


def flat_order(plan: WidePlan) -> Tuple[np.ndarray, np.ndarray]:
    """(k, e) indices of real ops in (group, lane) execution order per
    ensemble — the serialization the wide rounds realize (used by the
    differential tests to build the equivalent scalar op stream)."""
    k_depth, n_ens = plan.map_g.shape
    kk = np.arange(k_depth, dtype=np.int32)
    out_k = np.empty_like(plan.map_g)
    for e in range(n_ens):
        order = np.lexsort((plan.map_w[:, e], plan.map_g[:, e]))
        out_k[:, e] = kk[order]
    return out_k, np.broadcast_to(
        np.arange(n_ens, dtype=np.int32)[None, :], (k_depth, n_ens))


def shard_active_columns(active: np.ndarray, n_ens: int,
                         n_shards: int, a_min: int
                         ) -> Tuple[list, int]:
    """Split a GLOBAL active-column index set into per-ens-shard LOCAL
    index lists with one common pow2 bucket width (schedule.py:174-199).

    The mesh keeps E in ``n_shards`` contiguous blocks of
    ``E/n_shards`` rows, so a global column index ``c`` lives on shard
    ``c // e_loc`` at local index ``c % e_loc``.  Every shard packs the
    same ``a_width`` columns (pow2 >= the busiest shard's count, floored
    at ``a_min``, capped at ``e_loc``), so each shard's packed payload
    has one shape and stays on its device.

    Returns ``(per_shard, a_width)``: ``per_shard[s]`` is an int32
    array of <= ``a_width`` LOCAL indices (the caller pads to
    ``a_width``); ``a_width == e_loc`` means no compaction wins on
    this flush (every shard at full width).
    """
    e_loc = n_ens // n_shards
    active = np.asarray(active, np.int32)
    shard_of = active // e_loc
    per_shard = [active[shard_of == s] - s * e_loc
                 for s in range(n_shards)]
    busiest = max((p.size for p in per_shard), default=0)
    a_width = _pow2_at_least(max(busiest, a_min))
    return per_shard, min(a_width, e_loc)
