"""The Merkle lane hash of the device trees (hash format 3), and the
device Merkle tree built from it.

Port of ``riak_ensemble_tpu/ops/hash.py``: ``LANES``, ``HASH_FORMAT``,
:func:`leaf_hash`, :func:`obj_leaf_hash` and :func:`fold` (``:41-147``),
and the whole trie as a structure-of-arrays program (``:150-246``) —
:func:`build`, :func:`update`, :func:`diff_levels`,
:func:`exchange_cost`, :func:`verify` and :func:`segment_of` — all
bit-identical to the reference.  ``levels[k]`` is ``[width**k, LANES]``,
level 0 the root, the last level the segment (leaf) hashes.  The tree
functions are plain tensor programs: they run on the device their
tensors lie on (the card's trees stay on the card), and they return new
levels without changing their arguments, as the reference's do.  The
reference computes on uint32 arrays; here every lane is an int32 tensor
holding the same bits (:mod:`.u32` says why and how).  Sites that
differ from the reference because of that say so.

Hash lanes are a murmur3-style mix — not md5: the device hash only
needs uniformity + avalanche (corruption/diff detection).  The fold's
per-child pre-mix is deliberately non-linear in (child, position) so
that a compensated swap of two children cannot collide (format 2's
structured blind spot; see the reference's docstring).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from riak_ensemble_tpu_torch.ops import u32

#: 4 x uint32 lanes = 128-bit hashes per bucket.
LANES = 4

#: Device-tree hash-format version (3 = salted non-linear parallel
#: fold).  Must move with the reference's: both packages persist and
#: compare the same tree bits.
HASH_FORMAT = 3

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_F1 = 0x85EBCA6B
_F2 = 0xC2B2AE35


def _fmix(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on int32 bit patterns: the reference's uint32
    ``h >> r`` becomes the logical :func:`u32.shr`, its multiplies by
    ``_F1``/``_F2`` wrap identically on int32."""
    h = h ^ u32.shr(h, 16)
    h = u32.mul(h, _F1)
    h = h ^ u32.shr(h, 13)
    h = u32.mul(h, _F2)
    return h ^ u32.shr(h, 16)


def _fmix_np(h: np.ndarray) -> np.ndarray:
    """The same finalizer on numpy uint32 (wraps like the reference's
    trace-time constants)."""
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(_F1)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(_F2)
    return h ^ (h >> np.uint32(16))


@functools.lru_cache(maxsize=None)
def _fold_consts_np(width: int) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's trace-time numpy constants (``hash.py:107-108``):
    per-position salts and odd multipliers, computed in numpy uint32
    and handed over as their int32 bit patterns, ``[width, 1]``."""
    pos = np.arange(width, dtype=np.uint32)
    salt = _fmix_np(pos * np.uint32(_C2) + np.uint32(0x9E3779B9))
    mul = _fmix_np(pos * np.uint32(_F1) + np.uint32(_C1)) | np.uint32(1)
    return (u32.from_uint32(salt)[:, None].copy(),
            u32.from_uint32(mul)[:, None].copy())


@functools.lru_cache(maxsize=None)
def _fold_consts(width: int, device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device copies of the fold constants, made once per (width,
    device): an upload inside the engine's round loop would be a host
    copy per round."""
    salt, mul = _fold_consts_np(width)
    return (torch.as_tensor(salt, device=device),
            torch.as_tensor(mul, device=device))


@functools.lru_cache(maxsize=None)
def _lanes(device: torch.device) -> torch.Tensor:
    """``arange(LANES)`` on ``device``, made once."""
    return torch.arange(LANES, dtype=torch.int32, device=device)


def fold(children: torch.Tensor) -> torch.Tensor:
    """Combine ``[..., width, LANES]`` child hashes into ``[..., LANES]``
    parent hashes (the md5-over-concatenated-children role,
    synctree.erl hash/1:255-259).

    Parallel-mix form: each child is avalanched independently with a
    position salt, the mixes sum mod 2^32, and one cross-lane stir +
    final avalanche seal the parent."""
    width = children.shape[-2]
    salt, mul = _fold_consts(width, children.device)
    h = _fmix((children ^ salt) * mul + _lanes(children.device))
    # the reference's sum(dtype=uint32): int32 sum, wraps mod 2^32
    acc = u32.sum32(h, -2)
    # two cross-lane stirs: after roll(1)+fmix then roll(2), lane j
    # reads lanes {j, j-1, j-2, j-3} — a change in ANY input lane
    # avalanches every output lane.  torch.roll moves int32 lanes
    # exactly as jnp.roll moves uint32 ones.
    acc = _fmix(acc ^ torch.roll(acc, 1, dims=-1))
    acc = acc ^ torch.roll(acc, 2, dims=-1)
    return _fmix(acc ^ width)


def _as_i32(x, device=None) -> torch.Tensor:
    """int32 view of an epoch/seq/val operand (the reference's
    ``jnp.asarray(x, uint32)`` reinterprets int32 bits the same way)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int32)
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def leaf_hash(epoch, seq) -> torch.Tensor:
    """Object-version leaf hashes (``get_obj_hash`` = ``<<0, Epoch:64,
    Seq:64>>``, peer.erl:1717-1724) mixed into the lane format.  Shapes
    broadcast; returns ``[..., LANES]`` int32 bit patterns."""
    e = _as_i32(epoch)
    s = _as_i32(seq, e.device)
    e, s = torch.broadcast_tensors(e, s)
    base = torch.stack([e, s, e ^ u32.rotl(s, 7), s ^ u32.rotl(e, 11)],
                       dim=-1)
    return _fmix(u32.mul(base, _C1) + _lanes(base.device))


def obj_leaf_hash(epoch, seq, val) -> torch.Tensor:
    """Object leaf hash covering version AND payload handle (a replica
    whose ``obj_val`` lane was damaged fails the tree check too).
    Shapes broadcast; returns ``[..., LANES]`` int32 bit patterns."""
    e = _as_i32(epoch)
    s = _as_i32(seq, e.device)
    v = _as_i32(val, e.device)
    e, s, v = torch.broadcast_tensors(e, s, v)
    base = torch.stack([e ^ u32.rotl(v, 5), s ^ u32.rotl(v, 9),
                        e ^ u32.rotl(s, 7), s ^ u32.rotl(e, 11)], dim=-1)
    return _fmix(u32.mul(base, _C1) + _lanes(base.device))


Levels = Tuple[torch.Tensor, ...]


def build(leaves: torch.Tensor, width: int = 16) -> Levels:
    """Bottom-up rebuild: ``leaves [S, LANES]`` → levels root-first
    (root ``[1, LANES]`` ... leaves ``[S, LANES]``)."""
    levels = [leaves]
    cur = leaves
    while cur.shape[0] > 1:
        cur = fold(cur.reshape(-1, width, LANES))
        levels.append(cur)
    return tuple(reversed(levels))


def update(levels: Levels, seg_ids: torch.Tensor,
           new_leaves: torch.Tensor, width: int = 16) -> Levels:
    """Incremental batched insert (the write-path hash update,
    peer.erl:1731-1738, batched across K keys): scatter the leaf hashes,
    then per level recompute only the K touched parents from their
    ``width`` children — O(K · width · height) work, plus one copy of
    each level (the reference's functional update returns new arrays).

    Duplicate ``seg_ids`` are LAST-WRITE-WINS.  An index put with
    repeated indices leaves the winner unspecified (on the card it is
    nondeterministic), so, as in the reference, an amax scatter over the
    segment axis finds each segment's last occurrence and every
    duplicate writes that occurrence's value.  Duplicate parents
    recompute identical values, so the parent puts are safe too."""
    out = [lvl.clone() for lvl in levels]
    depth = len(levels) - 1  # leaf level index
    ids = torch.as_tensor(seg_ids, device=out[depth].device).long()
    k = ids.shape[0]
    last_occ_by_seg = torch.zeros(
        out[depth].shape[0], dtype=torch.int64,
        device=ids.device).scatter_reduce(
            0, ids, torch.arange(k, device=ids.device), "amax")
    out[depth][ids] = new_leaves.to(out[depth].dtype)[last_occ_by_seg[ids]]
    lane_off = torch.arange(width, device=ids.device)
    for level in range(depth - 1, -1, -1):
        parent_ids = ids // width
        # [K, width] child indices → gather [K, width, LANES]
        gather_ids = (parent_ids * width)[:, None] + lane_off[None, :]
        out[level][parent_ids] = fold(out[level + 1][gather_ids])
        ids = parent_ids
    return tuple(out)


def diff_levels(a: Levels, b: Levels) -> Tuple[torch.Tensor, ...]:
    """Per-level differing-bucket masks between two trees — the
    device-side form of the exchange descent (synctree.erl:386-417).
    Mask k is True where bucket hashes differ at level k; the leaf mask
    marks exactly the segments whose keys need repair."""
    return tuple(torch.any(x != y, dim=-1) for x, y in zip(a, b))


def exchange_cost(a: Levels, b: Levels, width: int = 16) -> torch.Tensor:
    """Buckets that a streaming exchange would actually fetch: at each
    level only children of differing parents are visited
    (O(width·height·diffs), the remote-exchange traffic bound).  Returns
    ``[height+1]`` int32 visit counts root-ward → leaf-ward."""
    masks = diff_levels(a, b)
    counts = [torch.ones((), dtype=torch.int32, device=masks[0].device)]
    visit = masks[0]  # [1]
    for level in range(1, len(masks)):
        # children of differing parents are visited...
        visited_children = torch.repeat_interleave(visit, width)
        counts.append(visited_children.sum(dtype=torch.int32))
        # ...and among those, the differing ones descend further
        visit = visited_children & masks[level]
    return torch.stack(counts)


def verify(levels: Levels, width: int = 16) -> Tuple[torch.Tensor, ...]:
    """Integrity sweep: recompute each parent level from its children
    and flag mismatches — per-level corruption bitmaps (the BFS verify,
    synctree.erl:549-571, in one pass).  Bitmap k covers level k, for
    every level above the leaves."""
    out = []
    for level in range(len(levels) - 1):
        expect = fold(levels[level + 1].reshape(-1, width, LANES))
        out.append(torch.any(expect != levels[level], dim=-1))
    return tuple(out)


def segment_of(key_hash, segments: int) -> torch.Tensor:
    """Key → segment (the md5-mod mapping, synctree.erl:251-253) for
    uint32 key hashes computed host-side.  torch has no uint32
    remainder, so the hashes (uint32 values, or int32 tensors holding
    their bits) are widened to int64 first; returns int64 segment ids,
    the reference's uint32 values."""
    if isinstance(key_hash, torch.Tensor):
        h = key_hash.to(torch.int64) & 0xFFFFFFFF
    else:
        h = torch.as_tensor(np.asarray(key_hash).astype(np.uint32)
                            .astype(np.int64))
    return h % segments
