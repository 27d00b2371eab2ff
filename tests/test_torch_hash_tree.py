"""The port's device Merkle tree against the JAX package's, bit for bit.

``build``, ``update``, ``diff_levels``, ``exchange_cost``, ``verify``
and ``segment_of`` of ``riak_ensemble_tpu_torch.ops.hash`` run on the
same seeded uint32 lanes as the reference's (``tests/test_hash_kernel.py``'s
fourteen cases, each held against the JAX function on the same inputs),
and the 1M-segment tree (16^5 segments, width 16) builds to the same
levels in both packages.  The port's int32 lanes are compared as their
uint32 bits.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from riak_ensemble_tpu.ops import hash as jh  # noqa: E402
from riak_ensemble_tpu_torch.ops import hash as th  # noqa: E402
from riak_ensemble_tpu_torch.ops import u32  # noqa: E402

W = 4          # small width for exhaustive tests
S = W ** 3     # 64 segments


def _t(a) -> torch.Tensor:
    """uint32 numpy → the port's int32 bit-pattern tensor."""
    return torch.from_numpy(u32.from_uint32(np.asarray(a)).copy())


def _u(t: torch.Tensor) -> np.ndarray:
    return u32.to_uint32(t.numpy())


def rand_leaves(rng, n=S):
    return rng.integers(0, 2**32, (n, th.LANES), dtype=np.uint32)


def _same_levels(port, ref):
    assert len(port) == len(ref)
    for lp, lr in zip(port, ref):
        np.testing.assert_array_equal(_u(lp), np.asarray(lr))


def _same_masks(port, ref):
    assert len(port) == len(ref)
    for mp, mr in zip(port, ref):
        assert mp.dtype == torch.bool
        np.testing.assert_array_equal(mp.numpy(), np.asarray(mr))


def _both_build(leaves, width):
    port = th.build(_t(leaves), width=width)
    ref = jh.build(jnp.asarray(leaves), width=width)
    _same_levels(port, ref)
    return port, ref


def _both_update(levels, seg_ids, new, width):
    port_lv, ref_lv = levels
    port = th.update(port_lv, torch.as_tensor(np.asarray(seg_ids)),
                     _t(new), width=width)
    ref = jh.update(ref_lv, jnp.asarray(seg_ids), jnp.asarray(new),
                    width=width)
    _same_levels(port, ref)
    return port, ref


def test_build_shapes():
    rng = np.random.default_rng(0)
    port, _ref = _both_build(rand_leaves(rng), W)
    assert [lv.shape[0] for lv in port] == [1, W, W * W, S]
    assert all(lv.dtype == torch.int32 for lv in port)


def test_update_matches_rebuild():
    """Incremental update == full rebuild, in both packages."""
    rng = np.random.default_rng(1)
    leaves = rand_leaves(rng)
    levels = _both_build(leaves, W)
    seg_ids = np.asarray([3, 17, 17, 63])  # includes a duplicate
    new = rand_leaves(rng, 4)
    before = [lv.clone() for lv in levels[0]]
    updated, _ = _both_update(levels, seg_ids, new, W)
    # the port's update is functional, as the reference's: its input
    # levels are unchanged
    for a, b in zip(before, levels[0]):
        assert torch.equal(a, b)

    ref_leaves = leaves.copy()
    for i, seg in enumerate(seg_ids):
        ref_leaves[seg] = new[i]
    rebuilt, _ = _both_build(ref_leaves, W)
    for lu, lr in zip(updated, rebuilt):
        assert torch.equal(lu, lr)


def test_diff_exact():
    rng = np.random.default_rng(2)
    a = _both_build(rand_leaves(rng), W)
    changed = [5, 40]
    b = _both_update(a, np.asarray(changed), rand_leaves(rng, 2), W)
    masks = th.diff_levels(a[0], b[0])
    _same_masks(masks, jh.diff_levels(a[1], b[1]))
    assert sorted(torch.nonzero(masks[-1])[:, 0].tolist()) == changed
    assert bool(masks[0][0])


def test_diff_identical_is_empty():
    rng = np.random.default_rng(3)
    a = _both_build(rand_leaves(rng), W)
    masks = th.diff_levels(a[0], a[0])
    _same_masks(masks, jh.diff_levels(a[1], a[1]))
    assert not any(bool(m.any()) for m in masks)


def test_exchange_cost_bound():
    rng = np.random.default_rng(4)
    a = _both_build(rand_leaves(rng), W)
    b = _both_update(a, np.asarray([11]), rand_leaves(rng, 1), W)
    costs = th.exchange_cost(a[0], b[0], width=W)
    assert costs.dtype == torch.int32
    np.testing.assert_array_equal(
        costs.numpy(), np.asarray(jh.exchange_cost(a[1], b[1], width=W)))
    assert costs[0] == 1
    assert bool((costs[1:] <= W).all())
    assert int(costs.sum()) < S


def test_verify_detects_corruption():
    rng = np.random.default_rng(5)
    port, ref = _both_build(rand_leaves(rng), W)
    clean = th.verify(port, width=W)
    _same_masks(clean, jh.verify(ref, width=W))
    assert not any(bool(m.any()) for m in clean)

    # corrupt one inner bucket at level 2 in both
    lv2 = np.asarray(ref[2]).copy()
    lv2[7] ^= 0xDEAD
    port = list(port)
    ref = list(ref)
    port[2] = _t(lv2)
    ref[2] = jnp.asarray(lv2)
    masks = th.verify(tuple(port), width=W)
    _same_masks(masks, jh.verify(tuple(ref), width=W))
    assert bool(masks[1][7 // W]) and bool(masks[2][7])


def test_leaf_hash_version_sensitivity():
    hs = []
    for e, s in ((1, 1), (1, 2), (2, 1)):
        hp = th.leaf_hash(torch.tensor([e], dtype=torch.int32),
                          torch.tensor([s], dtype=torch.int32))
        hr = jh.leaf_hash(jnp.asarray([e]), jnp.asarray([s]))
        np.testing.assert_array_equal(_u(hp), np.asarray(hr))
        hs.append(_u(hp))
    assert not np.array_equal(hs[0], hs[1])
    assert not np.array_equal(hs[0], hs[2])
    assert not np.array_equal(hs[1], hs[2])


def test_million_segment_build_compiles():
    """The production shape (1M segments, width 16 — synctree.erl
    :88-89) builds and updates to the reference's bits."""
    rng = np.random.default_rng(6)
    segs = 16 ** 5
    levels = _both_build(np.zeros((segs, th.LANES), np.uint32), 16)
    assert levels[0][0].shape == (1, th.LANES)
    ids = rng.integers(0, segs, 256)
    new = rng.integers(0, 2**32, (256, th.LANES), dtype=np.uint32)
    updated = _both_update(levels, ids, new, 16)
    leaf_mask = th.diff_levels(levels[0], updated[0])[-1]
    assert set(torch.nonzero(leaf_mask)[:, 0].tolist()) == set(ids.tolist())


def test_million_segment_tree_bit_equal():
    """The reference's design scale with distinct leaves: 16^5 leaf
    hashes of (i, 7i + 1), built in both packages; every level, the
    verify bitmaps, an update of 4,096 ids (duplicates included) and the
    diff / exchange cost against the updated tree are equal."""
    segs = 16 ** 5
    idx = np.arange(segs, dtype=np.uint32)
    port_leaves = th.leaf_hash(_t(idx), _t(idx * np.uint32(7) + np.uint32(1)))
    ref_leaves = jh.leaf_hash(jnp.asarray(idx),
                              jnp.asarray(idx) * 7 + 1)
    np.testing.assert_array_equal(_u(port_leaves), np.asarray(ref_leaves))
    levels = _both_build(np.asarray(ref_leaves), 16)
    rng = np.random.default_rng(13)
    ids = rng.integers(0, segs, 4096)
    ids[100:200] = ids[:100]          # duplicates: the last one wins
    new = rng.integers(0, 2**32, (4096, th.LANES), dtype=np.uint32)
    upd = _both_update(levels, ids, new, 16)
    _same_masks(th.verify(upd[0]), jh.verify(upd[1]))
    _same_masks(th.diff_levels(levels[0], upd[0]),
                jh.diff_levels(levels[1], upd[1]))
    np.testing.assert_array_equal(
        th.exchange_cost(levels[0], upd[0]).numpy(),
        np.asarray(jh.exchange_cost(levels[1], upd[1])))


def test_update_duplicate_seg_ids_last_write_wins():
    """A batch with duplicate segment ids is a sequence of inserts: the
    final occurrence wins, as one-at-a-time updates do, in both."""
    segs = 16 ** 2
    levels = _both_build(np.zeros((segs, th.LANES), np.uint32), 16)
    ids = np.asarray([7, 3, 7, 7, 3])
    rng = np.random.default_rng(5)
    new = rng.integers(0, 2 ** 32, (5, th.LANES), dtype=np.uint32)
    got = _both_update(levels, ids, new, 16)
    want = levels
    for i in range(5):
        want = _both_update(want, ids[i:i + 1], new[i:i + 1], 16)
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)


def test_segment_of_matches_reference():
    rng = np.random.default_rng(9)
    h = rng.integers(0, 2**32, 1000, dtype=np.uint32)
    h[:4] = [0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]
    for segs in (16 ** 3, 16 ** 5, 1000):
        want = np.asarray(jh.segment_of(jnp.asarray(h), segs))
        np.testing.assert_array_equal(th.segment_of(h, segs).numpy(), want)
        np.testing.assert_array_equal(th.segment_of(_t(h), segs).numpy(),
                                      want)


# -- fold quality, on the port's fold, each fold held against the JAX one


def _fold_both(children: np.ndarray) -> np.ndarray:
    out = _u(th.fold(_t(children)))
    np.testing.assert_array_equal(out, np.asarray(jh.fold(
        jnp.asarray(children))))
    return out


def test_fold_avalanche():
    rng = np.random.default_rng(0)
    children = np.asarray(rng.integers(0, 2**32, (16, th.LANES)),
                          dtype=np.uint32)
    base = _fold_both(children)
    fracs = []
    for _trial in range(64):
        i = rng.integers(0, 16)
        lane = rng.integers(0, th.LANES)
        bit = rng.integers(0, 32)
        mut = children.copy()
        mut[i, lane] ^= np.uint32(1) << np.uint32(bit)
        out = _fold_both(mut)
        assert (out != base).any(), "flip went undetected"
        diff = np.bitwise_xor(out, base)
        fracs.append(sum(int(x).bit_count() for x in diff.ravel())
                     / (32 * th.LANES))
    mean = float(np.mean(fracs))
    assert 0.40 < mean < 0.60, f"avalanche degraded: {mean:.3f}"


def test_fold_order_and_position_sensitivity():
    rng = np.random.default_rng(1)
    children = np.asarray(rng.integers(0, 2**32, (16, th.LANES)),
                          dtype=np.uint32)
    base = _fold_both(children)
    swapped = children.copy()
    swapped[[2, 9]] = swapped[[9, 2]]
    assert (_fold_both(swapped) != base).any()
    for pos in range(1, 16):
        a = np.zeros((16, th.LANES), np.uint32)
        b = np.zeros((16, th.LANES), np.uint32)
        a[0] = 12345
        b[pos] = 12345
        assert (_fold_both(a) != _fold_both(b)).any(), pos


def test_fold_collision_smoke():
    rng = np.random.default_rng(2)
    blocks = np.asarray(rng.integers(0, 2**32, (10_000, 16, th.LANES)),
                        dtype=np.uint32)
    outs = _fold_both(blocks)
    assert len({tuple(int(v) for v in row) for row in outs}) == 10_000


def test_fold_compensated_swap_no_collision():
    c1, c2 = 0xCC9E2D51, 0x1B873593
    c1_inv = pow(c1, -1, 2**32)
    rng = np.random.default_rng(7)
    blocks = []
    for trial in range(100):
        children = np.asarray(
            rng.integers(0, 2**32, (16, th.LANES)), dtype=np.uint32)
        p, q = sorted(rng.choice(16, size=2, replace=False))
        d = np.uint32((int(q - p) * c2 * c1_inv) % 2**32)
        add = children.copy()
        add[p] = children[q] + d
        add[q] = children[p] - d
        blocks += [children, add]
        for delta in (np.uint32(d), np.uint32(trial + 1)):
            xr = children.copy()
            xr[p] = children[q] ^ delta
            xr[q] = children[p] ^ delta
            blocks.append(xr)
    outs = _fold_both(np.stack(blocks)).reshape(100, 4, th.LANES)
    for trial in range(100):
        for j in (1, 2, 3):
            assert (outs[trial, j] != outs[trial, 0]).any(), (trial, j)


def test_fold_plain_swap_with_shift_sweep():
    rng = np.random.default_rng(8)
    children = np.asarray(rng.integers(0, 2**32, (16, th.LANES)),
                          dtype=np.uint32)
    blocks = [children]
    for d in range(1, 65):
        du = np.uint32(d)
        add = children.copy()
        add[0], add[1] = children[1] + du, children[0] - du
        xr = children.copy()
        xr[0], xr[1] = children[1] ^ du, children[0] ^ du
        blocks += [add, xr]
    outs = _fold_both(np.stack(blocks))
    assert (outs[1:] != outs[0]).any(axis=1).all()
