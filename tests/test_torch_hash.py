"""The port's Merkle lane hash against the JAX package's, bit for bit.

``fold``, ``leaf_hash``, ``obj_leaf_hash`` and the engine's
``build_uppers`` run on the same seeded uint32 lanes — including 0,
0x7FFFFFFF, 0x80000000 and 0xFFFFFFFF — through both packages; the
port's int32 bit patterns must equal the reference's uint32 bits
exactly.  The compensated-swap regressions of
``tests/test_hash_kernel.py`` run on the port's fold.
"""

import types

import numpy as np
import pytest
import torch

from riak_ensemble_tpu_torch.ops import engine as teng
from riak_ensemble_tpu_torch.ops import hash as th
from riak_ensemble_tpu_torch.ops import u32

EDGES = np.array([0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 1, 0x9E3779B9],
                 dtype=np.uint32)


@pytest.fixture
def ref():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from riak_ensemble_tpu.ops import engine as jeng
    from riak_ensemble_tpu.ops import hash as jh
    return types.SimpleNamespace(jnp=jnp, jh=jh, jeng=jeng)


def _lanes(rng, shape):
    a = rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
    flat = a.reshape(-1)
    flat[:len(EDGES)] = EDGES[:flat.size]
    return a


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32 numpy → the port's int32 bit-pattern tensor."""
    return torch.from_numpy(u32.from_uint32(a).copy())


def _u(t: torch.Tensor) -> np.ndarray:
    return u32.to_uint32(t.numpy())


def test_u32_helpers_match_numpy_uint32():
    rng = np.random.default_rng(0)
    x = _lanes(rng, (4096,))
    t = _t(x)
    for r in (1, 7, 13, 16, 31):
        np.testing.assert_array_equal(_u(u32.shr(t, r)), x >> np.uint32(r))
        np.testing.assert_array_equal(
            _u(u32.rotl(t, r)),
            (x << np.uint32(r)) | (x >> np.uint32(32 - r)))
    for c in (0xCC9E2D51, 0x85EBCA6B, 3, 0xFFFFFFFF):
        np.testing.assert_array_equal(_u(u32.mul(t, c)), x * np.uint32(c))
    y = _lanes(rng, (64, 16))
    np.testing.assert_array_equal(_u(u32.sum32(_t(y), 1)),
                                  y.sum(1, dtype=np.uint32))
    assert u32.i32(0xFFFFFFFF) == -1 and u32.i32(0x7FFFFFFF) == 0x7FFFFFFF


@pytest.mark.parametrize("shape", [(16, 4), (3, 5, 16, 4), (40, 7, 4)])
def test_fold_matches_jax(ref, shape):
    rng = np.random.default_rng(len(shape) * 10 + shape[-2])
    x = _lanes(rng, shape)
    want = np.asarray(ref.jh.fold(ref.jnp.asarray(x)))
    got = th.fold(_t(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_u(got), want)


def test_leaf_hashes_match_jax(ref):
    jnp, jh = ref.jnp, ref.jh
    rng = np.random.default_rng(1)
    e, s, v = (u32.from_uint32(_lanes(rng, (3, 257))) for _ in range(3))
    np.testing.assert_array_equal(
        _u(th.leaf_hash(torch.from_numpy(e), torch.from_numpy(s))),
        np.asarray(jh.leaf_hash(jnp.asarray(e), jnp.asarray(s))))
    np.testing.assert_array_equal(
        _u(th.obj_leaf_hash(torch.from_numpy(e), torch.from_numpy(s),
                            torch.from_numpy(v))),
        np.asarray(jh.obj_leaf_hash(jnp.asarray(e), jnp.asarray(s),
                                    jnp.asarray(v))))
    # broadcasting scalar operands, as init_state hashes the empty object
    np.testing.assert_array_equal(
        _u(th.obj_leaf_hash(torch.tensor(0, dtype=torch.int32), 0, 0)),
        np.asarray(jh.obj_leaf_hash(jnp.int32(0), jnp.int32(0),
                                    jnp.int32(0))))
    assert th.LANES == jh.LANES and th.HASH_FORMAT == jh.HASH_FORMAT == 3


@pytest.mark.parametrize("n_slots", [1, 16, 32, 100, 128])
def test_build_uppers_matches_jax(ref, n_slots):
    rng = np.random.default_rng(n_slots)
    leaves = _lanes(rng, (2, 3, n_slots, th.LANES))
    want = np.asarray(ref.jeng.build_uppers(ref.jnp.asarray(leaves)))
    np.testing.assert_array_equal(_u(teng.build_uppers(_t(leaves))), want)
    assert teng.tree_sizes(n_slots) == ref.jeng.tree_sizes(n_slots)


def test_fold_compensated_swap_no_collision(ref):
    """Format 2's linear pre-mix collided on (a, b) -> (b+d, a-d),
    d = (q-p)*C2*C1^-1; format 3 must not, for the additive and the
    xor-compensated swap (tests/test_hash_kernel.py:211)."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    c1_inv = pow(c1, -1, 2 ** 32)
    rng = np.random.default_rng(7)
    for trial in range(100):
        children = rng.integers(0, 2 ** 32, (16, th.LANES), dtype=np.uint32)
        base = _u(th.fold(_t(children)))
        np.testing.assert_array_equal(
            base, np.asarray(ref.jh.fold(ref.jnp.asarray(children))))
        p, q = sorted(rng.choice(16, size=2, replace=False))
        d = np.uint32((int(q - p) * c2 * c1_inv) % 2 ** 32)
        add = children.copy()
        add[p] = children[q] + d
        add[q] = children[p] - d
        assert (_u(th.fold(_t(add))) != base).any(), trial
        for delta in (np.uint32(d), np.uint32(trial + 1)):
            xr = children.copy()
            xr[p] = children[q] ^ delta
            xr[q] = children[p] ^ delta
            assert (_u(th.fold(_t(xr))) != base).any(), trial


def test_fold_plain_swap_with_shift_sweep():
    rng = np.random.default_rng(8)
    children = rng.integers(0, 2 ** 32, (16, th.LANES), dtype=np.uint32)
    base = _u(th.fold(_t(children)))
    for d in range(1, 65):
        du = np.uint32(d)
        add = children.copy()
        add[0], add[1] = children[1] + du, children[0] - du
        assert (_u(th.fold(_t(add))) != base).any()
        xr = children.copy()
        xr[0], xr[1] = children[1] ^ du, children[0] ^ du
        assert (_u(th.fold(_t(xr))) != base).any()
