"""The port's engine against the JAX package's, plane for plane.

Seeded ``full_step`` streams (in the style of
``tests/test_engine_model.py``) drive both engines with the same inputs:
elections with arbitrary up-masks and bogus candidates, every op kind
with invalid slots, leased and unleased reads, CAS with random expected
versions, every RMW fun code, tombstones, joint views, and out-of-band
corruption of object and tree planes.  Every state plane and every
result field must be bit-equal after every step (exact equality; the
port's int32 tree planes are compared as the reference's uint32).

The JAX side runs as its own tests run it: jitted on the CPU.  The port
updates its state in place, so each arm keeps its own copy.
"""

import types

import numpy as np
import pytest
import torch

from riak_ensemble_tpu_torch import interop
from riak_ensemble_tpu_torch.ops import engine as teng


@pytest.fixture
def ref():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from riak_ensemble_tpu.ops import engine as jeng
    return types.SimpleNamespace(jnp=jnp, jeng=jeng)


def _assert_state_equal(js, ts, tag):
    tn = interop.state_to_numpy(ts)
    for f in teng.EngineState._fields:
        a, b = np.asarray(getattr(js, f)), getattr(tn, f)
        assert a.dtype == b.dtype and a.shape == b.shape, (tag, f)
        assert np.array_equal(a, b), (tag, f)


def _assert_result_equal(jr, tr, tag):
    tn = interop.result_to_numpy(tr)
    for f in teng.KvResult._fields:
        a, b = np.asarray(getattr(jr, f)), getattr(tn, f)
        assert a.dtype == b.dtype and a.shape == b.shape, (tag, f)
        assert np.array_equal(a, b), (tag, f)


def _stream(rng, e, m, s, k):
    up = rng.random((e, m)) < 0.85
    elect = rng.random(e) < 0.35
    cand = rng.integers(-1, m + 1, e).astype(np.int32)
    kind = rng.integers(0, 5, (k, e)).astype(np.int32)
    slot = rng.integers(-2, s + 2, (k, e)).astype(np.int32)
    val = rng.integers(-3, 60, (k, e)).astype(np.int32)
    val[rng.random((k, e)) < 0.15] = 0                      # tombstones
    val[rng.random((k, e)) < 0.05] = 2 ** 31 - 1            # wrap in RMW
    lease = rng.random((k, e)) < 0.3
    exp_e = np.where(kind == teng.OP_RMW, rng.integers(0, 9, (k, e)),
                     rng.integers(0, 3, (k, e))).astype(np.int32)
    exp_s = rng.integers(0, 4, (k, e)).astype(np.int32)
    return elect, cand, kind, slot, val, lease, up, exp_e, exp_s


def _corrupt(ref, js, ts, rng, e, m, s):
    """The same out-of-band damage on both arms: a bumped object value,
    a flipped leaf bit and a flipped upper-node bit."""
    ee, mm, ss = int(rng.integers(0, e)), int(rng.integers(0, m)), \
        int(rng.integers(0, s))
    js = js._replace(obj_val=js.obj_val.at[ee, mm, ss].add(1))
    ts.obj_val[ee, mm, ss] += 1
    ee, mm = int(rng.integers(0, e)), int(rng.integers(0, m))
    js = js._replace(tree_leaf=js.tree_leaf.at[ee, mm, ss, 1].set(
        js.tree_leaf[ee, mm, ss, 1] ^ ref.jnp.uint32(1 << 31)))
    ts.tree_leaf[ee, mm, ss, 1] ^= -(1 << 31)
    js = js._replace(tree_node=js.tree_node.at[ee, 0, 0, 2].set(
        js.tree_node[ee, 0, 0, 2] ^ ref.jnp.uint32(5)))
    ts.tree_node[ee, 0, 0, 2] ^= 5
    return js, ts


@pytest.mark.parametrize("e,m,s,k,views,seed", [
    (16, 5, 32, 4, None, 0),
    (16, 5, 32, 4, [[0, 1, 2], [1, 2, 3, 4]], 1),   # joint views
    (7, 3, 16, 3, None, 2),
])
def test_full_step_stream_matches_jax(ref, e, m, s, k, views, seed):
    jnp, jeng = ref.jnp, ref.jeng
    rng = np.random.default_rng(seed)
    js = jeng.init_state(e, m, s, views=views)
    ts = teng.init_state(e, m, s, views=views, device="cpu")
    _assert_state_equal(js, ts, "init")
    commits = corrupt_flags = 0
    for step in range(14):
        if step in (6, 10):
            js, ts = _corrupt(ref, js, ts, rng, e, m, s)
        planes = _stream(rng, e, m, s, k)
        js, jw, jr = jeng.full_step(
            js, *(jnp.asarray(p) for p in planes[:7]),
            exp_epoch=jnp.asarray(planes[7]),
            exp_seq=jnp.asarray(planes[8]))
        t = [torch.from_numpy(p) for p in planes]
        ts, tw, tr = teng.full_step(ts, *t[:7], exp_epoch=t[7],
                                    exp_seq=t[8])
        _assert_state_equal(js, ts, step)
        _assert_result_equal(jr, tr, step)
        np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
        commits += int(tr.committed.sum())
        corrupt_flags += int(tr.tree_corrupt.sum())
    # the stream really exercised commits and the integrity gate
    assert commits > 10 and corrupt_flags > 0


def test_kv_step_and_elect_step_match_jax(ref):
    jnp, jeng = ref.jnp, ref.jeng
    e, m, s = 9, 4, 16
    rng = np.random.default_rng(5)
    js = jeng.init_state(e, m, s)
    ts = teng.init_state(e, m, s, device="cpu")
    for step in range(6):
        elect, cand, kind, slot, val, lease, up, exp_e, exp_s = \
            _stream(rng, e, m, s, 1)
        js, jw = jeng.elect_step(js, jnp.asarray(elect), jnp.asarray(cand),
                                 jnp.asarray(up))
        ts, tw = teng.elect_step(ts, torch.from_numpy(elect),
                                 torch.from_numpy(cand),
                                 torch.from_numpy(up))
        np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
        args = (kind[0], slot[0], val[0], lease[0], up)
        js, jr = jeng.kv_step(js, *(jnp.asarray(a) for a in args),
                              exp_epoch=jnp.asarray(exp_e[0]),
                              exp_seq=jnp.asarray(exp_s[0]))
        ts, tr = teng.kv_step(ts, *(torch.from_numpy(a) for a in args),
                              exp_epoch=torch.from_numpy(exp_e[0]),
                              exp_seq=torch.from_numpy(exp_s[0]))
        _assert_state_equal(js, ts, step)
        _assert_result_equal(jr, tr, step)


def test_zero_round_step_matches_jax(ref):
    """An election-only launch (K = 0) — the service's idle flush."""
    jnp, jeng = ref.jnp, ref.jeng
    e, m, s = 5, 3, 16
    z = np.zeros((0, e), np.int32)
    elect = np.ones(e, bool)
    cand = np.zeros(e, np.int32)
    up = np.ones((e, m), bool)
    js, jw, jr = jeng.full_step(
        jeng.init_state(e, m, s), jnp.asarray(elect), jnp.asarray(cand),
        jnp.asarray(z), jnp.asarray(z), jnp.asarray(z),
        jnp.zeros((0, e), bool), jnp.asarray(up))
    tz = torch.from_numpy(z)
    ts, tw, tr = teng.full_step(
        teng.init_state(e, m, s, device="cpu"), torch.from_numpy(elect),
        torch.from_numpy(cand), tz, tz, tz,
        torch.zeros((0, e), dtype=torch.bool), torch.from_numpy(up))
    _assert_state_equal(js, ts, "k0")
    _assert_result_equal(jr, tr, "k0")
    np.testing.assert_array_equal(np.asarray(jw), tw.numpy())


def test_reset_rows_gather_and_merge_match_jax(ref):
    jnp, jeng = ref.jnp, ref.jeng
    e, m, s, k = 6, 3, 16, 3
    rng = np.random.default_rng(11)
    js = jeng.init_state(e, m, s)
    ts = teng.init_state(e, m, s, device="cpu")
    for _ in range(3):
        planes = _stream(rng, e, m, s, k)
        js, _, jr = jeng.full_step(js, *(jnp.asarray(p) for p in planes[:7]))
        ts, _, tr = teng.full_step(
            ts, *(torch.from_numpy(p) for p in planes[:7]))
    mask = rng.random(e) < 0.5
    view = rng.random((e, m)) < 0.7
    js = jeng.reset_rows(js, jnp.asarray(mask), jnp.asarray(view))
    ts = teng.reset_rows(ts, torch.from_numpy(mask), torch.from_numpy(view))
    _assert_state_equal(js, ts, "reset")
    idx = np.array([4, 0, 0, 5], np.int32)
    _assert_result_equal(
        jeng.gather_result_columns(jr, jnp.asarray(idx)),
        teng.gather_result_columns(tr, torch.from_numpy(idx)), "gather")
    cur = rng.integers(-2 ** 31, 2 ** 31, 200, dtype=np.int64).astype(np.int32)
    op = rng.integers(-2 ** 31, 2 ** 31, 200, dtype=np.int64).astype(np.int32)
    mcls = rng.integers(0, 5, 200).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jeng.merge_vals(jnp.asarray(cur), jnp.asarray(mcls),
                                   jnp.asarray(op))),
        teng.merge_vals(torch.from_numpy(cur), torch.from_numpy(mcls),
                        torch.from_numpy(op)).numpy())


def test_interop_round_trip_is_bit_exact(ref):
    jnp, jeng = ref.jnp, ref.jeng
    e, m, s = 4, 3, 16
    rng = np.random.default_rng(2)
    js = jeng.init_state(e, m, s, views=[[0, 1], [1, 2]])
    # every uint32 edge value in the tree planes
    leaf = rng.integers(0, 2 ** 32, js.tree_leaf.shape, dtype=np.uint32)
    leaf.reshape(-1)[:4] = [0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]
    js = js._replace(tree_leaf=jnp.asarray(leaf),
                     obj_val=jnp.asarray(rng.integers(
                         -2 ** 31, 2 ** 31, (e, m, s), dtype=np.int64)
                         .astype(np.int32)))
    ts = interop.state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in js._fields}, device="cpu")
    assert ts.tree_leaf.dtype == torch.int32
    back = interop.state_to_numpy(ts)
    _assert_state_equal(js, ts, "round trip")
    again = jeng.EngineState(*(jnp.asarray(a) for a in back))
    for f in js._fields:
        assert np.asarray(getattr(again, f)).dtype == \
            np.asarray(getattr(js, f)).dtype
    # from_numpy copies: the port's in-place rounds cannot write back
    src = interop.state_to_numpy(ts)
    ts2 = interop.state_from_numpy(src, device="cpu")
    ts2.obj_val.add_(1)
    assert np.array_equal(src.obj_val, back.obj_val)
    planes = _stream(rng, e, m, s, 2)
    _, _, jr = jeng.full_step(js, *(jnp.asarray(p) for p in planes[:7]))
    tr = interop.result_from_numpy(
        {f: np.asarray(getattr(jr, f)) for f in jr._fields}, device="cpu")
    _assert_result_equal(jr, tr, "result round trip")
