"""The mesh's integrity, membership, wide and checkpoint paths against the
JAX package, and the mesh's own contracts.

Mirrors, each on numpy-seeded inputs with the port's mesh over ``cpu``
shards held exactly against the JAX package's unsharded engine:

- ``tests/test_engine_integrity.py:375`` — elect, puts, a diverged
  replica, the anti-entropy exchange and the tree sweep at (4, 2);
- ``tests/test_engine_reconfig.py:269`` — ``reconfig_propose`` and
  ``reconfig_transition`` at (4, 2);
- ``tests/test_engine_wide.py:158`` — a fused ``full_step_wide`` with
  half the rows re-electing, at (4, 2) and (8, 1);
- ``tests/test_checkpoint.py:45`` — a mesh state saved through
  :mod:`..ops.checkpoint` loads as one state and places back bit-equal,
  and keeps serving.

And the mesh's own contracts: ``mesh_engine`` on a box without CUDA
raises unless it is given ``cpu`` devices, asks naming the count, and a
fault in one peer shard's thread raises in the caller instead of
hanging the row at its barrier.

Tolerance: exact equality everywhere.
"""

import numpy as np
import pytest
import torch

from riak_ensemble_tpu_torch import interop
from riak_ensemble_tpu_torch.ops import checkpoint
from riak_ensemble_tpu_torch.ops import engine as teng
from riak_ensemble_tpu_torch.parallel import mesh as tmesh
from test_torch_mesh_engine import (
    _Jax, assert_tree_equal, cpu_mesh, flat, jax_to, ref,  # noqa: F401
    torch_to)

VIEWS = [list(range(5))]


def test_sharded_integrity_matches_single_device(ref):
    e, m, s = 8, 8, 16
    up = np.ones((e, m), bool)
    k = 2
    kind = np.full((k, e), teng.OP_PUT, np.int32)
    slot = np.broadcast_to(np.array([3, 7], np.int32)[:, None],
                           (k, e)).copy()
    val = (np.arange(k * e).reshape(k, e) + 1).astype(np.int32)
    lease = np.ones((k, e), bool)

    def drive(stepper, state, to, diverge):
        state, won = stepper.elect_step(state, to(np.ones(e, bool)),
                                        to(np.zeros(e, np.int32)), to(up))
        state, res = stepper.kv_step_scan(state, to(kind), to(slot),
                                          to(val), to(lease), to(up))
        state = diverge(state)
        state, diverged, synced = stepper.exchange_step(
            state, to(np.ones(e, bool)), to(up))
        nb, lb = stepper.verify_trees(state)
        return won, res, diverged, synced, nb, lb, state

    class J(_Jax):
        exchange_step = staticmethod(ref.jeng.exchange_step)
        verify_trees = staticmethod(ref.jeng.verify_trees)

    want = drive(J(ref), ref.jeng.init_state(e, m, s, views=VIEWS),
                 jax_to(ref),
                 lambda st: st._replace(obj_val=st.obj_val.at[:, 1, 3]
                                        .set(999)))
    se = cpu_mesh(4, 2)

    def diverge(ms):
        # replica 1 lives on peer shard 0 of every row
        for (i, j), st in ms.shards.items():
            if j == 0:
                st.obj_val[:, 1, 3] = 999
        return ms
    got = drive(se, se.init_state(e, m, s, views=VIEWS), torch_to, diverge)
    assert_tree_equal(flat(want), flat(got), "integrity")
    won, res, diverged, synced, nb, lb, _ = want
    assert np.asarray(won).all() and np.asarray(res.committed).all()
    dv = np.asarray(diverged)
    assert dv[:, 1].all() and not dv[:, 0].any()
    assert not np.asarray(nb).any() and not np.asarray(lb).any()


def test_sharded_general_reconfig_matches_single(ref):
    e, m = 8, 8
    up = np.ones((e, m), bool)
    nv = np.tile([1, 1, 1, 0, 0, 0, 0, 0], (e, 1)).astype(bool)

    def run(stepper, state, to):
        state, won = stepper.elect_step(state, to(np.ones(e, bool)),
                                        to(np.zeros(e, np.int32)), to(up))
        state, inst = stepper.reconfig_propose(
            state, to(np.ones(e, bool)), to(nv), to(np.ones(e, np.int32)),
            to(up))
        state, coll = stepper.reconfig_transition(
            state, to(np.ones(e, bool)), to(up))
        return won, inst, coll, state

    class J(_Jax):
        reconfig_propose = staticmethod(ref.jeng.reconfig_propose)
        reconfig_transition = staticmethod(ref.jeng.reconfig_transition)

    want = run(J(ref), ref.jeng.init_state(e, m, 8, views=VIEWS),
               jax_to(ref))
    se = cpu_mesh(4, 2)
    got = run(se, se.init_state(e, m, 8, views=VIEWS), torch_to)
    assert_tree_equal(flat(want), flat(got), "reconfig")
    won, inst, coll, state = want
    assert np.asarray(won).all() and np.asarray(inst).all()
    assert np.asarray(coll).all()
    np.testing.assert_array_equal(np.asarray(state.commit_vsn), 1)


@pytest.mark.parametrize("mesh_shape", [(4, 2), (8, 1)])
def test_wide_sharded_matches_local(ref, mesh_shape):
    """``full_step_wide`` on the mesh equals the JAX ``full_step_wide``:
    the wide rounds' peer collectives keep the exact semantics."""
    e, m, s, g, w = 8, 4, 16, 2, 4
    rng = np.random.default_rng(13)
    st = ref.jeng.init_state(e, m, s)
    up = np.ones((e, m), bool)
    st, won0 = ref.jeng.elect_step(st, ref.jnp.ones(e, bool),
                                   ref.jnp.zeros(e, ref.jnp.int32),
                                   ref.jnp.asarray(up))
    assert np.asarray(won0).all()
    kind = rng.choice([teng.OP_NOOP, teng.OP_GET, teng.OP_PUT],
                      (g, e, w)).astype(np.int32)
    slot = np.stack([np.stack([rng.permutation(s)[:w] for _ in range(e)])
                     for _ in range(g)]).astype(np.int32)
    val = rng.integers(1, 99, (g, e, w)).astype(np.int32)
    lease = rng.random((g, e, w)) < 0.5
    elect = np.arange(e) % 2 == 0
    cand = np.ones(e, np.int32)
    args = (elect, cand, kind, slot, val, lease, up)
    st_a, won_a, res_a = ref.jeng.full_step_wide(
        st, *map(ref.jnp.asarray, args))
    se = cpu_mesh(*mesh_shape)
    ms = interop.mesh_state_from_numpy(
        {f: np.asarray(getattr(st, f)) for f in st._fields}, se)
    st_b, won_b, res_b = se.full_step_wide(ms, *map(torch_to, args))
    assert_tree_equal(flat((won_a, res_a, st_a)), flat((won_b, res_b, st_b)),
                      mesh_shape)
    assert np.asarray(won_a)[::2].all()          # elections really ran
    assert np.asarray(res_a.committed).any()


def test_save_restore_sharded_state(ref, tmp_path):
    """A mesh state checkpoints as the one state it shards, restores into
    the mesh bit-equal, keeps serving, and equals the JAX package's
    state after the same steps."""
    e, m = 8, 4
    se = cpu_mesh(4, 2)
    up = np.ones((e, m), bool)
    kind = np.full((2, e), teng.OP_PUT, np.int32)
    slot = np.zeros((2, e), np.int32)
    val = (np.arange(2 * e).reshape(2, e) + 1).astype(np.int32)
    lease = np.ones((2, e), bool)

    def steps(stepper, state, to):
        state, _ = stepper.elect_step(state, to(np.ones(e, bool)),
                                      to(np.zeros(e, np.int32)), to(up))
        state, _ = stepper.kv_step_scan(state, to(kind), to(slot), to(val),
                                        to(lease), to(up))
        return state

    state = steps(se, se.init_state(e, m, 8, views=[list(range(m))]),
                  torch_to)
    path = str(tmp_path / "sharded")
    checkpoint.save_state(path, state)
    one = checkpoint.load_state(path, "cpu")
    restored = se.shard_state(one)
    for a, b in zip(state, restored):
        assert torch.equal(a.gather(), b.gather())
    jst = steps(_Jax(ref), ref.jeng.init_state(e, m, 8,
                                               views=[list(range(m))]),
                jax_to(ref))
    assert_tree_equal(tuple(jst), tuple(one), "checkpoint")
    gk = np.full((1, e), teng.OP_GET, np.int32)
    _, res = se.kv_step_scan(restored, torch_to(gk),
                             torch.zeros((1, e), dtype=torch.int32),
                             torch.zeros((1, e), dtype=torch.int32),
                             torch.ones((1, e), dtype=torch.bool),
                             torch_to(up))
    assert res.get_ok.numpy().all()
    np.testing.assert_array_equal(res.value.numpy()[0], val[1])


def test_mesh_engine_devices_and_errors(monkeypatch):
    """``mesh_engine`` takes the first n cards; without CUDA (or asked
    for more than ``torch.cuda.device_count()``) it raises naming the
    count, unless it is given the devices; the grid is 'peer'-innermost
    and may repeat a device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="sees 0 CUDA"):
        tmesh.mesh_engine(4)
    with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
        tmesh.make_mesh(2, 1)
    with pytest.raises(ValueError, match="divide"):
        tmesh.mesh_engine(6, n_peer=4, devices=["cpu"] * 6)
    se = tmesh.mesh_engine(8, n_peer=2, devices=["cpu"] * 8)
    assert se.mesh.shape == {"ens": 4, "peer": 2}
    assert (se.n_ens_shards, se.n_peer_shards) == (4, 2)
    assert se.mesh.local_shards() == [(i, j) for i in range(4)
                                      for j in range(2)]
    assert se.device == torch.device("cpu")
    with pytest.raises(ValueError, match="divide"):
        se.init_state(6, 4, 8)


def test_peer_shard_fault_raises_instead_of_hanging(monkeypatch):
    """A step that fails in one peer shard's thread aborts its row's
    barrier: the caller sees the shard's own exception, promptly, and
    the engine keeps working afterwards."""
    se = cpu_mesh(2, 4)
    st = se.init_state(8, 4, 8)
    real = teng.elect_step

    def flaky(state, elect, cand, up, axis=None):
        if axis is not None and axis.index == 2:
            raise RuntimeError("injected shard fault")
        return real(state, elect, cand, up, axis)
    monkeypatch.setattr(teng, "elect_step", flaky)
    args = (torch.ones(8, dtype=torch.bool),
            torch.zeros(8, dtype=torch.int32),
            torch.ones((8, 4), dtype=torch.bool))
    with pytest.raises(RuntimeError, match="injected shard fault"):
        se.elect_step(st, *args)
    monkeypatch.setattr(teng, "elect_step", real)
    st, won = se.elect_step(st, *args)
    assert won.numpy().all()
