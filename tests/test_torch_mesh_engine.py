"""The port's mesh engine against the JAX package's engine, plane for plane.

Mirrors of ``tests/test_engine.py``'s sharded cases (``:242`` at the
mesh shapes (8, 1), (4, 2), (2, 4) and (1, 8), ``:305``, ``:465``): the
port's :class:`ShardedEngine` over eight ``cpu`` shards (the stand-in for
the reference tests' eight virtual CPU devices; no ``XLA_FLAGS`` for the
port) runs the scenario on numpy-seeded inputs, and every output and
state plane must equal the JAX package's UNSHARDED engine on the same
inputs — the reference's own mesh tests hold those equal to its
``ShardedEngine``.  One case also holds the port's (4, 2) mesh against
the JAX ``ShardedEngine`` on the virtual 8-device mesh, block by block,
so that a layout slip (which peer shard holds a global index) cannot
hide behind the gathered arrays.

Tolerance: exact equality everywhere.
"""

import types

import numpy as np
import pytest
import torch

from riak_ensemble_tpu_torch import interop
from riak_ensemble_tpu_torch.ops import engine as teng
from riak_ensemble_tpu_torch.parallel.mesh import (
    Sharded, ShardedEngine, make_mesh)

S = 16
E, M = 8, 8
VIEWS = [list(range(5))]     # a 5-member view inside an 8-wide peer axis


@pytest.fixture
def ref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from riak_ensemble_tpu.ops import engine as jeng
    from riak_ensemble_tpu.parallel import mesh as jmesh
    return types.SimpleNamespace(jax=jax, jnp=jnp, jeng=jeng, jmesh=jmesh)


def cpu_mesh(n_ens, n_peer):
    return ShardedEngine(make_mesh(n_ens, n_peer,
                                   devices=["cpu"] * (n_ens * n_peer)))


def as_np(x):
    """A JAX array, a port tensor or a port mesh output as numpy."""
    if isinstance(x, Sharded):
        x = x.gather()
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def assert_tree_equal(a, b, tag):
    """Equal leaves of two output tuples (JAX against the port), the
    port's int32 tree planes compared as the JAX uint32 bits."""
    assert len(a) == len(b), tag
    for i, (x, y) in enumerate(zip(a, b)):
        xa, ya = np.asarray(x), as_np(y)
        if xa.dtype == np.uint32:
            ya = ya.view(np.uint32)
        assert xa.shape == ya.shape and np.array_equal(xa, ya), (tag, i)


def flat(out):
    """Leaves of nested (state, result) tuples in order."""
    leaves = []
    for x in out:
        if isinstance(x, tuple) or hasattr(x, "_fields"):
            leaves.extend(flat(tuple(x)))
        else:
            leaves.append(x)
    return leaves


def scenario(stepper, state, to):
    """test_engine.py:242's run: an election, puts and a get, a second
    election, reads with a peer down (the mixed-epoch latest-object
    chain and the stale-epoch rewrite under peer sharding)."""
    rng = np.random.default_rng(5)
    k = 3
    up = np.ones((E, M), bool)
    state, won = stepper.elect_step(state, to(np.ones(E, bool)),
                                    to(np.zeros(E, np.int32)), to(up))
    kind = np.array([[teng.OP_PUT] * E, [teng.OP_PUT] * E,
                     [teng.OP_GET] * E], np.int32)
    slot = rng.integers(0, S, (1, E)).repeat(k, 0).astype(np.int32)
    val = rng.integers(1, 1000, (k, E)).astype(np.int32)
    lease = np.ones((k, E), bool)
    state, res1 = stepper.kv_step_scan(state, to(kind), to(slot), to(val),
                                       to(lease), to(up))
    state, won2 = stepper.elect_step(state, to(np.ones(E, bool)),
                                     to(np.zeros(E, np.int32)), to(up))
    up2 = np.tile(np.array([1, 0, 1, 1, 1, 1, 1, 1], bool), (E, 1))
    kind2 = np.full((k, E), teng.OP_GET, np.int32)
    state, res2 = stepper.kv_step_scan(state, to(kind2), to(slot), to(val),
                                       to(lease), to(up2))
    return (won, res1, won2, res2, state)


class _Jax:
    def __init__(self, ref):
        self.elect_step = ref.jeng.elect_step
        self.kv_step_scan = ref.jeng.kv_step_scan
        self.reconfig_step = ref.jeng.reconfig_step


def jax_to(ref):
    return ref.jnp.asarray


def torch_to(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_matches_single_device(ref, mesh_shape):
    want = scenario(_Jax(ref), ref.jeng.init_state(E, M, S, views=VIEWS),
                    jax_to(ref))
    se = cpu_mesh(*mesh_shape)
    got = scenario(se, se.init_state(E, M, S, views=VIEWS), torch_to)
    assert_tree_equal(flat(want), flat(got), mesh_shape)
    won, _, won2, res2, _ = want
    assert np.asarray(won2).all() and np.asarray(res2.get_ok).all()
    assert np.asarray(res2.found).all()
    np.testing.assert_array_equal(np.asarray(res2.obj_vsn[..., 0]),
                                  2 * np.ones((3, E)))


@pytest.mark.parametrize("mesh_shape", [(4, 2), (8, 1)])
def test_sharded_reconfig_matches_single_device(ref, mesh_shape):
    up = np.ones((E, M), bool)
    new_view = np.tile(np.array([1, 1, 1, 0, 0, 0, 0, 0], bool), (E, 1))

    def run(stepper, state, to):
        state, won = stepper.elect_step(state, to(np.ones(E, bool)),
                                        to(np.zeros(E, np.int32)), to(up))
        state, inst, _ = stepper.reconfig_step(state, to(np.ones(E, bool)),
                                               to(new_view), to(up))
        state, _, coll = stepper.reconfig_step(state, to(np.zeros(E, bool)),
                                               to(new_view), to(up))
        return won, inst, coll, state

    want = run(_Jax(ref), ref.jeng.init_state(E, M, S, views=VIEWS),
               jax_to(ref))
    se = cpu_mesh(*mesh_shape)
    got = run(se, se.init_state(E, M, S, views=VIEWS), torch_to)
    assert_tree_equal(flat(want), flat(got), mesh_shape)
    won, inst, coll, state = want
    assert np.asarray(won).all() and np.asarray(inst).all()
    assert np.asarray(coll).all()
    vm = np.asarray(state.view_mask)
    assert vm[:, 0, :3].all() and not vm[:, 0, 3:].any()
    assert not vm[:, 1, :].any()


def test_sharded_cas_matches_single_device(ref):
    """test_engine.py:465 at (4, 2): put, a matching CAS, a stale CAS,
    a get."""
    up = np.ones((E, M), bool)
    kind = np.stack([np.full(E, teng.OP_PUT), np.full(E, teng.OP_CAS),
                     np.full(E, teng.OP_CAS),
                     np.full(E, teng.OP_GET)]).astype(np.int32)
    slot = np.ones((4, E), np.int32)
    val = np.stack([np.full(E, 5), np.full(E, 6), np.full(E, 7),
                    np.zeros(E)]).astype(np.int32)
    xe = np.ones((4, E), np.int32)
    xs = np.stack([np.zeros(E), np.ones(E), np.ones(E),
                   np.zeros(E)]).astype(np.int32)
    lease = np.ones((4, E), bool)

    def run(stepper, state, to):
        state, won = stepper.elect_step(state, to(np.ones(E, bool)),
                                        to(np.zeros(E, np.int32)), to(up))
        state, res = stepper.kv_step_scan(
            state, to(kind), to(slot), to(val), to(lease), to(up),
            exp_epoch=to(xe), exp_seq=to(xs))
        return won, res, state

    want = run(_Jax(ref), ref.jeng.init_state(E, M, S, views=VIEWS),
               jax_to(ref))
    se = cpu_mesh(4, 2)
    got = run(se, se.init_state(E, M, S, views=VIEWS), torch_to)
    assert_tree_equal(flat(want), flat(got), "cas")
    committed = np.asarray(want[1].committed)
    assert committed[1].all() and not committed[2].any()
    np.testing.assert_array_equal(np.asarray(want[1].value[3]), 6)


def test_layout_matches_jax_sharded_engine(ref):
    """The port's (4, 2) mesh against the JAX ``ShardedEngine`` on the
    virtual 8-device mesh, block by block: each port shard (i, j) must
    hold exactly the block of the JAX array that the JAX mesh's device
    (i, j) holds — which peer shard holds a global index included.  The
    scenario starts from a seeded random store (via
    :func:`interop.mesh_state_from_numpy`), runs a fused ``full_step``
    with random ops, up-masks and elections, and compares the state's
    and the results' blocks."""
    jax = ref.jax
    if jax.device_count() < 8:
        pytest.skip("needs the 8 virtual devices")
    rng = np.random.default_rng(17)
    jse = ref.jmesh.ShardedEngine(ref.jmesh.make_mesh(4, 2))
    se = cpu_mesh(4, 2)
    k = 4
    st = ref.jeng.init_state(E, M, S, views=VIEWS)
    st, _ = ref.jeng.elect_step(st, ref.jnp.ones(E, bool),
                                ref.jnp.asarray(rng.integers(0, 5, E),
                                                ref.jnp.int32),
                                ref.jnp.ones((E, M), bool))
    kind = rng.integers(0, 5, (k, E)).astype(np.int32)
    slot = rng.integers(-1, S + 1, (k, E)).astype(np.int32)
    val = rng.integers(0, 50, (k, E)).astype(np.int32)
    lease = rng.random((k, E)) < 0.5
    up = rng.random((E, M)) < 0.85
    elect = rng.random(E) < 0.3
    cand = rng.integers(0, M, E).astype(np.int32)
    xe = rng.integers(0, 3, (k, E)).astype(np.int32)
    xs = rng.integers(0, 3, (k, E)).astype(np.int32)
    args = (elect, cand, kind, slot, val, lease, up)
    jst, jwon, jres = jse.full_step(jse.shard_state(st),
                                    *map(ref.jnp.asarray, args),
                                    exp_epoch=ref.jnp.asarray(xe),
                                    exp_seq=ref.jnp.asarray(xs))
    ms = interop.mesh_state_from_numpy(
        {f: np.asarray(getattr(st, f)) for f in st._fields}, se)
    tst, twon, tres = se.full_step(ms, *map(torch_to, args),
                                   exp_epoch=torch_to(xe),
                                   exp_seq=torch_to(xs))
    grid = np.asarray(jse.mesh.devices)
    pos = {d: (i, j) for (i, j), d in np.ndenumerate(grid)}
    pairs = [(getattr(jst, f), getattr(tst, f), f) for f in st._fields]
    pairs += [(jwon, twon, "won")]
    pairs += [(getattr(jres, f), getattr(tres, f), f)
              for f in jres._fields]
    checked = 0
    for jarr, tarr, name in pairs:
        for sh in jarr.addressable_shards:
            block = np.asarray(sh.data)
            mine = tarr.blocks[pos[sh.device]].numpy()
            if block.dtype == np.uint32:
                mine = mine.view(np.uint32)
            assert block.shape == mine.shape, name
            assert np.array_equal(block, mine), (name, pos[sh.device])
            checked += 1
    assert checked == 8 * len(pairs)
    assert np.asarray(jres.committed).any()
