"""Sharded host passes in the port (``resolve_shards=N``, the reference's
``RETPU_RESOLVE_SHARDS``) on the CPU:

- the port at ``resolve_shards`` in {2, 4} against the JAX service under
  the same ``RETPU_RESOLVE_SHARDS``, on seeded keyed streams at depths 1
  and 2, with and without wide rounds, and on the oracle arm (which has
  no C++ pass to shard): futures, packed buffers, engine state, mirror
  slabs, counters and ``sharded_flushes`` equal;
- the port at N against the port at 1 on the same stream and on a bulk
  ``execute``: state-identical, futures equal;
- the pool is made on the first sharded pass and torn down by ``stop()``.

Tolerance: exact equality.
"""

import numpy as np
import pytest

from riak_ensemble_tpu_torch import interop
from riak_ensemble_tpu_torch.ops import engine as teng
from riak_ensemble_tpu_torch.parallel import batched_host as tb
from test_torch_compaction import norm
from test_torch_kmodify import FixedClock, _record_packed
from test_torch_native_enqueue import COUNTERS, MIRRORS, PORT_KW, Pair, \
    _jax_env, _stream
from test_torch_reference_natives import reference_natives  # noqa: F401 (autouse)

pytest.importorskip("jax")
from riak_ensemble_tpu.parallel import batched_host as jb  # noqa: E402


class ShardPair(Pair):
    """The JAX service under ``RETPU_RESOLVE_SHARDS=shards`` and the port's
    with ``resolve_shards=shards`` (``Pair``'s lockstep and checks)."""

    def __init__(self, monkeypatch, shards, arm="default", depth=1,
                 wide=False, e=256, m=3, s=16, k=4):
        _jax_env(monkeypatch, arm, True, True)
        monkeypatch.setenv("RETPU_RESOLVE_SHARDS", str(shards))
        if wide:
            monkeypatch.setenv("RETPU_WIDE", "1")
        self.js = jb.BatchedEnsembleService(
            FixedClock(), e, m, s, tick=None, max_ops_per_tick=k,
            pipeline_depth=depth)
        self.ts = tb.BatchedEnsembleService(
            FixedClock(), e, m, s, tick=None, max_ops_per_tick=k,
            device="cpu", pipeline_depth=depth, wide=wide,
            resolve_shards=shards, **PORT_KW[arm])
        self.bufs = ([], [])
        _record_packed(self.js, self.bufs[0])
        _record_packed(self.ts, self.bufs[1])
        self.futs = ([], [])

    def check(self):
        super().check()
        js, ts = self.js, self.ts
        assert ts.sharded_flushes == js.sharded_flushes
        assert ts.wide_launches == js.wide_launches
        assert ts.stats()["resolve_shards"] == js.stats()["resolve_shards"]


@pytest.mark.parametrize("shards,depth,wide", [
    (2, 1, False), (4, 2, False), (4, 1, True)])
def test_sharded_service_matches_jax(monkeypatch, shards, depth, wide):
    p = ShardPair(monkeypatch, shards, depth=depth, wide=wide)
    p.run(seed=50 + shards + depth, rounds=5)
    p.check()
    ts = p.ts
    assert ts.stats()["resolve_shards"]["shards"] == shards
    assert ts.sharded_flushes > 0 and ts._resolve_pool is not None
    if wide:
        assert ts.wide_launches > 0
    ts.stop()
    p.js.stop()
    assert ts._resolve_pool is None


def test_oracle_arm_has_nothing_to_shard(monkeypatch):
    p = ShardPair(monkeypatch, 4, arm="oracle")
    p.run(seed=57, rounds=4)
    p.check()
    assert p.ts.sharded_flushes == 0 and p.ts._resolve_pool is None


def _drive_same(svcs, seed, rounds=4, n_active=24):
    """The same seeded keyed stream through every service in ``svcs``."""
    rng = np.random.default_rng(seed)
    ens = rng.choice(svcs[0].n_ens, n_active, replace=False).tolist()
    futs = [[] for _ in svcs]
    for r in range(rounds):
        state = rng.bit_generator.state
        for i, svc in enumerate(svcs):
            rng.bit_generator.state = state
            _stream(rng, svc, ens, r, futs[i])
        for _ in range(6):
            served = {svc.flush() for svc in svcs}
            assert len(served) == 1
        for svc in svcs:
            svc.runtime.now += 0.25
    return futs


@pytest.mark.parametrize("shards", (2, 4))
def test_sharded_equals_one_shard(shards):
    svcs = [tb.BatchedEnsembleService(
        FixedClock(), 256, 3, 16, tick=None, max_ops_per_tick=4,
        device="cpu", resolve_shards=n) for n in (1, shards)]
    futs = _drive_same(svcs, seed=60 + shards)
    one, many = svcs
    assert all(f.done for fl in futs for f in fl)
    assert [norm(f.value) for f in futs[1]] == [norm(f.value)
                                                for f in futs[0]]
    # a bulk execute: its settle scatters the mirrors sharded too
    rng = np.random.default_rng(shards)
    kind = rng.choice([teng.OP_PUT, teng.OP_GET, teng.OP_NOOP],
                      (4, 256)).astype(np.int32)
    slot = rng.integers(0, 16, (4, 256)).astype(np.int32)
    val = rng.integers(1, 99, (4, 256)).astype(np.int32)
    outs = [svc.execute(kind, slot, val) for svc in svcs]
    for a, b in zip(*outs):
        assert np.array_equal(a, b)
    a, b = (interop.state_to_numpy(svc.state) for svc in svcs)
    for f in a._fields:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    for name in MIRRORS + ("leader_np", "lease_until", "_corrupt_rows"):
        assert np.array_equal(getattr(one, name), getattr(many, name)), name
    for name in COUNTERS + ("key_slot", "slot_handle", "flushes",
                            "ops_served", "payload_bytes"):
        assert getattr(one, name) == getattr(many, name), name
    assert one.sharded_flushes == 0 < many.sharded_flushes
    assert many.stats()["resolve_shards"] == {
        "shards": shards, "sharded_flushes": many.sharded_flushes}


def test_pool_is_lazy_and_stop_tears_it_down():
    svc = tb.BatchedEnsembleService(FixedClock(), 8, 3, 16, tick=None,
                                    max_ops_per_tick=4, device="cpu",
                                    resolve_shards=3)
    assert svc._resolve_pool is None
    futs = [svc.kput_many(e, ["a", "b"], [b"1", b"2"]) for e in range(8)]
    while not all(f.done for f in futs):
        svc.flush()
    pool = svc._resolve_pool
    assert pool is not None and svc.sharded_flushes > 0
    threads = list(pool._threads)
    svc.stop()
    assert svc._resolve_pool is None and pool._shutdown
    assert not any(t.is_alive() for t in threads)
    # one shard, or one descriptor, never makes a pool
    assert svc._shard_bounds(1) is None
    assert svc._shard_bounds(10) == [(0, 4), (4, 8), (8, 10)]
    one = tb.BatchedEnsembleService(FixedClock(), 8, 3, 16, tick=None,
                                    max_ops_per_tick=4, device="cpu")
    assert one._shard_bounds(10) is None
