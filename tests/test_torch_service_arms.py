"""Keyed streams and batch CAS / delete on the port's service against the JAX
service on every host arm (the shared helpers are in
``test_torch_service.py``).
"""

import numpy as np
import pytest

from riak_ensemble_tpu_torch import interop
from test_torch_reference_natives import reference_natives  # noqa: F401 (autouse)
from test_torch_service import (
    _batch_cas_delete_stream, _note_vsns, _submit, services)


@pytest.mark.parametrize("e,m,s,k,seed,compact", [
    (6, 5, 16, 8, 1, False), (4, 3, 8, 4, 2, False),
    (24, 3, 8, 4, 3, True)], ids=["oracle-1", "oracle-2", "default-arm"])
def test_keyed_stream_matches_jax_oracle_arm(services, e, m, s, k, seed,
                                             compact):
    make, norm = services
    js, ts, clocks, bufs = make(e, m, s, k, compact)
    rng = np.random.default_rng(seed)
    futs = ([], [])
    for step in range(30):
        for _ in range(int(rng.integers(1, 14))):
            ens = int(rng.integers(0, e))
            key = f"k{int(rng.integers(0, 3 * s // 2))}"
            draw = (int(rng.integers(0, 8)),
                    (int(rng.integers(0, 3)), int(rng.integers(0, 4))),
                    bool(rng.integers(0, 2)), f"v{step}")
            for i, svc in enumerate((js, ts)):
                futs[i].append(_submit(svc, draw, ens, key))
        if step % 6 == 2:
            ens, p = int(rng.integers(0, e)), int(rng.integers(0, m))
            up = bool(rng.integers(0, 3))   # mostly back up, some down
            for svc in (js, ts):
                svc.set_peer_up(ens, p, up)
        if step % 5 == 4:
            kk = 3
            kind = rng.integers(0, 5, (kk, e)).astype(np.int32)
            slot = rng.integers(-1, s, (kk, e)).astype(np.int32)
            val = rng.integers(0, 99, (kk, e)).astype(np.int32)
            xe = rng.integers(0, 9, (kk, e)).astype(np.int32)
            a = js.execute(kind, slot, val, xe)
            b = ts.execute(kind, slot, val, xe)
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and np.array_equal(x, y)
        js.flush()
        ts.flush()
        for c in clocks:
            c.now += 0.4
    while any(js.queues) or any(ts.queues):
        js.flush()
        ts.flush()
    # an idle flush that must still elect (a down leader)
    leaders = js.leader_np.copy()
    for svc in (js, ts):
        svc.up[:] = True
        svc.set_peer_up(0, int(leaders[0]), False)
        assert svc.flush() == 0
    assert js.leader_np[0] not in (-1, leaders[0])

    assert all(f.done for fl in futs for f in fl)
    got_j = [norm(f.value) for f in futs[0]]
    got_t = [norm(f.value) for f in futs[1]]
    assert got_t == got_j
    assert len(bufs[0]) == len(bufs[1]) > 30
    for i, (a, b) in enumerate(zip(*bufs)):
        assert a.dtype == b.dtype == np.uint8, i
        assert np.array_equal(a, b), f"packed buffer {i} differs"
    tn = interop.state_to_numpy(ts.state)
    for f in tn._fields:
        assert np.array_equal(np.asarray(getattr(js.state, f)),
                              getattr(tn, f)), f
    # host bookkeeping agrees too
    assert np.array_equal(js.leader_np, ts.leader_np)
    assert np.array_equal(js.lease_until, ts.lease_until)
    assert js.key_slot == ts.key_slot and js.slot_handle == ts.slot_handle
    assert js.values == ts.values and js.ops_served == ts.ops_served
    assert js.flushes == ts.flushes
    assert js.payload_bytes == ts.payload_bytes
    if compact:
        assert ts.payload_bytes < ts.payload_bytes_full_width
    # the stream really committed, failed, elected and hit tombstones
    flat = [r for v in got_t for r in (v if isinstance(v, list) else [v])]
    assert any(r == "failed" for r in flat)
    assert any(isinstance(r, tuple) and r[1] == "NOTFOUND" for r in flat)
    assert sum(isinstance(r, tuple) and r[0] == "ok" for r in flat) > 50


@pytest.mark.parametrize("arm,depth", [("default", 1), ("default", 2),
                                       ("oracle", 1), ("plain", 1),
                                       ("plain", 2)])
def test_batch_cas_and_delete_match_jax_on_every_arm(monkeypatch, arm,
                                                     depth):
    """``kupdate_many`` and ``kdelete_many`` through the pending slab and
    the completion slab (native and plain passes) and through the
    per-op resolve (oracle arm), against the JAX service on the same arm
    and depth, compaction on (sliced launches at E = 256): every future,
    packed buffer, mirror slab, the engine state and the counters
    equal."""
    pytest.importorskip("jax")
    from riak_ensemble_tpu.parallel import batched_host as jb
    from test_torch_native_enqueue import Pair
    p = Pair(jb, monkeypatch, arm, depth=depth, k=4)
    rng = np.random.default_rng(5)
    ens = rng.choice(p.js.n_ens, 12, replace=False).tolist()
    vsns = ({}, {})
    for r in range(8):
        state = rng.bit_generator.state
        calls = []
        for i, svc in enumerate((p.js, p.ts)):
            rng.bit_generator.state = state
            calls.append(_batch_cas_delete_stream(rng, svc, ens, r,
                                                  vsns[i]))
            p.futs[i].extend(f for f, _e, _k in calls[i])
        while any(p.js.queues) or any(p.ts.queues):
            assert p.js.flush() == p.ts.flush()
        assert p.js.flush() == p.ts.flush()
        for i, svc in enumerate((p.js, p.ts)):
            _note_vsns(calls[i], vsns[i])
            svc.runtime.now += 0.25
    assert vsns[1] == vsns[0] and len(vsns[1]) > 20
    p.check()
    assert p.ts.completion_wakes == p.js.completion_wakes
