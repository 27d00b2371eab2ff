"""The launch pipeline against the JAX service: depth 2 on a queued stream,
``execute_async``, injected launch failures, a failed settle and a read of
an unsettled write (the other pipeline cases and the shared helpers are in
``test_torch_pipeline.py``).
"""

import numpy as np
import pytest

from riak_ensemble_tpu_torch import funref as tfunref
from riak_ensemble_tpu_torch.ops import engine as teng
from riak_ensemble_tpu_torch.parallel import batched_host as tb
from test_torch_compaction import Lockstep, norm
from test_torch_kmodify import FixedClock
from test_torch_reference_natives import reference_natives  # noqa: F401 (autouse)
from test_torch_pipeline import _exec_planes, _stream, drain, jb, make


def test_execute_async_matches_execute_and_jax(jb):
    """One op stream through the port at depth 1 (``execute``), the port
    at depth 2 (``execute_async``) and the JAX service at depth 2
    (``execute_async``): identical result planes and final states.  At
    E = 256 the sparse batches slice."""
    from riak_ensemble_tpu_torch import interop
    outs = {}
    states = {}
    e = 256
    batches = []
    for i in range(5):
        kind, slot, val = _exec_planes(e, 8, 4, seed=i)
        if i:                                # sparse: 20 active columns
            idle = np.random.default_rng(50 + i).permutation(e)[20:]
            kind[:, idle] = teng.OP_NOOP
        batches.append((kind, slot, val))
    for arm in ("port1", "port2", "jax2"):
        if arm == "jax2":
            svc = jb.BatchedEnsembleService(FixedClock(), e, 3, 8,
                                            tick=None, max_ops_per_tick=4,
                                            pipeline_depth=2)
        else:
            svc = make(depth=1 if arm == "port1" else 2, n_ens=e, max_k=4)
        res = []
        for kind, slot, val in batches:
            res.append(svc.execute(kind, slot, val) if arm == "port1"
                       else svc.execute_async(kind, slot, val))
            svc.runtime.now += 0.1
        svc.flush()
        if arm != "port1":
            assert all(f.done for f in res)
            res = [f.value for f in res]
        outs[arm] = res
        states[arm] = (interop.state_to_numpy(svc.state) if arm != "jax2"
                       else svc.state)
        if arm == "port2":
            assert svc.sliced_launches == 4
    for arm in ("port2", "jax2"):
        for a, b in zip(outs["port1"], outs[arm]):
            for pa, pb in zip(a, b):
                assert np.array_equal(np.asarray(pa), np.asarray(pb)), arm
        for f in teng.EngineState._fields:
            assert np.array_equal(getattr(states["port1"], f),
                                  np.asarray(getattr(states[arm], f))), \
                (arm, f)


def test_read_of_an_unsettled_write_takes_the_device_round(jb):
    """At depth 2 a put enqueued but not settled keeps its slot's pending
    write: a read of it misses the fast path and rides a round behind
    the put — in the port as in the JAX service."""
    p = Lockstep(jb, 4, 3, 8, 1, pipeline_depth=2)
    p.submit(lambda s: [s.kput(0, k, 1) for k in ("a", "b")])
    p.drain()
    p.tick(0.1)
    p.submit(lambda s: [s.kput(0, "a", 5), s.kput(0, "b", 6)])
    p.both(lambda s: s.flush())          # "a" enqueued, "b" still queued
    assert len(p.ts._inflight) == 1 and not p.futs[1][-2].done
    p.submit(lambda s: [s.kget(0, "a"), s.kget(0, "c")])
    assert not p.futs[1][-2].done and p.futs[1][-1].done
    assert p.ts.read_fastpath_miss_reasons == {"pending_write": 1}
    p.drain()
    assert p.futs[1][-2].value == ("ok", 5)
    p.check()


def test_depth2_matches_jax_depth2_on_queued_stream(jb):
    """The keyed stream through the port and the JAX service, both at
    depth 2 and default compaction (sliced launches at E = 256): every
    future, packed buffer, state plane and mirror equal; the port at
    depth 1 reaches the same future values."""
    e = 256
    ref = tfunref.ref
    values = {}
    for depth in (2, 1):
        p = Lockstep(jb, e, 3, 8, 4, pipeline_depth=depth)
        rng = np.random.default_rng(3)
        p.submit(lambda s: [s.kput(x, "w", 1) for x in range(0, e, 51)])
        for step in range(14):
            _stream(p, rng, e, step, ref)
            if step == 6:                # a leader down: an election
                for s in (p.js, p.ts):
                    s.set_peer_up(7, int(s.leader_np[7]), False)
            assert p.js.flush() == p.ts.flush()
            p.tick(float(rng.choice([0.1, 0.3])))
        p.drain()
        while p.js._retry_at or p.ts._retry_at or any(p.ts.queues):
            p.drain()
        p.check()
        assert p.ts.sliced_launches > 5 and p.ts.rmw_device_fastpath > 0
        assert p.ts.rmw_conflicts == p.js.rmw_conflicts
        assert p.ts._flush_calls == p.js._flush_calls
        values[depth] = [norm(f.value) for f in p.futs[1]]
    assert values[2] == values[1]


def test_failed_settle_fails_later_launches_like_jax(jb, monkeypatch):
    """A settle that raises fails its launch's ops and those of every
    later launch in flight, and the error reaches the flush caller.  The
    port's donated contract (CUDA's; pinned here on the CPU through
    ``_donate``) keeps no rollback snapshot, which is the JAX service's
    donated arm (``RETPU_DONATE=1``): both keep the stepped state."""
    monkeypatch.setenv("RETPU_DONATE", "1")
    import warnings
    warnings.simplefilter("ignore")     # CPU jax may warn on donation
    p = Lockstep(jb, 4, 3, 8, 1, pipeline_depth=2)
    assert p.js._donate and not p.ts._donate
    p.ts._donate = True
    p.both(lambda s: s.flush())                 # elect
    p.submit(lambda s: [s.kput(0, f"k{i}", i + 1) for i in range(3)])
    for svc in (p.js, p.ts):
        orig = svc._fetch_packed
        calls = {"n": 0}

        def bad(fl, orig=orig, calls=calls):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("device lost")
            return orig(fl)
        svc._fetch_packed = bad
        with pytest.raises(RuntimeError, match="device lost"):
            while any(svc.queues):
                svc.flush()
        assert not svc._inflight_launches if svc is p.js \
            else not svc._inflight
    assert [f.value for f in p.futs[1][:2]] == ["failed", "failed"]
    assert not p.futs[1][2].done
    p.drain()
    p.check()
    assert p.futs[1][2].value[0] == "ok"
    assert int(p.ts.state.obj_seq_ctr[0]) == 3   # the failed steps stand


@pytest.mark.parametrize("seed", [801, 802])
def test_launch_failures_injected_through_engine_match_jax(jb, seed):
    """``test_service_linearizability.py:213`` on the port: a seeded
    ~15 % of launches (one forced early) raise in the engine's
    ``full_step``, injected through ``engine=`` with the same schedule in
    both packages.  Every future, the final state and mirrors equal the
    JAX service's default (rollback) arm, the failures fired, and every
    acknowledged write reads back at the end."""
    from riak_ensemble_tpu.parallel.batched_host import \
        _LocalEngine as JaxEngine

    def failing(base):
        rng = np.random.default_rng(seed + 50_000)
        forced = 1 + int(rng.integers(6))
        n = {"launch": 0}

        class Failing(base):
            def full_step(self, *a, **kw):
                n["launch"] += 1
                if n["launch"] == forced or rng.random() < 0.15:
                    raise RuntimeError("injected-launch-failure")
                return base.full_step(*a, **kw)
        return Failing()
    e, m, s, k = 6, 5, 8, 8
    js = jb.BatchedEnsembleService(FixedClock(), e, m, s, tick=None,
                                   max_ops_per_tick=k,
                                   engine=failing(JaxEngine))
    ts = tb.BatchedEnsembleService(FixedClock(), e, m, s, tick=None,
                                   max_ops_per_tick=k, device="cpu",
                                   engine=failing(tb._LocalEngine))
    rng = np.random.default_rng(seed)
    futs = ([], [])
    acked = {}
    fails = [0, 0]
    down = {}

    def flush_all():
        for i, svc in enumerate((js, ts)):
            for _ in range(25):
                if not any(svc.queues) and not svc._retry_at:
                    break
                try:
                    svc.flush()
                except RuntimeError as exc:
                    assert "injected-launch-failure" in str(exc)
                    fails[i] += 1
    for rnd in range(30):
        r = rng.random()
        if r < 0.3 and down:
            x = sorted(down)[int(rng.integers(len(down)))]
            p = down.pop(x)
            js.set_peer_up(x, p, True)
            ts.set_peer_up(x, p, True)
        elif r < 0.6:
            x = int(rng.integers(e))
            if x not in down and ts.leader_np[x] >= 0:
                down[x] = int(ts.leader_np[x])
                js.set_peer_up(x, down[x], False)
                ts.set_peer_up(x, down[x], False)
        ops = []
        for _ in range(6):
            x, key = int(rng.integers(e)), f"key{int(rng.integers(3))}"
            ops.append((x, key, int(rng.integers(0, 3)), rnd))
        for i, svc in enumerate((js, ts)):
            for x, key, op, v in ops:
                if op == 0:
                    futs[i].append((x, key, v, svc.kput(x, key, v + 1)))
                elif op == 1:
                    futs[i].append((x, key, None, svc.kget(x, key)))
                else:
                    futs[i].append((x, key, -1, svc.kdelete(x, key)))
        if rng.random() < 0.3:
            js.runtime.now += 2.5
            ts.runtime.now += 2.5
        flush_all()
        assert js.leader_np.tolist() == ts.leader_np.tolist()
    assert fails[0] == fails[1] > 0
    assert [norm(f.value) for *_r, f in futs[1]] == \
        [norm(f.value) for *_r, f in futs[0]]
    for x, key, v, f in futs[1]:
        if v is not None and isinstance(f.value, tuple) \
                and f.value[0] == "ok":
            acked[x, key] = v
    for x, p in down.items():
        js.set_peer_up(x, p, True)
        ts.set_peer_up(x, p, True)
    reads = [((x, key), ts.kget(x, key)) for (x, key) in acked]
    for _ in range(10):
        try:
            drain(ts)
            break
        except RuntimeError as exc:
            assert "injected-launch-failure" in str(exc)
    got = {xk: f.value for xk, f in reads}
    want = {xk: ("ok", v + 1) if v >= 0 else ("ok", "NOTFOUND")
            for xk, v in acked.items()}
    assert {xk: norm(v) for xk, v in got.items()} == want
