"""The port's launch pipeline (enqueue half / settle half, depth <= 2)
— the mirror of ``tests/test_pipeline.py``:

- settles are FIFO and results resolve in submission order;
- at depth 2 launch N + 1 is ENQUEUED before launch N settles (an
  ordering assertion on the two halves, not a wall-clock ratio), and at
  depth 1 every launch settles before the next is enqueued;
- ``execute_async`` interleaves with ``execute`` (a synchronous execute
  settles everything in flight first) and lands the same results as
  ``execute``, and as the JAX service's ``execute_async`` at depth 2;
- corruption flagged by launch N is exchanged at N's settle, before the
  next launch's ack;
- a read of a slot whose write is enqueued but unsettled does not take
  the fast path (``pending_write``), as in the JAX service;
- a queued keyed stream (device RMW, host-path kmodify chains with
  backoff, elections, fast reads, sliced launches at E = 256) through the
  port at depth 2 equals the JAX service at depth 2 — futures, packed
  buffers, states, mirrors — and the port's own depth-1 results;
- a settle that fails fails its launch and every later in-flight launch:
  the port's CUDA contract (donated, no rollback; pinned on the CPU
  through ``_donate``) as the JAX service with ``RETPU_DONATE=1``, and
  the port's CPU default (rollback to the launch's snapshot) as the JAX
  service's CPU default (``RETPU_DONATE`` unset);
- launch failures injected through ``engine=`` (a ``_LocalEngine``
  subclass in each package, one seeded schedule): every future, state
  plane and mirror equal the JAX service's, and every acknowledged write
  reads back (``test_service_linearizability.py:213``).

Tolerance: exact equality everywhere.
"""

import numpy as np
import pytest
import torch

from riak_ensemble_tpu_torch import funref as tfunref
from riak_ensemble_tpu_torch.ops import engine as teng
from riak_ensemble_tpu_torch.parallel import batched_host as tb
from test_torch_compaction import DEFAULT_ENV, UNSET, Lockstep, norm
from test_torch_kmodify import FixedClock


def make(depth=2, n_ens=4, n_slots=8, max_k=1, **kw):
    return tb.BatchedEnsembleService(FixedClock(), n_ens, 3, n_slots,
                                     tick=None, max_ops_per_tick=max_k,
                                     device="cpu", pipeline_depth=depth, **kw)


def drain(svc):
    while any(svc.queues):
        svc.flush()
    svc.flush()  # idle flush settles the in-flight tail


class Traced(tb.BatchedEnsembleService):
    """Records the boundaries of both halves of every launch."""

    def __init__(self, *a, **kw):
        self.events = []
        self._seq = 0
        self._ids = {}
        super().__init__(*a, **kw)

    def _launch_enqueue(self, *a, **kw):
        fl = super()._launch_enqueue(*a, **kw)
        self._seq += 1
        self.events.append(("enq", self._seq))
        self._ids[id(fl)] = self._seq
        return fl

    def _settle_launch(self, fl):
        self.events.append(("settle", self._ids[id(fl)]))
        return super()._settle_launch(fl)


@pytest.fixture
def jb(monkeypatch):
    pytest.importorskip("jax")
    for key in UNSET:
        monkeypatch.delenv(key, raising=False)
    for key, v in DEFAULT_ENV.items():
        monkeypatch.setenv(key, v)
    from riak_ensemble_tpu.parallel import batched_host as jb
    return jb


def test_pipelined_results_resolve_in_submission_order():
    svc = make(max_k=1, n_slots=16)
    order, futs = [], []
    for j in range(10):
        f = svc.kput(0, f"k{j}", b"v%d" % j)
        f.add_waiter(lambda _r, j=j: order.append(j))
        futs.append(f)
    drain(svc)
    assert all(f.done and f.value[0] == "ok" for f in futs)
    assert order == sorted(order), order
    g = svc.kget(0, "k3")
    drain(svc)
    assert g.value == ("ok", b"v3")
    assert not svc._inflight


@pytest.mark.parametrize("depth", [1, 2])
def test_next_launch_enqueued_before_the_last_settles(depth):
    svc = Traced(FixedClock(), 4, 3, 8, tick=None, max_ops_per_tick=1,
                 device="cpu", pipeline_depth=depth)
    svc.flush()                                   # the election launch
    svc.events.clear()
    svc._ids.clear()
    futs = [svc.kput(1, f"k{j}", j + 1) for j in range(5)]
    drain(svc)
    assert all(f.value[0] == "ok" for f in futs)
    enq = [n for kind, n in svc.events if kind == "enq"]
    settle = [n for kind, n in svc.events if kind == "settle"]
    assert settle == enq == [2, 3, 4, 5, 6]       # FIFO, every one settled
    pos = {ev: i for i, ev in enumerate(svc.events)}
    for n in enq[:-1]:
        overlapped = pos[("enq", n + 1)] < pos[("settle", n)]
        assert overlapped == (depth == 2), (n, svc.events)
    assert len(svc._inflight) == 0


def _exec_planes(n_ens, n_slots, k, seed=0):
    rng = np.random.default_rng(seed)
    kind = rng.choice([teng.OP_PUT, teng.OP_GET],
                      (k, n_ens)).astype(np.int32)
    slot = rng.integers(0, n_slots, (k, n_ens)).astype(np.int32)
    val = rng.integers(1, 1 << 20, (k, n_ens)).astype(np.int32)
    return kind, slot, val


def test_execute_async_pipeline_and_sync_interleave():
    svc = make(depth=2, n_ens=8, max_k=4)
    kind, slot, val = _exec_planes(8, 8, 4)
    futs = [svc.execute_async(kind, slot, val) for _ in range(5)]
    # depth bound: at most pipeline_depth - 1 launches left unsettled
    assert len(svc._inflight) == 1 and not futs[-1].done
    assert all(f.done for f in futs[:-1])
    # a synchronous execute settles everything in flight first
    committed, get_ok, _f, _v = svc.execute(kind, slot, val)
    assert all(f.done for f in futs)
    assert (committed | get_ok).all()
    for f in futs:
        c, g, _fo, _va = f.value
        assert (c | g).all()
    tail = svc.execute_async(kind, slot, val)
    svc.flush()                          # an idle flush settles the tail
    assert tail.done and not svc._inflight


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


def test_corruption_deferral_repairs_before_next_ack(monkeypatch):
    """Launch 1's read trips the integrity gate; its corrupt plane is read
    at its settle — after launch 2's enqueue — and the exchange runs
    before launch 2's future resolves."""
    svc = Traced(FixedClock(), 4, 3, 8, tick=None, max_ops_per_tick=1,
                 device="cpu", pipeline_depth=2)
    futs = [svc.kput(e, "k", b"v") for e in range(4)]
    drain(svc)
    assert all(f.value[0] == "ok" for f in futs)
    svc.state.obj_val[0, 2, svc.key_slot[0]["k"]] = 424242
    svc.lease_until[:] = 0.0              # the reads take device rounds
    orig = svc.engine.exchange_step

    def exchange(*a, **kw):
        svc.events.append(("exchange", None))
        return orig(*a, **kw)
    # the service's exchanges run through its engine adapter
    monkeypatch.setattr(svc.engine, "exchange_step", exchange)
    svc.events.clear()
    g1 = svc.kget(0, "k")
    g1.add_waiter(lambda _r: svc.events.append(("ack", 1)))
    g2 = svc.kget(0, "k")
    g2.add_waiter(lambda _r: svc.events.append(("ack", 2)))
    drain(svc)
    assert g1.value == ("ok", b"v") and g2.value == ("ok", b"v")
    assert svc.corruptions > 0
    kinds = [k for k, _ in svc.events]
    assert kinds[:2] == ["enq", "enq"] and kinds[2] == "settle"
    assert kinds.index("exchange") < svc.events.index(("ack", 2))
    node_bad, leaf_bad = teng.verify_trees(svc.state)
    assert not (node_bad.any() or leaf_bad.any())


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


def _stream(p, rng, e, step, ref):
    for _ in range(int(rng.integers(2, 9))):
        ens = int(rng.choice([0, 1, 7, 100, 200, e - 1]))
        key = f"k{int(rng.integers(0, 5))}"
        op = int(rng.integers(0, 7))
        if op == 0:
            p.submit(lambda s: s.kput(ens, key, step + 1))
        elif op == 1:
            p.submit(lambda s: s.kget(ens, key))
        elif op == 2:
            p.submit(lambda s: s.kget_vsn(ens, key))
        elif op == 3:
            p.submit(lambda s: s.kmodify(ens, "ctr", ref("rmw:add", 2), 0))
        elif op == 4:
            p.submit(lambda s: s.kmodify(ens, "h", lambda v, c: c + 1, 0,
                                         retries=6))
        elif op == 5:
            p.submit(lambda s: s.kput_many(ens, [key, key + "'"],
                                           [step, step + 1]))
        else:
            p.submit(lambda s: s.kdelete(ens, key))


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


def _fail_first_fetch(svc):
    orig = svc._fetch_packed
    calls = {"n": 0}

    def bad(fl):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("device lost")
        return orig(fl)
    svc._fetch_packed = bad


def test_failed_settle_rolls_back_like_jax_default(jb, monkeypatch):
    """The default pair: the JAX service's CPU default (``RETPU_DONATE``
    unset: no donation, a snapshot per launch) against the port on the
    CPU.  The failed settle restores the state, the leader mirror and
    the leases of ITS launch's snapshot, and every later in-flight launch
    fails with it: the failed steps do not stand, and both services
    then serve the retried writes the same."""
    import jax
    if jax.default_backend() != "cpu":
        # JAX on an accelerator defaults to donation; its CPU default
        # is RETPU_DONATE=0
        monkeypatch.setenv("RETPU_DONATE", "0")
    p = Lockstep(jb, 4, 3, 8, 1, pipeline_depth=2)
    assert not p.js._donate and not p.ts._donate
    p.both(lambda s: s.flush())                 # elect
    p.submit(lambda s: [s.kput(0, f"k{i}", i + 1) for i in range(3)])
    before = int(p.ts.state.obj_seq_ctr[0])
    for svc in (p.js, p.ts):
        _fail_first_fetch(svc)
        with pytest.raises(RuntimeError, match="device lost"):
            while any(svc.queues):
                svc.flush()
    assert [f.value for f in p.futs[1][:2]] == ["failed", "failed"]
    assert int(p.ts.state.obj_seq_ctr[0]) == before   # rolled back
    assert np.array_equal(p.js.leader_np, p.ts.leader_np)
    p.drain()
    p.submit(lambda s: [s.kput(0, f"k{i}", 10 + i) for i in range(2)])
    p.drain()
    p.check()
    assert [f.value[0] for f in p.futs[1][2:]] == ["ok"] * 3


def test_failed_enqueue_rolls_back_on_cpu_only(monkeypatch):
    """A step that raises inside the enqueue half: on the CPU the
    snapshot comes back (state planes, leader mirror, leases equal their
    pre-launch values); with the donated contract nothing is
    restored."""
    for donate in (False, True):
        svc = make(depth=1, max_k=2)
        svc.flush()
        f = svc.kput(1, "a", b"1")
        drain(svc)
        assert f.value[0] == "ok"
        svc._donate = donate
        before = [t.clone() for t in svc.state]
        leader, lease = svc.leader_np.copy(), svc.lease_until.copy()
        real = svc.engine.full_step

        def broken(state, *a, **kw):
            real(state, *a, **kw)        # steps the planes in place
            raise RuntimeError("launch lost")
        monkeypatch.setattr(svc.engine, "full_step", broken)
        g = svc.kput(1, "a", b"2")
        svc.set_peer_up(2, int(svc.leader_np[2]), False)   # an election
        with pytest.raises(RuntimeError, match="launch lost"):
            svc.flush()
        assert g.value == "failed"
        same = all(torch.equal(a, b) for a, b in zip(before, svc.state))
        assert same == (not donate)
        assert np.array_equal(svc.leader_np, leader)
        assert np.array_equal(svc.lease_until, lease)


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


def test_set_pipeline_depth_settles_in_flight():
    svc = make(depth=2, max_k=1)
    futs = [svc.kput(0, f"k{i}", i + 1) for i in range(3)]
    svc.flush()
    svc.flush()
    assert len(svc._inflight) == 1
    assert svc.set_pipeline_depth(1) == 2
    assert not svc._inflight and svc.pipeline_depth == 1
    drain(svc)
    assert all(f.value[0] == "ok" for f in futs)
    assert torch.equal(svc.state.obj_seq_ctr[:1],
                       torch.tensor([3], dtype=torch.int32))
