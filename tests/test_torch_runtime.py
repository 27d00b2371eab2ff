"""The port's simulator runtime and its timer-driven service against the
JAX package's (the mirror of the timer cases of
``tests/test_batched_host.py``: ``:760``, and of ``runtime.py`` itself).

- A seeded schedule of ``defer`` / ``schedule`` / ``cancel`` / network
  sends between actors (latency and chaos draws, a partition, a
  suspended actor) / tasks / ``with_timeout`` / ``run_for`` /
  ``run_until`` runs on the reference's ``Runtime`` and on the port's
  with the same seed: the same events at the same virtual times, in the
  same order, and the same next draw of the runtime's generator.
- :class:`Twin` (used by the lifecycle and membership suites too) builds
  the JAX service and the port's (``device="cpu"``) on their own
  package's ``Runtime`` with the same seed and arguments.  With
  ``tick=0.005`` neither caller flushes: a seeded workload submitted at
  virtual times (bursts that reach ``max_ops_per_tick``, a trickle,
  ``kupdate_many`` / ``kdelete_many``, kmodify, peers going down)
  resolves every future to the same value at the same virtual time and
  in the same order, on the default, oracle and plain host arms and at
  depth 2; the flushes, states and mirrors end equal.
- A burst flushes on the next runtime turn, a deeper burst drains whole,
  a trickle waits for the tick, and ``stop()`` cancels the timer.

Tolerance: exact equality everywhere.
"""

import numpy as np
import pytest

from riak_ensemble_tpu_torch import funref as tfunref
from riak_ensemble_tpu_torch import interop
from riak_ensemble_tpu_torch import runtime as trt
from riak_ensemble_tpu_torch.config import fast_test_config as t_config
from riak_ensemble_tpu_torch.parallel import batched_host as tb
from test_torch_compaction import norm
from test_torch_native_enqueue import PORT_KW, _jax_env
from test_torch_reference_natives import reference_natives  # noqa: F401 (autouse)

MIRRORS = ("_slot_vsn_np", "_slot_vsn_ok", "_inline_value_np",
           "_inline_value_ok", "_inline_np", "leader_np", "lease_until",
           "_corrupt_rows", "member_np", "elections_np", "_live",
           "_desired_view_np", "_desired_mask", "_pending_view_np",
           "_pending_mask", "_queued_view_np", "_queued_mask", "up")
HOST = ("key_slot", "slot_handle", "values", "free_slots", "_next_handle",
        "_inline_slots", "slot_gen", "_free_rows", "_ens_names",
        "_row_name", "flushes", "ops_served")


def _schedule_trace(mod, seed: int):
    """Drive one runtime module through a seeded schedule of calls and
    return what ran, when, and the generator's next draw."""
    rt = mod.Runtime(seed=seed)
    rng = np.random.default_rng(seed)
    events = []

    class Rec(mod.Actor):
        def handle(self, msg):
            events.append(("msg", self.name, msg, self.runtime.now))

    nodes = ["n0", "n1", "n2"]
    for i in range(4):
        Rec(rt, f"a{i}", nodes[i % 3])
    if seed % 2:
        rt.net.chaos(window=0.02, local=0.005)
    timers = []

    def task(tag, delay):
        yield rt.sleep(delay)
        events.append(("task", tag, rt.now))
        yield None
        events.append(("task-resumed", tag, rt.now))

    for step in range(80):
        op = int(rng.integers(0, 11))
        if op == 0:
            rt.defer(lambda s=step: events.append(("defer", s, rt.now)))
        elif op == 1:
            timers.append(rt.schedule(
                float(rng.uniform(0, 0.05)),
                lambda s=step: events.append(("timer", s, rt.now))))
        elif op == 2 and timers:
            timers[int(rng.integers(len(timers)))].cancel()
        elif op == 3:
            rt.net_send(nodes[int(rng.integers(3))],
                        f"a{int(rng.integers(4))}", step)
        elif op == 4:
            rt.run_for(float(rng.uniform(0, 0.02)))
        elif op == 5:
            rt.run_until(lambda s=step: len(events) > s // 2,
                         max_time=0.05, poll=0.003)
        elif op == 6:
            rt.spawn_task(task(step, float(rng.uniform(0, 0.03))))
        elif op == 7:
            fut = mod.Future()
            rt.schedule(float(rng.uniform(0, 0.04)),
                        lambda f=fut, s=step: f.resolve(s))
            rt.with_timeout(fut, 0.02).add_waiter(
                lambda v, s=step: events.append(("timeout?", s, v,
                                                 rt.now)))
        elif op == 8:
            rt.net.partition(["n0"], ["n1"])
        elif op == 9:
            rt.net.heal()
        elif op == 10:
            name = f"a{int(rng.integers(4))}"
            if rt.actors[name].suspended:
                rt.resume(name)
            else:
                rt.suspend(name)
    for name in list(rt.actors):
        rt.resume(name)
    rt.run_for(1.0)
    return events, rt.now, rt.rng.random()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_runtime_event_order_matches_reference(seed):
    """The same seeded schedule gives the same events, times and order
    on both runtimes (the heap, the tie-break, the seeded generator)."""
    pytest.importorskip("jax")
    from riak_ensemble_tpu import runtime as jrt
    ref = _schedule_trace(jrt, seed)
    got = _schedule_trace(trt, seed)
    assert len(got[0]) > 20
    assert got == ref


class Twin:
    """The JAX service and the port's on their own package's simulator
    ``Runtime`` (same seed), built with the same arguments; every call
    goes to both and every result is held equal."""

    def __init__(self, monkeypatch, e, m, s, arm="default", seed=50,
                 depth=1, data_dirs=(None, None), fast=True, **kw):
        pytest.importorskip("jax")
        _jax_env(monkeypatch, arm, fast, True)
        if arm == "plain":
            from riak_ensemble_tpu.parallel import enqueue_native, \
                resolve_native
            from riak_ensemble_tpu.synctree import native_store
            for mod in (enqueue_native, resolve_native):
                monkeypatch.setattr(mod, "_instance", None)
                monkeypatch.setattr(mod, "_instance_tried", True)
            monkeypatch.setattr(native_store, "available", lambda: False)
        from riak_ensemble_tpu import runtime as jrt
        from riak_ensemble_tpu.config import fast_test_config as j_config
        from riak_ensemble_tpu.parallel import batched_host as jb
        self.jb, self.jrt, self.j_config = jb, jrt, j_config
        self.arm, self.kw = arm, kw
        self.rts = (jrt.Runtime(seed=seed), trt.Runtime(seed=seed))
        kw.setdefault("tick", 0.005)
        self.js = jb.BatchedEnsembleService(
            self.rts[0], e, m, s, config=j_config(), pipeline_depth=depth,
            data_dir=data_dirs[0], **kw)
        self.ts = tb.BatchedEnsembleService(
            self.rts[1], e, m, s, config=t_config(), pipeline_depth=depth,
            data_dir=data_dirs[1], device="cpu", **PORT_KW[arm], **kw)
        self.ts.set_fast_reads(fast)
        assert self.js._fast_reads == self.ts._fast_reads == fast
        assert (self.js._native_resolve is None) == \
            (self.ts._native_resolve is None)
        assert self.js._enq_slab == self.ts._enq_slab
        self.svcs = (self.js, self.ts)

    def call(self, fn):
        """``fn(svc)`` on each service: a (JAX, port) pair."""
        return tuple(fn(svc) for svc in self.svcs)

    def same(self, fn):
        """``fn(svc)`` on each service, held equal; the port's result."""
        a, b = self.call(fn)
        if isinstance(b, np.ndarray):
            assert np.array_equal(np.asarray(a), b)
        else:
            assert norm(b) == norm(a)
        return b

    def settle(self, futs, timeout=5.0):
        """Run each runtime until its future resolves; equal values."""
        vals = [rt.await_future(f, timeout)
                for rt, f in zip(self.rts, futs)]
        assert norm(vals[1]) == norm(vals[0])
        return norm(vals[1])

    def op(self, fn, timeout=5.0):
        return self.settle(self.call(fn), timeout)

    def run_for(self, dt):
        for rt in self.rts:
            rt.run_for(dt)

    def stop(self):
        for svc in self.svcs:
            svc.stop()

    def check(self):
        """Every state plane, mirror and host map equal."""
        js, ts = self.svcs
        tn = interop.state_to_numpy(ts.state)
        for f in tn._fields:
            assert np.array_equal(np.asarray(getattr(js.state, f)),
                                  getattr(tn, f)), f
        for name in MIRRORS:
            assert np.array_equal(getattr(js, name), getattr(ts, name)), \
                name
        for name in HOST:
            assert getattr(js, name) == getattr(ts, name), name
        assert self.rts[0].now == self.rts[1].now


def _workload(rt, svc, seed, order):
    """Schedule a seeded client workload on ``rt``: each submission runs
    at its virtual time and each future records (op index, resolve time,
    value) in ``order``.  Bursts put ``max_ops_per_tick`` rounds on one
    ensemble (the burst trigger); the rest is a trickle."""
    rng = np.random.default_rng(seed)
    add = tfunref.ref("rmw:add", 2)
    e = svc.n_ens
    idx = [0]

    def record(fut):
        i = idx[0]
        idx[0] += 1
        fut.add_waiter(lambda v: order.append((i, rt.now, norm(v))))

    def submit(kind, ens, r):
        keys = [f"k{(r + i) % 6}" for i in range(3)]
        if kind == 0:      # a burst: max_k rounds on one ensemble
            record(svc.kput_many(ens, [f"b{i}" for i in range(svc.max_k)],
                                 [b"%d" % r] * svc.max_k))
        elif kind == 1:
            record(svc.kput(ens, keys[0], b"p%d" % r))
        elif kind == 2:
            record(svc.kget_many(ens, keys, want_vsn=True))
        elif kind == 3:
            record(svc.kupdate_many(ens, keys, [(0, 0), (1, 1), (9, 9)],
                                    [b"c%d" % r] * 3))
        elif kind == 4:
            record(svc.kdelete_many(ens, keys[1:] + ["never"]))
        elif kind == 5:
            record(svc.kmodify(ens, "ctr", add, 0))
        elif kind == 6:
            record(svc.kget_vsn(ens, keys[2]))
        else:
            peer = r % svc.n_peers
            svc.set_peer_up(ens, peer, not svc.up[ens, peer])

    t = 0.0
    for r in range(60):
        t += float(rng.exponential(0.004))
        kind = int(rng.integers(0, 8))
        ens = int(rng.integers(0, e))
        rt.schedule(t, lambda k=kind, en=ens, rr=r: submit(k, en, rr))
    return t


@pytest.mark.parametrize("arm,depth", [("default", 1), ("default", 2),
                                       ("oracle", 1), ("plain", 1)])
def test_timer_driven_service_matches_jax(monkeypatch, arm, depth):
    """No caller flushes: the timer and the burst trigger serve a seeded
    workload; futures resolve to the same values at the same virtual
    times in the same order as the JAX service's."""
    tw = Twin(monkeypatch, 6, 3, 16, arm=arm, depth=depth,
              max_ops_per_tick=4)
    orders = ([], [])
    for rt, svc, order in zip(tw.rts, tw.svcs, orders):
        end = _workload(rt, svc, 7, order)
    tw.run_for(end + 1.0)
    assert len(orders[1]) > 40
    assert orders[1] == orders[0]
    assert tw.ts.flushes == tw.js.flushes > 0
    tw.stop()
    tw.check()


def test_burst_flush_does_not_wait_for_tick(monkeypatch):
    """``test_batched_host.py:760`` on both services: a queue reaching
    ``max_ops_per_tick`` flushes on the next runtime turn, a deeper burst
    drains whole, a trickle waits for the (10 s) tick; ``stop()`` then
    cancels the timer, so nothing more is flushed."""
    tw = Twin(monkeypatch, 2, 3, 16, tick=10.0, max_ops_per_tick=4)
    futs = [tw.call(lambda s, i=i: s.kput(0, f"k{i}", b"v"))
            for i in range(4)]
    tw.run_for(0.01)
    for pair in futs:
        assert all(f.done and f.value[0] == "ok" for f in pair)
        assert norm(pair[1].value) == norm(pair[0].value)
    deep = [tw.call(lambda s, i=i: s.kput(0, f"d{i}", b"v"))
            for i in range(11)]
    tw.run_for(0.01)
    for pair in deep:
        assert all(f.done and f.value[0] == "ok" for f in pair)
        assert norm(pair[1].value) == norm(pair[0].value)
    trickle = tw.call(lambda s: s.kput(1, "x", b"v"))
    tw.run_for(0.01)
    assert not any(f.done for f in trickle)
    assert tw.settle(trickle, timeout=11.0)[0] == "ok"
    assert tw.rts[1].now >= 10.0
    tw.stop()
    late = tw.call(lambda s: s.kput(1, "y", b"v"))
    flushes = tw.ts.flushes
    tw.run_for(25.0)
    assert not any(f.done for f in late)
    assert tw.ts.flushes == tw.js.flushes == flushes
    tw.check()
