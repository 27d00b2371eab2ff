"""The port's keyed read-modify-write against the JAX package's.

``kmodify`` / ``kmodify_many`` / ``ksafe_delete`` go through the JAX
service on its oracle arm (``RETPU_COMPACT=0 RETPU_NATIVE_RESOLVE=0
RETPU_NATIVE_ENQUEUE=0 RETPU_OBS=0``, no ``RETPU_WIDE``) and through the
port's service on the CPU with ``compact=False``, both on one fixed clock
each, with fast reads on and off (``RETPU_FAST_READS`` /
``set_fast_reads``) and enqueue-side coalescing on and off
(``RETPU_COMM_REPL`` / ``comm_repl``); one arm runs both at their default
compaction (``RETPU_COMPACT`` unset, ``compact=True``).

A scripted stream covers the behaviours of ``tests/test_kmodify.py`` and
``tests/test_rmw.py`` (device single flush, concurrent increments,
duplicate-key batches, host fallback, the contention storm with backoff,
computed tombstones, put-if-absent, non-zero defaults, an unflushed
kput, storage flips, numpy operands, ksafe_delete); a seeded random
stream mixes them with puts, reads, deletes, peer failures and lease
expiry.  Every future must resolve to the same value after the same
number of flush calls, every launch's packed result buffer must be
byte-identical, the final engine states bit-equal, and the host mirrors
and RMW / fast-read counters equal.  Tolerance: exact equality.
"""

import numpy as np
import pytest

from riak_ensemble_tpu_torch import funref as tfunref
from riak_ensemble_tpu_torch import interop
from riak_ensemble_tpu_torch.parallel import batched_host as tb
from riak_ensemble_tpu_torch.types import NOTFOUND as T_NOTFOUND
from test_torch_reference_natives import reference_natives  # noqa: F401 (autouse)

ORACLE_ENV = {"RETPU_COMPACT": "0", "RETPU_NATIVE_RESOLVE": "0",
              "RETPU_NATIVE_ENQUEUE": "0", "RETPU_OBS": "0"}


class FixedClock:
    """A runtime whose ``now`` only the test moves (no event loop)."""

    def __init__(self) -> None:
        self.now = 100.0

    def schedule(self, delay, fn):
        raise RuntimeError("caller-driven flush only")


def _record_packed(svc, out):
    orig = svc._fetch_packed

    def fetch(arg):
        flat = orig(arg)
        out.append(np.array(flat, copy=True))
        return flat
    svc._fetch_packed = fetch


def _incr_bytes(vsn, cur):
    return (int.from_bytes(cur, "big") + 1).to_bytes(4, "big")


def _fail_if_set(vsn, cur):
    return "failed" if cur != b"\0\0\0\0" else b"\0\0\0\1"


#: named host funs, registered under the same name in both registries
HOST_FUNS = {"torch-test:incr": _incr_bytes,
             "torch-test:fail-if-set": _fail_if_set}


def _incr(vsn, cur):
    return int(cur) + 1


def _boom(vsn, cur):
    raise RuntimeError("mod_fun bug")


class Pair:
    """The JAX service and the port's, driven in lockstep."""

    def __init__(self, js, ts, bufs, norm):
        self.js, self.ts, self.bufs, self.norm = js, ts, bufs, norm
        self.futs = ([], [])
        self.flush_counts = []

    def submit(self, fn):
        """Call ``fn(svc)`` on both services; returns the port's
        futures."""
        out = []
        for i, svc in enumerate((self.js, self.ts)):
            got = fn(svc)
            got = got if isinstance(got, list) else [got]
            self.futs[i].extend(got)
            out.append(got)
        return out[1]

    def tick(self, dt=0.1):
        self.js.runtime.now += dt
        self.ts.runtime.now += dt

    def flush(self):
        a, b = self.js.flush(), self.ts.flush()
        assert a == b
        self.tick()

    def drive(self, futs, limit=80):
        """Flush both until ``futs`` (the port's) resolve; returns the
        number of flush calls, which the JAX side must match."""
        n = 0
        while not all(f.done for f in futs):
            assert n < limit, "futures did not resolve"
            self.flush()
            n += 1
        self.flush_counts.append(n)
        return n

    def run(self, fn, dt=0.1):
        futs = self.submit(fn)
        n = self.drive(futs)
        self.tick(dt)
        return [self.norm(f.value) for f in futs], n

    def check(self):
        js, ts, norm = self.js, self.ts, self.norm
        while any(js.queues) or any(ts.queues) or js._retry_at \
                or ts._retry_at:
            self.flush()
        assert all(f.done for fl in self.futs for f in fl)
        assert [norm(f.value) for f in self.futs[1]] == \
            [norm(f.value) for f in self.futs[0]]
        assert len(self.bufs[0]) == len(self.bufs[1])
        for i, (a, b) in enumerate(zip(*self.bufs)):
            assert a.dtype == b.dtype == np.uint8, i
            assert np.array_equal(a, b), f"packed buffer {i} differs"
        tn = interop.state_to_numpy(ts.state)
        for f in tn._fields:
            assert np.array_equal(np.asarray(getattr(js.state, f)),
                                  getattr(tn, f)), f
        for name in ("key_slot", "slot_handle", "values", "slot_gen",
                     "free_slots", "_inline_slots", "_queued_handle_writes",
                     "_pending_writes", "ops_served", "flushes",
                     "_flush_calls", "rmw_conflicts", "rmw_device_fastpath",
                     "rmw_enqueue_coalesced", "read_fastpath_hits",
                     "read_fastpath_misses", "read_fastpath_miss_reasons",
                     "_chain_kick"):
            assert getattr(js, name) == getattr(ts, name), name
        for name in ("leader_np", "lease_until", "_slot_vsn_np",
                     "_slot_vsn_ok", "_inline_value_np",
                     "_inline_value_ok", "_inline_np", "_corrupt_rows"):
            assert np.array_equal(getattr(js, name),
                                  getattr(ts, name)), name
        assert js._rng.getstate() == ts._rng.getstate()
        assert not any(any(r) for r in ts._pending_writes)
        assert not any(any(r) for r in ts._queued_handle_writes)


@pytest.fixture
def pair(monkeypatch):
    """``pair(fast, comm, e, m, s, k)`` builds a lockstep Pair."""
    pytest.importorskip("jax")
    from riak_ensemble_tpu import funref as jfunref
    from riak_ensemble_tpu.parallel import batched_host as jb
    from riak_ensemble_tpu.types import NOTFOUND as J_NOTFOUND

    for mod in (jfunref, tfunref):
        for name, fn in HOST_FUNS.items():
            if name not in mod._REGISTRY:
                mod.register(name)(fn)

    def norm(x):
        if x is J_NOTFOUND or x is T_NOTFOUND:
            return "NOTFOUND"
        if isinstance(x, (list, tuple)):
            return type(x)(norm(y) for y in x)
        return x

    def make(fast, comm, e=4, m=3, s=16, k=8, compact=False):
        for key, v in ORACLE_ENV.items():
            monkeypatch.setenv(key, v)
        if compact:
            monkeypatch.delenv("RETPU_COMPACT")
        monkeypatch.setenv("RETPU_FAST_READS", "1" if fast else "0")
        monkeypatch.setenv("RETPU_COMM_REPL", "1" if comm else "0")
        monkeypatch.delenv("RETPU_WIDE", raising=False)
        js = jb.BatchedEnsembleService(FixedClock(), e, m, s, tick=None,
                                       max_ops_per_tick=k)
        ts = tb.BatchedEnsembleService(FixedClock(), e, m, s, tick=None,
                                       max_ops_per_tick=k, device="cpu",
                                       comm_repl=comm, compact=compact)
        ts.set_fast_reads(fast)
        assert js._native_resolve is None and not js._enq_slab
        assert js._compact == ts._compact == compact and not js._obs
        assert js._fast_reads == ts._fast_reads == fast
        assert js._comm_repl == comm
        bufs = ([], [])
        _record_packed(js, bufs[0])
        _record_packed(ts, bufs[1])
        return Pair(js, ts, bufs, norm)
    return make


ARMS = [(True, True, False), (True, False, False), (False, True, False),
        (False, False, False), (True, True, True)]
ARM_IDS = ["fast-comm", "fast-nocomm", "nofast-comm", "nofast-nocomm",
           "fast-comm-default-arm"]


@pytest.mark.parametrize("fast,comm,compact", ARMS, ids=ARM_IDS)
def test_rmw_scripted_stream_matches_jax(pair, fast, comm, compact):
    # the default arm on 16 rows: launches touching 1-4 rows pack-gather
    p = pair(fast, comm, e=16 if compact else 4, compact=compact)
    ref = tfunref.ref

    # device single flush; versions ride like any write
    (r,), n = p.run(lambda s: s.kmodify(0, "ctr", ref("rmw:add", 5), 0))
    assert r[0] == "ok" and n == 1
    (g,), _ = p.run(lambda s: s.kget_vsn(0, "ctr"))
    assert g == ("ok", 5, r[1])

    # concurrent device increments converge to +N in one flush
    rs, n = p.run(lambda s: [s.kmodify(0, "c6", ref("rmw:add", 1), 0)
                             for _ in range(6)])
    assert n == 1 and len({x[1] for x in rs}) == 6
    (g,), _ = p.run(lambda s: s.kget(0, "c6"))
    assert g == ("ok", 6)

    # kmodify_many with duplicate keys, commutative / semilattice /
    # ordered funs (coalesced only on the comm arm)
    keys = ["a", "b", "a", "c", "a", "b"]
    for name, opd in (("rmw:add", 3), ("rmw:sub", 7), ("rmw:max", 11),
                      ("rmw:band", 6), ("rmw:set", 9)):
        (rl,), n = p.run(lambda s: s.kmodify_many(1, keys, ref(name, opd)))
        assert n == 1 and all(x[0] == "ok" for x in rl)
    (g,), _ = p.run(lambda s: s.kget_many(1, ["a", "b", "c"]))
    assert g == [("ok", 9)] * 3
    coalesced = p.ts.rmw_enqueue_coalesced
    assert coalesced == (12 if comm else 0)

    # host fallback with a callable, for a batch and a scalar
    (rl,), _ = p.run(lambda s: s.kmodify_many(1, ["h1", "h2", "h1"],
                                              lambda v, c: int(c) + 2))
    assert all(x[0] == "ok" for x in rl)
    (g,), _ = p.run(lambda s: s.kget_many(1, ["h1", "h2"]))
    assert g == [("ok", 4), ("ok", 2)]

    # contention storm on the host path: chained CAS + backoff
    before = p.ts.rmw_conflicts
    rs, n = p.run(lambda s: [s.kmodify(2, "storm", _incr, 0, retries=16)
                             for _ in range(6)])
    assert all(x[0] == "ok" for x in rs) and n <= 24
    assert p.ts.rmw_conflicts - before >= 5
    (g,), _ = p.run(lambda s: s.kget(2, "storm"))
    assert g == ("ok", 6)

    # named host funs (registered in both registries), abort, raise
    (r,), _ = p.run(lambda s: s.kmodify(
        2, "bytes", ("fn", "torch-test:incr", ()), b"\0\0\0\0"))
    assert r[0] == "ok"
    (r,), _ = p.run(lambda s: s.kmodify(
        2, "bytes", ("fn", "torch-test:fail-if-set", ()), b"\0\0\0\0"))
    assert r == "failed"
    (r,), _ = p.run(lambda s: s.kmodify(2, "boom", _boom, 0))
    assert r == "failed"
    (r,), n = p.run(lambda s: s.kmodify(2, "x", ("fn", "no:such", ()), 0))
    assert r == "failed" and n == 0
    (g,), _ = p.run(lambda s: s.kget_many(2, ["bytes", "boom"]))
    assert g == [("ok", b"\0\0\0\1"), ("ok", "NOTFOUND")]

    # computed tombstone reads notfound, recycles, and revives from 0
    p.run(lambda s: s.kmodify(3, "t", ref("rmw:add", 9), 0))
    (r,), _ = p.run(lambda s: s.kmodify(3, "t", ref("rmw:set", 0), 0))
    assert r[0] == "ok"
    (g,), _ = p.run(lambda s: s.kget(3, "t"))
    assert g == ("ok", "NOTFOUND")
    p.flush()
    assert "t" not in p.ts.key_slot[3]
    p.run(lambda s: s.kmodify(3, "t", ref("rmw:add", 3), 0))
    # ... and a table fun computing 0 on a host payload tombstones too
    p.run(lambda s: s.kput(3, "hp", 5))
    (r,), _ = p.run(lambda s: s.kmodify(3, "hp", ref("rmw:sub", 5), 0))
    assert r[0] == "ok"
    (g,), _ = p.run(lambda s: s.kget(3, "hp"))
    assert g == ("ok", "NOTFOUND")

    # put-if-absent: device refusal fails fast, a live-zero payload
    # refuses, an arbitrary payload routes to kput_once
    (r,), _ = p.run(lambda s: s.kmodify(0, "p", ref("rmw:put_if_absent",
                                                    11), 0))
    assert r[0] == "ok"
    (r,), n = p.run(lambda s: s.kmodify(
        0, "p", ref("rmw:put_if_absent", 22), 0, retries=8))
    assert r == "failed" and n <= 2
    p.run(lambda s: s.kput(0, "z", 0))
    (r,), _ = p.run(lambda s: s.kmodify(0, "z", ref("rmw:put_if_absent",
                                                    7), 0))
    assert r == "failed"
    (r1, r2), _ = p.run(lambda s: [
        s.kmodify(0, "z", ref("rmw:put_if_absent", b"cfg"), 0),
        s.kmodify(0, "fresh", ref("rmw:put_if_absent", b"cfg"), 0)])
    assert r1 == "failed" and r2[0] == "ok"
    (g,), _ = p.run(lambda s: s.kget_many(0, ["p", "z", "fresh"]))
    assert g == [("ok", 11), ("ok", 0), ("ok", b"cfg")]

    # non-zero default keeps the host path
    dev_before = p.ts.rmw_device_fastpath
    p.run(lambda s: s.kmodify(1, "nz", ref("rmw:add", 1), 100))
    assert p.ts.rmw_device_fastpath == dev_before
    (g,), _ = p.run(lambda s: s.kget(1, "nz"))
    assert g == ("ok", 101)

    # kmodify after an unflushed kput sees the queued handle write
    (rp, rm), _ = p.run(lambda s: [s.kput(1, "u", b"payload"),
                                   s.kmodify(1, "u", ref("rmw:add", 1), 0)])
    assert rp[0] == "ok" and rm == "failed"

    # a put flips an inline slot to handle storage and a delete back
    p.run(lambda s: s.kmodify(2, "f", ref("rmw:add", 9), 0))
    p.run(lambda s: s.kput(2, "f", b"blob"))
    (r,), _ = p.run(lambda s: s.kmodify(2, "f", ref("rmw:add", 1), 0))
    assert r == "failed"
    p.run(lambda s: s.kdelete(2, "f"))
    p.run(lambda s: s.kmodify(2, "f", ref("rmw:add", 4), 0))
    (g,), _ = p.run(lambda s: s.kget(2, "f"))
    assert g == ("ok", 4)

    # numpy operand and default take the device path
    dev_before = p.ts.rmw_device_fastpath
    (r,), n = p.run(lambda s: s.kmodify(3, "np", ref("rmw:add",
                                                     np.int32(4)),
                                        np.int32(0)))
    assert r[0] == "ok" and n == 1
    assert p.ts.rmw_device_fastpath == dev_before + 1

    # ksafe_delete: hit, stale version, unknown key
    (w,), _ = p.run(lambda s: s.kput(3, "sd", b"v"))
    (r1, r2), _ = p.run(lambda s: [s.ksafe_delete(3, "sd", (0, 1)),
                                   s.ksafe_delete(3, "sd", w[1])])
    assert r1 == "failed" and r2[0] == "ok"
    (r,), n = p.run(lambda s: s.ksafe_delete(3, "never", (1, 1)))
    assert r == "failed" and n == 0
    (g,), _ = p.run(lambda s: s.kget(3, "sd"))
    assert g == ("ok", "NOTFOUND")

    # a lease lapse between RMWs (fast arm: the host read misses)
    p.tick(5.0)
    (r,), _ = p.run(lambda s: s.kmodify(0, "ctr", lambda v, c: c + 1, 0))
    assert r[0] == "ok"
    p.check()
    if compact:
        assert p.ts.payload_bytes < p.ts.payload_bytes_full_width
        assert p.js.payload_bytes == p.ts.payload_bytes


def _random_op(rng, s, e, key, ref):
    op = int(rng.integers(0, 11))
    names = ["rmw:add", "rmw:sub", "rmw:max", "rmw:min", "rmw:set",
             "rmw:band", "rmw:bor", "rmw:bxor", "rmw:put_if_absent"]
    fun = ref(names[int(rng.integers(0, len(names)))],
              int(rng.integers(-50, 50)))
    val = int(rng.integers(0, 1000))
    if op == 0:
        return s.kmodify(e, key, fun, 0)
    if op == 1:
        return s.kmodify(e, key, _incr, 0, retries=4)
    if op == 2:
        return s.kmodify_many(e, [key, key + "'", key], fun)
    if op == 3:
        return s.kput(e, key, val)
    if op == 4:
        return s.kget(e, key)
    if op == 5:
        return s.kget_vsn(e, key)
    if op == 6:
        return s.kdelete(e, key)
    if op == 7:
        return s.ksafe_delete(e, key, (int(rng.integers(0, 3)),
                                       int(rng.integers(0, 4))))
    if op == 8:
        return s.kget_many(e, [key, key + "'"], want_vsn=bool(val % 2))
    if op == 9:
        return s.kmodify(e, key, fun, 1)        # non-zero default
    return s.kput_many(e, [key, key + "'"], [val, val + 1])


@pytest.mark.parametrize("fast,comm,seed", [(True, True, 1),
                                            (False, False, 2)],
                         ids=["fast-comm", "nofast-nocomm"])
def test_rmw_random_stream_matches_jax(pair, fast, comm, seed):
    e, m, s = 4, 3, 8
    p = pair(fast, comm, e=e, m=m, s=s, k=4)
    rng = np.random.default_rng(seed)
    for step in range(40):
        for _ in range(int(rng.integers(1, 8))):
            draw = rng.bit_generator.state
            ens = int(rng.integers(0, e))
            key = f"k{int(rng.integers(0, 6))}"
            for i, svc in enumerate((p.js, p.ts)):
                rng.bit_generator.state = draw
                rng.integers(0, e)
                rng.integers(0, 6)
                f = _random_op(rng, svc, ens, key, tfunref.ref)
                p.futs[i].append(f)
        if step % 7 == 3:
            ens, peer = int(rng.integers(0, e)), int(rng.integers(0, m))
            up = bool(rng.integers(0, 3))
            for svc in (p.js, p.ts):
                svc.set_peer_up(ens, peer, up)
        p.flush()
        p.tick(float(rng.choice([0.0, 0.2, 0.6])))
    for svc in (p.js, p.ts):
        svc.up[:] = True
        svc._up_dev = None
    p.check()
    flat = [r for f in p.futs[1] for r in
            (f.value if isinstance(f.value, list) else [f.value])]
    assert any(r == "failed" for r in flat)
    assert sum(isinstance(r, tuple) and r[0] == "ok" for r in flat) > 40
    assert p.ts.rmw_device_fastpath > 10
