"""The enqueue half's host passes in the port — the pending slab, its C++
pack and the completion-slab gather — against their plain numpy versions
and the JAX package's passes, and the port's service at its default
(native) host arm and at its oracle arm against the JAX service in
lockstep (the mirror of ``tests/test_native_enqueue.py``):

- fuzzed runs through ``NativeEnqueue.pack`` / ``.gather``, the plain
  ``pack_plain`` / ``gather_plain`` and the JAX package's
  ``NativeEnqueue``: equal planes and completion slabs, K = 0 included;
  a run outside the grid raises;
- seeded keyed streams (``kput`` / ``kget`` / ``kupdate`` / ``kdelete``
  / ``kput_many`` / ``kget_many`` / ``kmodify`` / ``kmodify_many``, host
  and device RMW) through the port and the JAX service together, fast
  reads on and off, compaction on and off (sliced launches at E = 256),
  depth 1 and 2: the default arms against each other (the JAX service's
  ``.so`` asserted loaded), the ``False`` arms against the JAX
  ``RETPU_NATIVE_ENQUEUE=0 RETPU_NATIVE_RESOLVE=0`` arm, each ``False``
  alone against the JAX service with that knob alone at 0, the port's
  plain passes against the JAX arm with no host library.  Futures, packed
  buffers, the five mirror slabs, the engine state and the counters
  (``native_*_flushes``, ``fallback_*_flushes``, ``completion_wakes``,
  ``completion_rows``) are compared exactly;
- one wake per op-carrying flush; on every arm a read issued from a
  write's ack hits the mirror the write left; a leased read racing a
  slab-enqueued write takes the device round; a compacted payload
  unpacks through the C++ pass and a full-width one with numpy; a host
  compiler that does not exist raises when the service is built.

The reference's WAL cases wait for the WAL slice.  Tolerance: exact
equality everywhere.
"""

import os
import shutil

import numpy as np
import pytest

from riak_ensemble_tpu_torch import funref as tfunref
from riak_ensemble_tpu_torch import interop
from riak_ensemble_tpu_torch.ops import build
from riak_ensemble_tpu_torch.ops import engine as teng
from riak_ensemble_tpu_torch.parallel import batched_host as tb
from riak_ensemble_tpu_torch.parallel import enqueue_native as ten
from test_torch_compaction import norm
from test_torch_kmodify import FixedClock, _record_packed

#: the JAX service's environment per port arm ("default" and "oracle"
#: leave compaction and fast reads to the case)
JAX_ENV = {"default": {"RETPU_OBS": "0"},
           "plain": {"RETPU_OBS": "0"},
           "oracle": {"RETPU_OBS": "0", "RETPU_NATIVE_ENQUEUE": "0",
                      "RETPU_NATIVE_RESOLVE": "0"},
           "enqueue_only": {"RETPU_OBS": "0", "RETPU_NATIVE_RESOLVE": "0"},
           "resolve_only": {"RETPU_OBS": "0", "RETPU_NATIVE_ENQUEUE": "0"}}
PORT_KW = {"default": {},
           "plain": {"plain_host_passes": True},
           "oracle": {"native_enqueue": False, "native_resolve": False},
           "enqueue_only": {"native_resolve": False},
           "resolve_only": {"native_enqueue": False}}
UNSET = ("RETPU_NATIVE_ENQUEUE", "RETPU_NATIVE_RESOLVE", "RETPU_COMPACT",
         "RETPU_FAST_READS", "RETPU_WIDE", "RETPU_COMM_REPL", "RETPU_DONATE",
         "RETPU_RESOLVE_SHARDS", "RETPU_ADMISSION")
COUNTERS = ("native_enqueue_flushes", "fallback_enqueue_flushes",
            "native_resolve_flushes", "fallback_resolve_flushes",
            "completion_wakes", "completion_rows")
MIRRORS = ("_slot_vsn_np", "_slot_vsn_ok", "_inline_value_np",
           "_inline_value_ok", "_inline_np")


def _jax_env(monkeypatch, arm, fast, compact):
    for key in UNSET:
        monkeypatch.delenv(key, raising=False)
    for key, v in JAX_ENV[arm].items():
        monkeypatch.setenv(key, v)
    if not fast:
        monkeypatch.setenv("RETPU_FAST_READS", "0")
    if not compact:
        monkeypatch.setenv("RETPU_COMPACT", "0")


def _host_incr(vsn, cur):
    return int(cur) + 1


def _stream(rng, svc, ens, r, out):
    """One round of seeded keyed ops on ``ens`` (the same calls on
    either service for the same generator state)."""
    add = tfunref.ref("rmw:add", 1)    # plain tuples in both packages
    for e in ens:
        keys = [f"k{(r + i) % 7}" for i in range(4)]
        pick = int(rng.integers(0, 9))
        if pick == 0:
            out.append(svc.kput_many(e, keys, [f"v{r}.{i}" for i in
                                               range(4)]))
        elif pick == 1:
            out.append(svc.kget_many(e, keys + keys[:1],
                                     want_vsn=bool(rng.integers(0, 2))))
        elif pick == 2:
            out.append(svc.kput(e, keys[0], f"s{r}"))
            out.append(svc.kget(e, keys[1]))
        elif pick == 3:
            out.append(svc.kupdate(e, keys[0], (0, 0), f"c{r}"))
            out.append(svc.kdelete(e, keys[2]))
        elif pick == 4:
            out.append(svc.kget_vsn(e, keys[3]))
            out.append(svc.kput_once(e, f"once{r % 2}", f"o{r}"))
        elif pick == 5:
            out.append(svc.kmodify(e, f"ctr{r % 3}", add, 0))
            out.append(svc.kmodify(e, f"ctr{r % 3}",
                                   tfunref.ref("rmw:set", 0), 0))
        elif pick == 6:
            out.append(svc.kmodify_many(e, [f"ctr{r % 3}", "ctr9",
                                            f"ctr{r % 3}"], add, 0))
        elif pick == 7:
            out.append(svc.kmodify(e, "host", _host_incr, 0))
            out.append(svc.kmodify(e, "host", _host_incr, 0))
        else:
            out.append(svc.kget_many(e, [f"ctr{r % 3}", "ctr9", "host"]))


class Pair:
    """The JAX service and the port's, one arm each, driven together."""

    def __init__(self, jb, monkeypatch, arm, fast=True, compact=True,
                 depth=1, e=256, m=3, s=16, k=4):
        _jax_env(monkeypatch, arm, fast, compact)
        if arm == "plain":
            from riak_ensemble_tpu.parallel import enqueue_native, \
                resolve_native
            for mod in (enqueue_native, resolve_native):
                monkeypatch.setattr(mod, "_instance", None)
                monkeypatch.setattr(mod, "_instance_tried", True)
        self.js = jb.BatchedEnsembleService(
            FixedClock(), e, m, s, tick=None, max_ops_per_tick=k,
            pipeline_depth=depth)
        self.ts = tb.BatchedEnsembleService(
            FixedClock(), e, m, s, tick=None, max_ops_per_tick=k,
            device="cpu", compact=compact, pipeline_depth=depth,
            **PORT_KW[arm])
        self.ts.set_fast_reads(fast)
        js, ts = self.js, self.ts
        if arm == "default":
            assert js._native_resolve is not None
            assert js._native_enqueue is not None and js._enq_slab
            assert ts._native_resolve is not None
            assert ts._native_enqueue is not None
        elif arm == "plain":
            assert js._enq_slab and js._native_enqueue is None
            assert js._native_resolve is None
            assert ts._enq_slab and ts._native_enqueue is None
            assert ts._native_resolve is None
        elif arm == "enqueue_only":
            assert js._enq_slab and js._native_enqueue is not None
            assert js._native_resolve is None
            assert ts._enq_slab and ts._native_enqueue is not None
            assert ts._native_resolve is None
        elif arm == "resolve_only":
            assert not js._enq_slab and js._native_resolve is not None
            assert not ts._enq_slab and ts._native_resolve is not None
        else:
            assert not js._enq_slab and js._native_resolve is None
            assert not ts._enq_slab and ts._native_resolve is None
        assert js._compact == ts._compact == compact
        assert js._fast_reads == ts._fast_reads == fast
        self.bufs = ([], [])
        _record_packed(js, self.bufs[0])
        _record_packed(ts, self.bufs[1])
        self.futs = ([], [])

    def run(self, seed, rounds=8, n_active=16):
        rng = np.random.default_rng(seed)
        ens = rng.choice(self.js.n_ens, n_active, replace=False).tolist()
        for r in range(rounds):
            state = rng.bit_generator.state
            for i, svc in enumerate((self.js, self.ts)):
                rng.bit_generator.state = state
                _stream(rng, svc, ens, r, self.futs[i])
            while any(self.js.queues) or any(self.ts.queues) \
                    or self.js._retry_at or self.ts._retry_at:
                assert self.js.flush() == self.ts.flush()
            assert self.js.flush() == self.ts.flush()
            self.js.runtime.now += 0.25
            self.ts.runtime.now += 0.25

    def check(self):
        js, ts = self.js, self.ts
        assert all(f.done for fl in self.futs for f in fl)
        assert [norm(f.value) for f in self.futs[1]] == \
            [norm(f.value) for f in self.futs[0]]
        assert len(self.bufs[0]) == len(self.bufs[1]) > 0
        for i, (a, b) in enumerate(zip(*self.bufs)):
            assert np.array_equal(a, b), f"packed buffer {i} differs"
        tn = interop.state_to_numpy(ts.state)
        for f in tn._fields:
            assert np.array_equal(np.asarray(getattr(js.state, f)),
                                  getattr(tn, f)), f
        for name in MIRRORS + ("leader_np", "lease_until", "_corrupt_rows"):
            assert np.array_equal(getattr(js, name), getattr(ts, name)), \
                name
        for name in COUNTERS + (
                "key_slot", "slot_handle", "_inline_slots", "_pending_writes",
                "_queued_handle_writes", "flushes", "ops_served",
                "read_fastpath_hits", "read_fastpath_miss_reasons",
                "rmw_conflicts", "rmw_device_fastpath", "payload_bytes"):
            got = getattr(ts, name)
            want = getattr(js, name)
            assert got == want, (name, got, want)


@pytest.fixture
def jb():
    pytest.importorskip("jax")
    from riak_ensemble_tpu.parallel import batched_host as jb
    return jb


# -- the passes --------------------------------------------------------------


def _slab(rng, k, e, n_ent):
    """Random run descriptors that tile disjoint rows of random columns,
    and their lanes."""
    cols = rng.choice(e, min(n_ent, e), replace=False)
    ec, er, el = [], [], []
    for c in cols:
        row = 0
        while row < k and len(ec) < n_ent:
            n = int(rng.integers(1, k - row + 1))
            ec.append(c)
            er.append(row)
            el.append(n)
            row += n
            if rng.random() < 0.3:
                break
    ec, er, el = (np.asarray(x, np.int32) for x in (ec, er, el))
    ek = rng.integers(0, 5, len(ec)).astype(np.int32)
    n = int(el.sum())
    lanes = [rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(
        np.int32) for _ in range(4)]
    return ec, er, el, ek, lanes


def _planes(k, e):
    return [np.zeros((k, e), np.int32) for _ in range(5)]


@pytest.mark.parametrize("seed", range(3))
def test_pack_gather_fuzz(jb, seed):
    """Random pending slabs (K = 0 included) through the port's C++ pack
    and gather, their plain versions and the JAX package's passes."""
    from riak_ensemble_tpu.parallel import enqueue_native as jen
    jnat = jen.get()
    assert jnat is not None, "the JAX package's host library did not load"
    tnat = ten.get()
    rng = np.random.default_rng(seed)
    for trial in range(40):
        k = int(rng.integers(0, 9))
        e = int(rng.integers(1, 40))
        n_ent = int(rng.integers(0, 30)) if k else 0
        ec, er, el, ek, lanes = _slab(rng, k, e, n_ent)
        outs = [_planes(k, e) for _ in range(3)]
        tnat.pack(k, e, ec, er, el, ek, *lanes, *outs[0])
        ten.pack_plain(k, e, ec, er, el, ek, *lanes, *outs[1])
        assert jnat.pack(k, e, ec, er, el, ek, *lanes, *outs[2])
        for a, b, c in zip(*outs):
            assert np.array_equal(a, b) and np.array_equal(b, c), trial
        committed, get_ok, found = (rng.random((k, e)) < 0.5
                                    for _ in range(3))
        value = rng.integers(-2 ** 31, 2 ** 31, (k, e),
                             dtype=np.int64).astype(np.int32)
        vsn = rng.integers(0, 2 ** 31, (k, e, 2)).astype(np.int32)
        n = int(el.sum())
        u8 = [tb._u8view(x) for x in (committed, get_ok, found)]
        got = tnat.gather(k, e, ec, er, el, *u8, value, vsn, n)
        plain = ten.gather_plain(k, e, ec, er, el, committed, get_ok, found,
                                 value, vsn, n)
        ref = jnat.gather(k, e, ec, er, el, *u8, value, vsn, n)
        for a, b, c in zip(got, plain, ref):
            assert a.dtype == b.dtype == c.dtype
            assert np.array_equal(a, b) and np.array_equal(b, c), trial


def test_pack_refuses_a_run_outside_the_grid():
    tnat = ten.get()
    lanes = [np.zeros(3, np.int32) for _ in range(4)]
    for col, row0 in ((5, 0), (-1, 0), (0, 2)):
        with pytest.raises(IndexError):
            tnat.pack(4, 5, np.asarray([col], np.int32),
                      np.asarray([row0], np.int32),
                      np.asarray([3], np.int32), np.asarray([1], np.int32),
                      *lanes, *_planes(4, 5))
    with pytest.raises(TypeError):
        tnat.pack(4, 5, np.asarray([0], np.int64),
                  np.asarray([0], np.int32), np.asarray([3], np.int32),
                  np.asarray([1], np.int32), *lanes, *_planes(4, 5))


# -- the service against the JAX service --------------------------------------


@pytest.mark.parametrize("fast,compact,depth", [
    (True, True, 1), (True, True, 2), (False, True, 2), (True, False, 1),
    (False, False, 2)])
def test_default_arm_matches_jax_default(jb, monkeypatch, fast, compact,
                                         depth):
    """The port's default host arm against the JAX service's default
    (``RETPU_NATIVE_ENQUEUE`` / ``RETPU_NATIVE_RESOLVE`` unset)."""
    p = Pair(jb, monkeypatch, "default", fast, compact, depth)
    p.run(seed=depth + 2 * fast + 4 * compact)
    p.check()
    ts = p.ts
    assert ts.native_enqueue_flushes > 0 and ts.fallback_enqueue_flushes == 0
    assert ts.native_resolve_flushes > 0
    assert ts.completion_wakes == ts.native_enqueue_flushes
    if compact:
        assert ts.sliced_launches > 0


@pytest.mark.parametrize("depth", (1, 2))
def test_plain_passes_match_jax_without_host_library(jb, monkeypatch, depth):
    """``plain_host_passes`` against the JAX service whose host library
    did not load: the slab path with the numpy pack and gather, the
    Python unpack and mirror walk."""
    p = Pair(jb, monkeypatch, "plain", depth=depth)
    p.run(seed=20 + depth)
    p.check()
    ts = p.ts
    assert ts.native_enqueue_flushes == ts.native_resolve_flushes == 0
    assert ts.fallback_enqueue_flushes == ts.completion_wakes > 0


@pytest.mark.parametrize("arm,depth,compact", [
    ("enqueue_only", 1, True), ("enqueue_only", 2, False),
    ("resolve_only", 1, True), ("resolve_only", 2, False)])
def test_mixed_arms_match_jax(jb, monkeypatch, arm, depth, compact):
    """One native half alone against the JAX service with the other knob
    at 0: the slab path with the Python unpack and mirror walk
    (``RETPU_NATIVE_RESOLVE=0``), and the per-op loops over the C++
    unpack and mirror scatter, which skip their own mirror writes
    (``RETPU_NATIVE_ENQUEUE=0``)."""
    p = Pair(jb, monkeypatch, arm, compact=compact, depth=depth)
    p.run(seed=30 + depth)
    p.check()
    ts = p.ts
    if arm == "enqueue_only":
        assert ts.native_enqueue_flushes == ts.completion_wakes > 0
        assert ts.native_resolve_flushes == 0
    else:
        assert ts.native_resolve_flushes > 0
        assert ts.completion_wakes == ts.native_enqueue_flushes == \
            ts.fallback_enqueue_flushes == 0


# -- behaviour ---------------------------------------------------------------


def _svc(**kw):
    kw.setdefault("max_ops_per_tick", 4)
    return tb.BatchedEnsembleService(FixedClock(), 2, 3, 64, tick=None,
                                     device="cpu", **kw)


@pytest.mark.parametrize("plain", (False, True))
def test_completion_slab_one_wake_per_flush(plain):
    """One wake per settled op-carrying flush, rounds conserved, at depth
    2 with a batch split across three flushes by the K cap."""
    svc = _svc(pipeline_depth=2, plain_host_passes=plain)
    keys = [f"k{i}" for i in range(10)]
    f = svc.kput_many(0, keys, [f"v{i}" for i in range(10)])
    while not f.done:
        svc.flush()
    svc.flush()
    assert [r[0] for r in f.value] == ["ok"] * 10
    assert svc.completion_wakes == 3 and svc.completion_rows == 10
    assert (svc.native_enqueue_flushes, svc.fallback_enqueue_flushes) == \
        ((0, 3) if plain else (3, 0))
    # an election-only launch carries no ops: no wake, and its unpack is
    # the Python one in either arm
    before = (svc.completion_wakes, svc.fallback_resolve_flushes)
    svc.set_peer_up(1, int(svc.leader_np[1]), False)
    svc.flush()
    assert svc.completion_wakes == before[0]
    assert svc.fallback_resolve_flushes == before[1] + 1


def test_oracle_arm_takes_no_slab():
    svc = _svc(native_enqueue=False, native_resolve=False)
    f = svc.kput_many(0, ["k"], ["v"])
    g = svc.kget(0, "k")
    while not (f.done and g.done):
        svc.flush()
    assert f.value == [("ok", (1, 1))] and g.value == ("ok", "v")
    assert svc.completion_wakes == svc.native_enqueue_flushes == \
        svc.fallback_enqueue_flushes == svc.native_resolve_flushes == 0
    assert svc.fallback_resolve_flushes == 1


def test_leased_read_racing_slab_write_falls_back():
    """A slab-enqueued write is visible to the fast-read gate when it is
    queued: a leased read of the slot takes the device round, which
    orders it after the write."""
    svc = _svc()
    for v in ("v0", "v1"):
        f = svc.kput_many(0, ["k"], [v])
        while not f.done:
            svc.flush()
    g0 = svc.kget(0, "k")
    assert g0.done and g0.value == ("ok", "v1")
    assert svc.read_fastpath_hits == 1
    f2 = svc.kput_many(0, ["k"], ["v2"])
    g = svc.kget(0, "k")
    assert not g.done, "read served around a pending slab write"
    assert svc.read_fastpath_miss_reasons.get("pending_write") == 1
    while not (f2.done and g.done):
        svc.flush()
    assert g.value == ("ok", "v2")
    # the mirror was written before the ack: the next read is fast
    h = svc.kget(0, "k")
    assert h.done and h.value == ("ok", "v2")


@pytest.mark.parametrize("arm", sorted(PORT_KW))
def test_mirror_written_before_ack(arm):
    """On every host arm a committed write's mirror is in place when its
    future resolves: a read issued from the ack itself is served at once
    from the mirrors, with the value and version just written (handle-
    class puts, batch and scalar, and a device RMW's inline counter)."""
    svc = _svc(**PORT_KW[arm])
    f = svc.kput_many(0, ["a"], ["v0"])
    while not f.done:
        svc.flush()
    seen = {}

    def read_back(e, keys):
        def waiter(_value):
            gets = [g for key in keys
                    for g in (svc.kget(e, key), svc.kget_vsn(e, key))]
            seen[keys[0]] = [g.value if g.done else "queued" for g in gets]
        return waiter
    add = tfunref.ref("rmw:add", 1)
    futs = [svc.kput_many(0, ["a", "b"], ["v1", "v2"]),
            svc.kput(1, "c", "v3"), svc.kmodify(1, "ctr", add, 0)]
    futs[0].add_waiter(read_back(0, ["a", "b"]))
    futs[1].add_waiter(read_back(1, ["c"]))
    futs[2].add_waiter(read_back(1, ["ctr"]))
    while not all(f.done for f in futs):
        svc.flush()
    assert seen == {
        "a": [("ok", "v1"), ("ok", "v1", (1, 2)),
              ("ok", "v2"), ("ok", "v2", (1, 3))],
        "c": [("ok", "v3"), ("ok", "v3", (1, 1))],
        "ctr": [("ok", 1), ("ok", 1, (1, 2))]}, arm
    assert svc.waiter_errors == 0


def test_missing_host_compiler_raises(monkeypatch, tmp_path):
    """The host library is built when a native arm is; a compiler that
    does not exist raises instead of falling back."""
    monkeypatch.setattr(build, "HOST_CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g"):
        _svc()
    with pytest.raises(RuntimeError, match="no-such-g"):
        _svc(native_enqueue=False)
    # the arms that run no C++ build nothing
    _svc(native_enqueue=False, native_resolve=False)
    _svc(plain_host_passes=True)


def test_host_library_name_moves_with_sources_compiler_and_flags(
        tmp_path, monkeypatch):
    host = tmp_path / "host"
    shutil.copytree(build.HOST_DIR, host)
    monkeypatch.setattr(build, "HOST_DIR", str(host))
    names = [build._host_lib_path()]
    assert names[0] == build._host_lib_path()
    assert os.path.dirname(names[0]) == build.BUILD_DIR
    with open(host / "resolvekernel.cc", "a") as f:
        f.write("\n// edited\n")
    names.append(build._host_lib_path())
    monkeypatch.setattr(build, "HOST_FLAGS", build.HOST_FLAGS + ("-g",))
    names.append(build._host_lib_path())
    monkeypatch.setattr(build, "HOST_CXX", "c++")
    names.append(build._host_lib_path())
    assert len(set(names)) == 4


def test_execute_unpacks_natively():
    """``execute`` launches settle on the native arm (counted like the
    reference) and take no slab.  The arm hands a compacted payload to
    the C++ unpack and unpacks a full-width one with numpy."""
    def spy(svc):
        calls = []
        unpack = svc._native_resolve.unpack

        def run(flat, e, m, k, want_vsn, active, a_width, sliced):
            calls.append(active is not None)
            return unpack(flat, e, m, k, want_vsn, active, a_width, sliced)
        svc._native_resolve.unpack = run
        return calls

    svc = _svc()
    calls = spy(svc)
    kind = np.full((2, 2), teng.OP_PUT, np.int32)
    committed, _, _, _ = svc.execute(kind, np.zeros((2, 2), np.int32),
                                     np.ones((2, 2), np.int32))
    assert committed.all()
    assert svc.native_resolve_flushes == 1 and svc.completion_wakes == 0
    assert calls == [] and svc.sliced_launches == 0
    # one column of 16 carries ops: a compacted (pack-gather) payload
    svc = tb.BatchedEnsembleService(FixedClock(), 16, 3, 64, tick=None,
                                    max_ops_per_tick=4, device="cpu")
    svc.flush()
    calls = spy(svc)
    kind = np.full((2, 16), teng.OP_NOOP, np.int32)
    kind[:, 3] = teng.OP_PUT
    committed, _, _, _ = svc.execute(kind, np.zeros((2, 16), np.int32),
                                     np.ones((2, 16), np.int32))
    assert committed[:, 3].all() and not committed[:, :3].any()
    assert calls == [True]
    assert svc.native_resolve_flushes == 1
