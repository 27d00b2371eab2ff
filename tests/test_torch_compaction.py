"""Active-column compaction in the port against the JAX package's DEFAULT
arm (``RETPU_COMPACT`` unset, fast reads on, ``RETPU_NATIVE_RESOLVE=0
RETPU_NATIVE_ENQUEUE=0 RETPU_OBS=0``) — the mirror of
``tests/test_active_compaction.py``:

- the pack / unpack layout through an active index (pow2 padding, the
  pack-gather and the sliced layouts), byte-equal to the JAX pack;
- the skew-load sweep through ``execute`` with the sliced strength
  (E = 256, A <= E/4) and the pack-gather strength (A > E/4, and a small
  grid) both engaging: results, packed buffers, every state plane,
  ``lease_until``, ``payload_bytes`` and the occupancy equal;
- the keyed path with device RMW; the corrupt flag of a sliced launch
  reaching the exchange and the scrub;
- the fault the compaction slice closed: after a sparse flush at
  E >= 256 the reference renews only the active rows' leases, so the
  port's ``lease_until`` and fast-read counters must equal its own;
- the engine: ``full_step_sliced_plain`` against the JAX
  ``full_step_sliced`` on the same seeded inputs, pads present with row
  E - 1 active and idle; the host index checks of sliced F1; and a
  ``cuda``-marked test holding sliced F1 against its plain version.

Tolerance: exact equality everywhere.
"""

import numpy as np
import pytest
import torch

from riak_ensemble_tpu_torch import funref as tfunref
from riak_ensemble_tpu_torch import interop
from riak_ensemble_tpu_torch.ops import cuda_engine
from riak_ensemble_tpu_torch.ops import engine as teng
from riak_ensemble_tpu_torch.parallel import batched_host as tb
from riak_ensemble_tpu_torch.types import NOTFOUND as T_NOTFOUND
from test_torch_kmodify import FixedClock, _record_packed

#: the JAX service's default arm, less the native and obs planes the
#: port does not have
DEFAULT_ENV = {"RETPU_NATIVE_RESOLVE": "0", "RETPU_NATIVE_ENQUEUE": "0",
               "RETPU_OBS": "0"}
UNSET = ("RETPU_COMPACT", "RETPU_FAST_READS", "RETPU_WIDE",
         "RETPU_COMM_REPL", "RETPU_DONATE")


def norm(x):
    if x is T_NOTFOUND or type(x).__name__ == "_NotFound":
        return "NOTFOUND"
    if isinstance(x, (list, tuple)):
        return type(x)(norm(y) for y in x)
    return x


class Lockstep:
    """The JAX service at its default arm and the port's at its
    defaults (plus ``port_kw``), driven together on fixed clocks."""

    def __init__(self, jb, e, m, s, k, **port_kw):
        self.js = jb.BatchedEnsembleService(FixedClock(), e, m, s,
                                            tick=None, max_ops_per_tick=k,
                                            pipeline_depth=port_kw.get(
                                                "pipeline_depth", 1))
        self.ts = tb.BatchedEnsembleService(FixedClock(), e, m, s,
                                            tick=None, max_ops_per_tick=k,
                                            device="cpu", **port_kw)
        assert self.js._compact and self.js._fast_reads
        assert self.js._native_resolve is None and not self.js._enq_slab
        assert self.ts._compact and self.ts._fast_reads
        self.bufs = ([], [])
        _record_packed(self.js, self.bufs[0])
        _record_packed(self.ts, self.bufs[1])
        self.futs = ([], [])

    def both(self, fn):
        """``fn(svc)`` on both; returns the two results."""
        return fn(self.js), fn(self.ts)

    def submit(self, fn):
        for i, svc in enumerate((self.js, self.ts)):
            got = fn(svc)
            self.futs[i].extend(got if isinstance(got, list) else [got])

    def tick(self, dt):
        self.js.runtime.now += dt
        self.ts.runtime.now += dt

    def drain(self):
        while any(self.js.queues) or any(self.ts.queues):
            assert self.js.flush() == self.ts.flush()
        assert self.js.flush() == self.ts.flush()   # idle: settles a tail

    def check(self):
        js, ts = self.js, self.ts
        assert all(f.done for fl in self.futs for f in fl)
        assert [norm(f.value) for f in self.futs[1]] == \
            [norm(f.value) for f in self.futs[0]]
        assert len(self.bufs[0]) == len(self.bufs[1]) > 0
        for i, (a, b) in enumerate(zip(*self.bufs)):
            assert a.dtype == b.dtype == np.uint8, i
            assert np.array_equal(a, b), f"packed buffer {i} differs"
        tn = interop.state_to_numpy(ts.state)
        for f in tn._fields:
            assert np.array_equal(np.asarray(getattr(js.state, f)),
                                  getattr(tn, f)), f
        for name in ("leader_np", "lease_until", "_slot_vsn_np",
                     "_slot_vsn_ok", "_corrupt_rows", "_inline_value_np"):
            assert np.array_equal(getattr(js, name), getattr(ts, name)), \
                name
        for name in ("payload_bytes", "payload_bytes_full_width",
                     "read_fastpath_hits", "read_fastpath_misses",
                     "read_fastpath_miss_reasons", "corruptions", "repairs",
                     "flushes", "ops_served", "key_slot", "slot_handle"):
            assert getattr(js, name) == getattr(ts, name), name
        assert js.stats()["grid_occupancy"] == ts.grid_occupancy


@pytest.fixture
def jb(monkeypatch):
    pytest.importorskip("jax")
    for key in UNSET:
        monkeypatch.delenv(key, raising=False)
    for key, v in DEFAULT_ENV.items():
        monkeypatch.setenv(key, v)
    from riak_ensemble_tpu.parallel import batched_host as jb
    return jb


# -- layout round trip -------------------------------------------------------


def _result_planes(rng, k, e, m, cols):
    """Result planes with client data only in ``cols`` (what a launch
    produces) and full-width won / quorum / corrupt planes."""
    def bplane():
        full = np.zeros((k, e), bool)
        full[:, cols] = rng.random((k, len(cols))) < 0.5
        return full
    value = np.zeros((k, e), np.int32)
    value[:, cols] = rng.integers(-2 ** 31, 2 ** 31, (k, len(cols)),
                                  dtype=np.int64)
    vsn = np.zeros((k, e, 2), np.int32)
    vsn[:, cols] = rng.integers(0, 100, (k, len(cols), 2))
    planes = dict(committed=bplane(), get_ok=bplane(), found=bplane(),
                  value=value, obj_vsn=vsn,
                  quorum_ok=rng.random((k, e)) < 0.5,
                  tree_corrupt=rng.random((k, e, m)) < 0.1)
    return rng.random(e) < 0.5, planes


@pytest.mark.parametrize("cols,a_width", [
    ([2, 7, 8, 21], 4),       # exact pow2 fit
    ([0, 3, 9, 20, 30], 8),   # padded bucket (pad repeats index 0)
    ([31], 1),                # single hot column
])
def test_pack_unpack_roundtrip_active(jb, cols, a_width):
    import jax.numpy as jnp

    from riak_ensemble_tpu.ops import engine as jeng
    rng = np.random.default_rng(7)
    k, e, m = 5, 32, 3
    cols = np.asarray(cols, np.int32)
    won, planes = _result_planes(rng, k, e, m, cols)
    pad = np.zeros((a_width,), np.int32)
    pad[:len(cols)] = cols
    t_res = teng.KvResult(**{f: torch.from_numpy(a)
                             for f, a in planes.items()})
    j_res = jeng.KvResult(**{f: jnp.asarray(a) for f, a in planes.items()})
    for want_vsn in (False, True):
        full = tb._pack_results_body(torch.from_numpy(won), t_res,
                                     want_vsn).numpy()
        comp = tb._pack_results_body(torch.from_numpy(won), t_res, want_vsn,
                                     active_idx=torch.from_numpy(pad)).numpy()
        want = np.asarray(jb._pack_results(jnp.asarray(won), j_res, want_vsn,
                                           active_idx=jnp.asarray(pad)))
        assert np.array_equal(comp, want)
        assert comp.nbytes < full.nbytes
        assert comp.nbytes == tb.packed_nbytes(e, m, k, want_vsn, a_width) \
            == jb.packed_nbytes(e, m, k, want_vsn, a_width)
        o_full = tb.unpack_results(full, e, m, k, want_vsn)
        o_comp = tb.unpack_results(comp, e, m, k, want_vsn, active=cols,
                                   a_width=a_width)
        o_jax = jb.unpack_results(want, e, m, k, want_vsn, active=cols,
                                  a_width=a_width)
        for name, a, b, c in zip(("won", "quorum", "corrupt", "committed",
                                  "get_ok", "found", "value", "vsn"),
                                 o_full, o_comp, o_jax):
            assert (a is None and b is None and c is None) or (
                np.array_equal(a, b) and np.array_equal(b, c)), name


def test_pack_unpack_sliced_layout(jb):
    """A sliced launch's planes are A-wide, won / quorum / corrupt
    included: the port's pack and unpack agree with the JAX package's
    byte for byte, and the unpack scatters every plane back to E."""
    import jax.numpy as jnp

    from riak_ensemble_tpu.ops import engine as jeng
    rng = np.random.default_rng(8)
    k, e, m, aw = 3, 300, 3, 8
    active = np.asarray([4, 17, 150, 299], np.int32)
    won, planes = _result_planes(rng, k, aw, m, np.arange(aw))
    t_res = teng.KvResult(**{f: torch.from_numpy(a)
                             for f, a in planes.items()})
    j_res = jeng.KvResult(**{f: jnp.asarray(a) for f, a in planes.items()})
    got = tb._pack_results_body(torch.from_numpy(won), t_res, True).numpy()
    want = np.asarray(jb._pack_results(jnp.asarray(won), j_res, True))
    assert np.array_equal(got, want)
    ours = tb.unpack_results(got, e, m, k, True, active=active, a_width=aw,
                             sliced=True)
    theirs = jb.unpack_results(want, e, m, k, True, active=active,
                               a_width=aw, sliced=True)
    for a, b in zip(ours, theirs):
        assert a.shape[:2] == b.shape[:2] and np.array_equal(a, b)
    assert ours[0].shape == (e,) and ours[3].shape == (k, e)


# -- the skew-load equivalence sweep ----------------------------------------


def _skew_planes(rng, n_ens, n_slots, k, n_light):
    """Column 0 hot at full depth k (PUT / GET / CAS / RMW / tombstone),
    ``n_light`` other columns 1-3 deep, the rest idle."""
    kind = np.zeros((k, n_ens), np.int32)
    slot = np.zeros((k, n_ens), np.int32)
    val = np.zeros((k, n_ens), np.int32)
    exp_e = np.zeros((k, n_ens), np.int32)
    exp_s = np.zeros((k, n_ens), np.int32)

    def fill(col, depth):
        kinds = rng.choice([teng.OP_PUT, teng.OP_GET, teng.OP_CAS,
                            teng.OP_RMW, teng.OP_PUT], depth,
                           p=[0.35, 0.25, 0.15, 0.15, 0.1])
        kind[:depth, col] = kinds
        slot[:depth, col] = rng.integers(0, n_slots, depth)
        val[:depth, col] = rng.integers(1, 1 << 20, depth)
        tomb = (kinds == teng.OP_PUT) & (rng.random(depth) < 0.2)
        val[:depth, col][tomb] = 0
        rmw = kinds == teng.OP_RMW
        exp_e[:depth, col][rmw] = rng.choice(
            [teng.RMW_ADD, teng.RMW_MAX, teng.RMW_BXOR], int(rmw.sum()))

    fill(0, k)
    light = rng.permutation(np.arange(1, n_ens))[:n_light]
    for col in light[:-4]:
        fill(int(col), 1)
    for col in light[-4:]:
        fill(int(col), int(rng.integers(2, 4)))
    if n_ens - 1 not in light:          # the last row active: pads
        fill(n_ens - 1, 1)              # follow row E - 1's own block
    return kind, slot, val, exp_e, exp_s


@pytest.mark.parametrize("e,n_light,sliced", [
    (256, 24, True),      # bucket 32 <= E/4: the step runs on A rows
    (256, 90, False),     # bucket 128 > E/4: pack-gather
    (64, 10, False),      # E < SLICE_MIN_E: pack-gather
], ids=["sliced", "pack-gather", "small-grid"])
def test_skew_equivalence_sweep(jb, e, n_light, sliced):
    p = Lockstep(jb, e, 3, 16, 8)
    rng = np.random.default_rng(11)
    seeds = rng.integers(0, 999, 3)
    for i, sd in enumerate(seeds):
        planes = _skew_planes(np.random.default_rng(sd), e, 16, 8, n_light)
        kind, slot, val, exp_e, exp_s = planes
        out_j, out_t = p.both(lambda s: s.execute(
            kind, slot, val, exp_epoch=exp_e, exp_seq=exp_s))
        for name, a, b in zip(("committed", "get_ok", "found", "value"),
                              out_j, out_t):
            assert a.dtype == b.dtype and np.array_equal(a, b), (i, name)
        p.tick(0.3)
    p.check()
    # the first launch elects every row (full width); the later ones
    # compacted with the strength this case is about
    assert p.ts.sliced_launches == (2 if sliced else 0)
    assert p.ts.payload_bytes < p.ts.payload_bytes_full_width
    assert p.ts.grid_occupancy < 1.0
    assert all((planes[0] == op).any() for op in
               (teng.OP_PUT, teng.OP_GET, teng.OP_CAS, teng.OP_RMW))


def test_keyed_equivalence_with_rmw(jb):
    """The queued keyed path (futures, want_vsn results, the device RMW
    fast path, fast reads) at E = 256: the first flush elects every row
    at full width, the later ones slice."""
    p = Lockstep(jb, 256, 3, 16, 8)
    ref = tfunref.ref
    p.submit(lambda s: [s.kput(e, "warm", 1) for e in range(s.n_ens)])
    p.drain()
    p.tick(0.2)
    p.submit(lambda s: [s.kput(0, f"k{i}", 1000 + i) for i in range(8)]
             + [s.kput(9, "x", 7),
                s.kmodify(17, "ctr", ref("rmw:add", 5), 0),
                s.kmodify(17, "ctr", ref("rmw:add", 5), 0),
                s.kget_vsn(9, "x"), s.kget(255, "warm")])
    p.drain()
    p.tick(0.2)
    # a different active set, fast reads and a host-path kmodify chain
    p.submit(lambda s: [s.kput(3, "y", 1), s.kget(17, "ctr"),
                        s.kdelete(40, "nope"), s.kget(0, "k3"),
                        s.kmodify(255, "warm", lambda v, c: c + 1, 0),
                        s.kmodify_many(200, ["a", "b", "a"],
                                       ref("rmw:max", 4))])
    p.drain()
    p.tick(0.9)                     # every lease lapses: reads go round
    p.submit(lambda s: [s.kget(17, "ctr"), s.kget_vsn(255, "warm"),
                        s.kget_many(200, ["a", "b"])])
    p.drain()
    p.check()
    assert p.ts.sliced_launches >= 3 and p.ts.rmw_device_fastpath > 0
    assert p.ts.read_fastpath_hits > 0
    assert p.ts.payload_bytes < p.ts.payload_bytes_full_width / 2


def test_corrupt_flag_reaches_scrub_under_compaction(jb):
    """A launch sliced down to one active row still reports the
    integrity-gate failure and runs the same exchange; the scrub then
    finds the damage no read touched — equal to the JAX service."""
    import jax.numpy as jnp
    p = Lockstep(jb, 256, 3, 8, 4)
    p.submit(lambda s: [s.kput(e, "k", 40 + e) for e in range(0, 256, 5)])
    p.drain()
    slot = p.ts.key_slot[5]["k"]
    cold = p.ts.key_slot[10]["k"]
    leaf = np.asarray(p.js.state.tree_leaf).copy()
    leaf[5, 1, slot] ^= 0xDEAD
    leaf[10, 2, cold] ^= 0xBEEF
    p.js.state = p.js.state._replace(tree_leaf=jnp.asarray(leaf))
    p.ts.state.tree_leaf[5, 1, slot] ^= 0xDEAD
    p.ts.state.tree_leaf[10, 2, cold] ^= 0xBEEF
    for s in (p.js, p.ts):
        s.lease_until[:] = 0.0      # the read must take the device round
    p.submit(lambda s: s.kget(5, "k"))
    p.drain()
    assert p.ts.sliced_launches >= 1
    assert p.ts.corruptions >= 1 and p.futs[1][-1].value == ("ok", 45)
    reports = p.both(lambda s: s.scrub())
    assert reports[0] == reports[1] and reports[1]["replicas_damaged"] >= 1
    p.check()


def test_sparse_flush_leases_match_jax_default(jb):
    """THE compaction fault: the reference's default arm steps only the
    active rows of a sparse flush at E >= 256, so idle rows get no lease
    renewal.  A port that steps all E rows renews every lease and then
    serves fast reads the reference refuses."""
    p = Lockstep(jb, 256, 3, 8, 4)
    p.submit(lambda s: [s.kput(e, "k", e + 1) for e in range(256)])
    p.drain()                          # t = 100: every lease to 100.75
    p.tick(0.4)
    p.submit(lambda s: [s.kput(e, "k2", 7) for e in (3, 30, 100, 255)])
    p.drain()                          # t = 100.4: a sparse flush
    assert np.array_equal(p.js.lease_until, p.ts.lease_until)
    p.tick(0.2)                        # t = 100.6 (read margin 0.25)
    p.submit(lambda s: [s.kget(e, "k") for e in (3, 4, 30, 31, 255)])
    assert p.js.read_fastpath_hits == p.ts.read_fastpath_hits
    assert p.js.read_fastpath_miss_reasons == \
        p.ts.read_fastpath_miss_reasons
    assert p.ts.read_fastpath_miss_reasons.get("no_lease") == 2
    p.drain()
    p.check()


# -- the engine --------------------------------------------------------------


def _step_inputs(rng, e, m, s, k, active):
    """Seeded sliced-step inputs: ``active`` (real rows then pads = E),
    pads NOOP and not electing."""
    a = active.size
    real = active < e
    elect = (rng.random(a) < 0.5) & real
    cand = np.where(real, rng.integers(-1, m + 1, a), 0).astype(np.int32)
    kind = np.where(real[None, :], rng.integers(0, 5, (k, a)),
                    0).astype(np.int32)
    slot = rng.integers(-1, s + 1, (k, a)).astype(np.int32)
    val = rng.integers(-5, 50, (k, a)).astype(np.int32)
    lease = (rng.random((k, a)) < 0.3) & real[None, :]
    up = rng.random((e, m)) < 0.85
    exp_e = np.where(kind == teng.OP_RMW, rng.integers(0, 9, (k, a)),
                     rng.integers(0, 3, (k, a))).astype(np.int32)
    exp_s = rng.integers(0, 3, (k, a)).astype(np.int32)
    return elect, cand, kind, slot, val, lease, up, exp_e, exp_s


@pytest.mark.parametrize("last_active", [True, False],
                         ids=["row-E-1-active", "row-E-1-idle"])
def test_full_step_sliced_plain_matches_jax(jb, last_active):
    import jax.numpy as jnp

    from riak_ensemble_tpu.ops import engine as jeng
    rng = np.random.default_rng(21 + last_active)
    e, m, s, k = 40, 3, 16, 4
    js = jeng.init_state(e, m, s)
    ts = interop.state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in js._fields}, device="cpu")
    f1_before = cuda_engine.engine_step_launches
    for step in range(4):
        rows = np.sort(rng.choice(e - 1, 5, replace=False))
        if last_active:
            rows = np.append(rows[:-1], e - 1)
        active = np.full(8, e, np.int32)          # three pads
        active[:rows.size] = rows
        planes = _step_inputs(rng, e, m, s, k, active)
        if step == 0:
            planes[0][:] = active < e             # elect every real row
        j_out = jeng.full_step_sliced(
            js, jnp.asarray(active), *(jnp.asarray(a) for a in planes[:7]),
            exp_epoch=jnp.asarray(planes[7]), exp_seq=jnp.asarray(planes[8]))
        js = j_out[0]
        t_in = [torch.from_numpy(a) for a in planes]
        before = [t.clone() for t in ts]
        ts2, won, res = teng.full_step_sliced(
            ts, active, *t_in[:7], exp_epoch=t_in[7], exp_seq=t_in[8])
        # rows were stepped IN PLACE, idle rows untouched
        assert all(a is b for a, b in zip(ts2, ts))
        idle = np.setdiff1d(np.arange(e), active)
        for a, b in zip(before, ts):
            assert torch.equal(a[idle], b[idle])
        assert np.array_equal(won.numpy(), np.asarray(j_out[1])), step
        for f in teng.KvResult._fields:
            assert np.array_equal(getattr(res, f).numpy(),
                                  np.asarray(getattr(j_out[2], f))), (step, f)
        got = interop.state_to_numpy(ts)
        for f in js._fields:
            assert np.array_equal(getattr(got, f),
                                  np.asarray(getattr(js, f))), (step, f)
        # pads: NOOP results, and all of them row E - 1's epoch check
        pads = slice(rows.size, None)
        assert not (won[pads].any() or res.committed[:, pads].any()
                    or res.get_ok[:, pads].any()
                    or res.tree_corrupt[:, pads].any())
        assert (res.quorum_ok[:, pads] == res.quorum_ok[:1, pads][:, :1]).all()
    assert cuda_engine.engine_step_launches == f1_before
    assert int(res.committed.sum()) > 0


@pytest.mark.parametrize("idx,err", [
    (np.asarray([1, 3, 3, 10], np.int32), "ascend"),
    (np.asarray([5, 2, 10, 10], np.int32), "ascend"),
    (np.asarray([1, 10, 4, 10], np.int32), "padding"),
    (np.asarray([-1, 2, 10], np.int32), "negative"),
    (np.asarray([1, 11], np.int32), "padding"),
    (np.asarray([], np.int32), "empty"),
    (np.asarray([[1, 2]], np.int32), "1-D"),
    (np.asarray([1, 2], np.int64), "int32"),
    ([1, 2], "numpy"),
])
def test_check_active_raises(idx, err):
    with pytest.raises((TypeError, ValueError), match=err):
        cuda_engine.check_active(idx, 10)


def test_check_active_counts_real_rows():
    assert cuda_engine.check_active(np.asarray([0, 4, 9, 10, 10],
                                               np.int32), 10) == 3
    assert cuda_engine.check_active(np.asarray([10, 10], np.int32), 10) == 0
    assert cuda_engine.check_active(np.asarray([2], np.int32), 10) == 1


def test_compact_off_keeps_full_width():
    svc = tb.BatchedEnsembleService(FixedClock(), 256, 3, 8, tick=None,
                                    max_ops_per_tick=4, device="cpu",
                                    compact=False)
    for _ in range(2):
        f = svc.kput(7, "k", 1)
        svc.flush()
        assert f.value[0] == "ok"
    assert svc.sliced_launches == 0 and svc.grid_occupancy == 1.0
    assert svc.payload_bytes == svc.payload_bytes_full_width > 0


@pytest.mark.cuda
def test_f1_sliced_matches_plain_on_card():
    """Sliced F1 on the card equals ``full_step_sliced_plain`` on every
    state plane, ``won`` and every result plane, with row E - 1 active and
    pads present, and with row E - 1 idle."""
    if not torch.cuda.is_available():
        pytest.skip("F1 is a CUDA kernel: no CUDA device is visible")
    rng = np.random.default_rng(31)
    e, m, s, k = 300, 5, 128, 8
    st = teng.init_state(e, m, s, device="cuda")
    ref = teng.EngineState(*(t.clone() for t in st))
    for step in range(6):
        rows = np.sort(rng.choice(e - 1, 20, replace=False))
        if step % 2 == 0:
            rows = np.append(rows[:-1], e - 1)
        active = np.full(32, e, np.int32)
        active[:rows.size] = rows
        planes = _step_inputs(rng, e, m, s, k, active)
        if step == 0:
            planes[0][:] = active < e
        p = [torch.from_numpy(a).cuda() for a in planes]
        before = (cuda_engine.engine_step_launches,
                  cuda_engine.engine_step_sliced_launches)
        st, won, res = teng.full_step_sliced(
            st, active, *p[:7], exp_epoch=p[7], exp_seq=p[8])
        ref, rwon, rres = teng.full_step_sliced_plain(
            ref, active, *p[:7], exp_epoch=p[7], exp_seq=p[8])
        torch.cuda.synchronize()
        assert (cuda_engine.engine_step_launches,
                cuda_engine.engine_step_sliced_launches) == \
            (before[0] + 1, before[1] + 1)
        assert torch.equal(won, rwon), step
        assert all(torch.equal(a, b) for a, b in zip(st, ref)), step
        assert all(torch.equal(a, b) for a, b in zip(res, rres)), step
    assert int(res.committed.sum()) > 0
