"""The port's keyed service against the JAX package's, flush for flush.

One seeded keyed op stream — kput / kget / kget_vsn / kupdate /
kput_once / kdelete / kput_many / kget_many / execute,
peers going down and up (forcing elections), and a small K cap that
splits batches across flushes — goes through the JAX service on its
oracle arm (``RETPU_COMPACT=0 RETPU_FAST_READS=0 RETPU_NATIVE_RESOLVE=0
RETPU_NATIVE_ENQUEUE=0 RETPU_OBS=0``, no ``RETPU_WIDE``) and through the
port's service on the CPU with fast reads off (``set_fast_reads(False)``;
``tests/test_torch_fastread.py`` covers the fast-read arm) and with
compaction off (``compact=False``).  One case runs both at their default
compaction arm (``RETPU_COMPACT`` unset, ``compact=True``) on a grid wide
enough for the pack-gather strength to engage.  Both run on the same
fixed clock.  Every future must resolve to the same value,
every flush's packed result buffer must be byte-identical, and the final
engine states bit-equal.

Device-resident ``execute`` / ``execute_async`` planes (int32 tensors on
the service's device) give the same results and state as the host-array
calls and as the JAX service's ``jax.Array`` planes, count ``k * E``
served ops, and, under a ``data_dir``, skip the WAL once flagged.
"""

import numpy as np
import pytest

from riak_ensemble_tpu_torch import interop
from riak_ensemble_tpu_torch.parallel import batched_host as tb
from riak_ensemble_tpu_torch.types import NOTFOUND as T_NOTFOUND

ORACLE_ENV = {"RETPU_COMPACT": "0", "RETPU_FAST_READS": "0",
              "RETPU_NATIVE_RESOLVE": "0", "RETPU_NATIVE_ENQUEUE": "0",
              "RETPU_OBS": "0"}


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


@pytest.fixture
def services(monkeypatch):
    pytest.importorskip("jax")
    for k, v in ORACLE_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("RETPU_WIDE", raising=False)
    from riak_ensemble_tpu.parallel import batched_host as jb
    from riak_ensemble_tpu.types import NOTFOUND as J_NOTFOUND

    def make(e, m, s, k, compact=False):
        if compact:
            monkeypatch.delenv("RETPU_COMPACT")
        cj, ct = FixedClock(), FixedClock()
        js = jb.BatchedEnsembleService(cj, e, m, s, tick=None,
                                       max_ops_per_tick=k)
        ts = tb.BatchedEnsembleService(ct, e, m, s, tick=None,
                                       max_ops_per_tick=k, device="cpu",
                                       compact=compact)
        # the port's counterpart of RETPU_FAST_READS=0: this oracle arm
        # routes every read through a device round
        ts.set_fast_reads(False)
        assert js._native_resolve is None and not js._enq_slab
        assert not js._fast_reads and not js._obs
        assert js._compact == ts._compact == compact
        assert not ts._fast_reads
        bufs = ([], [])
        _record_packed(js, bufs[0])
        _record_packed(ts, bufs[1])
        return js, ts, (cj, ct), bufs

    def norm(x):
        if x is J_NOTFOUND or x is T_NOTFOUND:
            return "NOTFOUND"
        if isinstance(x, (list, tuple)):
            return type(x)(norm(y) for y in x)
        return x
    return make, norm


def _submit(svc, rng_draw, e, key):
    op, exp, want_vsn, val = rng_draw
    if op == 0:
        return svc.kput(e, key, val)
    if op == 1:
        return svc.kget(e, key)
    if op == 2:
        return svc.kget_vsn(e, key)
    if op == 3:
        return svc.kupdate(e, key, exp, val)
    if op == 4:
        return svc.kput_once(e, key, val)
    if op == 5:
        return svc.kdelete(e, key)
    if op == 6:
        return svc.kput_many(e, [key, key + "/x", key, key + "/y"],
                             [val, val + "x", val + "!", val + "y"])
    return svc.kget_many(e, [key, key + "/x", "never"],
                         want_vsn=want_vsn)


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


def test_pack_results_body_matches_jax(services):
    """The packer alone, on random result planes with every width's
    tail-byte padding case (E*M not a multiple of 8)."""
    import jax.numpy as jnp
    import torch

    from riak_ensemble_tpu.ops import engine as jeng
    from riak_ensemble_tpu.parallel import batched_host as jb
    from riak_ensemble_tpu_torch.ops import engine as teng
    rng = np.random.default_rng(4)
    for e, m, k in [(5, 3, 2), (7, 5, 1), (16, 4, 0), (9, 2, 3)]:
        planes = dict(
            committed=rng.random((k, e)) < 0.5,
            get_ok=rng.random((k, e)) < 0.5,
            found=rng.random((k, e)) < 0.5,
            value=rng.integers(-2 ** 31, 2 ** 31, (k, e),
                               dtype=np.int64).astype(np.int32),
            obj_vsn=rng.integers(0, 2 ** 31, (k, e, 2),
                                 dtype=np.int64).astype(np.int32),
            quorum_ok=rng.random((k, e)) < 0.5,
            tree_corrupt=rng.random((k, e, m)) < 0.2)
        won = rng.random(e) < 0.5
        for want_vsn in (False, True):
            want = np.asarray(jb._pack_results_body(
                jnp.asarray(won), jeng.KvResult(
                    **{f: jnp.asarray(a) for f, a in planes.items()}),
                want_vsn))
            got = tb._pack_results_body(
                torch.from_numpy(won), teng.KvResult(
                    **{f: torch.from_numpy(a) for f, a in planes.items()}),
                want_vsn).numpy()
            assert got.dtype == np.uint8
            assert np.array_equal(got, want), (e, m, k, want_vsn)
            assert got.size == jb.packed_nbytes(e, m, k, want_vsn)
            for a, b in zip(tb.unpack_results(got, e, m, k, want_vsn),
                            jb.unpack_results(want, e, m, k, want_vsn)):
                assert (a is None and b is None) or np.array_equal(a, b)


def _bulk(rng, k, e, s):
    kind = rng.choice([1, 2, 2, 4, 0], (k, e)).astype(np.int32)  # RMW = 4
    slot = rng.integers(0, s, (k, e)).astype(np.int32)
    val = rng.integers(0, 1 << 20, (k, e)).astype(np.int32)
    xe = np.where(kind == 4, rng.integers(1, 4, (k, e)), 0).astype(np.int32)
    return kind, slot, val, xe


@pytest.mark.parametrize("asynchronous", [False, True])
def test_device_resident_execute_matches_host_arrays(services,
                                                     asynchronous):
    """Three services on one stream: the port with host arrays, the port
    with int32 tensors on its device, the JAX service with ``jax.Array``
    planes.  Results, state planes and leases equal; the device-resident
    calls count every lane as served, as the reference does."""
    import jax.numpy as jnp
    import torch

    make, _norm = services
    e, m, s, k = 8, 3, 8, 4
    js, ts, _clocks, _bufs = make(e, m, s, k)
    th = tb.BatchedEnsembleService(FixedClock(), e, m, s, tick=None,
                                   max_ops_per_tick=k, device="cpu",
                                   compact=False, pipeline_depth=2)
    th.set_fast_reads(False)
    ts.set_pipeline_depth(2)
    rng = np.random.default_rng(9)
    batches = [_bulk(rng, k, e, s) for _ in range(5)]
    served = (th.ops_served, ts.ops_served)
    out_h, out_t, out_j = [], [], []
    for b in batches:
        tb_planes = [torch.from_numpy(x.copy()) for x in b]
        if asynchronous:
            out_h.append(th.execute_async(*b))
            out_t.append(ts.execute_async(*tb_planes))
        else:
            out_h.append(th.execute(*b))
            out_t.append(ts.execute(*tb_planes))
        out_j.append(js.execute(*(jnp.asarray(x) for x in b)))
    if asynchronous:
        th.flush()
        ts.flush()
        out_h = [f.value for f in out_h]
        out_t = [f.value for f in out_t]
    for h, t, j in zip(out_h, out_t, out_j):
        for a, b, c in zip(h, t, j):
            assert np.array_equal(a, b) and np.array_equal(b, np.asarray(c))
    assert th.ops_served - served[0] == sum(
        int((b[0] != 0).sum()) for b in batches)
    assert ts.ops_served - served[1] == len(batches) * k * e \
        == js.ops_served
    for f in ts.state._fields:
        assert torch.equal(getattr(ts.state, f), getattr(th.state, f)), f
    tn = interop.state_to_numpy(ts.state)
    for f in tn._fields:
        assert np.array_equal(np.asarray(getattr(js.state, f)),
                              getattr(tn, f)), f
    assert np.array_equal(ts.lease_until, js.lease_until)
    with pytest.raises(TypeError):
        ts.execute(torch.zeros((k, e), dtype=torch.int64),
                   torch.zeros((k, e), dtype=torch.int32),
                   torch.zeros((k, e), dtype=torch.int32))
    with pytest.raises(TypeError):
        ts.execute(torch.zeros((k, e), dtype=torch.int32),
                   torch.zeros((k, e + 1), dtype=torch.int32),
                   torch.zeros((k, e), dtype=torch.int32))


def test_device_resident_execute_is_unlogged_under_data_dir(tmp_path,
                                                            monkeypatch):
    """With a ``data_dir`` a host-array call logs its committed writes
    (RMW rows their computed values) before it returns; a device-resident
    call logs nothing and sets ``_dev_exec_unlogged``, as the JAX
    service's ``jax.Array`` call does."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    import torch

    from riak_ensemble_tpu.parallel import batched_host as jb
    from riak_ensemble_tpu_torch.ops import engine as teng
    monkeypatch.setenv("RETPU_OBS", "0")
    e, m, s, k = 4, 3, 8, 2
    js = jb.BatchedEnsembleService(FixedClock(), e, m, s, tick=None,
                                   max_ops_per_tick=k,
                                   data_dir=str(tmp_path / "j"))
    ts = tb.BatchedEnsembleService(FixedClock(), e, m, s, tick=None,
                                   max_ops_per_tick=k, device="cpu",
                                   data_dir=str(tmp_path / "t"))
    kind = np.full((k, e), 2, np.int32)
    kind[1] = 4
    slot = np.tile(np.arange(e, dtype=np.int32), (k, 1))
    val = np.full((k, e), 5, np.int32)
    xe = np.where(kind == 4, teng.RMW_ADD, 0).astype(np.int32)
    for svc in (js, ts):
        svc.execute(kind, slot, val, xe)
    assert ts._wal.count == js._wal.count == e
    assert ts._wal.records() == js._wal.records()
    assert {v[1] for _k, v in ts._wal.records()} == {10}   # 5, then +5
    assert not ts._dev_exec_unlogged and not js._dev_exec_unlogged
    ts.execute(*(torch.from_numpy(x) for x in (kind, slot + 4, val, xe)))
    js.execute(*(jnp.asarray(x) for x in (kind, slot + 4, val, xe)))
    assert ts._wal.count == js._wal.count == e
    assert ts._dev_exec_unlogged and js._dev_exec_unlogged
