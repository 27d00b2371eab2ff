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

``kupdate_many`` and ``kdelete_many`` (batch CAS and batch delete) run
against the JAX service on the default, oracle and plain host arms, at
depth 1 and 2 (the pending slab's CAS-batch and delete-batch runs, the
completion slab, the per-op resolve): equal futures, packed buffers,
mirror slabs, state and counters; their WAL records (the C++ encode on
the default arm) are byte-identical to the JAX service's and restore
across packages.

The keyed streams and batch CAS / delete on every arm are in
``tests/test_torch_service_arms.py``.
"""

import numpy as np
import pytest
from test_torch_reference_natives import reference_natives  # noqa: F401 (autouse)

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


def _batch_cas_delete_stream(rng, svc, ens, r, vsns):
    """One round of batch CAS / batch delete traffic (with puts and reads
    around it) on ``ens``: versions from earlier acks and reads, stale
    ones, create-if-missing, and deletes of live, deleted and unknown
    keys.  Returns (future, ensemble, keys) per call."""
    out = []
    for e in ens:
        keys = [f"k{(r + i) % 5}" for i in range(3)]
        pick = int(rng.integers(0, 4))
        if pick == 0:
            f = svc.kput_many(e, keys, [b"p%d.%d" % (r, i) for i in
                                        range(3)])
        elif pick == 1:
            keys = keys + keys[:1]
            exp = [vsns.get((e, k), (0, 0)) if rng.random() < 0.7
                   else (int(rng.integers(0, 4)), int(rng.integers(0, 4)))
                   for k in keys]
            f = svc.kupdate_many(e, keys, exp, [b"c%d.%d" % (r, i)
                                                for i in range(4)])
        elif pick == 2:
            keys = keys[:2] + ["never"]
            f = svc.kdelete_many(e, keys)
        else:
            f = svc.kget_many(e, keys, want_vsn=True)
        out.append((f, e, keys))
    return out


def _note_vsns(calls, vsns):
    """Remember each key's newest acknowledged or read version."""
    for f, e, keys in calls:
        for key, res in zip(keys, f.value):
            if isinstance(res, tuple) and res[0] == "ok":
                vsns[e, key] = tuple(res[-1]) if len(res) == 3 \
                    else tuple(res[1]) if isinstance(res[1], tuple) \
                    else vsns.get((e, key), (0, 0))


@pytest.mark.parametrize("arm", ["default", "plain"])
def test_batch_cas_and_delete_wal_bytes_match_jax(monkeypatch, tmp_path,
                                                  arm):
    """The WAL records of batch CAS and batch delete flushes (str keys,
    bytes payloads: the C++ encode's subset on the default arm) are
    written byte for byte as the JAX service writes them, and both
    packages restore them alike."""
    pytest.importorskip("jax")
    from riak_ensemble_tpu.parallel import batched_host as jb
    from test_torch_wal import Durable, assert_same_service
    p = Durable(jb, monkeypatch, str(tmp_path), arm, e=6, s=8)
    native = []
    if arm == "default":
        enc = p.ts._log_wal_native

        def spy(taken, planes, *rec):
            ok = enc(taken, planes, *rec)
            native.append(ok)
            return ok
        p.ts._log_wal_native = spy
    for r in range(4):
        for e in range(6):
            keys = [f"k{(r + i + e) % 4}" for i in range(3)]
            p.both(lambda s: s.kput_many(e, keys, [b"a%d" % r] * 3))
        p.settle()
        for e in range(6):
            keys = [f"k{(r + i + e) % 4}" for i in range(3)]
            p.both(lambda s: [
                s.kupdate_many(e, keys, [(0, 0), (1, 1), (9, 9)],
                               [b"u%d" % r] * 3),
                s.kdelete_many(e, keys[1:] + ["never"])])
        p.settle()
    p.check_futures()
    assert any(not isinstance(v, str) and any(
        isinstance(x, tuple) and x[0] == "ok" for x in v)
        for v in (f.value for f in p.futs[1]))
    if arm == "default":
        assert native and all(native)
    p.crash()
    p.check_files()
    js, ts = p.restore("jax", p.dirs[1]), p.restore("port", p.dirs[0])
    assert_same_service(js, ts)
