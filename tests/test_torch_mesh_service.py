"""The keyed service over the port's mesh engine against the JAX package's
unsharded service — the mirror of ``tests/test_mesh_service.py``.

The port's service runs over :func:`mesh_engine` on eight ``cpu`` shards
('ens'-sharded, peer axis unsharded: the shard-wise pack) or a (4, 2)
mesh (peer axis sharded: the gathered pack); the JAX service runs
unsharded at its default arm.  Over mixed put / CAS / RMW / tombstone
streams the two must be BIT-IDENTICAL: futures, every device state
plane, the host read-path mirrors, and the WAL bytes of their data dirs
— with every row active (full-width flushes), with a few hot rows (the
shard-wise compaction: each shard's LOCAL active columns at the busiest
shard's bucket), and with wide-group flushes.  ``warmup`` runs the
shard-wise buckets and serving afterwards builds nothing; checkpoints
restore across shard counts, 8 → 1 and 1 → 8, bit-equal.  The
runtime-driven mirrors and ``svcnode --mesh-devices`` are in
``tests/test_torch_mesh_runtime.py``.

Tolerance: exact equality everywhere.
"""

import os

import numpy as np
import pytest

from riak_ensemble_tpu_torch import funref as tfunref
from riak_ensemble_tpu_torch import interop
from riak_ensemble_tpu_torch.parallel import batched_host as tb
from riak_ensemble_tpu_torch.parallel.mesh import mesh_engine
from test_torch_compaction import norm
from test_torch_kmodify import FixedClock
from test_torch_native_enqueue import _jax_env
from test_torch_reference_natives import reference_natives  # noqa: F401 (autouse)
from test_torch_wal import _tree

MIRRORS = ("leader_np", "lease_until", "_slot_vsn_np", "_slot_vsn_ok",
           "_inline_value_np", "_inline_value_ok", "_inline_np")


@pytest.fixture
def jb(monkeypatch):
    pytest.importorskip("jax")
    _jax_env(monkeypatch, "default", True, True)
    from riak_ensemble_tpu.parallel import batched_host as jb
    return jb


def cpu_mesh_engine(n_peer=1):
    return mesh_engine(8, n_peer=n_peer, devices=["cpu"] * 8)


def pair(jb, n_ens, n_peers=3, n_slots=8, n_peer=1, data=None, **kw):
    """(JAX service, port service over a cpu mesh), driven together."""
    dirs = ((None, None) if data is None
            else (os.path.join(data, "jax"), os.path.join(data, "port")))
    js = jb.BatchedEnsembleService(FixedClock(), n_ens, n_peers, n_slots,
                                   tick=None, data_dir=dirs[0], **kw)
    ts = tb.BatchedEnsembleService(FixedClock(), n_ens, n_peers, n_slots,
                                   tick=None, data_dir=dirs[1],
                                   engine=cpu_mesh_engine(n_peer), **kw)
    return js, ts


def drive(svc, futs):
    while not all(f.done for f in futs):
        svc.flush()
    return [norm(f.value) for f in futs]


def mixed_stream(svc, phase, rows):
    """test_mesh_service.py's phase on ``rows``: puts, CAS (hit and
    miss), RMW, deletes (tombstones), gets."""
    futs = []
    for e in rows:
        futs.append(svc.kput(e, "a", b"A%d" % (phase + e)))
        futs.append(svc.kput(e, "b", b"B"))
        futs.append(svc.kput_once(e, "once", b"first"))
    out = drive(svc, futs)
    vsns = drive(svc, [svc.kget_vsn(e, "b") for e in rows])
    futs = [svc.kupdate(e, "b", vsn[2], b"B%d" % phase)
            for e, vsn in zip(rows, vsns)]
    futs += [svc.kupdate(e, "b", (1, 1 << 30), b"never") for e in rows]
    futs += [svc.kmodify(e, "ctr", tfunref.ref("rmw:add", 3 + phase), 0)
             for e in rows]
    out += vsns + drive(svc, futs)
    futs = [svc.kdelete(e, "a") for e in rows]
    futs += [svc.kget(e, "b") for e in rows]
    futs += [svc.kget(e, "a") for e in rows]
    return out + drive(svc, futs)


def jax_stream(js, phase, rows):
    """:func:`mixed_stream` on the JAX service (its funref module)."""
    from riak_ensemble_tpu import funref as jfunref
    futs = []
    for e in rows:
        futs.append(js.kput(e, "a", b"A%d" % (phase + e)))
        futs.append(js.kput(e, "b", b"B"))
        futs.append(js.kput_once(e, "once", b"first"))
    out = drive(js, futs)
    vsns = drive(js, [js.kget_vsn(e, "b") for e in rows])
    futs = [js.kupdate(e, "b", vsn[2], b"B%d" % phase)
            for e, vsn in zip(rows, vsns)]
    futs += [js.kupdate(e, "b", (1, 1 << 30), b"never") for e in rows]
    futs += [js.kmodify(e, "ctr", jfunref.ref("rmw:add", 3 + phase), 0)
             for e in rows]
    out += vsns + drive(js, futs)
    futs = [js.kdelete(e, "a") for e in rows]
    futs += [js.kget(e, "b") for e in rows]
    futs += [js.kget(e, "a") for e in rows]
    return out + drive(js, futs)


def assert_same(js, ts):
    """Every state plane (the mesh state gathered) and host mirror."""
    tn = interop.mesh_state_to_numpy(ts.state)
    for f in tn._fields:
        assert np.array_equal(np.asarray(getattr(js.state, f)),
                              getattr(tn, f)), f
    for name in MIRRORS:
        assert np.array_equal(getattr(js, name), getattr(ts, name)), name


def test_shardwise_pack_selected():
    svc = tb.BatchedEnsembleService(FixedClock(), 16, 3, 8, tick=None,
                                    engine=cpu_mesh_engine())
    try:
        assert tb.mesh_ens_shards(svc.engine) == 8
        assert svc._mesh_shards == 8
        assert svc._pack is tb._pack_shardwise
        assert svc.device.type == "cpu"
        peer = tb.BatchedEnsembleService(FixedClock(), 8, 4, 8, tick=None,
                                         engine=cpu_mesh_engine(2))
        assert tb.mesh_ens_shards(peer.engine) == 0
        assert peer._pack is not tb._pack_shardwise
        local = tb.BatchedEnsembleService(FixedClock(), 8, 3, 8, tick=None,
                                          device="cpu")
        assert tb.mesh_ens_shards(local.engine) == 0
        assert local._pack is tb._pack_local
    finally:
        svc.stop()


@pytest.mark.parametrize("n_peer", [1, 2])
def test_mesh_equals_jax_mixed_stream(jb, tmp_path, n_peer):
    """Bit-identical futures, state, mirrors and WAL bytes over two
    phases of the mixed stream, every row active — at (8, 1) (the
    shard-wise pack) and at (4, 2) over 4 peers (the peer collectives
    and the gathered pack)."""
    js, ts = pair(jb, 16, n_peers=3 if n_peer == 1 else 4, n_peer=n_peer,
                  data=str(tmp_path))
    try:
        for phase in range(2):
            want = jax_stream(js, phase, range(16))
            assert mixed_stream(ts, phase, range(16)) == want, phase
        assert_same(js, ts)
        wa, wb = _tree(js.data_dir), _tree(ts.data_dir)
        assert wa and wa == wb, "WAL bytes diverge"
    finally:
        js.stop()
        ts.stop()


def test_mesh_equals_jax_compacted_flush(jb):
    """Shard-wise compaction (E = 128, a few hot rows: A_loc strictly
    below E/8) stays bit-identical to the JAX service, and compacts."""
    js, ts = pair(jb, 128)
    try:
        rows = [0, 3, 17, 63, 64, 127]      # spans shards, empties included
        assert mixed_stream(ts, 0, rows) == jax_stream(js, 0, rows)
        assert_same(js, ts)
        assert ts.payload_bytes < ts.payload_bytes_full_width
        assert ts._occ_launches > 0 and ts._occ_sum < ts._occ_launches
    finally:
        js.stop()
        ts.stop()


def test_mesh_equals_jax_wide_flush(jb):
    """Wide-group flushes through the mesh's ``full_step_wide``."""
    js, ts = pair(jb, 16, max_ops_per_tick=8)
    js._wide = ts._wide = True
    try:
        results = []
        for svc in (js, ts):
            drive(svc, [svc.kput_many(e, ["w%d" % j for j in range(4)],
                                      [b"v%d" % j for j in range(4)])
                        for e in range(16)])
            results.append(drive(svc, [
                svc.kget_many(e, ["w%d" % j for j in range(4)])
                for e in range(16)]))
            assert svc.wide_launches > 0, "wide path never engaged"
        assert results[0] == results[1]
        assert_same(js, ts)
    finally:
        js.stop()
        ts.stop()


def test_mesh_warmup_covers_shardwise_buckets():
    """``warmup`` launches the mesh step and packs every per-shard
    (K, A) bucket (A strictly below the LOCAL width E/8); serving a
    compacted and a full-width stream afterwards builds nothing."""
    svc = tb.BatchedEnsembleService(FixedClock(), 128, 3, 8, tick=None,
                                    engine=cpu_mesh_engine())
    try:
        assert svc._a_ladder() == [None, 8]
        packs = []
        orig = svc._pack

        def counted(won, res, want_vsn, active_idx=None, wide=None):
            packs.append(None if active_idx is None
                         else np.asarray(active_idx).shape)
            return orig(won, res, want_vsn, active_idx, wide)
        svc._pack = counted
        svc.warmup()
        assert (8, 8) in packs and None in packs
        serve0 = svc._c_compile.labels("serve").value
        mixed_stream(svc, 0, [0, 3, 17, 63, 127])
        mixed_stream(svc, 1, range(128))
        assert svc._c_compile.labels("serve").value == serve0
    finally:
        svc.stop()


@pytest.mark.parametrize("direction", ["8to1", "1to8"])
def test_checkpoint_across_shard_counts(jb, tmp_path, direction):
    """A checkpoint saved under one placement restores bit-equal under
    the other (8 shards <-> one engine), host mirrors included, and the
    restored service serves; the source equals the JAX service on the
    same stream."""
    src_mesh = direction == "8to1"
    d = str(tmp_path / "svc")
    src = tb.BatchedEnsembleService(
        FixedClock(), 16, 3, 8, tick=None, data_dir=d,
        engine=cpu_mesh_engine() if src_mesh else None,
        device=None if src_mesh else "cpu")
    js = jb.BatchedEnsembleService(FixedClock(), 16, 3, 8, tick=None)
    dst = None
    try:
        assert mixed_stream(src, 0, range(16)) == jax_stream(js, 0,
                                                             range(16))
        src.save()
        dst = tb.BatchedEnsembleService.restore(
            FixedClock(), d, tick=None,
            engine=None if src_mesh else cpu_mesh_engine(),
            device="cpu" if src_mesh else None)
        a = src.engine.gather_state(src.state)
        b = dst.engine.gather_state(dst.state)
        for f, x, y in zip(a._fields, a, b):
            assert np.array_equal(x.numpy(), y.numpy()), f
        tn = interop.state_to_numpy(a)
        for f in tn._fields:
            assert np.array_equal(np.asarray(getattr(js.state, f)),
                                  getattr(tn, f)), f
        assert np.array_equal(src.leader_np, dst.leader_np)
        assert src.key_slot == dst.key_slot
        assert drive(dst, [dst.kget(e, "b") for e in range(16)]) == \
            [("ok", b"B0")] * 16
        put = drive(dst, [dst.kput(e, "p1", b"post") for e in range(16)])
        assert all(r[0] == "ok" for r in put)
    finally:
        src.stop()
        js.stop()
        if dst is not None:
            dst.stop()
