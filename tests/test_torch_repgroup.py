"""The port's replication group against the JAX package's — the mirror of
``tests/test_repgroup.py``, ``test_repl_delta.py`` and
``test_comm_repl.py`` at 4 ensembles x 8 slots, groups of 3 in one
process, on the CPU:

- the entry builders: the same seeded result planes give byte-equal
  delta, merge and full-plane entries and equal CRCs in both packages,
  through the numpy pipelines and through each package's C++ pass;
- lockstep: a port group and a JAX group fed the same ops give equal
  futures, equal ``abatch`` (and install) frames on the wire, leader and
  replica lanes equal across the packages and to their own leader, and
  byte-equal WAL files — with delta shipping, with ``RETPU_REPL_DELTA=0``
  (every entry full-plane, so the replicas re-execute every launch),
  and with the commutative lane off;
- interop in both directions: a JAX leader shipping to two port
  replicas, and a port leader shipping to a JAX replica and a port
  replica, end bit-equal;
- the replica core's seq-gap, CRC and merge-section nacks, answered
  exactly as the reference's core answers the same frames;
- coalesced entries that write the same slot, and ``takeover`` fencing
  the old leader.

Tolerance: exact equality everywhere.

The group lockstep and ``install_objs`` against a JAX group are in
``tests/test_torch_repgroup_group.py``.
"""

import os
import time

import numpy as np
import pytest

from riak_ensemble_tpu_torch import funref as tfunref
from riak_ensemble_tpu_torch import wire as twire
from riak_ensemble_tpu_torch.config import fast_test_config as t_fast
from riak_ensemble_tpu_torch.ops import engine as teng
from riak_ensemble_tpu_torch.parallel import repgroup as trg
from riak_ensemble_tpu_torch.parallel import resolve_native as trn
from riak_ensemble_tpu_torch.parallel.batched_host import (
    BatchedEnsembleService as TSvc, WallRuntime as TWall)
from test_torch_compaction import norm
from test_torch_kmodify import FixedClock
from test_torch_reference_natives import reference_natives  # noqa: F401 (autouse)

jax = pytest.importorskip("jax")

from riak_ensemble_tpu import wire as jwire  # noqa: E402
from riak_ensemble_tpu.config import fast_test_config as j_fast  # noqa: E402
from riak_ensemble_tpu.parallel import repgroup as jrg  # noqa: E402
from riak_ensemble_tpu.parallel import resolve_native as jrn  # noqa: E402

E, S, GROUP, K = 4, 8, 3, 8
UNSET = ("RETPU_NATIVE_ENQUEUE", "RETPU_NATIVE_RESOLVE", "RETPU_COMPACT",
         "RETPU_FAST_READS", "RETPU_WIDE", "RETPU_COMM_REPL",
         "RETPU_DONATE", "RETPU_RESOLVE_SHARDS", "RETPU_ADMISSION",
         "RETPU_REPL_DELTA", "RETPU_FOLLOWER_READS", "RETPU_WATCHDOG")


@pytest.fixture
def env(monkeypatch):
    """The reference's default arm with obs off (the flush ids that ride
    each entry are per-process counters); the knobs a test flips are
    set before either package builds a service."""
    for key in UNSET:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("RETPU_OBS", "0")
    return monkeypatch


def _parts_bytes(frame) -> bytes:
    return b"".join(bytes(memoryview(p).cast("B")) for p in frame.parts)


def _encoded(entry, wire_mod) -> bytes:
    return b"".join(bytes(memoryview(p).cast("B"))
                    for p in wire_mod.encode_parts(entry))


# -- entry builders ------------------------------------------------------------


def _planes(rng, k, rmw_share=0.3):
    committed = rng.random((k, E)) < 0.6
    kind = rng.choice([teng.OP_PUT, teng.OP_CAS, teng.OP_GET, teng.OP_RMW],
                      (k, E), p=[0.35, 0.1, 0.25, 0.3]).astype(np.int32)
    if rmw_share > 0.5:
        kind[:] = np.where(rng.random((k, E)) < 0.9, teng.OP_RMW,
                           teng.OP_PUT)
    slot = rng.integers(0, S, (k, E)).astype(np.int32)
    val = rng.integers(-2 ** 31, 2 ** 31, (k, E), dtype=np.int64
                       ).astype(np.int32)
    value = rng.integers(-2 ** 20, 2 ** 20, (k, E)).astype(np.int32)
    exp_e = rng.integers(0, 9, (k, E)).astype(np.int32)
    exp_s = rng.integers(0, 50, (k, E)).astype(np.int32)
    quorum = rng.random(E) < 0.7
    meta = [(int(j), int(e), f"k{j}.{e}", int(j * E + e + 1),
             b"p%d" % (j * E + e))
            for j, e in zip(*np.nonzero(committed))]
    return committed, kind, slot, val, value, exp_e, exp_s, quorum, meta


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_entries_and_crcs_byte_equal(native, seed):
    """Delta, merge and full-plane entries built by both packages from the
    same seeded planes are byte-equal on the wire, CRCs and byte counts
    included; the C++ passes (each package's own build) equal the numpy
    pipelines."""
    rng = np.random.default_rng(seed)
    tn = trn.get() if native else None
    jn = jrn.get() if native else None
    if native:
        assert jn is not None, "the reference's resolve library did not load"
    built_m = 0
    for k in (1, 3, 8):
        for rmw in (0.3, 0.9):
            (committed, kind, slot, val, value, exp_e, exp_s, quorum,
             meta) = _planes(rng, k, rmw)
            args = (5, k, committed, value, kind, slot, val)
            td = trg.build_delta_entry(*args, quorum, meta, n_slots=S,
                                       fid=0, native=tn)
            jd = jrg.build_delta_entry(*args, quorum, meta, n_slots=S,
                                       fid=0, native=jn)
            assert td[1:] == jd[1:]
            assert _encoded(td[0], twire) == _encoded(jd[0], jwire)
            # the port's C++ pass equals its numpy pipeline
            assert trg.build_delta_entry(*args, quorum, meta, n_slots=S)[1:] \
                == td[1:]
            tm = trg.build_comm_entry(*args, exp_e, quorum, meta,
                                      n_slots=S, native=tn)
            jm = jrg.build_comm_entry(*args, exp_e, quorum, meta,
                                      n_slots=S, native=jn)
            assert (tm is None) == (jm is None)
            if tm is not None:
                built_m += 1
                assert tm[1:] == jm[1:]
                assert _encoded(tm[0], twire) == _encoded(jm[0], jwire)
            fargs = (5, k, True, quorum, ~quorum, kind, slot, val, exp_e,
                     exp_s, meta)
            tf = trg.build_full_entry(*fargs)
            jf = jrg.build_full_entry(*fargs)
            assert tf[1] == jf[1]
            assert _encoded(tf[0], twire) == _encoded(jf[0], jwire)
            vsn = rng.integers(0, 9, (k, E, 2)).astype(np.int32)
            assert trg.result_crc(committed, vsn) == \
                jrg.result_crc(committed, vsn)
            assert trg.full_plane_nbytes(k, E, True) == \
                jrg.full_plane_nbytes(k, E, True)
    assert built_m >= 1
    assert trg._crc_chain(7, 123456) == jrg._crc_chain(7, 123456)
    items = [(1, 2, 3, 4), (np.int32(5), np.int64(6), 7, 8)]
    assert trg.record_digest(items) == jrg.record_digest(items)


# -- lockstep groups -----------------------------------------------------------


def _frames(link, out, rg):
    """Record every frame the leader posts on ``link``: encoded frames as
    their bytes, control tuples as given."""
    orig = link.post

    def post(frame, on_done=None):
        if isinstance(frame, rg._EncodedParts):
            out.append(_parts_bytes(frame))
        elif isinstance(frame, rg._Encoded):
            out.append(frame.payload)
        else:
            out.append(tuple(frame))
        return orig(frame, on_done)
    link.post = post


def _build(rg, fast, root, leader_pkg_kw=None, replica_pkgs=None, clock=None):
    """A leader on a fixed clock plus two threaded replica hosts; each
    replica entry of ``replica_pkgs`` is ``(module, config_fn, kw)``."""
    srvs = []
    for i, (mod, cfg, kw) in enumerate(replica_pkgs, start=1):
        srvs.append(mod.ReplicaServer(E, GROUP, S,
                                      data_dir=os.path.join(root, f"r{i}"),
                                      config=cfg(), **kw))
    svc = rg.ReplicatedService(
        clock or FixedClock(), E, 1, S, group_size=GROUP,
        peers=[("127.0.0.1", s.repl_port) for s in srvs], ack_timeout=15.0,
        config=fast(), data_dir=os.path.join(root, "leader"),
        max_ops_per_tick=K, **(leader_pkg_kw or {}))
    return svc, srvs


def _canon(rg, svc):
    """A lane's state: engine planes verbatim plus the keyed mirrors in
    an order-insensitive form (as the reference's ``_canon``)."""
    fields, host = rg.dump_state(svc)
    (key_slot, slot_handle, values, _nh, leader_b, dyn, _live, _free,
     _names, member_b, inline) = host
    return (fields, [sorted(p) for p in key_slot],
            [sorted(p) for p in slot_handle], sorted(values), leader_b, dyn,
            member_b, [sorted(s) for s in inline])


def _wait_lanes(svc, srvs, rg):
    """Every replica at the leader's applied position; returns the
    leader's canonical lane and each replica's."""
    svc._drain_pending(block_all=True)
    want_pos = (svc.core.applied_ge, svc.core.applied_seq)
    end = time.monotonic() + 60.0
    while time.monotonic() < end:
        pos = []
        for s in srvs:
            with s._lock:
                pos.append((s.core.applied_ge, s.core.applied_seq))
        if all(p == want_pos for p in pos):
            break
        time.sleep(0.02)
    else:
        raise AssertionError(f"replicas at {pos}, leader at {want_pos}")
    lanes = []
    for s in srvs:
        with s._lock:
            lanes.append(_canon(_mod_of(s), s.svc))
    return _canon(rg, svc), lanes


def _mod_of(srv):
    return trg if srv.__class__ is trg.ReplicaServer else jrg


def _settle(svc, futs, budget=60.0):
    end = time.monotonic() + budget
    while not all(f.done for f in futs) and time.monotonic() < end:
        svc.flush()
    assert all(f.done for f in futs), "futures never settled"


def _traffic(rng, svc, r, futs):
    """One round of seeded keyed ops (the same calls on either group for
    the same generator state): bytes puts with a duplicated key in one
    batch, reads with versions, commutative increments, a CAS and a
    delete."""
    add = tfunref.ref("rmw:add", int(rng.integers(1, 9)))
    for e in range(E):
        keys = [f"k{(r + i + e) % 5}" for i in range(3)]
        pick = int(rng.integers(0, 5))
        if pick == 0:
            futs.append(svc.kput_many(
                e, keys + [keys[0]],
                [b"v%d.%d" % (r, i) for i in range(4)]))
        elif pick == 1:
            futs.append(svc.kget_many(e, keys + ["ctr"], want_vsn=True))
        elif pick == 2:
            futs.append(svc.kmodify_many(e, ["ctr", "c2", "ctr"], add, 0))
        elif pick == 3:
            futs.append(svc.kupdate(e, keys[1], (1, 1), b"c%d" % r))
            futs.append(svc.kdelete(e, keys[2]))
        else:
            futs.append(svc.kput(e, keys[0], b"s%d" % r))
            futs.append(svc.kmodify(e, "ctr", add, 0))


def _stop(svc, srvs):
    """Stop the group and close every WAL (before another package opens
    or compares the dirs).  A replica answers nothing more first, so no
    late frame writes into a closed store."""
    svc.stop()
    for s in srvs:
        with s._lock:
            s._handle_repl = lambda frame: ("error", "host down")
        s.stop()
    if svc._wal is not None:
        svc._wal.close()
    for s in srvs:
        with s._lock:
            if s.svc._wal is not None:
                s.svc._wal.close()


ARMS = {"delta": {}, "full_plane": {"RETPU_REPL_DELTA": "0"},
        "comm_off": {"RETPU_COMM_REPL": "0"}}


# -- interop -------------------------------------------------------------------


@pytest.mark.parametrize("leader", ["jax", "port"])
def test_interop_across_packages(env, tmp_path, leader):
    """A JAX leader ships to two port replicas; a port leader ships to a
    JAX replica and a port replica.  Full entries (the first election),
    deltas and merge entries all cross, and every lane ends bit-equal."""
    port_r = (trg, t_fast, {"device": "cpu"})
    jax_r = (jrg, j_fast, {})
    if leader == "jax":
        svc, srvs = _build(jrg, j_fast, str(tmp_path), {},
                           [port_r, port_r])
        rg = jrg
    else:
        svc, srvs = _build(trg, t_fast, str(tmp_path), {"device": "cpu"},
                           [jax_r, port_r])
        rg = trg
    try:
        assert svc.takeover()
        futs = []
        for r in range(4):
            _traffic(np.random.default_rng(7 + r), svc, r, futs)
            _settle(svc, futs)
            svc.runtime.now += 0.25
        lead, reps = _wait_lanes(svc, srvs, rg)
        for i, rp in enumerate(reps):
            assert rp == lead, f"replica {i} left its leader"
        g = svc.stats()["group"]
        assert g["quorum_failures"] == 0 and g["resyncs"] == 0
        assert g["repl_delta_entries"] > 0 and g["repl_full_entries"] > 0
    finally:
        _stop(svc, srvs)


# -- the replica core ----------------------------------------------------------


def _cores(tmp_path):
    """A port lane and a JAX lane, each under a bare ReplicaCore."""
    ts = TSvc(TWall(), E, 1, S, config=t_fast(), tick=None, device="cpu",
              data_dir=str(tmp_path / "port"))
    from riak_ensemble_tpu.parallel.batched_host import (
        BatchedEnsembleService as JSvc, WallRuntime as JWall)
    js = JSvc(JWall(), E, 1, S, config=j_fast(), tick=None,
              data_dir=str(tmp_path / "jax"))
    return (trg.ReplicaCore(ts), ts), (jrg.ReplicaCore(js), js)


def _both(cores, frame):
    """The same frame, encoded once and decoded by each package's codec
    as a replica receives it, through both cores; the answers must be
    equal."""
    (tc, _ts), (jc, _js) = cores
    payload = _encoded(frame, twire)
    got = (tc.handle_abatch(twire.decode(payload)),
           jc.handle_abatch(jwire.decode(payload)))
    assert got[0] == got[1], got
    return got[0]


def test_core_nacks_seq_gap_and_crc_like_the_reference(env, tmp_path):
    """A flipped section byte nacks "crc" and leaves the lane untouched; a
    seq gap nacks "seq" with the in-order prefix applied; a bad merge
    section and an unknown entry kind nack; then the clean entries apply
    and both lanes hold the same cells."""
    cores = _cores(tmp_path)
    (tc, ts), (jc, js) = cores
    q = np.ones((E,), bool)
    committed = np.zeros((2, E), bool)
    committed[0, 1] = committed[1, 1] = committed[0, 2] = True
    kind = np.zeros((2, E), np.int32)
    kind[:, 1] = teng.OP_PUT
    kind[0, 2] = teng.OP_RMW
    slot = np.zeros((2, E), np.int32)
    slot[:, 1] = 3       # two rounds writing the same slot in one entry
    slot[0, 2] = 5
    val = np.full((2, E), 9, np.int32)
    val[1, 1] = 11
    value = np.full((2, E), 4, np.int32)
    entry, crc, _n = trg.build_delta_entry(1, 2, committed, value, kind,
                                           slot, val, q, [])
    bad_vals = np.frombuffer(entry[10].buf, np.int32).copy()
    bad_vals[0] ^= 0xFF
    bad = entry[:10] + (twire.Raw(bad_vals),) + entry[11:]
    r = _both(cores, ("abatch", 0, [bad]))
    assert r[0] == "nack" and r[1] == "crc"
    assert tc.applied_seq == jc.applied_seq == 0
    empty = [trg.build_delta_entry(seq, 0, None, None,
                                   np.zeros((0, E), np.int32),
                                   np.zeros((0, E), np.int32),
                                   np.zeros((0, E), np.int32), q, [])[0]
             for seq in (2, 4)]
    r = _both(cores, ("abatch", 0, [entry, empty[0], empty[1]]))
    assert r[0] == "nack" and r[1] == "seq"
    assert tc.applied_seq == jc.applied_seq == 2
    r = _both(cores, ("abatch", 0, [("zz", 3)]))
    assert r[0] == "nack" and r[1] == "bad-entry"
    # a retransmit of the applied batch re-acks
    r = _both(cores, ("abatch", 0, [entry, empty[0]]))
    assert r[0] == "applied" and r[2] == 2
    # a merge section whose CRC does not match nacks
    mc = np.zeros((2, E), bool)
    mc[0, 3] = mc[1, 3] = True
    mk = np.where(mc, teng.OP_RMW, 0).astype(np.int32)
    me = np.where(mc, tfunref.RMW_ADD, 0).astype(np.int32)
    ms = np.full((2, E), 6, np.int32)
    mv = np.full((2, E), 5, np.int32)
    m_entry = trg.build_comm_entry(3, 2, mc, value, mk, ms, mv, me, q, [],
                                   n_slots=S)[0]
    # the folded-operand section (index 20) changed, its CRC kept
    m_bad = m_entry[:20] + (twire.Raw(np.asarray([99], np.int32)),) \
        + m_entry[21:]
    r = _both(cores, ("abatch", 0, [m_bad]))
    assert r[0] == "nack" and r[1] == "crc"
    r = _both(cores, ("abatch", 0, [m_entry]))
    assert r[0] == "applied" and r[2] == 3
    tn = trg._host(ts.state.obj_val)
    assert np.array_equal(tn, np.asarray(js.state.obj_val))
    assert int(tn[1, 0, 3]) == 11 and int(tn[2, 0, 5]) == 4
    assert int(tn[3, 0, 6]) == 10     # two folded adds on 0
    assert trg.dump_state(ts)[0] == jrg.dump_state(js)[0]
    ts.stop()
    js.stop()


def _record_cells(monkeypatch):
    """Every cell run the port's replicas hand to one device scatter."""
    calls = []
    put = trg._put_cells

    def record(svc, cells):
        calls.append(np.array(cells, np.int64))
        put(svc, cells)
    monkeypatch.setattr(trg, "_put_cells", record)
    return calls


def _unique_cells(calls):
    for cells in calls:
        pairs = {(int(e), int(s)) for e, s in cells[:, :2]}
        assert len(pairs) == len(cells), \
            f"one scatter carried an (ensemble, slot) twice: {cells[:, :2]}"


def test_coalesced_entries_writing_one_slot(env, tmp_path):
    """Several launches settled by one flush ride one frame, and every one
    of them writes the same slot of every row: each of the replica's
    scatters carries an (ensemble, slot) once (CUDA's ``index_put_``
    picks no winner among repeated indices), the coalesced run's
    scatter carries each row's cell once for all its entries, and the
    last write lands."""
    calls = _record_cells(env)
    svc, srvs = _build(trg, t_fast, str(tmp_path), {"device": "cpu"},
                       [(trg, t_fast, {"device": "cpu"})] * 2)
    try:
        assert svc.takeover()
        _settle(svc, [svc.kput(0, "seed", b"s")])
        g0 = svc.stats()["group"]
        kind = np.full((1, E), teng.OP_PUT, np.int32)
        slot = np.full((1, E), S - 1, np.int32)
        futs = [svc.execute_async(kind, slot,
                                  np.full((1, E), 40 + i, np.int32))
                for i in range(3)]
        _settle(svc, futs)
        g1 = svc.stats()["group"]
        entries = (g1["repl_delta_entries"] + g1["repl_full_entries"]
                   - g0["repl_delta_entries"] - g0["repl_full_entries"])
        assert entries == 3
        assert g1["repl_frames"] - g0["repl_frames"] < entries
        lead, reps = _wait_lanes(svc, srvs, trg)
        assert all(rp == lead for rp in reps)
        assert (trg._host(srvs[0].svc.state.obj_val)[:, 0, S - 1] == 42).all()
    finally:
        _stop(svc, srvs)
    _unique_cells(calls)
    # the three writes of each row: a run of two or three entries gave
    # one scatter of E cells, so the replicas' scatters carried at most
    # 2 x 2 x E such cells between them, not 2 x 3 x E
    last = [c for c in calls if (c[:, 1] == S - 1).any()]
    assert 0 < sum(int((c[:, 1] == S - 1).sum()) for c in last) <= 4 * E


def test_tree_patch_with_repeated_cells_like_the_reference(env, tmp_path):
    """A tree patch that names one (ensemble, slot) twice: the port's one
    scatter carries the cell once and lands the patch's last write, the
    mirrors adopt the last key, and both packages' cores answer alike
    and end with equal lanes."""
    calls = _record_cells(env)
    cores = _cores(tmp_path)
    (tc, ts), (jc, js) = cores
    patches = [(1, 2, 3, 7, 100, "a", 1, b"first"),
               (2, 0, 3, 2, 5, "b", 2, b"b"),
               (1, 2, 3, 8, 101, "a2", 3, b"second"),
               (1, 2, 4, 9, 102, "a3", 4, b"last")]
    frame = ("tpatch", 1, 4, (0, 0), trg.dump_meta(ts), patches)
    payload = _encoded(frame, twire)
    got = (tc.handle_tpatch(twire.decode(payload)),
           jc.handle_tpatch(jwire.decode(payload)))
    assert got[0] == got[1] == ("installed", 1, 4)
    assert len(calls) == 1
    _unique_cells(calls)
    assert sorted(map(tuple, calls[0][:, :2].tolist())) == [(1, 2), (2, 0)]
    tn = trg._host(ts.state.obj_val)
    assert int(tn[1, 0, 2]) == 102 and int(tn[2, 0, 0]) == 5
    assert trg.dump_state(ts) == jrg.dump_state(js)
    assert ts.key_slot[1] == js.key_slot[1] == {"a3": 2}
    ts.stop()
    js.stop()


def test_takeover_fences_the_old_leader(env, tmp_path):
    """Promoting a replica (a promise round at a higher epoch) deposes the
    old leader: its next flush fails every op (no acked write after the
    fencing), it refuses new launches, and the promoted host serves
    every write the old reign acked."""
    svc, srvs = _build(trg, t_fast, str(tmp_path), {"device": "cpu"},
                       [(trg, t_fast, {"device": "cpu"})] * 2)
    try:
        assert svc.takeover()
        acked = [svc.kput(e, "a", b"before%d" % e) for e in range(E)]
        _settle(svc, acked)
        assert all(f.value[0] == "ok" for f in acked)
        new = srvs[0]
        r = new._promote([("127.0.0.1", srvs[1].repl_port)])
        assert r[0] == "ok" and new.svc.is_leader
        late = [svc.kput(e, "a", b"late") for e in range(E)]
        try:
            _settle(svc, late, budget=20.0)
        except trg.DeposedError:
            pass
        assert all(f.value == "failed" for f in late if f.done)
        assert not svc.is_leader and svc._deposed
        with pytest.raises(trg.DeposedError):
            svc.kput(0, "b", b"x")
            svc.flush()
        with new._lock:
            reads = [new.svc.kget(e, "a") for e in range(E)]
        end = time.monotonic() + 20
        while not all(f.done for f in reads) and time.monotonic() < end:
            time.sleep(0.05)
        assert [f.value for f in reads] == \
            [("ok", b"before%d" % e) for e in range(E)]
    finally:
        _stop(svc, srvs)


# -- lost host quorum, version-preserving installs --------------------------------


def _down(svc, srvs):
    """Both replica hosts die: they stop answering, their ports close and
    the leader's connections to them drop."""
    import socket
    for s in srvs:
        with s._lock:
            s._handle_repl = lambda frame: ("error", "host down")
        s.stop()
    for link in svc._links:
        sock = link._sock
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


def test_lost_host_quorum_fails_reads_and_writes_like_the_reference(
        env, tmp_path):
    """With both replicas gone every op of the flush resolves 'failed' —
    the reads too (``ack_reads=False``: a minority leader serves
    nothing) — in both packages alike, and neither leader's read mirrors
    take the unacknowledged reads."""
    groups = []
    for rg, fast, kw in ((jrg, j_fast, {}), (trg, t_fast,
                                             {"device": "cpu"})):
        groups.append(_build(rg, fast, str(tmp_path / rg.__name__), kw,
                             [(rg, fast, kw)] * 2))
    futs = ([], [])
    try:
        for (svc, srvs), fl in zip(groups, futs):
            assert svc.takeover()
            fl += [svc.kput_many(e, ["a", "b"], [b"1", b"2"])
                   for e in range(E)]
            _settle(svc, fl)
            _down(svc, srvs)
            svc.ack_timeout = 1.0
            late = [svc.kput_many(e, ["a", "c"], [b"3", b"4"])
                    for e in range(E)]
            late += [svc.kget_many(e, ["a", "b"], want_vsn=True)
                     for e in range(E)]
            late.append(svc.kget(0, "b"))
            _settle(svc, late)
            fl += late
        assert [norm(f.value) for f in futs[1]] == \
            [norm(f.value) for f in futs[0]]
        assert all(r == "failed" for f in futs[1][E:]
                   for r in (f.value if isinstance(f.value, list)
                             else [f.value]))
        (js, _), (ts, _) = groups
        for name in ("_slot_vsn_np", "_slot_vsn_ok", "_inline_value_ok"):
            assert np.array_equal(getattr(js, name), getattr(ts, name)), name
        assert ts.stats()["group"]["quorum_failures"] == \
            js.stats()["group"]["quorum_failures"] > 0
    finally:
        for svc, _srvs in groups:
            svc.stop()


def _settle_single(svc, futs):
    while not all(f.done for f in futs):
        svc.flush()
