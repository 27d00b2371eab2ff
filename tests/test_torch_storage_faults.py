"""The port's storage-fault plane against the JAX package's (the mirror of
the service cases of ``tests/test_storage_faults.py``, the WAL cases of
``tests/test_faults.py`` and ``tests/test_crashpoints.py:142``).

One fault schedule drives both packages: the same environment knobs
(``RETPU_FAULT_STORAGE`` / ``_TORN`` / ``_CORRUPT`` / ``_FSYNC_MS`` /
``_SEED`` / ``_SILENT``) parse to the same plan, and each case installs an
equal plan in each package's ``faults`` module.

- ``PyLogStore`` under injected write / fsync errors, torn writes (the
  tail repaired, later acks surviving two tears in a row) and read
  corruption (detected, never served; a transient flip healed by the
  re-read): the same outcome and byte-identical log files;
- ENOSPC at the WAL barrier degrades the service to read-only in
  lockstep with the JAX service: the write fails, queued writes fail,
  queued and new reads serve, new writes and ``execute`` writes are
  refused, nothing compacts, and a restore serves writes again;
- a generic ``OSError`` at the barrier re-raises to the flush caller and
  does not degrade; a fatal errno on a later launch of the same drain
  still wins;
- ``buffer`` mode reaches the kernel before the ack;
- a CPU-only subprocess (no JAX) killed at ``wal_append``,
  ``wal_fsync_pre`` and ``wal_fsync_post``: every acked write survives,
  the write in flight reads its value or NOTFOUND, the restored service
  serves.

Tolerance: exact equality everywhere.
"""

import errno
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from riak_ensemble_tpu_torch import faults as tfaults
from riak_ensemble_tpu_torch.ops import engine as teng
from riak_ensemble_tpu_torch.parallel import batched_host as tb
from riak_ensemble_tpu_torch.parallel import wal as twal
from test_torch_compaction import norm
from test_torch_kmodify import FixedClock
from test_torch_wal import Durable, _read_all

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def jf():
    """The JAX package's faults and WAL modules; both planes cleared
    after the test."""
    pytest.importorskip("jax")
    from riak_ensemble_tpu import faults as jfaults
    from riak_ensemble_tpu.parallel import wal as jwal
    yield jfaults, jwal
    jfaults.clear()
    tfaults.clear()


@pytest.fixture
def jb(jf):
    from riak_ensemble_tpu.parallel import batched_host as jb
    return jb


def _install(jfaults, arm):
    """The same plan in both packages; ``arm(plan)`` sets its rules."""
    return (jfaults.install(arm(jfaults.FaultPlan(seed=7))),
            tfaults.install(arm(tfaults.FaultPlan(seed=7))))


def test_storage_knobs_parse_like_jax(jf):
    jfaults, _ = jf
    env = {"RETPU_FAULT_STORAGE": "wal.fsync=ENOSPC,ckpt.write=EIO:2",
           "RETPU_FAULT_TORN": "wal:100", "RETPU_FAULT_CORRUPT": "tree:0.5",
           "RETPU_FAULT_FSYNC_MS": "3", "RETPU_FAULT_SEED": "9",
           "RETPU_FAULT_SILENT": "1"}
    want = jfaults.from_env(env).describe()
    got = tfaults.from_env(env).describe()
    for key in ("storage", "torn", "corrupt", "fsync_ms", "seed", "silent"):
        assert got[key] == want[key], key
    assert tfaults.from_env({}) is None and jfaults.from_env({}) is None
    for bad in ({"RETPU_FAULT_STORAGE": "wal.fsync=EPERM"},
                {"RETPU_FAULT_TORN": "wal"},
                {"RETPU_FAULT_STORAGE": "disk.write=EIO"}):
        with pytest.raises(ValueError):
            jfaults.from_env(bad)
        with pytest.raises(ValueError):
            tfaults.from_env(bad)
    plan = tfaults.install(tfaults.FaultPlan().set_fsync_delay(1.0))
    tfaults.fsync_sleep()
    assert plan.fsync_delays == 1 and plan.fsync_delay_injected_ms == 1.0


def _log_case(store_mod, faults_mod, path, case):
    """One scripted sequence on a ``PyLogStore``; returns what a fresh
    reader then sees and the store's evidence counters."""
    st = store_mod.PyLogStore(path)
    st.store("k0", "v0" * 20)
    st.sync()
    outcome = []
    if case == "errors":
        for rule in (("wal", "write", "EIO"), ("wal", "fsync", "ENOSPC")):
            faults_mod.install(faults_mod.FaultPlan()
                               .set_storage_error(*rule))
            try:
                st.store("k1", "v1") if rule[1] == "write" else st.sync()
            except OSError as exc:
                outcome.append(exc.errno)
            faults_mod.clear()
    elif case == "torn":
        for i in (1, 2):
            faults_mod.install(faults_mod.FaultPlan().set_torn_write("wal",
                                                                     6))
            try:
                st.store(f"t{i}", f"torn{i}")
            except OSError as exc:
                outcome.append(exc.errno)
            faults_mod.clear()
    st.store("k2", "v2")
    st.sync()
    outcome.append(st.append_repairs)
    st.close()
    if case == "corrupt":
        faults_mod.install(faults_mod.FaultPlan(seed=7)
                           .set_read_corruption("wal", 1.0))
    rd = store_mod.PyLogStore(path)
    faults_mod.clear()
    seen = [rd.fetch(k) for k in ("k0", "k1", "t1", "t2", "k2")]
    evidence = (rd.truncations, rd.read_retries, rd.count())
    rd.close()
    return outcome, seen, evidence


@pytest.mark.parametrize("case", ["errors", "torn", "corrupt"])
def test_pylogstore_faults_like_jax(jf, tmp_path, case):
    jfaults, jwal = jf
    got = _log_case(twal, tfaults, str(tmp_path / "t.log"), case)
    want = _log_case(jwal, jfaults, str(tmp_path / "j.log"), case)
    assert got == want
    outcome, seen, (truncations, _retries, _n) = got
    if case == "errors":
        assert outcome[:2] == [errno.EIO, errno.ENOSPC]
    if case == "torn":
        assert outcome == [errno.EIO, errno.EIO, 2]
        assert seen[4] == "v2" and seen[2] is None and truncations == 0
    if case == "corrupt":
        # every read flips: the first frame fails its CRC twice, replay
        # stops there, and nothing corrupted is served
        assert seen == [None] * 5 and truncations == 1
    files = [open(str(tmp_path / n), "rb").read()
             for n in ("t.log", "j.log")]
    assert files[0] == files[1]


def test_transient_read_flip_heals_on_reread(jf, tmp_path, monkeypatch):
    """A flip on the first read of a frame only: the re-read passes, the
    healthy record is served and nothing is truncated — in both
    packages."""
    jfaults, jwal = jf
    out = []
    for mod, faults_mod, name in ((twal, tfaults, "t"), (jwal, jfaults,
                                                         "j")):
        path = str(tmp_path / name)
        st = mod.PyLogStore(path)
        st.store("k", "v" * 40)
        st.sync()
        st.close()
        real = faults_mod.read_filter
        hits = {"n": 0}

        def once(cls, data, real=real, hits=hits):
            hits["n"] += 1
            return (data[:-1] + bytes([data[-1] ^ 1]) if hits["n"] == 1
                    else real(cls, data))
        monkeypatch.setattr(faults_mod, "read_filter", once)
        rd = mod.PyLogStore(path)
        out.append((rd.fetch("k"), rd.read_retries, rd.truncations))
        rd.close()
    assert out[0] == out[1] == ("v" * 40, 1, 0)


def test_enospc_degrades_read_only_like_jax(jb, jf, monkeypatch, tmp_path):
    jfaults, _ = jf
    p = Durable(jb, monkeypatch, str(tmp_path), "default", e=2, s=8, k=4)
    p.both(lambda s: s.kput(0, "a", b"1"))
    p.settle()
    _install(jfaults, lambda pl: pl.set_storage_error("wal", "fsync",
                                                      "ENOSPC"))
    p.both(lambda s: s.kput(0, "b", b"2"))
    p.settle()
    for svc in (p.js, p.ts):
        assert svc._storage_degraded["errno"] == "ENOSPC"
        assert svc._storage_degraded["mode"] == "read_only"
        assert svc.wal_storage_errors == 1
    jfaults.clear()
    tfaults.clear()
    # queued writes fail at the degrade's record, later ones at enqueue;
    # reads keep serving (the lease forced off: they take the device)
    for svc in (p.js, p.ts):
        svc.lease_until[:] = 0.0
    p.both(lambda s: [s.kput(1, "c", b"3"),
                      s.kput_many(1, ["d", "e"], [b"4", b"5"]),
                      s.kget(0, "a")])
    p.settle()
    p.check_futures()
    vals = [norm(f.value) for f in p.futs[1]]
    assert vals == [("ok", (1, 1)), "failed", "failed",
                    ["failed", "failed"], ("ok", b"1")]
    for svc in (p.js, p.ts):
        with pytest.raises(OSError):
            svc.execute(np.full((1, 2), teng.OP_PUT, np.int32),
                        np.zeros((1, 2), np.int32),
                        np.ones((1, 2), np.int32))
        got = svc.execute(np.full((1, 2), teng.OP_GET, np.int32),
                          np.zeros((1, 2), np.int32),
                          np.zeros((1, 2), np.int32))
        assert np.asarray(got[1]).all()        # reads serve
        svc.wal_compact_records = 1
        svc.flush()
        assert svc.wal_compactions == 0        # never compacts
    p.crash()
    js, ts = p.restore("jax", p.dirs[0]), p.restore("port", p.dirs[1])
    assert ts._storage_degraded is None
    keys = {0: ["a", "b"], 1: ["c", "d"]}
    got = _read_all(ts, keys)
    assert got == _read_all(js, keys)
    assert got[0][0][:2] == ("ok", b"1")
    assert got[0][1][1] in ("NOTFOUND", b"2")
    f = ts.kput(0, "post", b"p")
    while not f.done:
        ts.flush()
    assert f.value[0] == "ok"


def test_generic_oserror_reraises_and_fatal_errno_wins(jb, jf, monkeypatch,
                                                       tmp_path):
    """A generic ``OSError`` at the barrier fails the launch's writes and
    re-raises to the flush caller without degrading; later writes ack.
    At depth 2, an EBADF on one launch and an EIO on the next in one
    drain: the EIO degrades, nothing raises."""
    p = Durable(jb, monkeypatch, str(tmp_path), "default", e=1, s=8, k=1)
    p.settle()
    for svc in (p.js, p.ts):
        real = svc._wal.log

        def flaky(recs):
            raise OSError("transient")
        svc._wal.log = flaky
        f = svc.kput(0, "k", b"v")
        with pytest.raises(OSError, match="transient"):
            for _ in range(4):
                svc.flush()
        assert f.value == "failed" and svc._storage_degraded is None
        svc._wal.log = real
        g = svc.kput(0, "k", b"v2")
        while not g.done:
            svc.flush()
        assert g.value[0] == "ok"
    p2 = Durable(jb, monkeypatch, str(tmp_path / "late"), "default",
                 depth=2, e=1, s=8, k=1)
    p2.settle()
    for svc in (p2.js, p2.ts):
        errs = [OSError(errno.EBADF, "yanked fd"),
                OSError(errno.EIO, "dead disk")]

        def flaky2(recs, errs=errs):
            raise errs.pop(0)
        svc._wal.log = flaky2
        futs = [svc.kput(0, "a", b"1"), svc.kput(0, "b", b"2")]
        for _ in range(4):
            svc.flush()
        assert [f.value for f in futs] == ["failed", "failed"]
        assert svc._storage_degraded["errno"] == "EIO"
        assert svc.wal_storage_errors == 2


def test_fsync_delay_lands_under_the_barrier(tmp_path):
    """``RETPU_FAULT_FSYNC_MS``'s rule sleeps inside the WAL barrier of
    every write-carrying flush (``tests/test_faults.py``'s WAL case): one
    delay per durable flush, none for a read-only one."""
    svc = tb.BatchedEnsembleService(FixedClock(), 2, 3, 8, device="cpu",
                                    data_dir=str(tmp_path / "d"))
    svc.flush()
    plan = tfaults.install(tfaults.from_env({"RETPU_FAULT_FSYNC_MS": "2"}))
    try:
        f = svc.kput_many(0, ["a", "b"], [b"1", b"2"])
        svc.flush()
        assert f.value[0][0] == "ok" and plan.fsync_delays == 1
        svc.lease_until[:] = 0.0
        g = svc.kget(0, "a")
        svc.flush()
        assert g.value == ("ok", b"1") and plan.fsync_delays == 1
        assert plan.fsync_delay_injected_ms == 2.0
    finally:
        tfaults.clear()


def test_buffer_mode_reaches_the_kernel_before_the_ack(tmp_path):
    """``wal_sync="buffer"``: after ``log`` returns, a fresh reader of
    the file (the writer still open) sees the record, on both stores."""
    rec = [(("kv", 0, 0), ("k", 1, 1, 1, b"v", False))]
    w = twal.ServiceWAL(str(tmp_path / "py"), sync_mode="buffer",
                        native=False)
    w.log(rec)
    rd = twal.PyLogStore(os.path.join(str(tmp_path / "py"), "wal"))
    assert rd.fetch(("kv", 0, 0)) == rec[0][1]
    rd.close()
    w.close()
    n = twal.ServiceWAL(str(tmp_path / "nat"), sync_mode="buffer")
    n.log(rec)
    log_file = os.path.join(str(tmp_path / "nat"), "wal.log")
    assert os.path.getsize(log_file) > 30
    n.close()
    with pytest.raises(ValueError):
        twal.ServiceWAL(str(tmp_path / "x"), sync_mode="sometimes")


#: a CPU-only child (no JAX): prints TRY before each put and ACK after
#: each 'ok', so the parent splits acked writes from the one in flight
_PUT_CHILD = """
    import sys
    sys.path.insert(0, {repo!r})
    sys.modules["jax"] = sys.modules["riak_ensemble_tpu"] = None
    from riak_ensemble_tpu_torch.parallel.batched_host import (
        BatchedEnsembleService, WallRuntime)
    svc = BatchedEnsembleService(WallRuntime(), 2, 3, 4, device="cpu",
                                 data_dir={data!r})
    for i in range(6):
        print("TRY", i, flush=True)
        f = svc.kput(i % 2, "k%d" % i, b"v%d" % i)
        while not f.done:
            svc.flush()
        if f.value[0] == "ok":
            print("ACK", i, flush=True)
    print("SURVIVED", flush=True)
"""


@pytest.mark.parametrize("barrier", ["wal_append:2", "wal_fsync_pre:2",
                                     "wal_fsync_post:2"])
def test_kill_at_wal_barrier_recovers(tmp_path, barrier):
    data = str(tmp_path / "data")
    child = textwrap.dedent(_PUT_CHILD.format(repo=REPO, data=data))
    proc = subprocess.run([sys.executable, "-c", child],
                          env=dict(os.environ, RETPU_CRASHPOINT=barrier),
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == tfaults.CRASH_EXIT, proc.stderr[-2000:]
    assert "SURVIVED" not in proc.stdout
    acked = [int(ln.split()[1]) for ln in proc.stdout.splitlines()
             if ln.startswith("ACK")]
    tried = [int(ln.split()[1]) for ln in proc.stdout.splitlines()
             if ln.startswith("TRY")]
    inflight = [i for i in tried if i not in acked]
    assert acked and len(inflight) == 1
    svc = tb.BatchedEnsembleService.restore(FixedClock(), data,
                                            device="cpu", data_dir=data)
    got = _read_all(svc, {e: [f"k{i}" for i in tried if i % 2 == e]
                          for e in (0, 1)})
    seen = {f"k{i}": r[1] for e, row in enumerate(got)
            for i, r in zip([i for i in tried if i % 2 == e], row)}
    for i in acked:
        assert seen[f"k{i}"] == b"v%d" % i, (barrier, i, seen)
    for i in inflight:
        assert seen[f"k{i}"] in (b"v%d" % i, "NOTFOUND"), (barrier, seen)
    f = svc.kput(0, "post", b"p")
    while not f.done:
        svc.flush()
    assert f.value[0] == "ok"
    assert _read_all(svc, {0: ["post"]})[0][0][:2] == ("ok", b"p")


def test_crashpoint_malformed_nth_disarms(monkeypatch, capsys):
    monkeypatch.setenv("RETPU_CRASHPOINT", "wal_append:x")
    tfaults.crashpoint("wal_append")
    assert "RETPU_CRASHPOINT" not in os.environ
    assert "IGNORING" in capsys.readouterr().err
