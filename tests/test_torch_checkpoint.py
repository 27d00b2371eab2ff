"""Checkpoints of the port's service (the mirror of
``tests/test_checkpoint.py``, the checkpoint cases of ``tests/test_wal.py``
and ``tests/test_crashpoints.py:175``).

The port writes its own checkpoint format (``ops/checkpoint.py``: one
CRC-framed file of every ``EngineState`` plane), because the reference's
uses orbax; so a checkpoint never crosses packages.  What is held:

- ``save`` then ``restore``: every state plane ``torch.equal`` to the
  saved one, the host maps equal, and the restored service equal to the
  JAX service restored from ITS save of the same stream (every plane,
  mirror and map);
- generations: each ``save`` flips ``CURRENT``, prunes older
  checkpoints and rotates the WAL (only ``ckpt.<n>`` and ``wal.<n>``
  remain), writes after it land in the new generation, and a crash then
  restores (checkpoint + WAL) equal to the JAX service's;
- WAL compaction waits for an idle flush, runs in-line past twice the
  record bound, and never runs on a degraded service; the counts equal
  the JAX service's;
- a damaged engine file (a flipped byte, or the ``ckpt`` read-corruption
  rule) is refused, never served; a foreign (JAX) checkpoint, and a
  dynamic-row data dir restored with ``dynamic=False``, raise;
  ``restore`` defaults to CUDA;
- a process killed inside ``save`` (a CPU-only subprocess that imports no
  JAX) at the engine file, at the host blob and after the ``CURRENT``
  flip leaves a restorable data dir holding every acknowledged write.

Tolerance: exact equality everywhere.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from riak_ensemble_tpu_torch import faults as tfaults
from riak_ensemble_tpu_torch import funref as tfunref
from riak_ensemble_tpu_torch import save as tsave
from riak_ensemble_tpu_torch.ops import checkpoint as tckpt
from riak_ensemble_tpu_torch.parallel import batched_host as tb
from test_torch_kmodify import FixedClock
from test_torch_wal import Durable, _read_all, assert_same_service
from test_torch_reference_natives import reference_natives  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def jb():
    pytest.importorskip("jax")
    pytest.importorskip("orbax.checkpoint")
    from riak_ensemble_tpu.parallel import batched_host as jb
    return jb


def _stream(p, rounds=3):
    add = tfunref.ref("rmw:add", 2)
    for r in range(rounds):
        for e in range(p.ts.n_ens):
            p.both(lambda s: [s.kput_many(e, [f"a{r}", "b"],
                                          [b"%d" % r, b"b%d" % r]),
                              s.kmodify(e, "ctr", add, 0),
                              s.kdelete(e, f"a{r - 1}")])
        p.settle()


def test_save_restore_roundtrip_is_bit_equal(jb, monkeypatch, tmp_path):
    p = Durable(jb, monkeypatch, str(tmp_path), "default", e=4, s=8)
    _stream(p)
    for svc in (p.js, p.ts):
        svc.save()
    saved = [t.clone() for t in p.ts.state]
    assert sorted(os.listdir(p.dirs[1])) == sorted(os.listdir(p.dirs[0]))
    p.crash()
    js, ts = p.restore("jax", p.dirs[0]), p.restore("port", p.dirs[1])
    assert all(torch.equal(a, b) for a, b in zip(saved, ts.state))
    assert ts.key_slot == p.ts.key_slot and ts.values == p.ts.values
    assert ts._inline_slots == p.ts._inline_slots
    assert np.array_equal(ts._inline_np, p.ts._inline_np)
    assert not ts.lease_until.any()          # leases are never persisted
    assert_same_service(js, ts)
    keys = {e: ["a2", "b", "ctr", "a1"] for e in range(4)}
    assert _read_all(ts, keys) == _read_all(js, keys)


def test_generations_rotate_prune_and_replay(jb, monkeypatch, tmp_path):
    p = Durable(jb, monkeypatch, str(tmp_path), "default", e=4, s=8)
    _stream(p, 2)
    for _gen in (1, 2):
        for svc in (p.js, p.ts):
            svc.save()
        _stream(p, 1)
    for d in p.dirs:
        names = sorted(n for n in os.listdir(d) if "." in n
                       and not n.endswith(".backup"))
        assert names == ["ckpt.2", "wal.2"], names
        assert tsave.read(os.path.join(d, "CURRENT")) == b"2"
    assert p.ts._wal.dir_path.endswith("wal.2")
    assert p.ts._wal.count == p.js._wal.count > 0
    p.check_futures()
    p.check_files()
    p.crash()
    js, ts = p.restore("jax", p.dirs[0]), p.restore("port", p.dirs[1])
    assert_same_service(js, ts)
    assert ts.leader_np.tolist() == [-1] * 4     # the replay reset them


def test_compaction_waits_for_an_idle_flush(jb, monkeypatch, tmp_path):
    """``wal_compact_records=6``: a loaded depth-2 stream compacts only
    at idle flushes or past 12 records, exactly when the JAX service
    does; a degraded service never compacts."""
    p = Durable(jb, monkeypatch, str(tmp_path), "default", depth=2, e=4,
                s=8, k=2, wal_compact_records=6)
    at = ([], [])
    for r in range(6):
        for e in range(4):
            p.both(lambda s: s.kput_many(e, [f"k{r}", f"j{r}"],
                                         [b"1", b"2"]))
        for i, svc in enumerate((p.js, p.ts)):
            while any(svc.queues):
                svc.flush()
                at[i].append((svc.wal_compactions, bool(svc._active),
                              bool(svc._inflight_launches
                                   if i == 0 else svc._inflight)))
    p.settle()
    assert at[0] == at[1]
    assert p.ts.wal_compactions == p.js.wal_compactions > 0
    assert p.ts.wal_compaction_ms_total > 0
    p.check_futures()
    p.check_files()
    for svc in (p.js, p.ts):
        svc._degrade_storage("wal", OSError(28, "disk full"))
        svc.wal_compact_records = 1
        for _ in range(3):
            svc.flush()
    assert p.ts.wal_compactions == p.js.wal_compactions


def test_damaged_or_foreign_checkpoints_are_refused(jb, monkeypatch,
                                                   tmp_path):
    p = Durable(jb, monkeypatch, str(tmp_path), "default", e=2, s=4)
    _stream(p, 1)
    for svc in (p.js, p.ts):
        svc.save()
    p.crash()
    eng_file = os.path.join(p.dirs[1], "ckpt.1", "engine")
    plan = tfaults.install(tfaults.FaultPlan(seed=3)
                           .set_read_corruption("ckpt", 1.0))
    try:
        with pytest.raises(ValueError, match="CRC|not an engine|header"):
            tckpt.load_state(os.path.dirname(eng_file), "cpu")
    finally:
        tfaults.clear()
    assert plan.corrupt_reads_injected == 1
    raw = bytearray(open(eng_file, "rb").read())
    raw[-5] ^= 0x10
    open(eng_file, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="CRC"):
        p.restore("port", p.dirs[1], log=False)
    with pytest.raises(ValueError, match="directory"):
        p.restore("port", p.dirs[0], log=False)   # the JAX checkpoint
    dyn = str(tmp_path / "dyn")
    os.makedirs(dyn)
    tsave.write(os.path.join(dyn, "META"), pickle.dumps(
        {"shape": (2, 3, 4), "dynamic": True, "hash_format": 3},
        protocol=4))
    # a dynamic-row data dir restores dynamic (the persisted mode wins);
    # a contradicting flag is refused
    with pytest.raises(ValueError, match="dynamic"):
        tb.BatchedEnsembleService.restore(FixedClock(), dyn, tick=None,
                                          device="cpu", dynamic=False)
    svc = tb.BatchedEnsembleService.restore(FixedClock(), dyn, tick=None,
                                            device="cpu")
    assert svc.dynamic and not svc._live.any() and svc._free_rows == [1, 0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tb.BatchedEnsembleService.restore(FixedClock(), p.dirs[1],
                                              tick=None)


#: a CPU-only child (no JAX): an acked working set, a checkpoint, more
#: acked writes, then the second checkpoint the crash point kills
_CKPT_CHILD = """
    import sys
    sys.path.insert(0, {repo!r})
    sys.modules["jax"] = sys.modules["riak_ensemble_tpu"] = None
    from riak_ensemble_tpu_torch.parallel.batched_host import (
        BatchedEnsembleService, WallRuntime)
    svc = BatchedEnsembleService(WallRuntime(), 2, 3, 8, tick=None,
                                 device="cpu", data_dir={data!r})
    def put(i):
        f = svc.kput(i % 2, "k%d" % i, b"v%d" % i)
        while not f.done:
            svc.flush()
        assert f.value[0] == "ok", f.value
        print("ACK", i, flush=True)
    for i in range(3):
        put(i)
    svc.save()
    for i in range(3, 6):
        put(i)
    print("SAVING", flush=True)
    svc.save()
    print("SURVIVED", flush=True)
"""


@pytest.mark.parametrize("barrier", [
    "ckpt_tmp_write:6",   # the second save's engine file, never renamed
    "ckpt_rename:7",      # its host blob live, CURRENT not flipped
    "ckpt_rename:9",      # CURRENT flipped; backup and rotation never ran
])
def test_kill_inside_checkpoint_recovers(tmp_path, barrier):
    data = str(tmp_path / "data")
    child = textwrap.dedent(_CKPT_CHILD.format(repo=REPO, data=data))
    proc = subprocess.run([sys.executable, "-c", child],
                          env=dict(os.environ, RETPU_CRASHPOINT=barrier),
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == tfaults.CRASH_EXIT, proc.stderr[-2000:]
    assert "SAVING" in proc.stdout and "SURVIVED" not in proc.stdout
    want_gen = 2 if barrier == "ckpt_rename:9" else 1
    assert tb.BatchedEnsembleService._current_ckpt(data) == want_gen
    svc = tb.BatchedEnsembleService.restore(FixedClock(), data, tick=None,
                                            device="cpu", data_dir=data)
    keys = {e: [f"k{i}" for i in range(6) if i % 2 == e] for e in (0, 1)}
    got = _read_all(svc, keys)
    assert got == [[("ok", b"v%d" % i, r[2]) for i, r in zip(
        range(e, 6, 2), got[e])] for e in (0, 1)]
    f = svc.kput(0, "post", b"p")
    while not f.done:
        svc.flush()
    assert f.value[0] == "ok"
    assert _read_all(svc, {0: ["post"]})[0][0][:2] == ("ok", b"p")
