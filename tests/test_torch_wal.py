"""The port's write-ahead log against the JAX package's (the mirror of
``tests/test_wal.py`` and the WAL cases of the native suites).

The JAX service and the port's (``device="cpu"``) run one seeded keyed
stream in lockstep, each with its own ``data_dir``, on the default host
arm (the C++ WAL encode into the treestore; the JAX service's ``.so``
asserted loaded) and on the plain arm (``plain_host_passes=True`` against
the JAX service without its host library: the Python encoder into
``PyLogStore``), at depth 1 and 2.  The stream covers keyed puts, deletes,
CAS, device and host ``kmodify``, ``execute`` with RMW rows (their records
carry the computed value), a payload of 64 KiB or more, str payloads,
exotic keys (ints past int64, bytes, tuples, non-ASCII text):

- every future resolves the same, and every file of the two data dirs
  (``META``, the WAL generation's store files) is byte-identical;
- a crash without a checkpoint: each package restores its own dir, and
  each restores the other's; all four equal in every state plane and
  host mirror, and the restored service takes a write;
- the C++ encode against ``pickle.dumps`` of the same records (and the
  JAX package's pass), lane by lane;
- slot recycling across a crash: a deleted key's recycled slot that a
  new key took replays to the new key.

Tolerance: exact equality everywhere.
"""

import os
import pickle
import shutil

import numpy as np
import pytest

from riak_ensemble_tpu_torch import funref as tfunref
from riak_ensemble_tpu_torch import interop
from riak_ensemble_tpu_torch.ops import engine as teng
from riak_ensemble_tpu_torch.parallel import batched_host as tb
from riak_ensemble_tpu_torch.parallel import resolve_native as trn
from test_torch_compaction import norm
from test_torch_kmodify import FixedClock
from test_torch_native_enqueue import PORT_KW, _jax_env

MIRRORS = ("_slot_vsn_np", "_slot_vsn_ok", "_inline_value_np",
           "_inline_value_ok", "_inline_np", "leader_np", "lease_until")
HOST = ("key_slot", "slot_handle", "values", "free_slots", "_next_handle",
        "_inline_slots", "slot_gen")
EXOTIC = [7, 2 ** 70, b"raw", ("t", 1), "ключ", -3]


@pytest.fixture
def jb():
    pytest.importorskip("jax")
    from riak_ensemble_tpu.parallel import batched_host as jb
    return jb


def _host_incr(vsn, cur):
    return int(cur) + 1


class Durable:
    """The JAX service and the port's on one host arm, each with its own
    ``data_dir`` under ``root``, driven together."""

    def __init__(self, jb, monkeypatch, root, arm, depth=1, e=8, m=3,
                 s=16, k=4, **kw):
        _jax_env(monkeypatch, arm, True, True)
        if arm == "plain":
            from riak_ensemble_tpu.parallel import enqueue_native, \
                resolve_native
            from riak_ensemble_tpu.synctree import native_store
            for mod in (enqueue_native, resolve_native):
                monkeypatch.setattr(mod, "_instance", None)
                monkeypatch.setattr(mod, "_instance_tried", True)
            monkeypatch.setattr(native_store, "available", lambda: False)
        self.jb, self.arm, self.k, self.kw = jb, arm, k, kw
        self.dirs = (os.path.join(root, "jax"), os.path.join(root, "port"))
        self.js = jb.BatchedEnsembleService(
            FixedClock(), e, m, s, tick=None, max_ops_per_tick=k,
            pipeline_depth=depth, data_dir=self.dirs[0], **kw)
        self.ts = tb.BatchedEnsembleService(
            FixedClock(), e, m, s, tick=None, max_ops_per_tick=k,
            device="cpu", pipeline_depth=depth, data_dir=self.dirs[1],
            **PORT_KW[arm], **kw)
        native = arm == "default"
        assert (self.js._native_resolve is not None) == native
        assert (self.ts._native_resolve is not None) == native
        store = type(self.js._wal._store).__name__
        assert store == ("NativeBackend" if native else "PyLogStore")
        assert type(self.ts._wal._store).__name__ == store
        self.futs = ([], [])

    def both(self, fn):
        for i, svc in enumerate((self.js, self.ts)):
            got = fn(svc)
            self.futs[i].extend(got if isinstance(got, list) else [got])

    def settle(self):
        while any(self.js.queues) or any(self.ts.queues) \
                or self.js._retry_at or self.ts._retry_at:
            assert self.js.flush() == self.ts.flush()
        assert self.js.flush() == self.ts.flush()

    def run(self, seed, rounds=8):
        """Even rounds carry batches only (str keys, bytes payloads,
        device RMW): the flushes the C++ encode takes on the default
        arm.  Odd rounds mix in what sends a flush to the Python walk:
        scalar writes, host kmodify, exotic keys, str payloads and a
        70,000-byte payload."""
        rng = np.random.default_rng(seed)
        add = tfunref.ref("rmw:add", 3)
        for r in range(rounds):
            for e in range(self.js.n_ens):
                keys = [f"k{(r + i + e) % 6}" for i in range(3)]
                pick = int(rng.choice([0, 3, 7] if r % 2 == 0
                                      else range(8)))
                if pick == 0:
                    self.both(lambda s: s.kput_many(
                        e, keys, [f"b{r}.{i}".encode() for i in range(3)]))
                elif pick == 1:
                    self.both(lambda s: [s.kput(e, keys[0], b"p%d" % r),
                                         s.kdelete(e, keys[1])])
                elif pick == 2:
                    self.both(lambda s: [
                        s.kupdate(e, keys[2], (0, 0), b"c%d" % r),
                        s.kmodify(e, "ctr", add, 0)])
                elif pick == 3:
                    self.both(lambda s: s.kmodify_many(
                        e, ["ctr", "c2", "ctr"], add, 0))
                elif pick == 4:
                    self.both(lambda s: s.kmodify(e, "host", _host_incr,
                                                  0))
                elif pick == 5:
                    self.both(lambda s: s.kput_many(
                        e, EXOTIC[r % 3::3], [b"x%d" % r] * 2))
                elif pick == 6:
                    self.both(lambda s: s.kput_many(
                        e, keys[:2], ["str payload", b"y" * 70_000]))
                else:
                    self.both(lambda s: s.kget_many(e, keys + ["ctr"],
                                                    want_vsn=True))
            self.settle()
            if r == 2:
                # bulk writes on the top slots (keys take slots from the
                # top of the free list down): puts, a tombstone, RMW rows
                kind = np.full((2, self.js.n_ens), teng.OP_PUT, np.int32)
                kind[1, ::2] = teng.OP_RMW
                slot = np.zeros_like(kind)
                val = np.arange(1, kind.size + 1, dtype=np.int32).reshape(
                    kind.shape)
                val[0, 1] = 0
                exp_e = np.where(kind == teng.OP_RMW, teng.RMW_ADD,
                                 0).astype(np.int32)
                outs = [svc.execute(kind, slot, val, exp_e)
                        for svc in (self.js, self.ts)]
                for a, b in zip(*outs):
                    assert np.array_equal(np.asarray(a), b)
            for svc in (self.js, self.ts):
                svc.runtime.now += 0.25

    def check_futures(self):
        assert all(f.done for fl in self.futs for f in fl)
        assert [norm(f.value) for f in self.futs[1]] == \
            [norm(f.value) for f in self.futs[0]]

    def check_files(self):
        assert _tree(self.dirs[0]) == _tree(self.dirs[1])

    def crash(self):
        for svc in (self.js, self.ts):
            svc._wal.close()

    def restore(self, pkg, path, log=True):
        kw = dict(tick=None, max_ops_per_tick=self.k, **self.kw)
        if log:
            kw["data_dir"] = path
        if pkg == "jax":
            return self.jb.BatchedEnsembleService.restore(FixedClock(), path,
                                                          **kw)
        return tb.BatchedEnsembleService.restore(
            FixedClock(), path, device="cpu", **PORT_KW[self.arm], **kw)


def _tree(root):
    """Every file under ``root`` but the checkpoints: name -> bytes."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        if rel.split(os.sep)[0].startswith("ckpt."):
            continue
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as fh:
                out[os.path.join(rel, f)] = fh.read()
    return out


def assert_same_service(js, ts):
    """Every state plane, host mirror and host map of a JAX service and
    a port service equal."""
    tn = interop.state_to_numpy(ts.state)
    for f in tn._fields:
        assert np.array_equal(np.asarray(getattr(js.state, f)),
                              getattr(tn, f)), f
    for name in MIRRORS:
        assert np.array_equal(getattr(js, name), getattr(ts, name)), name
    for name in HOST:
        assert getattr(js, name) == getattr(ts, name), name


def _read_all(svc, keys_by_ens):
    futs = [svc.kget_many(e, keys, want_vsn=True)
            for e, keys in keys_by_ens.items()]
    while any(svc.queues):
        svc.flush()
    svc.flush()
    return [norm(f.value) for f in futs]


@pytest.mark.parametrize("arm,depth", [("default", 1), ("default", 2),
                                       ("plain", 1)])
def test_store_files_identical_and_restores_cross(jb, monkeypatch,
                                                  tmp_path, arm, depth):
    p = Durable(jb, monkeypatch, str(tmp_path), arm, depth=depth)
    p.run(seed=40 + depth)
    p.check_futures()
    p.check_files()
    assert p.ts._wal.count == p.js._wal.count > 0
    if arm == "default":
        assert p.ts.native_resolve_flushes > 0
    p.crash()
    # each package's dir restored by itself and by the other
    copies = {}
    for name, src in zip(("jax", "port"), p.dirs):
        for reader in ("jax", "port"):
            dst = str(tmp_path / f"{name}_by_{reader}")
            shutil.copytree(src, dst)
            copies[name, reader] = p.restore(reader, dst, log=False)
    for name in ("jax", "port"):
        assert_same_service(copies[name, "jax"], copies[name, "port"])
    assert_same_service(copies["jax", "jax"], copies["port", "port"])
    keys = {e: sorted(copies["port", "port"].key_slot[e], key=repr)
            for e in range(p.ts.n_ens)}
    assert any(keys.values())
    assert _read_all(copies["jax", "port"], keys) == \
        _read_all(copies["port", "jax"], keys)
    # the restored services keep logging: one more write, the same bytes
    js, ts = p.restore("jax", p.dirs[0]), p.restore("port", p.dirs[1])
    assert_same_service(js, ts)
    p.js, p.ts = js, ts
    p.both(lambda s: s.kput_many(0, ["after", 2 ** 70], [b"a", "b"]))
    p.settle()
    assert all(r[0] == "ok" for r in p.futs[1][-1].value)
    p.check_futures()
    p.check_files()


def _records(rng, n_lanes, e, k):
    """Random WAL lanes over [k, e] planes: str keys (some empty),
    bytes or None payloads, puts and RMW lanes, edge ints."""
    lane_j = rng.integers(0, k, n_lanes).astype(np.int32)
    lane_e = rng.integers(0, e, n_lanes).astype(np.int32)
    lane_slot = rng.choice([0, 1, 255, 256, 65535, 65536, 2 ** 31 - 1],
                           n_lanes).astype(np.int32)
    lane_f2 = rng.choice([0, 1, -1, 255, 2 ** 31 - 1, -2 ** 31],
                         n_lanes).astype(np.int32)
    lane_inl = (rng.random(n_lanes) < 0.3).astype(np.uint8)
    keys = [("k" * int(rng.integers(0, 300)))[:int(rng.integers(0, 300))]
            for _ in range(n_lanes)]
    pays = [None if (inl or rng.random() < 0.2) else
            bytes(rng.integers(0, 256, int(rng.choice([0, 5, 255, 256,
                                                       70_000 // 3])),
                               dtype=np.uint8))
            for inl in lane_inl]
    committed = rng.random((k, e)) < 0.7
    value = rng.integers(-2 ** 31, 2 ** 31, (k, e), dtype=np.int64).astype(
        np.int32)
    vsn = rng.integers(0, 2 ** 31, (k, e, 2), dtype=np.int64).astype(
        np.int32)
    return (lane_j, lane_e, lane_slot, lane_f2, lane_inl, keys, pays,
            committed, value, vsn)


def _arenas(keys, pays):
    n = len(keys)
    key_arena = "".join(keys).encode()
    key_len = np.fromiter(map(len, keys), np.int64, n)
    key_off = np.zeros((n,), np.int64)
    np.cumsum(key_len[:-1], out=key_off[1:])
    pay_len = np.fromiter((-1 if x is None else len(x) for x in pays),
                          np.int64, n)
    pay_off = np.zeros((n,), np.int64)
    np.cumsum(np.maximum(pay_len, 0)[:-1], out=pay_off[1:])
    pay_arena = b"".join(x for x in pays if x is not None)
    return key_off, key_len, key_arena, pay_off, pay_len, pay_arena


@pytest.mark.parametrize("seed", range(3))
def test_wal_encode_equals_protocol4_pickles(jb, seed):
    """The port's C++ encode: each committed lane's key and value bytes
    equal ``pickle.dumps(..., protocol=4)`` of the record the Python
    walk logs, uncommitted lanes are empty, and the arena equals the JAX
    package's pass byte for byte."""
    from riak_ensemble_tpu.parallel import resolve_native as jrn
    jnat = jrn.get()
    assert jnat is not None
    tnat = trn.get()
    rng = np.random.default_rng(seed)
    e, k = 5, 4
    (lj, le, ls, lf, li, keys, pays, committed, value,
     vsn) = _records(rng, 64, e, k)
    arenas = _arenas(keys, pays)
    args = (e, lj, le, ls, lf, li, np.zeros((64,), np.uint8), *arenas,
            committed, value, vsn)
    arena, idx = tnat.wal_encode(*args)
    j_arena, j_idx = jnat.wal_encode(*args)
    assert np.array_equal(idx, j_idx)
    assert bytes(arena) == bytes(j_arena)
    for i in range(64):
        j, c = int(lj[i]), int(le[i])
        if not committed[j, c]:
            assert not idx[i].any()
            continue
        f2 = int(value[j, c]) if li[i] else int(lf[i])
        rec_k = ("kv", c, int(ls[i]))
        rec_v = (keys[i], f2, int(vsn[j, c, 0]), int(vsn[j, c, 1]),
                 pays[i], bool(li[i]))
        ko, kl, vo, vl = idx[i].tolist()
        assert bytes(arena[ko:ko + kl]) == pickle.dumps(rec_k, protocol=4)
        assert bytes(arena[vo:vo + vl]) == pickle.dumps(rec_v, protocol=4)


def test_wal_encode_refuses_lanes_outside_planes():
    tnat = trn.get()
    lanes = [np.zeros((1,), np.int32)] * 4
    arenas = _arenas(["k"], [b"v"])
    with pytest.raises(ValueError):
        tnat.wal_encode(2, np.asarray([3], np.int32), *lanes[1:],
                        np.zeros((1,), np.uint8), np.zeros((1,), np.uint8),
                        *arenas, np.ones((2, 2), bool),
                        np.zeros((2, 2), np.int32),
                        np.zeros((2, 2, 2), np.int32))


def test_slot_recycled_to_new_key_across_crash(jb, monkeypatch, tmp_path):
    """``tests/test_wal.py:141``: a deleted key's slot recycles, a new
    key takes it, the process dies: the replay maps the slot to the new
    key only, in both packages."""
    p = Durable(jb, monkeypatch, str(tmp_path), "default", e=2, s=2, k=2)
    p.both(lambda s: [s.kput(0, "old", b"1"), s.kput(0, "keep", b"2")])
    p.settle()
    p.both(lambda s: s.kdelete(0, "old"))
    p.settle()
    assert "old" not in p.ts.key_slot[0]
    p.both(lambda s: s.kput(0, "new", b"3"))
    p.settle()
    p.check_futures()
    p.check_files()
    p.crash()
    js, ts = p.restore("jax", p.dirs[0]), p.restore("port", p.dirs[1])
    assert_same_service(js, ts)
    assert sorted(ts.key_slot[0]) == ["keep", "new"]
    got = _read_all(ts, {0: ["old", "keep", "new"]})
    assert [r[:2] for r in got[0]] == [("ok", "NOTFOUND"), ("ok", b"2"),
                                       ("ok", b"3")]
    assert _read_all(js, {0: ["old", "keep", "new"]}) == got
