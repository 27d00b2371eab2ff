"""Dynamic rows in the port against the JAX package (the mirror of the
non-``svcnode`` cases of ``tests/test_lifecycle.py`` (``:36-151``,
``:241``) and of ``tests/test_keyed_batch.py:201-273``).

Both services run timer-driven on their own package's simulator runtime
with the same seed (:class:`test_torch_runtime.Twin`), with
``dynamic=True``:

- create / serve / destroy, a recycled row that serves fresh state with a
  monotone ballot epoch, capacity backpressure, lifecycle under load
  (queued ops of a destroyed row fail, a membership change on a live
  row), batch CAS and batch delete with their recycling, and every
  keyed entry point failing on a destroyed row, on the default, oracle
  and plain host arms;
- durability: each package writes its own data dir for the same
  create / put / destroy / recreate / ``update_members`` sequence (batch
  CAS and delete included), and the two dirs' WAL files are
  byte-identical; each package restores its own dir and the other's,
  all four restores equal in every state plane, mirror and the name
  directory, and each takes a create and a write; a restore with the
  wrong ``dynamic`` flag raises.

Futures, states, mirrors and maps are compared exactly.
"""

import numpy as np
import pytest

from riak_ensemble_tpu_torch import funref as tfunref
from riak_ensemble_tpu_torch import interop
from riak_ensemble_tpu_torch import runtime as trt
from riak_ensemble_tpu_torch.config import fast_test_config as t_config
from riak_ensemble_tpu_torch.parallel import batched_host as tb
from test_torch_compaction import norm
from test_torch_native_enqueue import PORT_KW
from test_torch_runtime import MIRRORS, HOST, Twin
from test_torch_wal import _tree
from test_torch_reference_natives import reference_natives  # noqa: F401 (autouse)

ARMS = ["default", "oracle", "plain"]


def dyn(monkeypatch, e=4, m=3, s=4, arm="default", **kw):
    return Twin(monkeypatch, e, m, s, arm=arm, seed=31, dynamic=True, **kw)


@pytest.mark.parametrize("arm", ARMS)
def test_create_serve_destroy_roundtrip(monkeypatch, arm):
    tw = dyn(monkeypatch, arm=arm)
    assert tw.op(lambda s: s.kput(0, "k", b"v")) == "failed"
    assert tw.op(lambda s: s.kget(0, "k")) == "failed"
    e = tw.same(lambda s: s.create_ensemble("orders"))
    assert e is not None and tw.same(lambda s: s.resolve_ensemble(
        "orders")) == e
    assert tw.op(lambda s: s.kput(e, "k", b"v"))[0] == "ok"
    assert tw.op(lambda s: s.kget(e, "k")) == ("ok", b"v")
    assert tw.same(lambda s: s.destroy_ensemble("orders"))
    assert tw.same(lambda s: s.resolve_ensemble("orders")) is None
    assert tw.op(lambda s: s.kget(e, "k")) == "failed"
    assert not tw.same(lambda s: s.destroy_ensemble("orders"))
    tw.stop()
    tw.check()


def test_recycled_row_serves_fresh_state(monkeypatch):
    tw = dyn(monkeypatch, e=1)
    e = tw.same(lambda s: s.create_ensemble("a"))
    assert tw.op(lambda s: s.kput(e, "k", b"old"))[0] == "ok"
    epoch_before = int(tw.ts.state.epoch[e].max())
    assert tw.same(lambda s: s.destroy_ensemble("a"))
    assert tw.same(lambda s: s.create_ensemble("b")) == e
    assert tw.op(lambda s: s.kget(e, "k"))[0] == "ok"
    assert norm(tw.op(lambda s: s.kget(e, "k"))) == ("ok", "NOTFOUND")
    assert tw.op(lambda s: s.kput(e, "k", b"new"))[0] == "ok"
    assert tw.op(lambda s: s.kget(e, "k")) == ("ok", b"new")
    assert int(tw.ts.state.epoch[e].max()) > epoch_before
    assert len(tw.ts.values) == 1
    tw.stop()
    tw.check()


def test_capacity_backpressure_and_refill(monkeypatch):
    tw = dyn(monkeypatch, e=2)
    assert tw.same(lambda s: s.create_ensemble("a")) is not None
    assert tw.same(lambda s: s.create_ensemble("b")) is not None
    assert tw.same(lambda s: s.create_ensemble("c")) is None
    assert tw.same(lambda s: s.create_ensemble("a")) is None
    assert tw.same(lambda s: s.destroy_ensemble("a"))
    assert tw.same(lambda s: s.create_ensemble("c")) is not None
    tw.stop()
    tw.check()


@pytest.mark.parametrize("arm", ARMS)
def test_create_destroy_under_load(monkeypatch, arm):
    tw = dyn(monkeypatch, e=8, s=8, arm=arm)
    rows = {n: tw.same(lambda s, n=n: s.create_ensemble(n))
            for n in ("a", "b", "c")}
    futs = [tw.call(lambda s, n=n, i=i: s.kput(
        rows[n], f"k{i}", b"%s%d" % (n.encode(), i)))
        for n in rows for i in range(4)]
    for pair in futs:
        assert tw.settle(pair)[0] == "ok"
    add = tfunref.ref("rmw:add", 1)
    doomed = [tw.call(lambda s, i=i: s.kput(rows["b"], f"d{i}", b"x"))
              for i in range(3)]
    doomed.append(tw.call(lambda s: s.kmodify(rows["b"], "ctr", add, 0)))
    assert tw.same(lambda s: s.destroy_ensemble("b"))
    for pair in doomed:
        assert all(f.done and f.value == "failed" for f in pair)
    rows["d"] = tw.same(lambda s: s.create_ensemble("d"))
    assert rows["d"] == rows["b"]
    for n in ("a", "c"):
        for i in range(4):
            assert tw.op(lambda s, n=n, i=i: s.kget(rows[n], f"k{i}")) == \
                ("ok", b"%s%d" % (n.encode(), i))
    assert norm(tw.op(lambda s: s.kget(rows["d"], "k0"))) == \
        ("ok", "NOTFOUND")
    assert tw.op(lambda s: s.kput(rows["d"], "k0", b"d0"))[0] == "ok"
    nv = np.ones((8, 3), bool)
    nv[:, 2] = False
    sel = np.zeros(8, bool)
    sel[rows["a"]] = True
    sel[7] = True                       # a free row: no membership
    changed = tw.same(lambda s: s.update_members(sel, nv))
    assert changed[rows["a"]] and not changed[7]
    assert tw.op(lambda s: s.kget(rows["a"], "k1")) == ("ok", b"a1")
    tw.stop()
    tw.check()


@pytest.mark.parametrize("arm", ARMS)
def test_batch_cas_delete_and_dead_rows(monkeypatch, arm):
    """``test_keyed_batch.py:201-273``: batch CAS (fresh, stale and
    create-if-missing versions; no payload leaks), batch delete and its
    slot recycling, then every keyed entry point on a destroyed row
    fails at once."""
    tw = dyn(monkeypatch, e=2, s=3, arm=arm)
    e = tw.same(lambda s: s.create_ensemble("x"))
    put = tw.op(lambda s: s.kput_many(e, ["a", "b"], [b"1", b"2"]))
    vsn_a = tuple(put[0][1])
    res = tw.op(lambda s: s.kupdate_many(
        e, ["a", "b", "c"], [vsn_a, (9, 9), (0, 0)], [b"a2", b"b2", b"c1"]))
    assert res[0][0] == "ok" and res[1] == "failed" and res[2][0] == "ok"
    assert tw.op(lambda s: s.kget_many(e, ["a", "b", "c"])) == \
        [("ok", b"a2"), ("ok", b"2"), ("ok", b"c1")]
    assert len(tw.ts.values) == 3
    res = tw.op(lambda s: s.kdelete_many(e, ["a", "c", "nope"]))
    assert res[0][0] == "ok" and res[1][0] == "ok"
    assert res[2] == ("ok", "NOTFOUND")
    assert tw.op(lambda s: s.kget_many(e, ["a", "b", "c"])) == \
        [("ok", "NOTFOUND"), ("ok", b"2"), ("ok", "NOTFOUND")]
    assert all(r[0] == "ok" for r in tw.op(
        lambda s: s.kput_many(e, ["x", "y"], [b"8", b"9"])))
    assert len(tw.ts.values) == 3
    assert tw.same(lambda s: s.destroy_ensemble("x"))
    add = tfunref.ref("rmw:add", 1)
    dead = [lambda s: s.kput_many(e, ["k"], [b"v"]),
            lambda s: s.kget_many(e, ["k"]),
            lambda s: s.kupdate_many(e, ["k"], [(0, 0)], [b"v"]),
            lambda s: s.kdelete_many(e, ["k"]),
            lambda s: s.kmodify_many(e, ["k"], add, 0),
            lambda s: s.kput(e, "k", b"v"), lambda s: s.kget(e, "k"),
            lambda s: s.kget_vsn(e, "k"), lambda s: s.kdelete(e, "k"),
            lambda s: s.kupdate(e, "k", (0, 0), b"v"),
            lambda s: s.ksafe_delete(e, "k", (1, 1)),
            lambda s: s.kmodify(e, "k", add, 0)]
    for fn in dead:
        pair = tw.call(fn)
        assert all(f.done for f in pair)
        assert norm(pair[1].value) == norm(pair[0].value)
        assert pair[1].value in ("failed", ["failed"])
    assert not tw.ts._active
    tw.stop()
    tw.check()


def _planes(svc):
    """A service's state planes, mirrors and host maps as numpy / plain
    values, whichever package it comes from."""
    st = svc.state
    if hasattr(st.epoch, "numpy") and not hasattr(st.epoch, "devices"):
        st = interop.state_to_numpy(st)
    out = {f: np.asarray(getattr(st, f)) for f in st._fields}
    out.update({n: np.asarray(getattr(svc, n)) for n in MIRRORS})
    out.update({n: getattr(svc, n) for n in HOST})
    return out


def _durable_script(tw):
    """The lifecycle sequence both packages log: creates, writes, a
    destroy, a recreate on the recycled row, batch CAS and delete, and a
    membership change."""
    a = tw.same(lambda s: s.create_ensemble("a"))
    b = tw.same(lambda s: s.create_ensemble(
        "b", np.array([True, True, False])))
    assert tw.op(lambda s: s.kput(a, "k", b"va"))[0] == "ok"
    assert tw.op(lambda s: s.kput_many(b, ["k", "j"], [b"vb", b"j"]))[0][0] \
        == "ok"
    assert tw.same(lambda s: s.destroy_ensemble("b"))
    c = tw.same(lambda s: s.create_ensemble("c"))
    assert c == b
    put = tw.op(lambda s: s.kput_many(c, ["k", "m"], [b"vc", b"m"]))
    up = tw.op(lambda s: s.kupdate_many(c, ["k"], [tuple(put[0][1])],
                                        [b"vc2"]))
    assert up[0][0] == "ok"
    assert tw.op(lambda s: s.kdelete_many(c, ["m"]))[0][0] == "ok"
    nv = np.ones((4, 3), bool)
    nv[:, 0] = False
    sel = np.zeros(4, bool)
    sel[a] = True
    assert tw.same(lambda s: s.update_members(sel, nv))[a]
    assert tw.op(lambda s: s.kput(a, "k2", b"va2"))[0] == "ok"
    return a, c


@pytest.mark.parametrize("arm", ["default", "plain"])
def test_lifecycle_survives_crash_across_packages(monkeypatch, tmp_path,
                                                  arm):
    """``test_lifecycle.py:122`` on both packages' data dirs: the WAL
    files are byte-identical, and every package restores every dir to
    the same service (the directory, the live tenants' data, the
    destroyed tenant's absence, the changed membership)."""
    dirs = (str(tmp_path / "jax"), str(tmp_path / "port"))
    tw = dyn(monkeypatch, arm=arm, data_dirs=dirs)
    store = type(tw.js._wal._store).__name__
    assert store == ("NativeBackend" if arm == "default" else "PyLogStore")
    assert type(tw.ts._wal._store).__name__ == store
    a, c = _durable_script(tw)
    tw.stop()
    for svc in tw.svcs:
        svc._wal.close()
    assert _tree(dirs[0]) == _tree(dirs[1])
    with pytest.raises(ValueError, match="dynamic"):
        tb.BatchedEnsembleService.restore(
            trt.Runtime(seed=32), dirs[1], tick=None, device="cpu",
            dynamic=False, **PORT_KW[arm])
    backs = {}
    for reader in ("jax", "port"):
        for src in (0, 1):
            if reader == "jax":
                backs[reader, src] = tw.jb.BatchedEnsembleService.restore(
                    tw.jrt.Runtime(seed=32), dirs[src], tick=0.005,
                    config=tw.j_config(), dynamic=True)
            else:
                backs[reader, src] = tb.BatchedEnsembleService.restore(
                    trt.Runtime(seed=32), dirs[src], tick=0.005,
                    config=t_config(), device="cpu", **PORT_KW[arm])
    ref = _planes(backs["jax", 0])
    for key, svc in backs.items():
        assert svc.dynamic
        assert svc.resolve_ensemble("a") == a
        assert svc.resolve_ensemble("b") is None
        assert svc.resolve_ensemble("c") == c
        got = _planes(svc)
        for name in ref:
            assert np.array_equal(got[name], ref[name]) if isinstance(
                ref[name], np.ndarray) else got[name] == ref[name], \
                (key, name)
    for key, svc in backs.items():
        rt = svc.runtime
        assert rt.await_future(svc.kget(a, "k"), 5) == ("ok", b"va")
        assert rt.await_future(svc.kget(c, "k"), 5) == ("ok", b"vc2")
        assert norm(rt.await_future(svc.kget(c, "m"), 5)) == \
            ("ok", "NOTFOUND")
        assert norm(rt.await_future(svc.kget(c, "j"), 5)) == \
            ("ok", "NOTFOUND")
        assert (svc.member_np[a] == [False, True, True]).all()
        assert svc.create_ensemble("d") is not None
        assert rt.await_future(svc.kput(c, "post", b"p"), 5)[0] == "ok"
        svc.stop()


def test_restore_dynamic_flag_mismatch_fails_loudly(monkeypatch, tmp_path):
    """``test_lifecycle.py:241``: a static data dir restored with
    ``dynamic=True`` raises in both packages; without the flag it
    restores static and serves."""
    dirs = (str(tmp_path / "jax"), str(tmp_path / "port"))
    tw = Twin(monkeypatch, 2, 3, 4, seed=33, data_dirs=dirs)
    assert tw.op(lambda s: s.kput(0, "k", b"v"))[0] == "ok"
    tw.stop()
    for svc in tw.svcs:
        svc._wal.close()
    assert _tree(dirs[0]) == _tree(dirs[1])
    with pytest.raises(ValueError):
        tw.jb.BatchedEnsembleService.restore(
            tw.jrt.Runtime(seed=34), dirs[0], tick=0.005,
            config=tw.j_config(), dynamic=True)
    with pytest.raises(ValueError):
        tb.BatchedEnsembleService.restore(
            trt.Runtime(seed=34), dirs[1], tick=0.005, config=t_config(),
            device="cpu", dynamic=True)
    for src in dirs:
        rt2 = trt.Runtime(seed=34)
        svc2 = tb.BatchedEnsembleService.restore(
            rt2, src, tick=0.005, config=t_config(), device="cpu",
            data_dir=src)
        assert not svc2.dynamic
        assert rt2.await_future(svc2.kget(0, "k"), 5) == ("ok", b"v")
        svc2.stop()
        svc2._wal.close()


def test_dynamic_mirrors_match_after_restore(monkeypatch, tmp_path):
    """The restored lifecycle mirrors: the name directory, the live rows,
    and the free pool rebuilt in the reference's (descending) order,
    which differs from the running service's pop-and-append order."""
    dirs = (str(tmp_path / "jax"), str(tmp_path / "port"))
    tw = dyn(monkeypatch, e=6, data_dirs=dirs)
    rows = [tw.same(lambda s, n=n: s.create_ensemble(n)) for n in "pqrs"]
    for n in "qs":
        assert tw.same(lambda s, n=n: s.destroy_ensemble(n))
    assert tw.ts._free_rows == tw.js._free_rows == [5, 4, 1, 3]
    tw.stop()
    for svc in tw.svcs:
        svc._wal.close()
    back = tb.BatchedEnsembleService.restore(
        trt.Runtime(seed=1), dirs[0], tick=None, device="cpu")
    ref = tw.jb.BatchedEnsembleService.restore(
        tw.jrt.Runtime(seed=1), dirs[1], tick=None)
    assert back._free_rows == ref._free_rows == [5, 4, 3, 1]
    assert back._ens_names == ref._ens_names == {"p": rows[0],
                                                  "r": rows[2]}
    assert np.array_equal(back._live, tw.ts._live)
    assert np.array_equal(ref._live, tw.ts._live)
