"""Joint-consensus membership in the port against the JAX package (the
mirror of ``tests/test_engine_reconfig.py`` but its sharded case, and of
the ``update_members`` and watcher cases of ``tests/test_batched_host.py``
(``:237``, ``:346-458``, ``:783``) and ``tests/test_keyed_batch.py:175``).

- Engine: ``reconfig_propose`` / ``reconfig_transition`` /
  ``reconfig_step`` on the same seeded inputs as the JAX engine's give
  the same ``installed`` / ``collapsed`` and every state plane bit-equal
  (install then collapse with joint-quorum puts between, the commit gate,
  10,000-row churn, the views-list dance against a scalar model at
  V = 4, three stacked views, a full list's backpressure), and
  ``reconfig_step_plain`` equals ``reconfig_step``.
- Service (:class:`test_torch_runtime.Twin`: both services timer-driven
  on their own simulator runtime, same seed): ``update_members`` end to
  end, a blocked collapse that lands on a later call, a blocked install
  that retries after the re-election, a queued request, save / restore
  of the pipeline, and leader watchers (registration notify, elections,
  a membership deposition, a raising watcher, a watcher that unwatches
  itself mid-callback): equal ``changed`` vectors, futures, watcher
  event lists, state planes, mirrors and pipeline arrays.

Tolerance: exact equality everywhere.
"""

import numpy as np
import pytest
import torch

from riak_ensemble_tpu_torch import interop
from riak_ensemble_tpu_torch import runtime as trt
from riak_ensemble_tpu_torch.config import fast_test_config as t_config
from riak_ensemble_tpu_torch.ops import engine as teng
from riak_ensemble_tpu_torch.parallel import batched_host as tb
from riak_ensemble_tpu_torch.types import NOTFOUND as T_NOTFOUND
from test_torch_runtime import Twin
from test_torch_reference_natives import reference_natives  # noqa: F401 (autouse)


@pytest.fixture
def je():
    pytest.importorskip("jax")
    from riak_ensemble_tpu.ops import engine as je
    return je


class Engines:
    """The JAX engine's state and the port's (CPU) on the same calls."""

    def __init__(self, je, e, m, s=8, n_views=2, elect=True):
        import jax.numpy as jnp
        self.je, self.jnp = je, jnp
        self.js = je.init_state(e, m, s, n_views=n_views)
        self.ts = teng.init_state(e, m, s, n_views=n_views, device="cpu")
        self.e, self.m = e, m
        if elect:
            won = self.both("elect_step", np.ones((e,), bool),
                            np.zeros((e,), np.int32), np.ones((e, m), bool))
            assert won.all()

    def _args(self, args):
        jargs = [self.jnp.asarray(a) for a in args]
        targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
        return jargs, targs

    def both(self, fn, *args, keep=True):
        """``fn`` of both engines on the states and ``args``; every
        output equal; the states advance when ``keep``."""
        jargs, targs = self._args(args)
        jout = getattr(self.je, fn)(self.js, *jargs)
        tout = getattr(teng, fn)(self.ts, *targs)
        jst, jrest = jout[0], jout[1:]
        tst, trest = tout[0], tout[1:]
        for a, b in zip(jrest, trest):
            if hasattr(a, "_fields"):
                for f in a._fields:
                    assert np.array_equal(np.asarray(getattr(a, f)),
                                          getattr(b, f).numpy()), f
            else:
                assert np.array_equal(np.asarray(a), b.numpy())
        self.check(jst, tst)
        if keep:
            self.js, self.ts = jst, tst
        out = [b.numpy() if isinstance(b, torch.Tensor) else b
               for b in trest]
        return out[0] if len(out) == 1 else out

    def check(self, jst=None, tst=None):
        jst = self.js if jst is None else jst
        tn = interop.state_to_numpy(self.ts if tst is None else tst)
        for f in tn._fields:
            assert np.array_equal(np.asarray(getattr(jst, f)),
                                  getattr(tn, f)), f

    def view_mask(self):
        return self.ts.view_mask.numpy()


def _put(eg, up, val):
    e = eg.e
    return eg.both("kv_step", np.full((e,), teng.OP_PUT, np.int32),
                   np.zeros((e,), np.int32), np.full((e,), val, np.int32),
                   np.ones((e,), bool), up)


def test_install_then_collapse(je):
    e, m = 8, 5
    eg = Engines(je, e, m)
    up = np.ones((e, m), bool)
    nv = np.tile([True, True, True, False, False], (e, 1))
    inst, coll = eg.both("reconfig_step", np.ones((e,), bool), nv, up)
    assert inst.all() and not coll.any()
    vm = eg.view_mask()
    assert vm[:, 0, :3].all() and not vm[:, 0, 3:].any() and vm[:, 1].all()
    partial = np.tile([True, False, False, True, True], (e, 1))
    res = _put(eg, partial, 7)
    assert not res.committed.numpy().any()
    res = _put(eg, up, 7)
    assert res.committed.numpy().all()
    inst, coll = eg.both("reconfig_step", np.zeros((e,), bool), nv, up)
    assert coll.all() and not eg.view_mask()[:, 1].any()
    res = _put(eg, np.tile([True, True, True, False, False], (e, 1)), 7)
    assert res.committed.numpy().all()


def test_install_requires_commit_quorum(je):
    e, m = 4, 5
    eg = Engines(je, e, m)
    before = eg.view_mask().copy()
    nv = np.tile([True, True, True, False, False], (e, 1))
    minor = np.tile([True, True, False, False, False], (e, 1))
    inst, _ = eg.both("reconfig_step", np.ones((e,), bool), nv, minor)
    assert not inst.any()
    assert np.array_equal(eg.view_mask(), before)


def test_churn_cycle_at_scale(je):
    """10,000 rows through install → collapse cycles with one member
    rotated out each round, a joint-quorum write between."""
    e, m = 10_000, 5
    eg = Engines(je, e, m, s=4)
    rng = np.random.default_rng(0)
    up = np.ones((e, m), bool)
    full = np.ones((e, m), bool)
    for r in range(2):
        keep = np.ones((e, m), bool)
        keep[np.arange(e), rng.integers(0, m, e)] = False
        inst, _ = eg.both("reconfig_step", np.ones((e,), bool), keep, up)
        assert inst.all()
        assert _put(eg, up, r + 1).committed.numpy().all()
        _, coll = eg.both("reconfig_step", np.zeros((e,), bool), keep, up)
        assert coll.all()
        inst, _ = eg.both("reconfig_step", np.ones((e,), bool), full, up)
        assert inst.all()
        _, coll = eg.both("reconfig_step", np.zeros((e,), bool), full, up)
        assert coll.all()


@pytest.mark.parametrize("seed", range(4))
def test_views_dance_matches_jax_and_scalar_model(je, seed):
    """Seeded proposals with stale and fresh versions and transitions
    at V = 4 (``test_engine_reconfig.py``'s scalar views-list model):
    both engines equal each other and the model."""
    from test_engine_reconfig import ScalarViews
    rng = np.random.default_rng(seed)
    e, m, depth = 16, 5, 4
    eg = Engines(je, e, m, n_views=depth)
    up = np.ones((e, m), bool)
    models = [ScalarViews(m, depth) for _ in range(e)]
    for step in range(20):
        if rng.random() < 0.6:
            nv = np.zeros((e, m), bool)
            vsn = np.zeros((e,), np.int32)
            views = []
            for i in range(e):
                view = set(rng.choice(m, size=rng.integers(0, m + 1),
                                      replace=False).tolist())
                views.append(view)
                nv[i, list(view)] = True
                vsn[i] = models[i].pend_vsn + rng.integers(0, 2)
            inst = eg.both("reconfig_propose", np.ones((e,), bool), nv,
                           vsn, up)
            for i in range(e):
                assert inst[i] == models[i].propose(views[i], int(vsn[i]))
        else:
            coll = eg.both("reconfig_transition", np.ones((e,), bool), up)
            for i in range(e):
                assert coll[i] == models[i].transition()
        vm = eg.view_mask()
        for i in range(e):
            got = [set(np.nonzero(vm[i, v])[0].tolist())
                   for v in range(depth)]
            mdl = models[i]
            assert got == [set(v) for v in mdl.views] + \
                [set()] * (depth - len(mdl.views))
            assert int(eg.ts.commit_vsn[i]) == mdl.commit_vsn


def test_deep_views_quorum_spans_every_view(je):
    e, m = 4, 7
    eg = Engines(je, e, m, n_views=4)
    up = np.ones((e, m), bool)
    for view in ([2, 3, 4], [0, 1, 2]):
        nv = np.zeros((e, m), bool)
        nv[:, view] = True
        inst = eg.both("reconfig_propose", np.ones((e,), bool), nv,
                       eg.ts.pend_vsn.numpy() + 1, up)
        assert inst.all()
    p = np.tile([1, 1, 1, 0, 0, 1, 1], (e, 1)).astype(bool)
    assert not _put(eg, p, 5).committed.numpy().any()
    q = np.tile([1, 1, 1, 1, 1, 0, 0], (e, 1)).astype(bool)
    assert _put(eg, q, 5).committed.numpy().all()
    assert eg.both("reconfig_transition", np.ones((e,), bool), up).all()
    vm = eg.view_mask()
    assert vm[:, 0, :3].all() and not vm[:, 1:].any()


def test_full_views_list_backpressures(je):
    e, m = 2, 5
    eg = Engines(je, e, m)
    up = np.ones((e, m), bool)
    nv = np.tile([1, 1, 1, 0, 0], (e, 1)).astype(bool)

    def propose():
        return eg.both("reconfig_propose", np.ones((e,), bool), nv,
                       eg.ts.pend_vsn.numpy() + 1, up)
    assert propose().all()
    assert not propose().any()          # the list is full: nack
    assert eg.both("reconfig_transition", np.ones((e,), bool), up).all()
    assert propose().all()              # the slot freed


@pytest.mark.parametrize("seed", range(2))
def test_reconfig_step_plain_equals_reconfig_step(seed):
    """The plain twin (K1's plain version, new tensors) and the step
    agree on every output and plane over seeded proposals, partial up
    masks and joint views."""
    rng = np.random.default_rng(seed)
    e, m = 64, 5
    st = teng.init_state(e, m, 8, device="cpu")
    st, _ = teng.elect_step(st, torch.ones(e, dtype=torch.bool),
                            torch.zeros(e, dtype=torch.int32),
                            torch.ones((e, m), dtype=torch.bool))
    for _ in range(8):
        prop = torch.from_numpy(rng.random(e) < 0.5)
        nv = torch.from_numpy(rng.random((e, m)) < 0.7)
        up = torch.from_numpy(rng.random((e, m)) < 0.85)
        a = teng.reconfig_step_plain(st, prop, nv, up)
        st, inst, coll = teng.reconfig_step(st, prop, nv, up)
        assert torch.equal(a[1], inst) and torch.equal(a[2], coll)
        for x, y in zip(a[0], st):
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# The service: update_members and leader watchers


def _put_all(tw, n, key="k"):
    for e in range(n):
        assert tw.op(lambda s, e=e: s.kput(e, key, b"v-%d" % e))[0] == "ok"


def test_service_update_members_end_to_end(monkeypatch):
    tw = Twin(monkeypatch, 8, 5, 8)
    _put_all(tw, 8)
    leader0 = tw.ts.leader_np.copy()
    assert (leader0 >= 0).all()
    nv = np.ones((8, 5), bool)
    nv[np.arange(8), leader0] = False
    changed = tw.same(lambda s: s.update_members(np.ones(8, bool), nv))
    assert changed.all() and (tw.ts.member_np == nv).all()
    assert (tw.ts.leader_np == -1).all()
    for e in range(8):
        assert tw.op(lambda s, e=e: s.kget(e, "k")) == ("ok", b"v-%d" % e)
    assert (tw.ts.leader_np >= 0).all()
    full = np.ones((8, 5), bool)
    assert tw.same(lambda s: s.update_members(np.ones(8, bool),
                                              full)).all()
    assert tw.op(lambda s: s.kput(3, "k2", b"x"))[0] == "ok"
    tw.stop()
    tw.check()


def test_service_update_members_blocked_collapse_lands_later(monkeypatch):
    tw = Twin(monkeypatch, 1, 5, 4)
    assert tw.op(lambda s: s.kput(0, "k", b"v"))[0] == "ok"
    assert int(tw.ts.leader_np[0]) == 0
    for p in (1, 2):
        tw.call(lambda s, p=p: s.set_peer_up(0, p, False))
    nv = np.zeros((1, 5), bool)
    nv[0, :3] = True
    assert not tw.same(lambda s: s.update_members(np.ones(1, bool),
                                                  nv)).any()
    assert tw.ts._pending_mask[0] and tw.ts.member_np[0].all()
    for p in (1, 2):
        tw.call(lambda s, p=p: s.set_peer_up(0, p, True))
    assert tw.same(lambda s: s.update_members(np.zeros(1, bool),
                                              nv)).all()
    assert (tw.ts.member_np[0] == nv[0]).all()
    assert tw.op(lambda s: s.kget(0, "k")) == ("ok", b"v")
    tw.stop()
    tw.check()


def test_service_update_members_blocked_install_retries(monkeypatch):
    tw = Twin(monkeypatch, 1, 5, 4)
    assert tw.op(lambda s: s.kput(0, "k", b"v"))[0] == "ok"
    lead = int(tw.ts.leader_np[0])
    tw.call(lambda s: s.set_peer_up(0, lead, False))
    nv = np.zeros((1, 5), bool)
    nv[0, 1:4] = True
    assert not tw.same(lambda s: s.update_members(np.ones(1, bool),
                                                  nv)).any()
    assert tw.ts._desired_mask[0] and not tw.ts._pending_mask[0]
    assert tw.op(lambda s: s.kget(0, "k")) == ("ok", b"v")
    assert tw.same(lambda s: s.update_members(np.zeros(1, bool),
                                              nv)).all()
    assert (tw.ts.member_np[0] == nv[0]).all()
    tw.stop()
    tw.check()


def test_service_update_members_queued_request_not_dropped(monkeypatch):
    tw = Twin(monkeypatch, 1, 5, 4)
    assert tw.op(lambda s: s.kput(0, "k", b"v"))[0] == "ok"
    for p in (1, 2):
        tw.call(lambda s, p=p: s.set_peer_up(0, p, False))
    view_a = np.zeros((1, 5), bool)
    view_a[0, :3] = True
    view_b = np.zeros((1, 5), bool)
    view_b[0, [0, 3, 4]] = True
    one = np.ones(1, bool)
    assert not tw.same(lambda s: s.update_members(one, view_a)).any()
    assert not tw.same(lambda s: s.update_members(one, view_b)).any()
    assert tw.ts._queued_mask[0]
    for p in (1, 2):
        tw.call(lambda s, p=p: s.set_peer_up(0, p, True))
    assert tw.same(lambda s: s.update_members(~one, view_a)).all()
    assert (tw.ts.member_np[0] == view_a[0]).all()
    assert tw.same(lambda s: s.update_members(~one, view_a)).all()
    assert (tw.ts.member_np[0] == view_b[0]).all()
    assert tw.op(lambda s: s.kget(0, "k")) == ("ok", b"v")
    tw.stop()
    tw.check()


def test_service_save_restore_keeps_membership(monkeypatch, tmp_path):
    """``test_batched_host.py:396`` on the port: a service with a
    changed membership and a joint (pending) change saves and restores
    with its pipeline; the restored service serves as the original.
    (Checkpoints do not cross packages; the JAX run is the oracle of
    the observable results.)"""
    tw = Twin(monkeypatch, 4, 5, 4)
    for e in range(4):
        assert tw.op(lambda s, e=e: s.kput(e, "k", b"v%d" % e))[0] == "ok"
    assert tw.op(lambda s: s.kdelete(3, "k"))[0] == "ok"
    nv = np.ones((4, 5), bool)
    nv[:, 4] = False
    assert tw.same(lambda s: s.update_members(np.ones(4, bool), nv)).all()
    tw.call(lambda s: s.set_peer_up(1, 1, False))
    tw.call(lambda s: s.set_peer_up(1, 2, False))
    nv1 = np.zeros((4, 5), bool)
    nv1[1, :3] = True
    sel = np.zeros(4, bool)
    sel[1] = True
    assert not tw.same(lambda s: s.update_members(sel, nv1)).any()
    tw.ts.save(str(tmp_path / "ckpt"))
    tw.stop()
    rt2 = trt.Runtime(seed=99)
    back = tb.BatchedEnsembleService.restore(
        rt2, str(tmp_path / "ckpt"), tick=0.005, config=t_config(),
        device="cpu")
    assert (back.lease_until == 0).all()
    for name in ("member_np", "_pending_mask", "_pending_view_np",
                 "_desired_mask", "_queued_mask", "up"):
        assert np.array_equal(getattr(back, name), getattr(tw.ts, name))
    assert torch.equal(back.state.view_mask, tw.ts.state.view_mask)
    for e in (0, 2):
        assert rt2.await_future(back.kget(e, "k"), 5) == ("ok", b"v%d" % e)
    assert rt2.await_future(back.kget(3, "k"), 5) == ("ok", T_NOTFOUND)
    # row 1 is joint with its new view's quorum down: it serves again
    # once the peers are back
    assert rt2.await_future(back.kget(1, "k"), 5) == "failed"
    for p in (1, 2):
        back.set_peer_up(1, p, True)
    assert rt2.await_future(back.kget(1, "k"), 5) == ("ok", b"v1")
    assert rt2.await_future(back.kput(1, "k", b"post"), 5)[0] == "ok"
    assert back.update_members(np.zeros(4, bool), nv1)[1]
    assert (back.member_np[1] == nv1[1]).all()
    back.stop()


def test_service_leader_watchers(monkeypatch):
    """``test_batched_host.py:783``: registration notifies the current
    status, an election and a re-election fire, a membership change that
    drops the leader deposes it (-1), a raising watcher is contained
    (counted), and unwatch stops the events — the same event lists as
    the JAX service's."""
    tw = Twin(monkeypatch, 2, 3, 16)
    events = ([], [])
    hostile = [0, 0]

    def boom(i):
        hostile[i] += 1
        raise ZeroDivisionError("hostile watcher")
    for i, (svc, ev) in enumerate(zip(tw.svcs, events)):
        svc.watch_leader(0, lambda e, o, n, ev=ev: ev.append((e, o, n)))
        svc.watch_leader(0, lambda e, o, n, i=i: boom(i))
    assert events[1] == [(0, -1, -1)]
    assert tw.op(lambda s: s.kput(0, "k", b"v"))[0] == "ok"
    assert events[1][1] == (0, -1, int(tw.ts.leader_np[0]))
    old = int(tw.ts.leader_np[0])
    tw.call(lambda s: s.set_peer_up(0, old, False))
    assert tw.op(lambda s: s.kget(0, "k")) == ("ok", b"v")
    assert events[1][-1][1] == old != events[1][-1][2]
    tw.call(lambda s: s.set_peer_up(0, old, True))
    assert tw.op(lambda s: s.kput(0, "k", b"v2"))[0] == "ok"
    n = len(events[1])
    nv = np.ones((2, 3), bool)
    nv[0, int(tw.ts.leader_np[0])] = False
    sel = np.array([True, False])
    assert tw.same(lambda s: s.update_members(sel, nv))[0]
    assert any(ev[2] == -1 for ev in events[1][n:])
    assert all(ev[0] == 0 for ev in events[1])
    fns = [svc._leader_watchers[0][0] for svc in tw.svcs]
    assert tw.same(lambda s: s.unwatch_leader(0, fns[tw.svcs.index(s)]))
    assert not tw.ts.unwatch_leader(0, fns[1])
    n2 = len(events[1])
    assert tw.op(lambda s: s.kget(0, "k"))[0] == "ok"
    assert len(events[1]) == n2
    assert events[1] == events[0]
    assert tw.ts.watcher_errors == hostile[1] == hostile[0] > len(events[1])
    tw.stop()
    tw.check()


def test_watcher_unwatches_itself_mid_callback(monkeypatch):
    """``test_keyed_batch.py:175``: a one-shot watcher that deregisters
    inside its callback does not skip its sibling."""
    tw = Twin(monkeypatch, 1, 3, 32)
    events = ([], [])
    shots = []
    for svc, ev in zip(tw.svcs, events):
        def one_shot(e, old, new, svc=svc, ev=ev):
            if old == new:
                return
            svc.unwatch_leader(0, one_shot)
            ev.append(("one", old, new))
        shots.append(one_shot)
        svc.watch_leader(0, one_shot)
        svc.watch_leader(0, lambda e, o, n, ev=ev: ev.append(("two", o, n)))
    assert tw.op(lambda s: s.kput(0, "k", b"v"))[0] == "ok"
    lead = int(tw.ts.leader_np[0])
    assert ("one", -1, lead) in events[1] and ("two", -1, lead) in events[1]
    assert shots[1] not in tw.ts._leader_watchers[0]
    assert tw.ts._leader_watchers[0] != []
    assert events[1] == events[0]
    tw.stop()


@pytest.mark.cuda
def test_reconfig_step_on_card_matches_plain():
    """On the card, ``reconfig_step`` (K1 for both gates, the planes
    stepped in place) equals ``reconfig_step_plain`` on seeded proposals
    and up masks, and launches K1 twice per step."""
    if not torch.cuda.is_available():
        pytest.skip("K1 is a CUDA kernel: no CUDA device is visible")
    from riak_ensemble_tpu_torch.ops import cuda_quorum
    rng = np.random.default_rng(3)
    e, m = 4096, 5
    dev = torch.device("cuda")
    st = teng.init_state(e, m, 16, device=dev)
    st, _ = teng.elect_step(st, torch.ones(e, dtype=torch.bool, device=dev),
                            torch.zeros(e, dtype=torch.int32, device=dev),
                            torch.ones((e, m), dtype=torch.bool, device=dev))
    for _ in range(4):
        prop, nv, up = (torch.from_numpy(x).to(dev) for x in (
            rng.random(e) < 0.5, rng.random((e, m)) < 0.7,
            rng.random((e, m)) < 0.85))
        want = teng.reconfig_step_plain(
            teng.EngineState(*(t.clone() for t in st)), prop, nv, up)
        before = cuda_quorum.quorum_launches
        st, inst, coll = teng.reconfig_step(st, prop, nv, up)
        assert cuda_quorum.quorum_launches - before == 2
        assert torch.equal(want[1], inst) and torch.equal(want[2], coll)
        for x, y in zip(want[0], st):
            assert torch.equal(x, y)
