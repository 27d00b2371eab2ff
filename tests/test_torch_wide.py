"""Wide rounds in the port (``ops/schedule.py``, the wide steps of
``ops/engine.py`` and the service's ``wide=True``) against the JAX
package on the CPU — the mirror of ``tests/test_engine_wide.py`` and
``tests/test_wide_service.py``:

- ``schedule_wide`` plans (every plane, the routing maps, ``flat_order``,
  the ``max_groups`` / ``max_width`` gates) equal the reference's on
  seeded planes with duplicate chains; ``validate_wide_plane`` raises on
  the same planes with the same message and passes every scheduled plan;
- ``kv_step_scan_wide`` / ``full_step_wide`` / ``full_step_wide_sliced``
  and their ``_plain`` twins equal JAX's on every state plane, ``won`` and
  every result lane (NOOP and pad lanes included), on damaged trees
  where a wide round's lanes verify against the tree as it stood before
  the round;
- ``_set_lanes`` is exact when masked-off lanes aim at a live lane's slot,
  in either lane order;
- the service with ``wide=True`` against the JAX service under
  ``RETPU_WIDE=1`` on both host arms, at depths 1 and 2, compacted and
  not: seeded keyed streams (futures, packed buffers, state, mirrors,
  counters), the scalar-match workload, a duplicate chain, a bulk
  ``execute``, the G <= 2 gate, the warm-up's wide buckets and a dynamic
  row's lifecycle — each asserting ``wide_launches > 0`` in both packages.

F1's wide mode itself runs only on a card: the ``cuda`` cases here and in
``test_torch_engine_step.py``, and ``chip_smoke.py`` phase 11(a); its
algorithm is held on the CPU by ``test_torch_f1_wide_design.py``.
Tolerance: exact equality everywhere.
"""

import numpy as np
import pytest
import torch

from riak_ensemble_tpu_torch import interop
from riak_ensemble_tpu_torch.ops import engine as teng
from riak_ensemble_tpu_torch.ops import schedule as tsch
from riak_ensemble_tpu_torch.parallel import batched_host as tb
from test_torch_compaction import norm
from test_torch_kmodify import FixedClock, _record_packed
from test_torch_native_enqueue import PORT_KW, Pair, _jax_env
from test_torch_reference_natives import reference_natives  # noqa: F401 (autouse)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from riak_ensemble_tpu.ops import engine as jeng  # noqa: E402
from riak_ensemble_tpu.ops import schedule as jsch  # noqa: E402
from riak_ensemble_tpu.parallel import batched_host as jb  # noqa: E402

KINDS = (teng.OP_NOOP, teng.OP_GET, teng.OP_PUT, teng.OP_CAS, teng.OP_RMW)


def _random_planes(rng, k, e, s, p_dup=0.5):
    """Mixed [K, E] planes with duplicate chains, invalid slots (below 0
    and past S) and RMW fun codes."""
    kind = rng.choice(KINDS, (k, e), p=[.15, .3, .3, .1, .15]).astype(
        np.int32)
    slot = rng.integers(0, s, (k, e)).astype(np.int32)
    for i in range(1, k):
        reuse = rng.random(e) < p_dup
        slot[i, reuse] = slot[i - 1, reuse]
    slot[rng.random((k, e)) < 0.05] = -1
    slot[rng.random((k, e)) < 0.03] = s + 2
    val = rng.integers(1, 1 << 20, (k, e)).astype(np.int32)
    lease = rng.random((k, e)) < 0.5
    xe = rng.integers(0, 3, (k, e)).astype(np.int32)
    rmw = kind == teng.OP_RMW
    xe[rmw] = rng.integers(0, 9, int(rmw.sum()))
    xs = rng.integers(0, 3, (k, e)).astype(np.int32)
    return kind, slot, val, lease, xe, xs


def _filled_state(rng, e, m, s, up):
    """An elected JAX state with objects on most slots, then damage the
    wide rounds must see as the pre-round tree: upper nodes (shared by
    many slots' paths), a leaf and an object."""
    js = jeng.init_state(e, m, s)
    js, _ = jeng.elect_step(js, jnp.ones((e,), bool),
                            jnp.zeros((e,), jnp.int32), jnp.asarray(up))
    k = 8
    js, _ = jeng.kv_step_scan(
        js, jnp.full((k, e), teng.OP_PUT, jnp.int32),
        jnp.asarray(rng.integers(0, s, (k, e)).astype(np.int32)),
        jnp.asarray(rng.integers(1, 99, (k, e)).astype(np.int32)),
        jnp.zeros((k, e), bool), jnp.asarray(up))
    st = {f: np.array(getattr(js, f)) for f in js._fields}
    u = st["tree_node"].shape[2]
    st["tree_node"][1, 0, 0, 0] ^= 5
    st["tree_node"][2, 1, u - 1, 1] ^= 7
    st["tree_node"][5 % e, 2, min(1, u - 1), 3] ^= 11
    st["tree_leaf"][3 % e, 0, 4, 2] ^= 9
    st["obj_val"][4 % e, 1, 5] ^= 3
    return jeng.EngineState(**{f: jnp.asarray(v) for f, v in st.items()})


def _port_state(js):
    return interop.state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in js._fields}, device="cpu")


def _assert_state_equal(js, ts):
    got = interop.state_to_numpy(ts)
    for f in js._fields:
        assert np.array_equal(np.asarray(getattr(js, f)), getattr(got, f)), f


def _assert_results_equal(jres, tres):
    for f in jres._fields:
        assert np.array_equal(np.asarray(getattr(jres, f)),
                              getattr(tres, f).numpy()), f


# -- the scheduler -------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_schedule_matches_jax(seed):
    rng = np.random.default_rng(seed)
    k, e, s = 12, 9, 16
    kind, slot, val, lease, xe, xs = _random_planes(rng, k, e, s)
    for kw in ({}, {"max_groups": 2}, {"max_groups": 64},
               {"max_width": 2}, {"max_width": 2, "max_groups": 3}):
        for lz in (lease, None):
            jp = jsch.schedule_wide(kind, slot, val, lz, xe, xs, **kw)
            tp = tsch.schedule_wide(kind, slot, val, lz, xe, xs, **kw)
            assert (jp is None) == (tp is None), kw
            if jp is None:
                continue
            for f in jp._fields:
                a, b = getattr(jp, f), getattr(tp, f)
                assert (a is None and b is None) or np.array_equal(a, b), \
                    (kw, f)
            for a, b in zip(jsch.flat_order(jp), tsch.flat_order(tp)):
                assert np.array_equal(a, b)
            for field in (tp.kind, tp.val):
                assert np.array_equal(tsch.route_results(tp, field),
                                      jsch.route_results(jp, field))
            teng.validate_wide_plane(tp.kind, tp.slot)


def test_validate_wide_plane_raises_as_jax():
    rng = np.random.default_rng(4)
    g, e, w, s = 2, 5, 4, 8
    kind = rng.choice(KINDS, (g, e, w)).astype(np.int32)
    slot = np.stack([np.stack([rng.permutation(s)[:w] for _ in range(e)])
                     for _ in range(g)]).astype(np.int32)
    teng.validate_wide_plane(kind, slot)
    jeng.validate_wide_plane(kind, slot)
    kind[1, 3, :2] = teng.OP_GET
    slot[1, 3, 1] = slot[1, 3, 0]
    errors = []
    for fn in (jeng.validate_wide_plane, teng.validate_wide_plane):
        with pytest.raises(ValueError) as exc:
            fn(kind, slot)
        errors.append(str(exc.value))
    assert errors[0] == errors[1] and "group 1, ensemble 3" in errors[1]
    # a NOOP or negative-slot duplicate is no conflict
    kind[1, 3, 1] = teng.OP_NOOP
    teng.validate_wide_plane(kind, slot)


# -- the engine ----------------------------------------------------------------


def _wide_inputs(rng, e, m, s, k=10):
    up = np.ones((e, m), bool)
    up[::4, m - 1] = False
    js = _filled_state(rng, e, m, s, up)
    planes = _random_planes(rng, k, e, s)
    plan = jsch.schedule_wide(*planes)
    return js, up, plan


@pytest.mark.parametrize("seed", range(3))
def test_kv_step_scan_wide_matches_jax(seed):
    rng = np.random.default_rng(10 + seed)
    e, m, s = 9, 3, 32
    js, up, plan = _wide_inputs(rng, e, m, s)
    ops = (plan.kind, plan.slot, plan.val, plan.lease_ok)
    js2, jres = jeng.kv_step_scan_wide(
        js, *(jnp.asarray(x) for x in ops), jnp.asarray(up),
        exp_epoch=jnp.asarray(plan.exp_epoch),
        exp_seq=jnp.asarray(plan.exp_seq))
    T = torch.from_numpy
    for fn in (teng.kv_step_scan_wide, teng.kv_step_scan_wide_plain):
        ts, tres = fn(_port_state(js), *(T(x) for x in ops), T(up),
                      T(plan.exp_epoch), T(plan.exp_seq))
        _assert_state_equal(js2, ts)
        _assert_results_equal(jres, tres)
    assert int(np.asarray(jres.tree_corrupt).sum()) > 0
    assert int(np.asarray(jres.committed).sum()) > 0


@pytest.mark.parametrize("seed", range(2))
def test_full_step_wide_matches_jax(seed):
    rng = np.random.default_rng(20 + seed)
    e, m, s = 9, 5, 16
    js, up, plan = _wide_inputs(rng, e, m, s)
    elect = rng.random(e) < 0.4
    cand = rng.integers(-1, m + 1, e).astype(np.int32)
    ops = (elect, cand, plan.kind, plan.slot, plan.val, plan.lease_ok, up)
    js2, jwon, jres = jeng.full_step_wide(
        js, *(jnp.asarray(x) for x in ops),
        exp_epoch=jnp.asarray(plan.exp_epoch),
        exp_seq=jnp.asarray(plan.exp_seq))
    T = torch.from_numpy
    for fn in (teng.full_step_wide, teng.full_step_wide_plain):
        ts, twon, tres = fn(_port_state(js), *(T(x) for x in ops),
                            T(plan.exp_epoch), T(plan.exp_seq))
        _assert_state_equal(js2, ts)
        assert np.array_equal(np.asarray(jwon), twon.numpy())
        _assert_results_equal(jres, tres)


@pytest.mark.parametrize("last_row", (False, True))
def test_full_step_wide_sliced_matches_jax(last_row):
    """The sliced wide step on A active rows plus pads (index E), the last
    row active or not (the pads then read a copy of a row the step
    rewrites)."""
    rng = np.random.default_rng(30 + last_row)
    e, m, s = 12, 3, 16
    js, up, _ = _wide_inputs(rng, e, m, s)
    rows = np.sort(rng.choice(e - 1, 4, replace=False))
    if last_row:
        rows[-1] = e - 1
    aidx = np.full(8, e, np.int32)
    aidx[:rows.size] = rows
    planes = list(_random_planes(rng, 10, aidx.size, s))
    planes[0][:, rows.size:] = teng.OP_NOOP
    plan = jsch.schedule_wide(*planes)
    elect = np.zeros(aidx.size, bool)
    elect[:rows.size] = rng.random(rows.size) < 0.5
    cand = rng.integers(0, m, aidx.size).astype(np.int32)
    ops = (elect, cand, plan.kind, plan.slot, plan.val, plan.lease_ok, up)
    js2, jwon, jres = jeng.full_step_wide_sliced(
        js, jnp.asarray(aidx), *(jnp.asarray(x) for x in ops),
        exp_epoch=jnp.asarray(plan.exp_epoch),
        exp_seq=jnp.asarray(plan.exp_seq))
    T = torch.from_numpy
    for fn in (teng.full_step_wide_sliced, teng.full_step_wide_sliced_plain):
        ts, twon, tres = fn(_port_state(js), aidx, *(T(x) for x in ops),
                            T(plan.exp_epoch), T(plan.exp_seq))
        _assert_state_equal(js2, ts)
        assert np.array_equal(np.asarray(jwon), twon.numpy())
        _assert_results_equal(jres, tres)


@pytest.mark.parametrize("lanes", (4, 4 * 3))
def test_set_lanes_exact_with_colliding_masked_lanes(lanes):
    """Masked-off lanes (NOOP, invalid or pad) aimed at a live lane's slot,
    before and after it, and rows with no live lane: the live values
    land, everything else keeps its bits — in every lane order, for
    [E, M, S] and [E, M, S, LANES] planes."""
    rng = np.random.default_rng(lanes)
    e, m, s, w = 3, 2, 6, lanes
    idx = rng.integers(0, 3, (e, w)).astype(np.int64)
    idx[:, 0] = 1
    idx[:, -1] = 1
    mask = np.zeros((e, m, w), bool)
    live = {0: (0, w // 2), 1: (w - 1,), 2: ()}   # row 2: no live lane
    for r, ws in live.items():
        for j, wi in enumerate(ws):
            idx[r, wi] = 5 - j                     # distinct live slots
            mask[r, :, wi] = True
    idx[:, 1] = idx[0, 0]                          # a collision, row 0
    for dims in ((), (4,)):
        plane = rng.integers(0, 99, (e, m, s) + dims).astype(np.int32)
        new = rng.integers(100, 199, (e, m, w) + dims).astype(np.int32)
        want = plane.copy()
        for r in range(e):
            for wi in range(w):
                if mask[r, 0, wi]:
                    want[r, :, idx[r, wi]] = new[r, :, wi]
        for order in (np.arange(w), np.arange(w)[::-1],
                      rng.permutation(w)):
            got = torch.from_numpy(plane.copy())
            teng._set_lanes(got, torch.from_numpy(idx[:, order]),
                            torch.from_numpy(new[:, :, order]),
                            torch.from_numpy(mask[:, :, order]))
            assert np.array_equal(got.numpy(), want), (dims, order)


@pytest.mark.cuda
@pytest.mark.parametrize("aimed", (False, True))
def test_f1_wide_lanes_match_plain_on_card(aimed):
    """F1's wide mode (a group's lanes in parallel) equals
    ``full_step_wide_plain`` on the card: every state plane, ``won`` and
    every result lane, G = 2 over a damaged store.  ``aimed``: a group's
    first lanes sit on slots 0-15 and every row's level-0 node over them
    is corrupt on one replica, so that several lanes of one group cross
    one corrupt node (counted, and required)."""
    if not torch.cuda.is_available():
        pytest.skip("F1 is a CUDA kernel: no CUDA device is visible")
    from riak_ensemble_tpu_torch.ops import cuda_engine
    from test_torch_f1_wide_design import ops_of, plan_of
    rng = np.random.default_rng(50 + aimed)
    e, m, s, k = 257, 5, 128, 32
    st = teng.init_state(e, m, s, device="cuda")
    ref = teng.EngineState(*(t.clone() for t in st))
    shared = corrupt = 0
    for step in range(4):
        elect, cand, up, plan = plan_of(rng, st.leader.cpu().numpy(), e, m,
                                        s, k, True, aimed)
        if step == 0:
            elect[:] = True
            cand[:] = up.argmax(1)
        else:
            reps = rng.integers(0, m, e)
            for t in (st, ref):
                t.tree_node[torch.arange(e), torch.from_numpy(reps), 0, 1] \
                    ^= 0x40
                t.obj_val[step::9, 1, 3] += 1
            heard = (up & st.view_mask.any(1).cpu().numpy())[
                np.arange(e), reps]
            under = ((plan.kind >= 1) & (plan.kind <= 4) & (plan.slot >= 0)
                     & (plan.slot < 16)).sum(2) >= 2
            shared += int((under & heard[None, :]).sum())
        ops = [torch.from_numpy(x).cuda() for x in ops_of(plan)]
        args = (torch.from_numpy(elect).cuda(), torch.from_numpy(cand).cuda(),
                *ops[:4], torch.from_numpy(up).cuda())
        before = cuda_engine.engine_step_wide_launches
        st, won, res = teng.full_step_wide(st, *args, ops[4], ops[5])
        ref, rwon, rres = teng.full_step_wide_plain(ref, *args, ops[4],
                                                    ops[5])
        torch.cuda.synchronize()
        assert cuda_engine.engine_step_wide_launches == before + 1
        assert torch.equal(won, rwon), step
        assert all(torch.equal(a, b) for a, b in zip(st, ref)), step
        assert all(torch.equal(a, b) for a, b in zip(res, rres)), step
        corrupt += int(res.tree_corrupt.sum())
    assert corrupt and (shared or not aimed), (corrupt, shared)


# -- the service ---------------------------------------------------------------


class WidePair(Pair):
    """The JAX service under ``RETPU_WIDE=1`` and the port's with
    ``wide=True``, one host arm each (``Pair``'s lockstep and checks)."""

    def __init__(self, monkeypatch, arm, compact=True, depth=1, e=256,
                 m=3, s=16, k=4, shards=1, validate=False):
        _jax_env(monkeypatch, arm, True, compact)
        monkeypatch.setenv("RETPU_WIDE", "1")
        if validate:
            monkeypatch.setenv("RETPU_VALIDATE_WIDE", "1")
        if shards > 1:
            monkeypatch.setenv("RETPU_RESOLVE_SHARDS", str(shards))
        self.js = jb.BatchedEnsembleService(
            FixedClock(), e, m, s, tick=None, max_ops_per_tick=k,
            pipeline_depth=depth)
        self.ts = tb.BatchedEnsembleService(
            FixedClock(), e, m, s, tick=None, max_ops_per_tick=k,
            device="cpu", compact=compact, pipeline_depth=depth, wide=True,
            resolve_shards=shards, validate_wide=validate, **PORT_KW[arm])
        assert self.js._wide and self.ts._wide
        self.bufs = ([], [])
        _record_packed(self.js, self.bufs[0])
        _record_packed(self.ts, self.bufs[1])
        self.futs = ([], [])

    def check(self):
        super().check()
        assert self.ts.wide_launches == self.js.wide_launches > 0
        assert self.ts.stats()["wide_launches"] == self.ts.wide_launches


@pytest.mark.parametrize("arm,depth,compact,validate", [
    ("default", 1, True, False), ("default", 2, False, False),
    ("oracle", 1, False, False), ("oracle", 2, True, False),
    ("default", 1, True, True)])
def test_wide_service_matches_jax(monkeypatch, arm, depth, compact,
                                  validate):
    """Seeded keyed streams (every verb, host and device RMW): wide and
    scalar-fallback flushes, sliced when compacted (E = 256), and with
    each plan validated."""
    p = WidePair(monkeypatch, arm, compact=compact, depth=depth,
                 validate=validate)
    p.run(seed=40 + depth + 2 * compact, rounds=4)
    p.check()
    if compact:
        assert p.ts.sliced_launches > 0


def _mk(monkeypatch, **kw):
    """The small services of ``tests/test_wide_service.py`` (6 x 3 x 16,
    K = 8), the JAX one under ``RETPU_WIDE=1``."""
    _jax_env(monkeypatch, "default", True, True)
    monkeypatch.setenv("RETPU_WIDE", "1")
    js = jb.BatchedEnsembleService(FixedClock(), 6, 3, 16, tick=None,
                                   max_ops_per_tick=8, **kw)
    ts = tb.BatchedEnsembleService(FixedClock(), 6, 3, 16, tick=None,
                                   max_ops_per_tick=8, device="cpu",
                                   wide=True, **kw)
    return js, ts


def _drain(svc, futs, rounds=10):
    for _ in range(rounds):
        svc.flush()
        svc.runtime.now += 0.005
        if all(f.done for f in futs):
            return
    assert all(f.done for f in futs), "futures never resolved"


def _workload(svc, seed):
    """``test_wide_service._workload``: distinct keys per flush, puts and
    gets drained separately."""
    rng = np.random.default_rng(seed)
    out = []
    for _step in range(3):
        puts = []
        for e in range(svc.n_ens):
            keys = [f"k{i}" for i in rng.choice(6, 3, replace=False)]
            puts.append(svc.kput_many(
                e, keys, [int(rng.integers(1, 99)) for _ in keys]))
        _drain(svc, puts)
        gets = []
        for e in range(svc.n_ens):
            keys = [f"k{i}" for i in rng.choice(6, 3, replace=False)]
            gets.append(svc.kget_many(e, keys, want_vsn=True))
            if rng.random() < 0.3:
                gets.append(svc.kdelete(e, keys[0]))
        _drain(svc, gets)
        out.extend(norm(f.value) for f in puts)
        out.extend(norm(f.value) for f in gets)
    return out


def _assert_services_equal(js, ts):
    _assert_state_equal(js.state, ts.state)
    for name in ("leader_np", "lease_until", "_slot_vsn_np",
                 "_slot_vsn_ok", "_inline_value_np", "_inline_value_ok"):
        assert np.array_equal(getattr(js, name), getattr(ts, name)), name


@pytest.mark.parametrize("seed", (0, 1))
def test_wide_scalar_match_workload(monkeypatch, seed):
    js, ts = _mk(monkeypatch)
    assert _workload(ts, seed) == _workload(js, seed)
    assert ts.wide_launches == js.wide_launches > 0
    _assert_services_equal(js, ts)


def test_wide_duplicate_chain(monkeypatch):
    js, ts = _mk(monkeypatch)
    vals = []
    for svc in (js, ts):
        f = svc.kput_many(0, ["a", "a", "b"], [1, 2, 3])
        _drain(svc, [f])
        g = svc.kget_many(0, ["a", "b"], want_vsn=True)
        _drain(svc, [g])
        vals.append((norm(f.value), norm(g.value)))
    assert vals[0] == vals[1]
    (put, got) = vals[1]
    assert all(r[0] == "ok" for r in put)
    assert tuple(put[1][1]) > tuple(put[0][1])      # per-key monotone
    assert got[0][:2] == ("ok", 2) and got[1][:2] == ("ok", 3)
    assert tuple(got[0][2]) == tuple(put[1][1])
    assert ts.wide_launches == js.wide_launches > 0
    _assert_services_equal(js, ts)


def test_wide_execute_bulk(monkeypatch):
    js, ts = _mk(monkeypatch)
    outs = []
    for svc in (js, ts):
        svc.runtime.now += 1.0
        svc.flush()  # elections
        rng = np.random.default_rng(3)
        k, e = 8, svc.n_ens
        kind = rng.choice([teng.OP_PUT, teng.OP_GET, teng.OP_NOOP], (k, e),
                          p=[0.5, 0.4, 0.1]).astype(np.int32)
        slot = np.stack([rng.permutation(svc.n_slots)[:k]
                         for _ in range(e)], axis=1).astype(np.int32)
        val = rng.integers(1, 1 << 20, (k, e), dtype=np.int32)
        outs.append([np.asarray(x) for x in svc.execute(kind, slot, val)])
    for a, b in zip(*outs):
        assert np.array_equal(a, b)
    assert ts.wide_launches == js.wide_launches > 0
    _assert_services_equal(js, ts)


def _port_plan(ts, kind, slot, val, k):
    """The port's plan over the live columns, laid out at full width as
    the reference plans it (idle columns: NOOP lanes at slot -1, routed
    to (0, 0))."""
    live = np.flatnonzero((kind != teng.OP_NOOP).any(axis=0))
    p = ts._wide_plan(kind, slot, val, k, None, None, live)
    if p is None:
        return None
    g, _, w = p.kind.shape

    def lay(part, shape, fill):
        out = np.full(shape, fill, np.int32)
        out[:, live] = part
        return out
    planes = {f: lay(getattr(p, f), (g, ts.n_ens, w), fill) for f, fill in (
        ("kind", teng.OP_NOOP), ("slot", -1), ("val", 0), ("exp_epoch", 0),
        ("exp_seq", 0))}
    maps = {f: lay(getattr(p, f), (k, ts.n_ens), 0)
            for f in ("map_g", "map_w")}
    return p._replace(**planes, **maps)


def test_wide_gate_falls_back_on_deep_duplicates(monkeypatch):
    js, ts = _mk(monkeypatch)
    k, e = 6, ts.n_ens
    kind = np.full((k, e), teng.OP_PUT, np.int32)
    val = np.ones((k, e), np.int32)
    deep = np.zeros((k, e), np.int32)         # a 6-deep duplicate chain
    flat = np.tile(np.arange(k, dtype=np.int32)[:, None], (1, e))
    assert js._wide_plan(kind, deep, val, k, None, None) is None
    assert _port_plan(ts, kind, deep, val, k) is None
    jp = js._wide_plan(kind, flat, val, k, None, None)
    tp = _port_plan(ts, kind, flat, val, k)
    assert tp.kind.shape[0] == 1 and tp.lease_ok is None
    for f in ("kind", "slot", "val", "exp_epoch", "exp_seq", "map_g",
              "map_w"):
        assert np.array_equal(getattr(jp, f), getattr(tp, f)), f
    # sparse columns and an all-NOOP plane: the port plans the live
    # columns only, and equals the reference's plan laid out
    rng = np.random.default_rng(9)
    for p_col in (0.0, 0.4):
        sparse = kind.copy()
        sparse[:, rng.random(e) >= p_col] = teng.OP_NOOP
        sparse[rng.random((k, e)) < 0.2] = teng.OP_NOOP
        chain = rng.integers(0, 2, (k, e)).astype(np.int32) + flat
        jp = js._wide_plan(sparse, chain, val, k, None, None)
        tp = _port_plan(ts, sparse, chain, val, k)
        assert (jp is None) == (tp is None)
        for f in ("kind", "slot", "val", "exp_epoch", "exp_seq", "map_g",
                  "map_w"):
            assert jp is None or np.array_equal(getattr(jp, f),
                                                getattr(tp, f)), f
    # device-resident planes keep the scalar scan
    dev = tb.BatchedEnsembleService(FixedClock(), 6, 3, 16, tick=None,
                                    max_ops_per_tick=8, device="cpu",
                                    wide=True)
    dev.execute(*(torch.from_numpy(x) for x in (kind, flat, val)))
    assert dev.wide_launches == 0
    dev.execute(kind, flat, val)
    assert dev.wide_launches == 1
    # the deep chain then runs the scalar scan, as in the reference
    for svc in (js, ts):
        svc.runtime.now += 1.0
        svc.flush()
        svc.execute(kind, deep, val)
    assert ts.wide_launches == js.wide_launches == 0
    _assert_services_equal(js, ts)


def test_wide_warmup_covers_gated_shapes():
    """The warm-up launches the wide step at every (G, W) the gate admits
    (G in {1, 2}, W in {1, 2, 4, 8}), on a throwaway state."""
    shapes = []

    class Counting(tb._LocalEngine):
        @staticmethod
        def full_step_wide(*args, **kw):
            shapes.append(tuple(args[3].shape))
            return teng.full_step_wide(*args, **kw)

    ts = tb.BatchedEnsembleService(FixedClock(), 6, 3, 16, tick=None,
                                   max_ops_per_tick=8, device="cpu",
                                   wide=True, engine=Counting())
    before = [t.clone() for t in ts.state]
    ts.warmup()
    assert sorted(shapes) == sorted((g, 6, w) for g in (1, 2)
                                    for w in (1, 2, 4, 8))
    assert all(torch.equal(a, b) for a, b in zip(before, ts.state))
    f = ts.kput_many(1, ["x", "y"], [b"1", b"2"])
    _drain(ts, [f])
    assert [r[0] for r in f.value] == ["ok", "ok"]
    assert ts.wide_launches == 1


def test_wide_dynamic_lifecycle(monkeypatch):
    js, ts = _mk(monkeypatch, dynamic=True)
    got = []
    for svc in (js, ts):
        row = svc.create_ensemble("orders")
        svc.runtime.now += 0.5
        svc.flush()
        f = svc.kput_many(row, ["a", "b"], [b"1", b"2"])
        _drain(svc, [f])
        g = svc.kget_many(row, ["a", "b"], want_vsn=True)
        _drain(svc, [g])
        got.append((row, norm(f.value), norm(g.value)))
        assert svc.destroy_ensemble("orders")
    assert got[0] == got[1] and got[1][1][0][0] == "ok"
    assert ts.wide_launches == js.wide_launches > 0
    _assert_services_equal(js, ts)
