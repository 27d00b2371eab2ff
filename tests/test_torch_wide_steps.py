"""The port's wide steps (``full_step_wide``, ``full_step_wide_sliced``,
``kv_step_scan_wide``) against the JAX package's, and the wide service's
dynamic rows and its gate (the shared inputs are in ``test_torch_wide.py``).
"""

import numpy as np
import pytest
import torch

from riak_ensemble_tpu_torch.ops import engine as teng
from riak_ensemble_tpu_torch.parallel import batched_host as tb
from test_torch_compaction import norm
from test_torch_kmodify import FixedClock
from test_torch_reference_natives import reference_natives  # noqa: F401 (autouse)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from riak_ensemble_tpu.ops import engine as jeng  # noqa: E402
from riak_ensemble_tpu.ops import schedule as jsch  # noqa: E402
from test_torch_wide import (  # noqa: E402
    _assert_results_equal, _assert_services_equal, _assert_state_equal,
    _drain, _mk, _port_plan, _port_state, _random_planes, _wide_inputs)


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
