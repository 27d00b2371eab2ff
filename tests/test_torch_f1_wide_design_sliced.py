"""F1's wide mode in numpy (the model of ``test_torch_f1_wide_design.py``) in
sliced launches against ``full_step_wide_sliced_plain``, against the JAX
package's wide steps, and the design's byte and hash counts against what the
model moves and hashes.
"""

import numpy as np
import pytest
import torch

from riak_ensemble_tpu_torch.ops import (
    cuda_engine, engine as teng, schedule as tsch)
from test_torch_f1_design import (
    RESULT, STATE, U32, _tres, assert_results_equal, assert_states_equal,
    damage, stream, to_numpy, to_torch)
from test_torch_f1_wide_design import launch, ops_of, plan_of, wide_slots

#: (name, E, M, S, K, real rows, A, chains, row E - 1 active)
SLICED = [
    ("pads after row E-1, G=2", 9, 5, 128, 32, 4, 8, True, True),
    ("row E-1 idle, G=1", 9, 5, 33, 16, 4, 8, False, False),
    ("M=3 joint columns, G=2", 8, 3, 16, 16, 5, 8, True, True),
]


@pytest.mark.parametrize("case", SLICED, ids=[c[0] for c in SLICED])
def test_wide_design_equals_sliced_plain(case):
    name, e, m, s, k, n_real, bucket, chains, last = case
    rng = np.random.default_rng(len(name) * 17 + k)
    state = teng.init_state(e, m, s, device="cpu")
    st = to_numpy(state)
    pad_ok = 0
    for step in range(3):
        if step:
            damage(rng, st, 4)
            state = to_torch(st)
        rows = rng.choice(e - 1, n_real - (last or step == 0), replace=False)
        if last or step == 0:
            rows = np.append(rows, e - 1)
        active = np.full(bucket, e, np.int32)
        active[:n_real] = np.sort(rows)
        real = active < e
        col = np.minimum(active, e - 1)
        p = stream(rng, st["leader"], e, m, s, k)
        p[6][e - 1] = True      # the row the pads read: its leader up
        kind = np.ascontiguousarray(p[2][:, col])
        kind[:, ~real] = 0
        slot = wide_slots(rng, k, bucket, s, chains)
        picked = [np.ascontiguousarray(q[:, col]) for q in
                  (p[4], p[5], p[7], p[8])]
        plan = tsch.schedule_wide(kind, slot, picked[0], picked[1],
                                  picked[2], picked[3])
        elect = p[0][col] & real
        cand = np.where(real, p[1][col], 0).astype(np.int32)
        if step == 0:
            elect = real.copy()
            cand = np.where(real, p[6][col].argmax(1), 0).astype(np.int32)
        ops = ops_of(plan)
        T = torch.from_numpy
        state, want_won, want = teng.full_step_wide_sliced_plain(
            state, active, T(elect), T(cand), *map(T, ops[:4]), T(p[6]),
            T(ops[4]), T(ops[5]))
        won, got, _ = launch(st, elect, cand, *ops[:4], p[6], *ops[4:],
                             active_idx=active, warps=8)
        where = (name, step)
        assert_results_equal(want_won.numpy(), _tres(want), won, got, where)
        assert_states_equal(to_numpy(state), st, where)
        pad_ok += int(got["quorum_ok"][:, n_real:].sum())
    assert pad_ok, name


@pytest.mark.parametrize("sliced", [False, True])
def test_wide_design_equals_jax(sliced):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from riak_ensemble_tpu.ops import engine as jeng
    e, m, s, k = 6, 5, 128, 32
    rng = np.random.default_rng(41 + sliced)
    js = jeng.init_state(e, m, s)
    st = {f: np.array(getattr(js, f)) for f in STATE}
    for step in range(3):
        if step:
            damage(rng, st, 6)
            st["tree_node"][np.arange(e), rng.integers(0, m, e), 0, 1] ^= \
                U32(0x40)
            js = jeng.EngineState(**{f: jnp.asarray(st[f]) for f in STATE})
        if sliced:
            active = np.full(8, e, np.int32)
            active[:4] = np.sort(rng.choice(e, 4, replace=False))
            real = active < e
            col = np.minimum(active, e - 1)
            p = stream(rng, st["leader"], e, m, s, k)
            kind = np.ascontiguousarray(p[2][:, col])
            kind[:, ~real] = 0
            plan = tsch.schedule_wide(
                kind, wide_slots(rng, k, 8, s, True, True),
                *(np.ascontiguousarray(q[:, col]) for q in
                  (p[4], p[5], p[7], p[8])))
            elect = (p[0][col] & real) if step else real.copy()
            cand = np.where(real, p[6][col].argmax(1), 0).astype(np.int32)
            up = p[6]
        else:
            active = None
            elect, cand, up, plan = plan_of(rng, st["leader"], e, m, s, k,
                                            True, True)
            if step == 0:
                elect[:] = True
                cand[:] = up.argmax(1)
        ops = ops_of(plan)
        J = jnp.asarray
        head = (J(elect), J(cand), *map(J, ops[:4]), J(up))
        if sliced:
            js, jwon, jres = jeng.full_step_wide_sliced(
                js, J(active), *head, exp_epoch=J(ops[4]),
                exp_seq=J(ops[5]))
        else:
            js, jwon, jres = jeng.full_step_wide(
                js, *head, exp_epoch=J(ops[4]), exp_seq=J(ops[5]))
        won, got, _ = launch(st, elect, cand, *ops[:4], up, *ops[4:],
                             active_idx=active)
        where = (sliced, step)
        assert_results_equal(np.asarray(jwon), {
            f: np.asarray(getattr(jres, f)) for f in RESULT}, won, got,
            where)
        assert_states_equal({f: np.asarray(getattr(js, f)) for f in STATE},
                            st, where)
    assert int(np.asarray(jres.committed).sum()) > 0


@pytest.mark.parametrize("chains", [False, True])
def test_design_counts_what_the_wide_model_moves_and_hashes(chains):
    """``cuda_engine.design_work`` and ``design_bytes`` over a wide
    launch's flat rounds (``cuda_engine.flat_rounds``) count the model's
    verdicts, staged rows and live lanes exactly, its refolds and leaf
    writes from below (the model also hashes for read repairs), and one
    replica row for each replica it writes back and each heard replica
    of a staged row; ``tree_corrupt`` is charged once a group."""
    e, m, s, k = 6, 5, 128, 64
    rng = np.random.default_rng(60 + chains)
    st = to_numpy(teng.init_state(e, m, s, device="cpu"))
    v = st["view_mask"].shape[1]
    elect, cand, up, plan = plan_of(rng, st["leader"], e, m, s, k, chains)
    up[:] = True
    launch(st, np.ones(e, bool), np.zeros(e, np.int32), *ops_of(plan)[:4],
           up, *ops_of(plan)[4:])
    elect, cand, up, plan = plan_of(rng, st["leader"], e, m, s, k, chains)
    ops = ops_of(plan)
    pre = {f: x.copy() for f, x in st.items()}
    _, got, counts = launch(st, elect, cand, *ops[:4], up, *ops[4:])
    flat = cuda_engine.flat_rounds
    heard = up & pre["view_mask"].any(1)
    work = cuda_engine.design_work(heard, flat(plan.kind), flat(plan.slot),
                                   flat(got["committed"]), s)
    for key in ("staged_rows", "live_rounds", "verdict_folds",
                "leaf_verdicts"):
        assert work[key] == counts[key], key
    for key in ("refold_folds", "leaf_writes"):
        assert work[key] <= counts[key], key

    def changed(*fields):
        return np.any([(pre[f] != st[f]).reshape(e, m, -1).any(2)
                       for f in fields], axis=0)
    wrote = changed("obj_epoch", "obj_seq", "obj_val", "tree_leaf",
                    "tree_node")
    ballot = (changed("epoch", "fact_seq").any(1)
              | (pre["leader"] != st["leader"])
              | (pre["obj_seq_ctr"] != st["obj_seq_ctr"]))
    g_n, _, w = plan.kind.shape
    live = flat((plan.kind >= 1) & (plan.kind <= 4) & (plan.slot >= 0)
                & (plan.slot < s))
    staged = live.any(0)
    assert int(wrote.sum()) == counts["written_replicas"]
    assert int(staged.sum()) == counts["staged_rows"]
    moved = cuda_engine.design_bytes(heard, staged, wrote, ballot, s, v,
                                     g_n * w, e, groups=g_n)
    row = 3 * s * 4 + s * 16 + cuda_engine.n_uppers(s) * 16
    assert moved["read"]["replicas"] == int(
        (heard & staged[:, None]).sum()) * row
    assert moved["written"]["replicas"] == counts["written_replicas"] * row
    assert moved["written"]["results"] == (g_n * w * e * 16 + g_n * e * m
                                           + e)
