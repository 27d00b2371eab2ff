"""``correct`` on the CPU at a tiny size: true for the port, false for the
control and for each fault the cells can have, planted in the timed path
(the engine adapter every launch runs through).  The cells run on one
card, so no exchange between cards can be left out."""

import pytest
import torch

from perfbench import harness
from perfbench.control import ControlSystem

SMALL = {
    "riak_sc_mem.ycsb_a": {
        "config": {"n_ens": 16, "n_slots": 40, "record_count": 256},
        "traffic": {"clients": 16}},
    "riak_sc_mem.ycsb_b": {
        "config": {"n_ens": 16, "n_slots": 40, "record_count": 256},
        "traffic": {"clients": 24}},
}
CELLS = sorted(SMALL)
FIELDS = ("epoch", "fact_seq", "leader", "obj_seq_ctr", "obj_epoch",
          "obj_seq", "obj_val", "tree_leaf", "tree_node")


class _Wrap:
    """An engine adapter that breaks each step one way."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def full_step(self, state, elect, cand, kind, *a, **kw):
        return self.step(self._inner.full_step, state, (elect, cand),
                         kind, a, kw)

    def full_step_sliced(self, state, idx, elect, cand, kind, *a, **kw):
        return self.step(self._inner.full_step_sliced, state,
                         (idx, elect, cand), kind, a, kw)


class Unchanged(_Wrap):
    """The step answers, but returns the state as it found it."""

    def step(self, fn, state, head, kind, a, kw):
        keep = {f: getattr(state, f).clone() for f in FIELDS}
        new, won, res = fn(state, *head, kind, *a, **kw)
        for f in FIELDS:
            getattr(new, f).copy_(keep[f])
        return new, won, res


class HalfBatch(_Wrap):
    """Every other column's ops are left out of the step."""

    def step(self, fn, state, head, kind, a, kw):
        kind = kind.clone()
        kind[:, ::2] = 0
        return fn(state, *head, kind, *a, **kw)


class AlteredAnswer(_Wrap):
    """The first round's versions come out one seq too high."""

    def step(self, fn, state, head, kind, a, kw):
        new, won, res = fn(state, *head, kind, *a, **kw)
        if res.obj_vsn.shape[0]:
            vsn = res.obj_vsn.clone()
            vsn[0, :, 1] += 1
            res = res._replace(obj_vsn=vsn)
        return new, won, res


def _run(cell, **kw):
    return harness.run_cell(cell, 2 ** 31 + 5, 0.6, False, device="cpu",
                            overrides=SMALL[cell], **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_the_port_is_correct(cell):
    res = _run(cell)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not(cell):
    res = _run(cell, system_factory=ControlSystem)
    assert res["correct"] is False
    broken = {k for k, v in res["checks"].items() if v["value"] > 0}
    assert broken == {"replica_short"}


@pytest.mark.parametrize("fault", [Unchanged, HalfBatch, AlteredAnswer])
@pytest.mark.parametrize("cell", CELLS)
def test_each_planted_fault_is_caught(cell, fault):
    res = _run(cell, engine_wrap=fault)
    assert res["correct"] is False, (fault.__name__, res["checks"])


def test_the_wrappers_break_the_step_they_claim():
    from riak_ensemble_tpu_torch.ops import engine as eng
    st = eng.init_state(4, 3, 8, device="cpu")
    elect = torch.ones(4, dtype=torch.bool)
    cand = torch.zeros(4, dtype=torch.int32)
    kind = torch.full((1, 4), 2, dtype=torch.int32)       # puts
    slot = torch.zeros((1, 4), dtype=torch.int32)
    val = torch.full((1, 4), 7, dtype=torch.int32)
    lease = torch.zeros((1, 4), dtype=torch.bool)
    up = torch.ones((4, 3), dtype=torch.bool)
    inner = type("E", (), {"full_step": staticmethod(eng.full_step)})()
    pre = st.obj_val.clone()
    new, _, res = Unchanged(inner).full_step(st, elect, cand, kind, slot,
                                             val, lease, up)
    assert res.committed.all() and torch.equal(new.obj_val, pre)
