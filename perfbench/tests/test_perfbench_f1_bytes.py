"""The frozen F1 byte and operation counts equal the program's."""

import numpy as np
import pytest

from perfbench import f1_bytes
from riak_ensemble_tpu_torch.ops import cuda_engine


def _inputs(seed, r, m, k, a, s):
    rng = np.random.default_rng(seed)
    heard = rng.random((r, m)) < 0.8
    wrote = heard & (rng.random((r, m)) < 0.5)
    ballot = rng.random(r) < 0.3
    kind = rng.integers(0, 6, (k, a)).astype(np.int32)
    slot = rng.integers(-2, s + 2, (k, a)).astype(np.int32)
    committed = rng.random((k, a)) < 0.6
    return heard, wrote, ballot, kind, slot, committed


@pytest.mark.parametrize("seed,r,m,k,a,s,v", [
    (0, 64, 5, 8, 64, 128, 2),       # full width
    (1, 40, 5, 4, 64, 128, 2),       # sliced: 24 pad columns
    (2, 16, 7, 1, 16, 1024, 3),
    (3, 8, 3, 0, 8, 17, 1),          # an election-only launch
])
def test_copy_equals_the_program(seed, r, m, k, a, s, v):
    heard, wrote, ballot, kind, slot, committed = _inputs(seed, r, m, k,
                                                          a, s)
    live = (kind >= 1) & (kind <= 4) & (slot >= 0) & (slot < s)
    staged = live[:, :r].any(0) if k else np.zeros(r, bool)
    assert f1_bytes.design_bytes(heard, staged, wrote, ballot, s, v, k,
                                 a) == cuda_engine.design_bytes(
        heard, staged, wrote, ballot, s, v, k, a)
    cols = np.zeros((a, m), bool)
    cols[:r] = heard
    assert f1_bytes.design_work(cols, kind, slot, committed, s) == \
        cuda_engine.design_work(cols, kind, slot, committed, s)
    assert f1_bytes.n_uppers(s) == cuda_engine.n_uppers(s)
    assert (f1_bytes.FOLD_OPS, f1_bytes.LEAF_OPS) == (cuda_engine.FOLD_OPS,
                                                      cuda_engine.LEAF_OPS)


def test_launch_bound_is_the_larger_of_bytes_and_ops():
    heard, wrote, ballot, kind, slot, committed = _inputs(5, 32, 5, 8, 32,
                                                          128)
    b = f1_bytes.launch_bound(heard, wrote, ballot, kind, slot, committed,
                              128, 2)
    assert b["bytes_s"] == pytest.approx(b["bytes"] / f1_bytes.HBM_BYTES_PER_S)
    assert b["ops_s"] == pytest.approx(b["ops"] / f1_bytes.INT32_OPS_PER_S)
    assert b["bound_s"] == max(b["bytes_s"], b["ops_s"]) > 0
