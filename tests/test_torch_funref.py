"""The port's copy of ``funref`` against the JAX package's original.

- the table codes, merge classes and class maps are the same numbers;
- ``is_int32`` / ``i32`` / ``device_entry`` / ``device_code`` /
  ``resolve`` agree on a sweep of specs (ints, numpy ints, bools, bytes,
  out-of-range ints, unknown names, callables);
- ``fold_operand`` / ``fold_seed`` / ``merge_apply`` agree on seeded
  int32 draws, overflow included;
- each of the nine host-mirror table funs equals the original, and
  equals the port engine's ``OP_RMW`` round on the same (current
  value, operand) pairs;
- the two registries are separate dicts.

Inputs come from numpy seeds; tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from riak_ensemble_tpu_torch import funref as tf
from riak_ensemble_tpu_torch.ops import engine as teng

TABLE = ["rmw:add", "rmw:sub", "rmw:max", "rmw:min", "rmw:set",
         "rmw:band", "rmw:bor", "rmw:bxor", "rmw:put_if_absent"]


@pytest.fixture
def jf():
    pytest.importorskip("jax")
    from riak_ensemble_tpu import funref
    return funref


def _draws(rng, n):
    """int32 draws biased toward the edges (0, +-1, the extremes)."""
    edge = np.array([0, 1, -1, 2 ** 31 - 1, -2 ** 31, 2 ** 30, -2 ** 30])
    out = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64)
    pick = rng.random(n) < 0.3
    out[pick] = rng.choice(edge, int(pick.sum()))
    return [int(x) for x in out]


def test_codes_and_class_maps_match(jf):
    names = ["RMW_ADD", "RMW_SUB", "RMW_MAX", "RMW_MIN", "RMW_SET",
             "RMW_BAND", "RMW_BOR", "RMW_BXOR", "RMW_PIA", "MERGE_ADD",
             "MERGE_MAX", "MERGE_MIN", "MERGE_AND", "MERGE_OR", "ORDERED",
             "COMMUTATIVE", "SEMILATTICE", "TAG", "RMW_CLASS", "MERGE_OF"]
    for n in names:
        assert getattr(tf, n) == getattr(jf, n), n
    assert tf._DEVICE == jf._DEVICE
    assert set(TABLE) <= set(tf._REGISTRY)
    for code in range(9):
        assert tf.merge_class(code) == jf.merge_class(code)


def _call(fn):
    """``fn(vsn, 3)``, or the name of the exception it raised."""
    try:
        return fn((1, 1), 3)
    except Exception as exc:  # compared, not hidden
        return type(exc).__name__


def test_spec_helpers_match(jf):
    def fn(vsn, cur):
        return cur

    specs = [tf.ref(n, v) for n in TABLE
             for v in (0, 5, -7, 2 ** 31 - 1, -2 ** 31)]
    specs += [("fn", "rmw:add", (np.int32(4),)),
              ("fn", "rmw:add", (np.int64(2 ** 31),)),
              ("fn", "rmw:add", (True,)), ("fn", "rmw:add", (2 ** 31,)),
              ("fn", "rmw:add", (1.0,)), ("fn", "rmw:add", (1, 2)),
              ("fn", "rmw:add", ()), ("fn", "rmw:put_if_absent", (b"x",)),
              ("fn", "no:such", (1,)), ("fn", "rmw:add"), ("x", "rmw:add",
                                                            (1,)),
              "rmw:add", None, fn]
    for spec in specs:
        assert tf.device_entry(spec) == jf.device_entry(spec), spec
        assert tf.device_code(spec) == jf.device_code(spec), spec
        try:
            want = jf.resolve(spec)
        except ValueError:
            with pytest.raises(ValueError):
                tf.resolve(spec)
            continue
        got = tf.resolve(spec)
        if spec is fn:
            assert got is fn
        else:
            assert _call(got) == _call(want), spec
    for x in [0, 1, -1, 2 ** 31 - 1, 2 ** 31, -2 ** 31, -2 ** 31 - 1,
              True, False, np.int8(3), np.uint32(2 ** 32 - 1), 1.0, "1",
              None, b"1"]:
        assert tf.is_int32(x) == jf.is_int32(x), x
    for x in [0, 2 ** 31, -2 ** 31 - 1, 2 ** 40 + 5, -(2 ** 33) + 1]:
        assert tf.i32(x) == jf.i32(x)


def test_folds_match(jf):
    rng = np.random.default_rng(11)
    a, b = _draws(rng, 400), _draws(rng, 400)
    for code in range(9):
        for x, y in zip(a, b):
            assert tf.fold_seed(code, x) == jf.fold_seed(code, x)
            if jf.merge_class(code) is None:
                with pytest.raises(ValueError):
                    tf.fold_operand(code, x, y)
                continue
            assert tf.fold_operand(code, x, y) == jf.fold_operand(code, x, y)
    for mcls in range(5):
        for x, y in zip(a, b):
            assert tf.merge_apply(mcls, x, y) == jf.merge_apply(mcls, x, y)
    with pytest.raises(ValueError):
        tf.merge_apply(9, 1, 1)


def test_host_mirrors_match_original_and_engine(jf):
    """Each table fun's host mirror against the JAX package's and
    against the port engine: row i of a batch first writes ``cur[i]``
    (RMW_SET; 0 leaves the slot absent), then applies ``fun(operand)``
    in the next round; the round's committed value must equal the
    mirror (put-if-absent over a live value: nothing commits)."""
    rng = np.random.default_rng(5)
    n = 64
    cur, opd = _draws(rng, n), _draws(rng, n)
    e, m, s = n, 3, 4
    up = torch.ones((e, m), dtype=torch.bool)
    for name in TABLE:
        code = tf._DEVICE[name]
        want = [jf.resolve(jf.ref(name, o))(None, c)
                for c, o in zip(cur, opd)]
        got = [tf.resolve(tf.ref(name, o))(None, c)
               for c, o in zip(cur, opd)]
        assert got == want, name
        st = teng.init_state(e, m, s, device="cpu")
        st, won = teng.elect_step(st, torch.ones(e, dtype=torch.bool),
                                  torch.zeros(e, dtype=torch.int32), up)
        assert bool(won.all())
        rows = torch.full((e,), teng.OP_RMW, dtype=torch.int32)
        slot = torch.zeros(e, dtype=torch.int32)
        lease = torch.zeros(e, dtype=torch.bool)

        def rmw(st, code, vals):
            return teng.kv_step(
                st, rows, slot, torch.tensor(vals, dtype=torch.int32),
                lease, up, exp_epoch=torch.full((e,), code,
                                                dtype=torch.int32),
                exp_seq=torch.zeros(e, dtype=torch.int32))
        st, r0 = rmw(st, teng.RMW_SET, cur)
        assert bool(r0.committed.all())
        st, r1 = rmw(st, code, opd)
        committed = r1.committed.reshape(-1).tolist()
        value = r1.value.reshape(-1).tolist()
        for i, w in enumerate(want):
            if w == "failed":
                assert not committed[i], (name, cur[i], opd[i])
            else:
                assert committed[i] and value[i] == w, (name, cur[i],
                                                        opd[i])


def test_registries_are_separate(jf):
    name = "torch-test:only-in-the-port"
    if name not in tf._REGISTRY:
        tf.register(name)(lambda vsn, cur: cur)
    assert name not in jf._REGISTRY
    assert tf.ref(name, 1) == ("fn", name, (1,))
    with pytest.raises(AssertionError):
        tf.register(name)(lambda vsn, cur: cur)
    with pytest.raises(ValueError):
        jf.resolve(tf.ref(name, 1))
    assert tf.resolve(tf.ref(name))(None, 9) == 9
