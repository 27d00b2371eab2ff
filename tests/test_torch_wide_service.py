"""The wide-round arm of the port's service against the JAX service under
``RETPU_WIDE=1``: keyed streams, scalar-matching workloads, duplicate chains
and bulk ``execute`` (the steps are in ``test_torch_wide_steps.py``; the
schedule, the lane helpers and the shared inputs in ``test_torch_wide.py``).
"""

import numpy as np
import pytest

from riak_ensemble_tpu_torch.ops import engine as teng
from test_torch_compaction import norm
from test_torch_reference_natives import reference_natives  # noqa: F401 (autouse)
from test_torch_wide import (
    WidePair, _assert_services_equal, _drain, _mk, _workload)


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
