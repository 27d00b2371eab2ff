"""The port's ``linearizability`` harness against the reference's.

- The model cases of ``tests/test_linearizability.py:16-64`` on the port's
  ``KeyModel``.
- The port's ``KeyModel`` and ``CounterModel`` against the reference's on
  seeded random histories (writes invoked, acknowledged, failed and timed
  out in any order, reads of plausible, stale and never-written values,
  counters with acknowledged and ambiguous operands): the same verdict,
  a ``Violation`` at the same op, and the same model state after each op.
- The port's ``Workload`` on the port's ``ManagedCluster`` in lockstep
  with the reference's on the reference's cluster, with the seeds of
  ``:87``, ``:100`` and ``:120`` (peer freezes on one node, membership
  churn and partitions on three): the same op mix, the same history of
  every key, the same virtual clock and the same cluster snapshot at the
  end (``test_torch_scalar_plane.snapshot``), and the same outcome.
- The three ``ServiceReadWorkload`` cases (``:172``, ``:184``, ``:195``)
  on the port's service on the CPU.
"""

import importlib
import itertools
import random

import pytest

from riak_ensemble_tpu_torch import linearizability as lin
from riak_ensemble_tpu_torch.config import fast_test_config
from riak_ensemble_tpu_torch.linearizability import (
    KeyModel, ServiceReadWorkload, Violation)
from riak_ensemble_tpu_torch.parallel.batched_host import (
    BatchedEnsembleService)
from riak_ensemble_tpu_torch.runtime import Runtime
from riak_ensemble_tpu_torch.types import NOTFOUND


# -- model cases ------------------------------------------------------------


def test_model_accepts_acked_write_read():
    m = KeyModel("k")
    m.ack_write(m.invoke_write(b"a"))
    m.ack_read(b"a")


def test_model_rejects_stale_read():
    m = KeyModel("k")
    m.ack_write(m.invoke_write(b"a"))
    m.ack_write(m.invoke_write(b"b"))
    with pytest.raises(Violation):
        m.ack_read(b"a")


def test_model_rejects_lost_write():
    m = KeyModel("k")
    m.ack_write(m.invoke_write(b"a"))
    with pytest.raises(Violation, match="DATA LOSS"):
        m.ack_read(NOTFOUND)


def test_model_concurrent_write_may_win():
    m = KeyModel("k")
    op1 = m.invoke_write(b"a")
    op2 = m.invoke_write(b"b")
    m.ack_write(op1)
    m.ack_write(op2)
    m.ack_read(b"b")
    with pytest.raises(Violation):
        m.ack_read(b"a")


def test_model_timeout_write_remains_plausible():
    m = KeyModel("k")
    m.ack_write(m.invoke_write(b"a"))
    m.timeout_write(m.invoke_write(b"b"))
    m.ack_read(b"b")
    m.ack_read(b"b")
    with pytest.raises(Violation):
        m.ack_read(b"a")


def test_model_timeout_op_may_land_late():
    m = KeyModel("k")
    m.ack_write(m.invoke_write(b"a"))
    m.timeout_write(m.invoke_write(NOTFOUND))
    m.ack_write(m.invoke_write(b"b"))
    m.ack_read(NOTFOUND)
    with pytest.raises(Violation):
        m.ack_read(b"never-written")


# -- models against the reference's on random histories --------------------


def _pkg(name):
    """``test_torch_scalar_plane``'s namespace of ``name``'s scalar-plane
    modules, with its ``linearizability`` as ``lin``."""
    from test_torch_scalar_plane import _namespace

    ns = _namespace(name)
    ns.lin = importlib.import_module(f"{name}.linearizability")
    return ns


def _norm(x):
    from test_torch_scalar_plane import norm
    return norm(x)


def _key_history(ns, seed, n_ops=60):
    """Drive ``ns``'s KeyModel through a seeded random history; the
    record of the model's state after every op and where it raised."""
    ns.lin._op_ids = itertools.count(1)
    rng = random.Random(seed)
    nf = ns.types.NOTFOUND
    m = ns.lin.KeyModel("k")
    values = [b"a", b"b", b"c", nf]
    open_ops = []
    out = []
    for i in range(n_ops):
        r = rng.random()
        try:
            if r < 0.3 or not open_ops and r < 0.6:
                open_ops.append(m.invoke_write(rng.choice(values)))
                what = "invoke"
            elif r < 0.6:
                op = open_ops.pop(rng.randrange(len(open_ops)))
                what = rng.choice(("ack", "ack", "fail", "timeout"))
                {"ack": m.ack_write, "fail": m.fail_write,
                 "timeout": m.timeout_write}[what](op)
            else:
                what = "read"
                # mostly a plausible value (in a package-neutral order),
                # else any value, a never-written one included
                valid = sorted(m.possible | m.maybe | {
                    w.value for w in m.inflight.values()},
                    key=lambda v: repr(_norm(v)))
                m.ack_read(rng.choice(valid) if rng.random() < 0.9
                           else rng.choice(values + [b"never"]))
        except ns.lin.Violation as v:
            # (sets print in hash order, which differs across packages)
            out.append((i, what, "violation",
                        str(v).split("; plausible")[0], _norm(m.possible),
                        _norm(m.maybe), _norm(m.inflight)))
            return out
        out.append((i, what, _norm(m.possible), _norm(m.maybe),
                    _norm(m.inflight)))
    out.append(("history", _norm(m.history)))
    return out


def _counter_history(ns, seed):
    rng = random.Random(seed)
    m = ns.lin.CounterModel("c", initial=rng.randrange(-10, 10))
    big = 2 ** 31 - 1
    for _ in range(rng.randrange(1, 30)):
        operand = rng.choice([rng.randrange(-50, 50), big, -big - 1])
        if rng.random() < 0.15:
            m.unknown(operand)
        else:
            m.ack(operand)
    final = m.initial + m.acked_sum + sum(
        op for op in m.ambiguous if rng.random() < 0.5)
    final += rng.choice([0, 0, 0, 1, -1, big])
    try:
        m.check_final(final)
        verdict = "ok"
    except ns.lin.Violation as v:
        verdict = str(v)
    return (m.acked_sum, m.n_acked, list(m.ambiguous), final, verdict)


@pytest.mark.parametrize("chunk", range(4))
def test_models_equal_the_reference_on_random_histories(chunk):
    pytest.importorskip("jax")
    ref, port = _pkg("riak_ensemble_tpu"), _pkg("riak_ensemble_tpu_torch")
    verdicts = set()
    for seed in range(chunk * 100, chunk * 100 + 100):
        want = _key_history(ref, seed)
        assert _key_history(port, seed) == want, seed
        verdicts.add(want[-1][0] != "history")
        assert _counter_history(port, seed) == _counter_history(ref, seed)
    assert verdicts == {True, False}


# -- Workload in lockstep ------------------------------------------------------


def _workload_run(ns, kind, seed):
    from test_torch_scalar_plane import _reset_counters, snapshot

    _reset_counters(ns)
    ns.lin._op_ids = itertools.count(1)
    if kind == "freezes":
        mc = ns.testing.ManagedCluster(seed=seed)
        mc.ens_start(3)
        w = ns.lin.Workload(mc, "root", n_workers=3, n_keys=3,
                            ops_per_worker=40, seed=seed)
        partitions = False
    else:
        mc = ns.testing.ManagedCluster(seed=seed,
                                       nodes=("node0", "node1", "node2"))
        mc.enable("node0")
        mc.join("node1", "node0")
        mc.join("node2", "node0")
        mc.create_ensemble("sc", [ns.types.PeerId(i, f"node{i}")
                                  for i in range(3)])
        mc.wait_stable("sc")
        if kind == "churn":
            w = ns.lin.Workload(mc, "sc", n_workers=3, n_keys=3,
                                ops_per_worker=30, op_timeout=1.5,
                                seed=seed, nemesis_hold=(0.3, 1.5),
                                member_churn=True)
        else:
            w = ns.lin.Workload(mc, "sc", n_workers=3, n_keys=3,
                                ops_per_worker=30, op_timeout=1.0,
                                seed=seed, nemesis_hold=(0.5, 2.5))
        partitions = True
    try:
        w.run(partitions=partitions)
        outcome = "ok"
    except ns.lin.Violation as v:
        outcome = str(v)
    return {"outcome": outcome, "op_counts": w.op_counts,
            "histories": {k: _norm(m.history) for k, m in w.models.items()},
            "now": mc.runtime.now, "snapshot": snapshot(ns, mc)}


@pytest.mark.parametrize("kind,seed", [("freezes", 101), ("freezes", 102),
                                       ("churn", 501), ("churn", 502),
                                       ("partitions", 201)])
def test_workload_lockstep_with_reference(kind, seed):
    pytest.importorskip("jax")
    ref = _workload_run(_pkg("riak_ensemble_tpu"), kind, seed)
    port = _workload_run(_pkg("riak_ensemble_tpu_torch"), kind, seed)
    for key in ref:
        assert port[key] == ref[key], key
    assert port["outcome"] == "ok"
    assert sum(port["op_counts"].values()) >= (120 if kind == "freezes"
                                               else 90)
    if kind == "partitions":
        events = {ev[0] for h in port["histories"].values() for ev in h}
        assert "ack" in events and "read" in events


# -- the service's read fast path under its nemesis ---------------------------


def _read_fastpath_sweep(seed, *, pipeline_depth=1, margin=None, rounds=40):
    config = fast_test_config()
    if margin is not None:
        config.read_lease_margin = margin
    runtime = Runtime(seed=seed)
    svc = BatchedEnsembleService(runtime, 4, 5, n_slots=8, tick=None,
                                 max_ops_per_tick=8, config=config,
                                 pipeline_depth=pipeline_depth,
                                 device="cpu")
    w = ServiceReadWorkload(svc, runtime, seed=seed, rounds=rounds)
    w.run()  # raises Violation on a stale or lost read
    assert isinstance(w.models[(0, "k0")], lin.KeyModel)
    return svc


@pytest.mark.parametrize("seed", [1201, 1202, 1203])
def test_service_read_fastpath_linearizable(seed):
    svc = _read_fastpath_sweep(seed)
    assert svc.read_fastpath_hits > 0
    assert svc.read_fastpath_misses > 0
    reasons = svc.read_fastpath_miss_reasons
    assert reasons.get("no_lease", 0) > 0, reasons
    assert reasons.get("pending_write", 0) > 0, reasons


@pytest.mark.parametrize("seed", [1301, 1302])
def test_service_read_fastpath_linearizable_pipelined(seed):
    svc = _read_fastpath_sweep(seed, pipeline_depth=2)
    assert svc.read_fastpath_hits > 0
    assert svc.read_fastpath_misses > 0


@pytest.mark.parametrize("seed", [1401])
def test_service_read_fastpath_skewed_margin(seed):
    wide_margin = fast_test_config().lease() * 0.9
    svc = _read_fastpath_sweep(seed, margin=wide_margin)
    assert svc.read_fastpath_misses > 0
    assert svc.read_fastpath_miss_reasons.get("no_lease", 0) > 0

