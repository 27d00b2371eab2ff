"""The three nemesis sweeps of ``tests/test_service_linearizability.py``
(``:122-210``, ``:213``, ``:304``) on the port, in lockstep with the JAX
service, with the port's ``linearizability.KeyModel`` as the
checker of the port's futures.

Each seed is one schedule: the leader killed right before the flush that
carries the round's ops (the election folds into that launch), peers
healed, virtual time jumped past the lease so leased reads race expiry,
and per sweep:

- membership churn through ``update_members`` (one member out, or the
  full view back) at depth 1, and at depth 2 with ``max_ops_per_tick=4``;
- seeded launch failures injected through ``engine=`` (the CPU launch
  rolls the state and the host mirrors back);
- replica corruption (object, leaf and upper-node lanes on a minority of
  replicas) mid-run, then an exchange over every ensemble before the
  read-back, after which every lane that carries data verifies.

Both services get the same calls; every future resolves to the same
value in both packages (``NOTFOUND`` normalised), the nemesis decisions
read mirrors that are equal in both, and the quiesced read-back sees
every acknowledged write (the checker raises otherwise).  One seed per
sweep runs in tier-1; the wider seed lists carry the ``slow`` marker.
"""

import itertools

import numpy as np
import pytest
import torch

from riak_ensemble_tpu_torch import interop
from riak_ensemble_tpu_torch import runtime as trt
from riak_ensemble_tpu_torch.config import fast_test_config as t_config
from riak_ensemble_tpu_torch.linearizability import KeyModel
from riak_ensemble_tpu_torch.ops import engine as teng
from riak_ensemble_tpu_torch.parallel import batched_host as tb
from riak_ensemble_tpu_torch.types import NOTFOUND as T_NOTFOUND
from test_torch_compaction import norm
from test_torch_reference_natives import reference_natives  # noqa: F401 (autouse)

N_ENS = 6
N_PEERS = 5
N_KEYS = 3
ROUNDS = 35
FAIL = "injected-launch-failure"


class Sweep:
    """The JAX service and the port's on their own simulator runtimes
    (same seed), one nemesis and one workload for both."""

    def __init__(self, monkeypatch, seed, depth=1, max_k=8, failing=False):
        pytest.importorskip("jax")
        monkeypatch.setenv("RETPU_OBS", "0")
        from riak_ensemble_tpu import runtime as jrt
        from riak_ensemble_tpu.config import fast_test_config as j_config
        from riak_ensemble_tpu.parallel import batched_host as jb
        self.rng = np.random.default_rng(seed)
        self.seed = seed
        self.rts = (jrt.Runtime(seed=seed), trt.Runtime(seed=seed))
        self.config = t_config()
        engines = (None, None)
        self.failures = [0, 0]
        if failing:
            engines = (self._failing(jb._LocalEngine, seed),
                       self._failing(tb._LocalEngine, seed))
        self.svcs = (
            jb.BatchedEnsembleService(
                self.rts[0], N_ENS, N_PEERS, n_slots=8, tick=None,
                max_ops_per_tick=max_k, config=j_config(),
                pipeline_depth=depth, engine=engines[0]),
            tb.BatchedEnsembleService(
                self.rts[1], N_ENS, N_PEERS, n_slots=8, tick=None,
                max_ops_per_tick=max_k, config=self.config,
                pipeline_depth=depth, engine=engines[1], device="cpu"))
        self.ts = self.svcs[1]
        self.models = {(e, k): KeyModel(f"{e}/key{k}")
                       for e in range(N_ENS) for k in range(N_KEYS)}
        self.vals = itertools.count(1)
        self.vsns = {}
        self.down = {}

    @staticmethod
    def _failing(base, seed):
        """An engine whose full steps fail on a seeded schedule: one of
        the first six launches for sure, then ~15 % (the reference's
        sweep, ``test_service_linearizability.py:213``)."""
        inject = np.random.default_rng(seed + 50_000)
        forced = 1 + int(inject.integers(6))
        count = [0]

        class Failing(base):
            def full_step(self, *a, **kw):
                count[0] += 1
                if count[0] == forced or inject.random() < 0.15:
                    raise RuntimeError(FAIL)
                return base.full_step(*a, **kw)
        return Failing()

    def call(self, fn):
        return tuple(fn(s) for s in self.svcs)

    def same_mirrors(self):
        for name in ("leader_np", "member_np", "up"):
            assert np.array_equal(getattr(self.svcs[0], name),
                                  getattr(self.ts, name)), name

    def flush(self, tolerate=False):
        errs = []
        for i, svc in enumerate(self.svcs):
            try:
                svc.flush()
                errs.append(None)
            except RuntimeError as exc:
                if not tolerate or FAIL not in str(exc):
                    raise
                self.failures[i] += 1
                errs.append(FAIL)
        assert errs[0] == errs[1]

    def drain(self, pending, max_flushes=10, tolerate=False):
        for _ in range(max_flushes):
            if all(f.done for *_x, futs, _p in pending for f in futs):
                break
            self.flush(tolerate)
            for rt in self.rts:
                rt.run_for(0.001)
        else:
            raise AssertionError("ops never resolved")
        for *_x, (jf, tf), _p in pending:
            assert norm(tf.value) == norm(jf.value)

    def apply(self, pending):
        """The reference's ``_apply_outcomes`` on the port's futures."""
        for kind, model, op_id, (_jf, tf), _payload in pending:
            r = tf.value
            if kind in ("put", "del"):
                if isinstance(r, tuple) and r[0] == "ok":
                    model.ack_write(op_id)
                else:
                    model.fail_write(op_id)
            elif isinstance(r, tuple) and r[0] == "ok":
                model.ack_read(r[1])

    def submit(self):
        """The reference's ``_submit_batch``: puts, CAS on the last acked
        version (sometimes stale), reads and deletes, drawn once and sent
        to both services."""
        rng, pending = self.rng, []
        for _ in range(int(rng.integers(2, 8))):
            e = int(rng.integers(N_ENS))
            k = int(rng.integers(N_KEYS))
            m = self.models[(e, k)]
            key = f"key{k}"
            op = rng.random()
            if op < 0.55:
                payload = f"{self.seed}-{next(self.vals)}".encode()
                op_id = m.invoke_write(payload)
                if op < 0.4:
                    futs = self.call(lambda s: s.kput(e, key, payload))
                else:
                    exp = self.vsns.get((e, k), (0, 0))
                    futs = self.call(lambda s: s.kupdate(e, key, exp,
                                                         payload))
                if futs[1].done and futs[1].value == "failed":
                    assert futs[0].done and futs[0].value == "failed"
                    m.fail_write(op_id)
                else:
                    pending.append(("put", m, op_id, futs, payload))

                def track(res, ek=(e, k)):
                    if isinstance(res, tuple) and res[0] == "ok":
                        self.vsns[ek] = res[1]
                futs[1].add_waiter(track)
            elif op < 0.85:
                pending.append(("get", m, None,
                                self.call(lambda s: s.kget(e, key)), None))
            else:
                op_id = m.invoke_write(T_NOTFOUND)
                futs = self.call(lambda s: s.kdelete(e, key))
                if futs[1].done:
                    assert futs[0].done
                    assert norm(futs[1].value) == norm(futs[0].value)
                    m.ack_write(op_id)
                else:
                    pending.append(("del", m, op_id, futs, None))
        return pending

    def kill_leader(self, e, spare=()):
        ts = self.ts
        if e not in self.down and ts.leader_np[e] >= 0:
            p = int(ts.leader_np[e])
            if p not in spare:
                self.call(lambda s: s.set_peer_up(e, p, False))
                self.down[e] = p

    def heal_one(self):
        e = list(self.down)[int(self.rng.integers(len(self.down)))]
        p = self.down.pop(e)
        self.call(lambda s: s.set_peer_up(e, p, True))

    def lease_race(self):
        if self.rng.random() < 0.3:
            for rt in self.rts:
                rt.run_for(self.config.lease() * 2.5)

    def quiesce(self, tolerate=False, exchange=False):
        """Heal every peer, fold in the elections, (optionally) run the
        exchange over every ensemble, and read every key back through
        the checker."""
        for e, p in list(self.down.items()):
            self.call(lambda s: s.set_peer_up(e, p, True))
        for _ in range(10):
            before = list(self.failures)
            self.flush(tolerate)
            if self.failures == before:
                break
        if exchange:
            self.exchange_all()
        pending = [("get", m, None,
                    self.call(lambda s: s.kget(e, f"key{k}")), None)
                   for (e, k), m in self.models.items()]
        self.drain(pending, max_flushes=25, tolerate=tolerate)
        self.apply(pending)
        served = sum(1 for m in self.models.values()
                     for ev in m.history if ev[0] == "read")
        assert served >= len(self.models)
        js, ts = self.svcs
        tn = interop.state_to_numpy(ts.state)
        for f in tn._fields:
            assert np.array_equal(np.asarray(getattr(js.state, f)),
                                  getattr(tn, f)), f
        for name in ("leader_np", "lease_until", "_slot_vsn_np",
                     "_slot_vsn_ok", "_corrupt_rows"):
            assert np.array_equal(getattr(js, name), getattr(ts, name)), \
                name
        assert (ts.corruptions, ts.repairs) == (js.corruptions, js.repairs)

    def exchange_all(self):
        import jax.numpy as jnp
        js, ts = self.svcs
        js.state, _d, jsync = js.engine.exchange_step(
            js.state, jnp.ones((N_ENS,), bool), jnp.asarray(js.up))
        ts.state, _d, tsync = ts.engine.exchange_step(
            ts.state, torch.ones((N_ENS,), dtype=torch.bool),
            torch.from_numpy(ts.up.copy()))
        assert bool(np.asarray(jsync).all()) and bool(tsync.all())


def _nemesis_sweep(monkeypatch, seed, depth, max_k=8):
    """``test_service_linearizability.py:136-210``: leader kills, heals,
    membership churn and lease races."""
    sw = Sweep(monkeypatch, seed, depth, max_k)
    rng, ts = sw.rng, sw.ts
    churned = 0
    for _round in range(ROUNDS):
        sw.same_mirrors()
        r = rng.random()
        if r < 0.25 and sw.down:
            sw.heal_one()
        elif r < 0.55:
            sw.kill_leader(int(rng.integers(N_ENS)))
        elif r < 0.7:
            e = int(rng.integers(N_ENS))
            sel = np.zeros((N_ENS,), bool)
            sel[e] = True
            nv = ts.member_np.copy()
            if nv[e].sum() == N_PEERS:
                victim = int(rng.integers(N_PEERS))
                if victim != ts.leader_np[e]:
                    nv[e, victim] = False
            else:
                nv[e] = True
            changed = sw.call(lambda s: s.update_members(sel, nv))
            assert np.array_equal(changed[0], changed[1])
            churned += int(changed[1].sum())
        pending = sw.submit()
        sw.lease_race()
        sw.drain(pending)
        sw.apply(pending)
    sw.quiesce()
    assert ts.flushes == sw.svcs[0].flushes >= ROUNDS // 2
    return churned


@pytest.mark.parametrize("seed", [701])
def test_port_linearizable_under_nemesis(monkeypatch, seed):
    assert _nemesis_sweep(monkeypatch, seed, depth=1) > 0


@pytest.mark.parametrize("seed", [711])
def test_port_linearizable_under_nemesis_pipelined(monkeypatch, seed):
    _nemesis_sweep(monkeypatch, seed, depth=2, max_k=4)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [702, 703, 704, 705, 706])
def test_port_linearizable_under_nemesis_sweep(monkeypatch, seed):
    _nemesis_sweep(monkeypatch, seed, depth=1)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [712, 713])
def test_port_linearizable_under_nemesis_pipelined_sweep(monkeypatch, seed):
    _nemesis_sweep(monkeypatch, seed, depth=2, max_k=4)


def _launch_failure_sweep(monkeypatch, seed):
    """``test_service_linearizability.py:213``: seeded launch failures
    join the leader kills; the CPU launch rolls back."""
    sw = Sweep(monkeypatch, seed, failing=True)
    rng = sw.rng
    for _round in range(ROUNDS):
        sw.same_mirrors()
        r = rng.random()
        if r < 0.3 and sw.down:
            sw.heal_one()
        elif r < 0.6:
            sw.kill_leader(int(rng.integers(N_ENS)))
        pending = sw.submit()
        sw.lease_race()
        sw.drain(pending, max_flushes=25, tolerate=True)
        sw.apply(pending)
    sw.quiesce(tolerate=True)
    assert sw.failures[1] == sw.failures[0] > 0


@pytest.mark.parametrize("seed", [801])
def test_port_linearizable_across_launch_failures(monkeypatch, seed):
    _launch_failure_sweep(monkeypatch, seed)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [802, 803, 804])
def test_port_linearizable_across_launch_failures_sweep(monkeypatch, seed):
    _launch_failure_sweep(monkeypatch, seed)


def _corruption_sweep(monkeypatch, seed):
    """``test_service_linearizability.py:304``: object, leaf and upper
    node lanes of replicas 2 and 3 (a minority) are damaged mid-run in
    both services alike; after the read-back every lane that carries
    data verifies."""
    import jax.numpy as jnp
    sw = Sweep(monkeypatch, seed)
    rng = sw.rng
    js, ts = sw.svcs
    injected = 0

    def corrupt_lane():
        nonlocal injected
        e = int(rng.integers(N_ENS))
        p = int(rng.integers(2, 4))
        s = int(rng.integers(ts.n_slots))
        mode = int(rng.integers(3))
        st = js.state
        if mode == 0:
            v = int(rng.integers(1 << 20, 1 << 21))
            js.state = st._replace(obj_val=st.obj_val.at[e, p, s].set(v))
            ts.state.obj_val[e, p, s] = v
        elif mode == 1:
            js.state = st._replace(tree_leaf=st.tree_leaf.at[e, p, s, :]
                                   .set(jnp.uint32(0xDEADBEEF)))
            ts.state.tree_leaf[e, p, s, :] = 0xDEADBEEF - (1 << 32)
        else:
            u = int(rng.integers(st.tree_node.shape[2]))
            js.state = st._replace(tree_node=st.tree_node.at[e, p, u, :]
                                   .set(jnp.uint32(0xBADBAD)))
            ts.state.tree_node[e, p, u, :] = 0xBADBAD
        injected += 1

    for _round in range(ROUNDS):
        sw.same_mirrors()
        r = rng.random()
        if r < 0.2 and sw.down:
            sw.heal_one()
        elif r < 0.45:
            sw.kill_leader(int(rng.integers(N_ENS)), spare=(2, 3))
        elif r < 0.8:
            corrupt_lane()
        pending = sw.submit()
        sw.lease_race()
        sw.drain(pending)
        sw.apply(pending)
    assert injected > 0 and ts.corruptions > 0
    sw.quiesce(exchange=True)
    st = ts.state
    obj_exists = (st.obj_seq > 0).numpy()
    leaf_ok = (teng.hashk.obj_leaf_hash(st.obj_epoch, st.obj_seq,
                                        st.obj_val)
               == st.tree_leaf).all(-1).numpy()
    assert (leaf_ok | ~obj_exists).all(), "committed data not healed"


@pytest.mark.parametrize("seed", [901])
def test_port_linearizable_under_corruption_nemesis(monkeypatch, seed):
    _corruption_sweep(monkeypatch, seed)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [902, 903, 904])
def test_port_linearizable_under_corruption_nemesis_sweep(monkeypatch,
                                                          seed):
    _corruption_sweep(monkeypatch, seed)
