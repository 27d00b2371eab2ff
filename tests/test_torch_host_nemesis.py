"""The port's replication group across OS-process failure domains under
a host nemesis — the mirror of the reference's process-host scenarios,
with their seeds and shapes, on the CPU:

- ``tests/test_repgroup.py:275``: a SIGSTOP'd replica is a partition,
  not a death — commits go on at 2 of 3 by the ack deadline, and after
  SIGCONT it re-syncs and carries the quorum when the other one dies;
- ``tests/test_repgroup.py:304``: random put / get load while a nemesis
  kill -9s, SIGSTOPs and restarts the replica hosts (seeds 1101, 1102);
- ``tests/test_replace_hosts.py:253``: linearizable across a 3 -> 5
  membership transition (seed 2201);
- ``tests/test_comm_repl.py:663`` (``slow``, as in the reference):
  commutative convergence through a crash at the
  ``replica_apply_pre_ack`` barrier, a restart and a handoff.

The leader is the port's ``ReplicatedService`` in this process on the
CPU; each replica host is ``python -m
riak_ensemble_tpu_torch.parallel.repgroup --device cpu``.  The port's
``KeyModel`` / ``CounterModel`` check every op: an acknowledged write
lost, a stale or resurrected read, a counter over- or undershooting its
acknowledged operands raises.  A put that failed for want of a host
quorum is ambiguous (it applied on the surviving lanes) and joins the
plausible set as a timed-out write, as in the reference.
"""

import signal
import time

import numpy as np
import pytest

from riak_ensemble_tpu_torch import faults, funref
from riak_ensemble_tpu_torch.config import fast_test_config
from riak_ensemble_tpu_torch.linearizability import CounterModel, KeyModel
from riak_ensemble_tpu_torch.parallel import repgroup
from riak_ensemble_tpu_torch.parallel.batched_host import WallRuntime
from riak_ensemble_tpu_torch.types import NOTFOUND

from test_torch_fault_nemesis import int_read, soak_seeds, spawn_replica

N_ENS = 4
N_SLOTS = 8
#: the membership case's slots: its writes take ~12 keys an ensemble
N_SLOTS_MEMBERS = 32
#: the in-process leader's identity in member lists
LEADER_ADDR = ("leader.test", 1)


def _make_leader(tmp_path, repl_ports, ack_timeout=15.0, n_slots=N_SLOTS,
                 **kw):
    svc = repgroup.ReplicatedService(
        WallRuntime(), N_ENS, 1, n_slots, group_size=3,
        peers=[("127.0.0.1", p) for p in repl_ports],
        ack_timeout=ack_timeout, config=fast_test_config(),
        data_dir=str(tmp_path / "leader"), device="cpu", **kw)
    assert svc.takeover(), "takeover needs a majority of replicas"
    return svc


def _restart(procs, dirs, name):
    """Restart a dead replica on ITS OWN ports and data dir."""
    _, repl, client = procs[name]
    procs[name] = spawn_replica(dirs[name], repl_port=repl,
                                client_port=client)
    return procs[name]


def _settle(svc, futs, flushes=5):
    for _ in range(flushes):
        if all(f.done for f in futs):
            break
        svc.flush()
    assert all(f.done for f in futs)
    return [f.value for f in futs]


def _wait_synced(svc, n, deadline=60.0):
    """Heartbeat until n peers are connected AND re-synced (an idle
    leader drives liveness through empty applies)."""
    end = time.monotonic() + deadline
    while time.monotonic() < end:
        svc.heartbeat()
        if svc.stats()["group"]["peers_synced"] >= n:
            return
        time.sleep(0.1)
    raise AssertionError(f"peers never re-synced: {svc.stats()['group']}")


def _kill_all(procs):
    for p, _r, _c in procs.values():
        if p.poll() is None:
            p.send_signal(signal.SIGCONT)
            p.kill()
        p.wait()


def _random_ops(svc, rng, model, vals):
    """Six random puts (60 %) and gets on 4 ensembles x 3 keys."""
    pending = []
    for _ in range(6):
        e, k = int(rng.integers(N_ENS)), int(rng.integers(3))
        m = model(e, k)
        if rng.random() < 0.6:
            v = next(vals)
            pending.append(("put", m, m.invoke_write(v),
                            svc.kput(e, f"k{k}", v.to_bytes(4, "big"))))
        else:
            pending.append(("get", m, None, svc.kget(e, f"k{k}")))
    return pending


def _observe(pending):
    for kind, m, op, f in pending:
        assert f.done
        ok = isinstance(f.value, tuple) and f.value[0] == "ok"
        if kind == "get":
            int_read(m, f.value)
        elif ok:
            m.ack_write(op)
        else:
            m.timeout_write(op)


def _read_back(svc, models, flushes):
    pending = [(m, svc.kget(e, f"k{k}")) for (e, k), m in models.items()]
    for _ in range(flushes):
        if all(f.done for _m, f in pending):
            break
        svc.flush()
    for m, f in pending:
        assert f.done and isinstance(f.value, tuple) \
            and f.value[0] == "ok", f.value
        int_read(m, f.value)


@pytest.fixture
def group(tmp_path):
    procs, dirs = {}, {}
    for name in ("r1", "r2"):
        dirs[name] = str(tmp_path / name)
        procs[name] = spawn_replica(dirs[name])
    svc = _make_leader(tmp_path, [procs["r1"][1], procs["r2"][1]])
    yield svc, procs, dirs
    svc.stop()
    _kill_all(procs)


def test_partition_sigstop_excludes_then_heals(group):
    """A SIGSTOP'd replica is a network partition, not a death: its
    socket stays open and frames back up.  The leader commits without it
    (the ack deadline decides, not a blocking send), and after SIGCONT
    the replica re-syncs and carries the quorum once the other dies."""
    svc, procs, _dirs = group
    svc.ack_timeout = 3.0
    p1, _, _ = procs["r1"]

    _settle(svc, [svc.kput(0, "a", b"1")])
    p1.send_signal(signal.SIGSTOP)
    try:
        futs = [svc.kput(0, "b", b"2"), svc.kput(1, "c", b"3")]
        _settle(svc, futs)
        assert all(f.value[0] == "ok" for f in futs), \
            [f.value for f in futs]
    finally:
        p1.send_signal(signal.SIGCONT)
    _wait_synced(svc, 2)
    p2, _, _ = procs["r2"]
    p2.send_signal(signal.SIGKILL)
    p2.wait()
    futs = [svc.kget(0, "a"), svc.kget(0, "b"), svc.kget(1, "c")]
    _settle(svc, futs)
    assert [f.value for f in futs] == \
        [("ok", b"1"), ("ok", b"2"), ("ok", b"3")]


@pytest.mark.parametrize("seed", soak_seeds([1101, 1102]))
def test_repgroup_linearizable_under_host_nemesis(tmp_path, seed):
    """sc.erl over host failure domains: random put / get load against
    the leader while a nemesis kill -9s, SIGSTOPs and restarts the
    replica hosts; every acknowledged write reads back after the heal."""
    rng = np.random.default_rng(seed)
    procs, dirs = {}, {}
    for name in ("r1", "r2"):
        dirs[name] = str(tmp_path / name)
        procs[name] = spawn_replica(dirs[name])
    svc = _make_leader(tmp_path, [procs["r1"][1], procs["r2"][1]],
                       ack_timeout=4.0)
    models = {}
    stopped = set()
    vals = iter(range(1, 100000))

    def model(e, k):
        return models.setdefault((e, k), KeyModel(f"{e}/k{k}"))

    def heal():
        for name in ("r1", "r2"):
            p, _, _ = procs[name]
            if name in stopped:
                p.send_signal(signal.SIGCONT)
                stopped.discard(name)
            elif p.poll() is not None:
                _restart(procs, dirs, name)

    try:
        for _rnd in range(12):
            r = rng.random()
            if r < 0.25:
                name = ("r1", "r2")[int(rng.integers(2))]
                p, _, _ = procs[name]
                if p.poll() is None and name not in stopped:
                    if rng.random() < 0.5:
                        p.send_signal(signal.SIGSTOP)
                        stopped.add(name)
                    else:
                        p.send_signal(signal.SIGKILL)
                        p.wait()
            elif r < 0.5:
                heal()
            pending = _random_ops(svc, rng, model, vals)
            for _ in range(8):
                if all(f.done for *_x, f in pending):
                    break
                svc.flush()
            _observe(pending)
        heal()
        _wait_synced(svc, 2, deadline=120.0)
        _read_back(svc, models, flushes=10)
    finally:
        svc.stop()
        _kill_all(procs)


def _drive_until(svc, cond, deadline=120.0, what="condition"):
    end = time.monotonic() + deadline
    while time.monotonic() < end:
        svc.heartbeat()
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"{what} never reached: {svc.membership_status()}"
                         f" / {svc.stats()['group']}")


@pytest.mark.parametrize("seed", soak_seeds([2201]))
def test_linearizable_across_membership_transition(tmp_path, seed):
    """sc.erl across the transition window: random put / get load runs
    while the group grows 3 -> 5; every acknowledged write reads back
    through the collapsed 5-host group."""
    rng = np.random.default_rng(seed)
    procs, dirs = {}, {}
    models = {}
    vals = iter(range(1, 100000))

    def model(e, k):
        return models.setdefault((e, k), KeyModel(f"{e}/k{k}"))

    def spawn(name):
        dirs[name] = str(tmp_path / name)
        procs[name] = spawn_replica(dirs[name], n_slots=N_SLOTS_MEMBERS)

    svc = None
    try:
        for name in ("r1", "r2"):
            spawn(name)
        svc = _make_leader(tmp_path, [procs["r1"][1], procs["r2"][1]],
                           ack_timeout=6.0, n_slots=N_SLOTS_MEMBERS,
                           self_addr=LEADER_ADDR)
        new = None
        for rnd in range(10):
            if rnd == 3:                # mid-run: start the grow
                for name in ("r3", "r4"):
                    spawn(name)
                new = [LEADER_ADDR] + [("127.0.0.1", procs[n][1])
                                       for n in ("r1", "r2", "r3", "r4")]
                svc.update_members(new)
            pending = _random_ops(svc, rng, model, vals)
            for _ in range(10):
                if all(f.done for *_x, f in pending):
                    break
                svc.flush()
            _observe(pending)
        assert new is not None

        def collapsed():
            st = svc.membership_status()
            return (not st["transition"] and st["joint"] is None
                    and st["hosts"] is not None
                    and set(map(tuple, st["hosts"])) == set(new))
        _drive_until(svc, collapsed, what="collapse")
        _read_back(svc, models, flushes=12)
    finally:
        if svc is not None:
            svc.stop()
        _kill_all(procs)


def _counter_val(res):
    """A kget result as an int counter (the engine encodes 0 as
    NOTFOUND, the inline tombstone convention)."""
    assert res[0] == "ok", res
    return 0 if res[1] is NOTFOUND or res[1] == NOTFOUND else int(res[1])


@pytest.mark.slow
def test_comm_randomized_convergence_crash_and_handoff(tmp_path):
    """Randomized commutative and ordered load under drop / RTT churn,
    replica r1 killed at the ``replica_apply_pre_ack`` barrier (its WAL
    holds applies past its last ack: the retransmit discipline must
    absorb them, not merge them twice), restarted, re-synced, and
    finally carrying the quorum ALONE after r2 dies.  ``CounterModel``
    holds every final to the acknowledged-operand sum plus a subset of
    the ambiguous ones; a CAS token minted after the handoff swaps."""
    rng = np.random.default_rng(20818)
    procs, dirs = {}, {}
    for name in ("r1", "r2"):
        dirs[name] = str(tmp_path / name)
    procs["r1"] = spawn_replica(
        dirs["r1"], env={"RETPU_CRASHPOINT": "replica_apply_pre_ack:4"})
    procs["r2"] = spawn_replica(dirs["r2"])
    svc = _make_leader(tmp_path, [procs["r1"][1], procs["r2"][1]],
                       ack_timeout=5.0)
    plan = faults.install(faults.FaultPlan(seed=20818))
    labels = [lk.label for lk in svc._links]
    ctrs = {(e, k): CounterModel(f"{e}/c{k}")
            for e in range(4) for k in range(2)}
    keymods = {e: KeyModel(f"{e}/ord") for e in range(4)}

    def settle(futs, budget=45.0):
        end = time.monotonic() + budget
        while not all(f.done for f in futs) and time.monotonic() < end:
            svc.flush()
            time.sleep(0.005)
        assert all(f.done for f in futs), "futures never settled"

    def classify(pending):
        for m, tag, f in pending:
            ok = isinstance(f.value, tuple) and f.value[0] == "ok"
            if isinstance(m, CounterModel):
                m.ack(tag) if ok else m.unknown(tag)
            else:
                m.ack_write(tag) if ok else m.timeout_write(tag)

    restarted = False
    try:
        for rnd in range(10):
            # churn on two rounds only: the reachable-sum set is 2^n
            if rnd in (2, 6):
                lab = labels[int(rng.integers(len(labels)))]
                if rng.random() < 0.5:
                    plan.drop(faults.LOCAL, lab)
                else:
                    plan.drop(lab, faults.LOCAL)
            elif rnd in (3, 7):
                plan.set_rtt(faults.LOCAL,
                             labels[int(rng.integers(len(labels)))],
                             float(rng.uniform(1.0, 3.0)))
            else:
                plan.heal()
            pending = []
            for _ in range(8):
                e = int(rng.integers(4))
                if rng.random() < 0.7:
                    k = int(rng.integers(2))
                    opd = int(rng.integers(-50, 50))
                    name = "rmw:add" if rng.random() < 0.7 else "rmw:sub"
                    # one attempt: an internal retry of a quorum-failed
                    # round could land an operand twice
                    fut = svc.kmodify(e, f"c{k}", funref.ref(name, abs(opd)),
                                      0, retries=1)
                    signed = abs(opd) if name == "rmw:add" else -abs(opd)
                    pending.append((ctrs[(e, k)], signed, fut))
                else:
                    m = keymods[e]
                    v = b"o%d-%d" % (rnd, int(rng.integers(1000)))
                    pending.append((m, m.invoke_write(v),
                                    svc.kput(e, "ord", v)))
            settle([f for *_x, f in pending])
            classify(pending)
            if not restarted and procs["r1"][0].poll() is not None:
                # the crashpoint fired mid-stream: bring r1 back on its
                # own ports and data, and let the leader re-sync it
                assert procs["r1"][0].poll() == faults.CRASH_EXIT
                plan.heal()
                _restart(procs, dirs, "r1")
                _wait_synced(svc, 2)
                restarted = True
        plan.heal()
        if not restarted:
            # drive applies until the barrier fires (heartbeats are
            # empty applies), then recover the host
            end = time.monotonic() + 90.0
            while procs["r1"][0].poll() is None and time.monotonic() < end:
                svc.heartbeat()
                time.sleep(0.05)
            assert procs["r1"][0].poll() == faults.CRASH_EXIT, \
                "replica never died at replica_apply_pre_ack"
            _restart(procs, dirs, "r1")
            _wait_synced(svc, 2)
        # handoff: the once-crashed host carries the quorum alone
        p2, _, _ = procs["r2"]
        p2.send_signal(signal.SIGKILL)
        p2.wait()
        post = [(m, 11, svc.kmodify(e, f"c{k}", funref.ref("rmw:add", 11),
                                    0, retries=1))
                for (e, k), m in ctrs.items()]
        settle([f for *_x, f in post], budget=60.0)
        classify(post)
        finals = [svc.kget(e, f"c{k}") for (e, k) in ctrs]
        settle(finals, budget=60.0)
        for m, f in zip(ctrs.values(), finals):
            m.check_final(_counter_val(f.value))
        assert sum(m.n_acked for m in ctrs.values()) > 20
        reads = [svc.kget(e, "ord") for e in range(4)]
        settle(reads, budget=60.0)
        for e, f in enumerate(reads):
            if isinstance(f.value, tuple) and f.value[0] == "ok":
                keymods[e].ack_read(f.value[1])
        # a CAS token minted through the commutative lane survives the
        # handoff: read the version, then swap
        gv = svc.kget_vsn(0, "c0")
        settle([gv], budget=30.0)
        assert gv.value[0] == "ok"
        cu = svc.kupdate(0, "c0", tuple(gv.value[2]), b"swapped")
        settle([cu], budget=30.0)
        assert cu.value[0] == "ok", cu.value
    finally:
        faults.clear()
        try:
            svc.stop()
        except repgroup.DeposedError:
            pass
        _kill_all(procs)
