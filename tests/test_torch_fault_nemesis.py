"""The port's one-directional-partition nemesis — the mirror of
``tests/test_fault_nemesis.py``, with its seeds and shapes, on the CPU:

- the scalar peer plane: the port's ``Workload(oneway_partitions=True)``
  on the port's ``ManagedCluster`` (the deterministic simulator), with
  the reference's assertions, and in lockstep with the reference's
  ``Workload`` on the reference's cluster: the same op mix, the same
  history of every key, the same virtual clock, the same cluster
  snapshot at the end (``test_torch_scalar_plane.snapshot``) and the
  same fault-plan counters;
- the replication group: a live 3-host group (the leader and two
  replica hosts in this process, or two replica processes of the port's
  ``python -m riak_ensemble_tpu_torch.parallel.repgroup --device cpu``)
  whose leader's quorum traffic is blackholed in ONE direction while its
  client surface stays up: a deposed leader stops acking before the new
  leader's first commit, checked by the port's ``KeyModel`` over every
  op.

The randomized sweeps and the live-group scenarios carry the ``slow``
marker, as in the reference; :func:`soak_seeds` widens their seed lists
through ``RETPU_SOAK_SEEDS="start:count"`` as the reference's
``conftest.soak_seeds`` does (these files run under ``--noconftest``
on a machine without JAX).
"""

import asyncio
import itertools
import os
import select
import signal
import socket
import subprocess
import sys
import time
import types

import numpy as np
import pytest

from riak_ensemble_tpu_torch import faults, linearizability, svcnode, testing
from riak_ensemble_tpu_torch import types as port_types
from riak_ensemble_tpu_torch.config import fast_test_config
from riak_ensemble_tpu_torch.linearizability import KeyModel
from riak_ensemble_tpu_torch.parallel import repgroup
from riak_ensemble_tpu_torch.parallel.batched_host import WallRuntime
from riak_ensemble_tpu_torch.types import NOTFOUND

N_ENS = 4
N_SLOTS = 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def soak_seeds(base):
    """The fixed seed list, or ``RETPU_SOAK_SEEDS="start:count"``'s fresh
    seeds (the reference's ``conftest.soak_seeds``)."""
    spec = os.environ.get("RETPU_SOAK_SEEDS")
    if not spec:
        return base
    start, count = (int(x) for x in spec.split(":"))
    return list(range(start, start + count))


def spawn_replica(data_dir, n_ens=N_ENS, n_slots=N_SLOTS, repl_port=0,
                  client_port=0, env=None):
    """One port replica host as a fresh interpreter on the CPU, at 3
    hosts; returns ``(process, repl port, client port)`` once it serves.
    A restart passes its old ports, as a rebooted machine keeps its
    address.  Its stdout is left unread after the banner line."""
    p = subprocess.Popen(
        [sys.executable, "-m", "riak_ensemble_tpu_torch.parallel.repgroup",
         "--device", "cpu", "--n-ens", str(n_ens), "--group-size", "3",
         "--n-slots", str(n_slots), "--fast", "--repl-port", str(repl_port),
         "--client-port", str(client_port), "--data-dir", data_dir],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True, env=dict(os.environ, PYTHONPATH=ROOT, **(env or {})))
    ready, _w, _x = select.select([p.stdout], [], [], 120.0)
    if not ready:
        p.kill()
        p.wait()
        raise AssertionError("the replica process did not start in 120 s")
    line = p.stdout.readline()
    assert line.startswith("repgroup replica"), line
    parts = dict(kv.split("=") for kv in line.split()[2:])
    return p, int(parts["repl"]), int(parts["client"])


def control(port, frame, timeout=60.0):
    """One frame on a fresh connection to a host's replication port."""
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=timeout) as s:
        s.settimeout(timeout)
        repgroup.send_frame(s, frame)
        return repgroup.recv_frame(s)


def int_read(m, res):
    """An acknowledged read of a 4-byte big-endian value into ``m``."""
    if isinstance(res, tuple) and res[0] == "ok":
        v = res[1]
        m.ack_read(v if v is NOTFOUND else int.from_bytes(v, "big"))


@pytest.fixture(autouse=True)
def _no_leaked_fault_plan():
    faults.clear()
    yield
    faults.clear()


# -- scalar peer plane: one-way partitions on the simulator ------------------


#: the port's modules under the names of ``test_torch_scalar_plane``'s
#: package namespaces
PORT = types.SimpleNamespace(testing=testing, types=port_types,
                             lin=linearizability)


def _oneway_run(ns, seed, **kw):
    """The reference's scenario on ``ns``'s package: a 3-node ensemble
    under the random workload with the one-way partition arm."""
    mc = ns.testing.ManagedCluster(seed=seed,
                                   nodes=("node0", "node1", "node2"))
    mc.enable("node0")
    mc.join("node1", "node0")
    mc.join("node2", "node0")
    mc.create_ensemble("sc", [ns.types.PeerId(i, f"node{i}")
                              for i in range(3)])
    mc.wait_stable("sc")
    w = ns.lin.Workload(mc, "sc", seed=seed, oneway_partitions=True, **kw)
    w.run(partitions=True)
    return mc, w


SMOKE = dict(n_workers=3, n_keys=3, ops_per_worker=25, op_timeout=1.5,
             nemesis_hold=(0.3, 1.5))


@pytest.mark.parametrize("seed", [4202])
def test_scalar_oneway_partition_workload_smoke(seed):
    """The full random workload with the ONE-WAY partition nemesis arm on
    a 3-node ensemble of the port: every acked write observable, no
    stale or phantom read, and the asymmetric cuts really fired."""
    mc, w = _oneway_run(PORT, seed, **SMOKE)
    assert sum(w.op_counts.values()) >= 75
    plan = mc.runtime.net.plan
    assert plan is not None, "one-way nemesis arm never engaged"
    assert plan.dropped_frames > 0, \
        "one-way cuts were installed but no frame ever crossed them"
    # healed at the end: the evidence stays, the rules are gone
    assert not plan.active()


@pytest.mark.parametrize("seed", [4202])
def test_scalar_oneway_partition_workload_lockstep(seed):
    """The smoke on both packages from one seed, each package's id
    counters reset first: the same op counts, histories, clock, final
    cluster snapshot and fault-plan counters."""
    pytest.importorskip("jax")
    from test_torch_linearizability_harness import _norm, _pkg
    from test_torch_scalar_plane import _reset_counters, snapshot

    out = []
    for name in ("riak_ensemble_tpu", "riak_ensemble_tpu_torch"):
        ns = _pkg(name)
        _reset_counters(ns)
        ns.lin._op_ids = itertools.count(1)
        mc, w = _oneway_run(ns, seed, **SMOKE)
        out.append({"op_counts": w.op_counts,
                    "histories": {k: _norm(m.history)
                                  for k, m in w.models.items()},
                    "now": mc.runtime.now, "snapshot": snapshot(ns, mc),
                    "plan": mc.runtime.net.plan.counters()})
    ref, port = out
    for key in ref:
        assert port[key] == ref[key], key
    assert port["plan"]["dropped_frames"] > 0


@pytest.mark.slow
@pytest.mark.parametrize("seed", soak_seeds([4301, 4302, 4303]))
def test_scalar_oneway_partition_workload_sweep(seed):
    """Longer workloads, member churn AND one-way partitions together —
    the full adversarial schedule."""
    mc, w = _oneway_run(PORT, seed, n_workers=3, n_keys=4,
                        ops_per_worker=60, op_timeout=1.0,
                        nemesis_hold=(0.5, 2.5), member_churn=True)
    assert sum(w.op_counts.values()) >= 180
    # whether the one-way arm fired depends on the schedule; when it
    # did, its rules are healed and its drops counted
    plan = mc.runtime.net.plan
    if plan is not None:
        assert not plan.active()


# -- replication group: a live 3-host group ----------------------------------


def _inproc_group(tmp_path, ack_timeout=3.0):
    """The leader and two ``ReplicaServer`` hosts in this process — real
    sockets, the real protocol.  Each replica's own future links get a
    distinct fault label, so directional rules can aim at the OLD
    leader's links alone."""
    servers = []
    for i in (1, 2):
        s = repgroup.ReplicaServer(
            N_ENS, 3, N_SLOTS, data_dir=str(tmp_path / f"r{i}"),
            config=fast_test_config(), device="cpu")
        s.svc.fault_label = f"replica{i}"
        servers.append(s)
    svc = repgroup.ReplicatedService(
        WallRuntime(), N_ENS, 1, N_SLOTS, group_size=3,
        peers=[("127.0.0.1", s.repl_port) for s in servers],
        ack_timeout=ack_timeout, config=fast_test_config(),
        data_dir=str(tmp_path / "leader"), device="cpu")
    assert svc.takeover(), "takeover needs a replica majority"
    return svc, servers


def _settle(svc, futs, flushes=12):
    for _ in range(flushes):
        if all(f.done for f in futs):
            break
        try:
            svc.flush()
        except repgroup.DeposedError:
            break
    return [f.value if f.done else None for f in futs]


def _not_acked(f):
    return f.done and (not isinstance(f.value, tuple) or f.value[0] != "ok")


@pytest.mark.slow
def test_repgroup_oneway_blackhole_fences_deposed_leader(tmp_path):
    """The leader's quorum traffic is blackholed in the RETURN direction
    (its applies still reach the replicas, which may apply them, but
    every ack vanishes) while its client surface stays up.  From the
    first blackholed flush on it acks NOTHING; a replica promotes itself
    and commits; the ``KeyModel`` checks every key across the handoff;
    after the heal the old leader observes that it is deposed."""
    svc, (r1, r2) = _inproc_group(tmp_path, ack_timeout=2.0)
    models = {}

    def model(key):
        return models.setdefault(key, KeyModel(key))

    try:
        # -- healthy acked writes ---------------------------------------
        futs = []
        for i in range(4):
            m = model(f"pre{i}")
            op = m.invoke_write(b"p%d" % i)
            futs.append((m, op, svc.kput(i % N_ENS, f"pre{i}", b"p%d" % i)))
        _settle(svc, [f for *_x, f in futs])
        for m, op, f in futs:
            assert f.value[0] == "ok", f.value
            m.ack_write(op)

        # -- inbound blackhole: acks dropped, sends deliver -------------
        plan = faults.install(faults.FaultPlan())
        for link in svc._links:
            plan.drop(link.label, faults.LOCAL)
        dark = []
        for i in range(4):
            m = model(f"dark{i}")
            op = m.invoke_write(b"d%d" % i)
            dark.append((m, op, svc.kput(i % N_ENS, f"dark{i}", b"d%d" % i)))
        _settle(svc, [f for *_x, f in dark])
        for m, op, f in dark:
            assert _not_acked(f), \
                f"acked through a blackholed quorum: {f.value!r}"
            m.timeout_write(op)          # it may have applied: ambiguous
        g = svc.stats()["group"]
        assert g["quorum_failures"] > 0, g
        assert g["link_injected_drops"] > 0, g
        h = svc.health()
        assert h["injected"]["active"] is True
        assert any(lk["injected_drops"] > 0
                   for lk in h["group"]["links"]), h["group"]["links"]

        # -- replica 1 promotes itself and commits ----------------------
        resp = control(r1.repl_port, ("promote", [("127.0.0.1",
                                                   r2.repl_port)]))
        assert resp[0] == "ok", resp
        assert resp[1] > svc._ge

        async def new_leader_io():
            c = svcnode.ServiceClient("127.0.0.1", r1.client_port)
            await c.connect()
            m = model("newldr")
            op = m.invoke_write(b"n0")
            r = await c.kput(0, "newldr", b"n0", timeout=60.0)
            assert r[0] == "ok", r
            m.ack_write(op)
            for key, m in sorted(models.items()):
                r = await c.kget(0 if key == "newldr"
                                 else int(key[-1]) % N_ENS, key,
                                 timeout=60.0)
                assert r[0] == "ok", (key, r)
                m.ack_read(r[1])
            await c.close()

        asyncio.run(new_leader_io())

        # -- the deposed leader still cannot ack ------------------------
        m = model("stale")
        op = m.invoke_write(b"s0")
        f = svc.kput(0, "stale", b"s0")
        _settle(svc, [f])
        assert _not_acked(f), \
            f"deposed leader acked after the rival's commit: {f.value!r}"
        m.timeout_write(op)

        # -- heal: the old leader's next contact observes the fence -----
        plan.heal()
        try:
            for _ in range(6):
                svc.heartbeat()
                if svc._deposed:
                    break
                time.sleep(0.1)
        except repgroup.DeposedError:
            pass
        assert svc._deposed, "healed leader never observed the fence"
    finally:
        faults.clear()
        try:
            svc.stop()
        except repgroup.DeposedError:
            pass
        for s in (r1, r2):
            s.stop()


@pytest.mark.slow
@pytest.mark.parametrize("seed", soak_seeds([5101, 5102]))
def test_repgroup_oneway_nemesis_sweep(tmp_path, seed):
    """Randomized directional faults on a live 3-host group whose
    replica hosts are OS processes: each round toggles a one-way drop
    (either direction of either link), injects 1-3 ms of link RTT, or
    heals, while random put / get load runs through the leader under
    the ``KeyModel``.  Healed at the end, every key reads back through
    the leader, then through replica 1 after it takes over."""
    rng = np.random.default_rng(seed)
    plan = faults.install(faults.FaultPlan(seed=int(seed)))
    procs = {name: spawn_replica(str(tmp_path / name))
             for name in ("r1", "r2")}
    svc = repgroup.ReplicatedService(
        WallRuntime(), N_ENS, 1, N_SLOTS, group_size=3,
        peers=[("127.0.0.1", procs["r1"][1]),
               ("127.0.0.1", procs["r2"][1])],
        ack_timeout=3.0, config=fast_test_config(),
        data_dir=str(tmp_path / "leader"), device="cpu")
    assert svc.takeover()
    labels = [lk.label for lk in svc._links]
    models = {}
    vals = iter(range(1, 10 ** 6))

    def model(e, k):
        return models.setdefault((e, k), KeyModel(f"{e}/k{k}"))

    try:
        for _rnd in range(14):
            r = rng.random()
            lab = labels[int(rng.integers(len(labels)))]
            if r < 0.30:
                if rng.random() < 0.5:
                    plan.drop(faults.LOCAL, lab)     # requests die
                else:
                    plan.drop(lab, faults.LOCAL)     # acks die
            elif r < 0.45:
                plan.set_rtt(faults.LOCAL, lab, float(rng.uniform(1.0, 3.0)))
            elif r < 0.75:
                plan.heal()
            pending = []
            for _ in range(6):
                e, k = int(rng.integers(N_ENS)), int(rng.integers(3))
                m = model(e, k)
                if rng.random() < 0.6:
                    v = next(vals)
                    pending.append(("put", m, m.invoke_write(v), svc.kput(
                        e, f"k{k}", v.to_bytes(4, "big"))))
                else:
                    pending.append(("get", m, None, svc.kget(e, f"k{k}")))
            _settle(svc, [f for *_x, f in pending], flushes=10)
            for kind, m, op, f in pending:
                res = f.value if f.done else None
                ok = isinstance(res, tuple) and res[0] == "ok"
                if kind == "get":
                    int_read(m, res)
                elif ok:
                    m.ack_write(op)
                else:
                    m.timeout_write(op)              # it may have applied

        plan.heal()
        end = time.monotonic() + 90.0
        while time.monotonic() < end:
            svc.heartbeat()
            if svc.stats()["group"]["peers_synced"] >= 2:
                break
            time.sleep(0.1)
        pending = [(m, svc.kget(e, f"k{k}")) for (e, k), m in models.items()]
        _settle(svc, [f for _m, f in pending], flushes=12)
        for m, f in pending:
            assert f.done and isinstance(f.value, tuple) \
                and f.value[0] == "ok", f.value
            int_read(m, f.value)

        # handoff: replica 1 takes over; history must not have forked
        resp = control(procs["r1"][1],
                       ("promote", [("127.0.0.1", procs["r2"][1])]))
        assert resp[0] == "ok", resp

        async def read_through_new_leader():
            c = svcnode.ServiceClient("127.0.0.1", procs["r1"][2])
            await c.connect()
            for (e, k), m in sorted(models.items()):
                r = await c.kget(e, f"k{k}", timeout=60.0)
                assert r[0] == "ok", ((e, k), r)
                int_read(m, r)
            await c.close()

        asyncio.run(read_through_new_leader())
        assert plan.dropped_frames > 0 or plan.delayed_frames > 0
    finally:
        faults.clear()
        try:
            svc.stop()
        except repgroup.DeposedError:
            pass
        for p, _rp, _cp in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGKILL)
            p.wait()
