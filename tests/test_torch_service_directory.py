"""The port's ``service_directory`` — the mirror of
``tests/test_service_directory.py`` (``:24``, ``:60``) on the port's
``ManagedCluster`` and ``svcnode``, and the same registration script run on
both packages' clusters in lockstep.

- A service registered through the root ensemble gossips to every node,
  resolves to its address and shape, starts no actor peers, and neither
  unknown names nor actor ensembles resolve.
- A resolved address dials a live port ``svcnode`` (on the CPU) and
  serves K/V traffic.
- Lockstep: one script (three nodes, services registered from different
  nodes, an actor ensemble beside them) on ``riak_ensemble_tpu`` and on
  ``riak_ensemble_tpu_torch`` from the same seed.  Every call is a step of
  ``test_torch_scalar_plane.lockstep`` (results and whole-cluster
  snapshots equal), and after gossip every node's ``list_services`` and
  ``resolve_service`` answers are equal across the packages.
"""

import asyncio
import importlib

import pytest

from riak_ensemble_tpu_torch import service_directory as sd
from riak_ensemble_tpu_torch import svcnode
from riak_ensemble_tpu_torch.config import fast_test_config
from riak_ensemble_tpu_torch.testing import ManagedCluster
from riak_ensemble_tpu_torch.types import PeerId

NODES = ("node0", "node1", "node2")


def test_registration_propagates_and_starts_no_peers():
    mc = ManagedCluster(seed=9, nodes=NODES)
    mc.enable("node0")
    mc.join("node1", "node0")
    mc.join("node2", "node0")

    r = sd.register_service(mc.mgr("node0"), mc.runtime, "kvplane",
                            "10.0.0.7", 7601, (10_000, 5, 128))
    assert r == "ok", r

    ok = mc.runtime.run_until(
        lambda: all(sd.resolve_service(mc.mgr(n), "kvplane") is not None
                    for n in NODES), 60.0)
    assert ok, "service registration never gossiped"
    assert sd.resolve_service(mc.mgr("node0"), "kvplane") == {
        "host": "10.0.0.7", "port": 7601, "shape": (10_000, 5, 128)}
    assert sd.list_services(mc.mgr("node2")) == {
        "kvplane": {"host": "10.0.0.7", "port": 7601,
                    "shape": (10_000, 5, 128)}}

    # directory-only: reconciliation starts no actor peers for it
    mc.runtime.run_for(5.0)
    for n in NODES:
        assert not any(ens == sd.service_id("kvplane")
                       for ens, _pid in mc.mgr(n).local_peers), \
            "actor peers started for a directory-only ensemble"

    assert sd.resolve_service(mc.mgr("node0"), "nope") is None
    peers = [PeerId(i, f"node{i}") for i in range(3)]
    mc.create_ensemble("actor-ens", peers)
    assert sd.resolve_service(mc.mgr("node0"), "actor-ens") is None


def test_resolved_address_dials_a_live_svcnode():
    """Register the real address of a live port svcnode in the simulated
    cluster's directory, resolve it on another node, dial it, and run
    K/V traffic."""

    async def scenario():
        server = await svcnode.serve(4, 3, 8, port=0,
                                     config=fast_test_config(),
                                     device="cpu")
        try:
            mc = ManagedCluster(seed=10, nodes=("node0", "node1"))
            mc.enable("node0")
            mc.join("node1", "node0")
            assert sd.register_service(mc.mgr("node0"), mc.runtime,
                                       "plane", server.host, server.port,
                                       (4, 3, 8)) == "ok"
            assert mc.runtime.run_until(
                lambda: sd.resolve_service(mc.mgr("node1"), "plane")
                is not None, 60.0)
            addr = sd.resolve_service(mc.mgr("node1"), "plane")
            assert addr["shape"] == (4, 3, 8)

            c = svcnode.ServiceClient(addr["host"], addr["port"])
            await c.connect()
            assert (await c.kput(0, "k", b"v"))[0] == "ok"
            assert await c.kget(0, "k") == ("ok", b"v")
            await c.close()
        finally:
            await server.stop()

    asyncio.run(scenario())


def sc_directory(t):
    """Three nodes; services registered from node0 and node2, one name
    registered twice, an actor ensemble beside them; after gossip every
    node's directory view is a step."""
    ns = t.ns
    sdir = importlib.import_module(f"{ns.name}.service_directory")
    mc = t.wrap(ns.testing.ManagedCluster(seed=21, nodes=NODES))
    mc.enable("node0")
    mc.join("node1", "node0")
    mc.join("node2", "node0")
    rt = mc.runtime
    raw = mc._obj
    regs = [("node0", "alpha", "10.0.0.1", 7001, (10_000, 5, 128)),
            ("node2", "beta", "10.0.0.2", 7002, (64, 3, 8)),
            ("node1", ("svc", 3), "10.0.0.3", 7003, (16, 7, 33)),
            ("node0", "alpha", "10.0.0.9", 7009, (1, 1, 1))]
    for i, (node, name, host, port, shape) in enumerate(regs):
        t.step(f"register {i}", sdir.register_service(
            raw.mgr(node), raw.runtime, name, host, port, shape))
    mc.create_ensemble("actor-ens", [ns.types.PeerId(i, f"node{i}")
                                     for i in range(3)])

    def everywhere():
        return all(len(sdir.list_services(raw.mgr(n))) == 3
                   for n in NODES)
    assert rt.run_until(everywhere, 60.0)
    rt.run_for(5.0)
    for n in NODES:
        d = raw.mgr(n)
        t.step(f"list {n}", sdir.list_services(d))
        for name in ("alpha", "beta", ("svc", 3), "actor-ens", "nope",
                     "root"):
            t.step(f"resolve {n} {name!r}", sdir.resolve_service(d, name))
        assert not any(ens[0] == "svc" for ens, _pid in d.local_peers
                       if isinstance(ens, tuple))
    return t


def test_directory_lockstep_with_reference():
    pytest.importorskip("jax")
    from test_torch_scalar_plane import lockstep

    log = lockstep(sc_directory)
    got = {label: value for label, value, _snap in log}
    assert [got[f"register {i}"] for i in range(3)] == ["ok"] * 3
    assert got["register 3"] != "ok"
    assert got["resolve node1 'beta'"] == (
        "dict", ("host", "10.0.0.2"), ("port", 7002), ("shape", (64, 3, 8)))
    # the first registration of a name holds; the second is refused
    assert got["resolve node2 'alpha'"][1] == ("host", "10.0.0.1")
    for n in NODES:
        assert got[f"resolve {n} 'actor-ens'"] is None
        assert got[f"resolve {n} 'nope'"] is None
