"""The port's app facade bring-up and its tracing helpers — the mirror of
``tests/test_app_trace.py``.

Each scenario is written once against a package namespace.  Run on the
port alone it keeps the reference's assertions (so it runs without JAX,
as on the card's machine); run on both packages from one seed, with each
package's id counters reset first, every value it records — each call's
result, ``runtime.now``, the tracer's counters and report, and
``dump_ensemble`` / ``peer_info`` of the ensemble — must be equal
(``test_torch_scalar_plane.norm`` makes them package-neutral).
"""

import importlib
import types

import pytest

_MODULES = ("app", "config", "runtime", "types", "utils.trace", "msg",
            "router", "testing")


def _ns(pkg):
    ns = types.SimpleNamespace(name=pkg)
    for mod in _MODULES:
        setattr(ns, mod.replace("utils.", ""),
                importlib.import_module(f"{pkg}.{mod}"))
    return ns


def sc_app_two_node_bringup(ns, out):
    runtime = ns.runtime.Runtime(seed=40)
    cfg = ns.config.fast_test_config()
    n0 = ns.app.start(runtime, "node0", cfg)
    n1 = ns.app.start(runtime, "node1", cfg)

    assert n0.enable() == "ok"
    assert not n1.enabled()
    assert n1.join("node0") == "ok"
    assert runtime.run_until(lambda: n1.enabled(), 30.0, poll=0.1)
    out.append(("joined", runtime.now))

    peers = [ns.types.PeerId(0, "node0"), ns.types.PeerId(1, "node1")]
    assert n0.create_ensemble("kv", peers) == "ok"
    assert runtime.run_until(
        lambda: any(k[0] == "kv" for k in n1.manager.local_peers),
        60.0, poll=0.1)
    out.append(("created", runtime.now))

    c = n0.client()

    def write_ok():
        return c.kover("kv", "k", b"v", timeout=5.0)[0] == "ok"
    assert runtime.run_until(write_ok, 60.0, poll=0.2)
    r = n1.client().kget("kv", "k")
    assert r[0] == "ok" and r[1].value == b"v"
    out.append(("kget", r, runtime.now))
    out.append(("dump kv", ns.trace.dump_ensemble(runtime, "kv")))


def sc_tracer_spans_and_dump(ns, out):
    runtime = ns.runtime.Runtime(seed=41)
    cfg = ns.config.fast_test_config()
    n0 = ns.app.start(runtime, "node0", cfg)
    tracer = ns.trace.Tracer(runtime).install()
    assert n0.enable() == "ok"

    c = n0.client()
    sid = tracer.begin("kover", "root", "k")

    def write_ok():
        return c.kover("root", "k", b"v", timeout=5.0)[0] == "ok"
    assert runtime.run_until(write_ok, 30.0, poll=0.2)
    span = tracer.finish(sid, "ok")
    assert span.duration is not None and span.duration >= 0
    assert tracer.summary()["finished_spans"]["kover"] == 1
    # runtime deliveries were traced
    assert tracer.counters.get("deliver", 0) > 0
    assert tracer.percentiles("kover")[0.5] >= 0
    out.append(("span", span.kind, span.ensemble, span.detail, span.start,
                span.end, span.outcome))
    out.append(("summary", tracer.summary(), tracer.percentiles("kover")))

    infos = ns.trace.dump_ensemble(runtime, "root")
    assert len(infos) == 1
    assert infos[0]["state"] == "leading"
    assert infos[0]["id"] == ns.types.PeerId("root", "node0")
    info = ns.trace.peer_info(
        n0.manager.local_peers[("root", ns.types.PeerId("root", "node0"))])
    assert info
    out.append(("dump root", infos, info, runtime.now))


def sc_cluster_dump_follows_the_leader(ns, out):
    """``dump_ensemble`` on a 3-peer ``testing.Cluster``: every peer, the
    leader first; after the leader is suspended and another elected, the
    new leader first and the suspended peer still listed."""
    c = ns.testing.Cluster(seed=42)
    peers = ns.testing.make_peers(3)
    c.create_ensemble("demo", peers)

    def dump(leader):
        infos = ns.trace.dump_ensemble(c.runtime, "demo")
        assert sorted(i["id"] for i in infos) == sorted(peers)
        assert infos[0]["id"] == leader and infos[0]["state"] == "leading"
        assert infos[0] == ns.trace.peer_info(c.peer("demo", leader))
        assert [repr(i["id"]) for i in infos[1:]] == sorted(
            repr(i["id"]) for i in infos[1:])
        out.append(("dump demo", infos, c.runtime.now))
        return infos

    first = c.wait_stable("demo")
    c.kput_ok("demo", "k", b"v")
    dump(first)
    c.suspend_peer("demo", first)
    assert c.runtime.run_until(
        lambda: c.leader_id("demo") not in (None, first), 60.0)
    infos = dump(c.wait_stable("demo"))
    assert [i["suspended"] for i in infos if i["id"] == first] == [True]


def _run(scenario, lockstep):
    """The scenario on the port; with ``lockstep``, also on the reference,
    and every recorded value equal."""
    if not lockstep:
        out = []
        scenario(_ns("riak_ensemble_tpu_torch"), out)
        return
    pytest.importorskip("jax")
    from test_torch_scalar_plane import _reset_counters, norm

    runs = []
    for pkg in ("riak_ensemble_tpu", "riak_ensemble_tpu_torch"):
        ns = _ns(pkg)
        _reset_counters(ns)
        out = []
        scenario(ns, out)
        runs.append(norm(out))
    ref, port = runs
    assert port == ref
    dumps = [x for x in port if x[0].startswith("dump")]
    assert dumps and dumps[0][1], "an empty dump"


@pytest.mark.parametrize("lockstep", [False, True], ids=["port", "lockstep"])
def test_app_two_node_bringup(lockstep):
    _run(sc_app_two_node_bringup, lockstep)


@pytest.mark.parametrize("lockstep", [False, True], ids=["port", "lockstep"])
def test_tracer_spans_and_dump(lockstep):
    _run(sc_tracer_spans_and_dump, lockstep)


@pytest.mark.parametrize("lockstep", [False, True], ids=["port", "lockstep"])
def test_cluster_dump_follows_the_leader(lockstep):
    _run(sc_cluster_dump_follows_the_leader, lockstep)
