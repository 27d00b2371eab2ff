"""The port's tenant plane against the reference's.

- ``place`` equals the reference's on 1,000 seeded names over 1-5
  svcnodes.
- Lockstep: one script (``test_torch_service_manager.Script``: tenants
  created through the root, written, a second svcnode joined, views
  changed, tenants retired) on the reference's ``ManagedCluster`` with
  JAX services and on the port's, from the same seed, each service with a
  data dir.  After every step the placements, each service's tenant
  rows, every exported ``(key, payload, (epoch, seq))`` list, the
  ``svc_*`` lifecycle events, the tenant rows' ``obj_epoch`` /
  ``obj_seq`` / ``obj_val`` planes and member masks, the virtual clock
  and the WAL files, byte for byte, are equal.
"""

import random

import pytest

from riak_ensemble_tpu_torch import service_manager as sm
from test_torch_service_manager import Script, _pkg, no_errors


def test_place_equals_the_reference():
    """1,000 seeded names (strings, ints and tuples) over 1-5 svcnodes
    (strings and tuples, in seeded orders): the same owner as the
    reference's ``place``."""
    pytest.importorskip("jax")
    from riak_ensemble_tpu import service_manager as jsm

    rng = random.Random(1401)
    pool = [f"svc@node{i}" for i in range(5)] + [("svc", i) for i in range(3)]
    for i in range(1000):
        name = rng.choice([f"tenant-{rng.randrange(10 ** 9)}",
                           rng.randrange(-10 ** 6, 10 ** 6),
                           ("t", i, rng.randrange(100))])
        nodes = rng.sample(pool, rng.randint(1, 5))
        assert sm.place(name, nodes) == jsm.place(name, nodes), (name, nodes)


def test_tenant_plane_lockstep_with_reference(monkeypatch, tmp_path):
    pytest.importorskip("jax")
    from test_torch_native_enqueue import _jax_env
    from test_torch_reference_natives import load_reference_natives

    load_reference_natives()
    _jax_env(monkeypatch, "default", True, True)
    runs = [Script(_pkg(name), str(tmp_path / name)).run()
            for name in ("riak_ensemble_tpu", "riak_ensemble_tpu_torch")]
    ref, port = (r.log for r in runs)
    assert [lab for lab, _ in ref] == [lab for lab, _ in port]
    for (label, a), (_, b) in zip(ref, port):
        for key in a:
            assert a[key] == b[key], (label, key)
    last = port[-1][1]
    assert last["svc@node0"]["rows"] and last["svc@node1"]["rows"]
    assert any(kind == "svc_tenant_adopt" and p["imported"] > 0
               for kind, p in last["svc@node1"]["events"])
    assert all(v[0] == "ok" for v in port[
        [lab for lab, _ in port].index("read back")][1]["value"][1::2])
    no_errors(*(r.events[n] for r in runs for n in r.events))
