"""The port's replication group against a JAX group, end to end: the lockstep
of both packages' groups on every shipping arm, and ``install_objs`` (the
entry, frame and core cases and the shared helpers are in
``test_torch_repgroup.py``).
"""

import numpy as np
import pytest

from riak_ensemble_tpu_torch.config import fast_test_config as t_fast
from riak_ensemble_tpu_torch.ops import engine as teng
from riak_ensemble_tpu_torch.parallel import repgroup as trg
from riak_ensemble_tpu_torch.parallel.batched_host import (
    BatchedEnsembleService as TSvc, WallRuntime as TWall)
from test_torch_compaction import norm
from test_torch_reference_natives import reference_natives  # noqa: F401 (autouse)
from test_torch_wal import _tree

jax = pytest.importorskip("jax")

from riak_ensemble_tpu.config import fast_test_config as j_fast  # noqa: E402
from riak_ensemble_tpu.parallel import repgroup as jrg  # noqa: E402
from test_torch_repgroup import (  # noqa: E402
    ARMS, E, S, _build, _frames, _settle, _settle_single, _stop, _traffic,
    _wait_lanes, env)


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_group_lockstep_with_reference(env, tmp_path, arm):
    """A port group and a JAX group fed the same ops: equal futures, equal
    frames on the wire, every lane equal across the packages and to its
    leader, byte-equal WAL files."""
    for key, v in ARMS[arm].items():
        env.setenv(key, v)
    comm = arm != "comm_off"
    groups = []
    for rg, fast, pkg_kw in (
            (jrg, j_fast, {}),
            (trg, t_fast, {"device": "cpu", "comm_repl": comm})):
        rkw = {"device": "cpu", "comm_repl": comm} if rg is trg else {}
        groups.append(_build(rg, fast, str(tmp_path / rg.__name__),
                             pkg_kw, [(rg, fast, rkw)] * 2))
    frames = ([], [])
    for (svc, _s), out, rg in zip(groups, frames, (jrg, trg)):
        assert svc._comm_repl == comm
        assert svc._repl_delta == (arm != "full_plane")
        _frames(svc._links[0], out, rg)
        assert svc.takeover()
    futs = ([], [])
    for r in range(5):
        for (svc, _s), fl in zip(groups, futs):
            _traffic(np.random.default_rng(100 + r), svc, r, fl)
            _settle(svc, fl)
        if r == 2:
            # bulk writes through execute: a full-width launch
            kind = np.full((2, E), teng.OP_PUT, np.int32)
            slot = np.full((2, E), S - 1, np.int32)
            val = np.arange(1, 2 * E + 1, dtype=np.int32).reshape(2, E)
            outs = [svc.execute(kind, slot, val) for svc, _s in groups]
            for a, b in zip(*outs):
                assert np.array_equal(np.asarray(a), np.asarray(b))
        for svc, _s in groups:
            svc.runtime.now += 0.25
    assert [norm(f.value) for f in futs[1]] == \
        [norm(f.value) for f in futs[0]]
    lanes = []
    for (svc, srvs), rg in zip(groups, (jrg, trg)):
        lead, reps = _wait_lanes(svc, srvs, rg)
        assert all(rp == lead for rp in reps), "a replica left its leader"
        lanes.append(lead)
    assert lanes[0] == lanes[1]
    g = [svc.stats()["group"] for svc, _s in groups]
    for key in ("repl_delta_entries", "repl_full_entries", "repl_frames",
                "repl_bytes_shipped", "repl_bytes_sections",
                "repl_merge_cells", "quorum_failures", "resyncs"):
        assert g[0][key] == g[1][key], key
    assert g[1]["quorum_failures"] == 0
    if arm == "full_plane":
        assert g[1]["repl_delta_entries"] == 0
    else:
        assert g[1]["repl_delta_entries"] > 0
    assert (g[1]["repl_merge_cells"] > 0) == (comm and arm != "full_plane")
    assert frames[0] == frames[1]
    assert any(isinstance(f, bytes) for f in frames[1])
    for svc, srvs in groups:
        _stop(svc, srvs)
    for sub in ("leader", "r1", "r2"):
        assert _tree(str(tmp_path / jrg.__name__ / sub)) == \
            _tree(str(tmp_path / trg.__name__ / sub)), sub


def test_install_objs_like_the_reference(env, tmp_path):
    """Version-preserving installs: on a single service the port's results,
    lanes, mirrors and WAL bytes equal the JAX service's; on a group the
    leader ships its exact allocation and both replicas end equal."""
    from riak_ensemble_tpu.parallel.batched_host import (
        BatchedEnsembleService as JSvc, WallRuntime as JWall)
    items = [(f"k{i}", (3 + i % 2, 10 + i), b"p%d" % i) for i in range(6)]
    items.append(("k1", (9, 40), b"again"))        # one slot twice
    js = JSvc(JWall(), E, 3, S, tick=None, config=j_fast(),
              data_dir=str(tmp_path / "j"))
    ts = TSvc(TWall(), E, 3, S, tick=None, config=t_fast(), device="cpu",
              data_dir=str(tmp_path / "t"))
    for svc in (js, ts):
        _settle_single(svc, [svc.kput(2, "k0", b"old")])
    got = [svc.install_objs(2, items) for svc in (js, ts)]
    assert norm(got[0]) == norm(got[1])
    from riak_ensemble_tpu_torch import interop
    tn = interop.state_to_numpy(ts.state)
    for f in tn._fields:
        assert np.array_equal(np.asarray(getattr(js.state, f)),
                              getattr(tn, f)), f
    for name in ("key_slot", "slot_handle", "values", "_next_handle"):
        assert getattr(js, name) == getattr(ts, name), name
    for name in ("leader_np", "_slot_vsn_np", "_slot_vsn_ok"):
        assert np.array_equal(getattr(js, name), getattr(ts, name)), name
    for svc in (js, ts):
        svc.stop()
        svc._wal.close()
    assert _tree(str(tmp_path / "j")) == _tree(str(tmp_path / "t"))
    svc, srvs = _build(trg, t_fast, str(tmp_path / "g"), {"device": "cpu"},
                       [(trg, t_fast, {"device": "cpu"})] * 2)
    try:
        assert svc.takeover()
        res = svc.install_objs(1, items)
        assert all(r[0] == "ok" for r in res)
        lead, reps = _wait_lanes(svc, srvs, trg)
        assert all(rp == lead for rp in reps)
        reads = [svc.kget_vsn(1, "k1"), svc.kget(1, "k3")]
        _settle(svc, reads)
        # k1 keeps its installed version (the row's top epoch); k3 sits
        # below it, so its first read re-versions it, as in the reference
        assert [f.value for f in reads] == [("ok", b"again", (9, 40)),
                                            ("ok", b"p3")]
    finally:
        _stop(svc, srvs)
