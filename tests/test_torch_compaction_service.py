"""Compacted services against the JAX service: the skew sweep, keyed
traffic with RMW, the corruption flag under compaction, ``compact=False``,
and the sliced plain step against the JAX step (the pack / unpack cases and
the shared helpers are in ``test_torch_compaction.py``).
"""

import numpy as np
import pytest
import torch

from riak_ensemble_tpu_torch import interop, funref as tfunref
from riak_ensemble_tpu_torch.ops import cuda_engine, engine as teng
from riak_ensemble_tpu_torch.parallel import batched_host as tb
from test_torch_compaction import Lockstep, _skew_planes, _step_inputs, jb
from test_torch_kmodify import FixedClock
from test_torch_reference_natives import reference_natives  # noqa: F401 (autouse)


@pytest.mark.parametrize("e,n_light,sliced", [
    (256, 24, True),      # bucket 32 <= E/4: the step runs on A rows
    (256, 90, False),     # bucket 128 > E/4: pack-gather
    (64, 10, False),      # E < SLICE_MIN_E: pack-gather
], ids=["sliced", "pack-gather", "small-grid"])
def test_skew_equivalence_sweep(jb, e, n_light, sliced):
    p = Lockstep(jb, e, 3, 16, 8)
    rng = np.random.default_rng(11)
    seeds = rng.integers(0, 999, 3)
    for i, sd in enumerate(seeds):
        planes = _skew_planes(np.random.default_rng(sd), e, 16, 8, n_light)
        kind, slot, val, exp_e, exp_s = planes
        out_j, out_t = p.both(lambda s: s.execute(
            kind, slot, val, exp_epoch=exp_e, exp_seq=exp_s))
        for name, a, b in zip(("committed", "get_ok", "found", "value"),
                              out_j, out_t):
            assert a.dtype == b.dtype and np.array_equal(a, b), (i, name)
        p.tick(0.3)
    p.check()
    # the first launch elects every row (full width); the later ones
    # compacted with the strength this case is about
    assert p.ts.sliced_launches == (2 if sliced else 0)
    assert p.ts.payload_bytes < p.ts.payload_bytes_full_width
    assert p.ts.grid_occupancy < 1.0
    assert all((planes[0] == op).any() for op in
               (teng.OP_PUT, teng.OP_GET, teng.OP_CAS, teng.OP_RMW))


def test_keyed_equivalence_with_rmw(jb):
    """The queued keyed path (futures, want_vsn results, the device RMW
    fast path, fast reads) at E = 256: the first flush elects every row
    at full width, the later ones slice."""
    p = Lockstep(jb, 256, 3, 16, 8)
    ref = tfunref.ref
    p.submit(lambda s: [s.kput(e, "warm", 1) for e in range(s.n_ens)])
    p.drain()
    p.tick(0.2)
    p.submit(lambda s: [s.kput(0, f"k{i}", 1000 + i) for i in range(8)]
             + [s.kput(9, "x", 7),
                s.kmodify(17, "ctr", ref("rmw:add", 5), 0),
                s.kmodify(17, "ctr", ref("rmw:add", 5), 0),
                s.kget_vsn(9, "x"), s.kget(255, "warm")])
    p.drain()
    p.tick(0.2)
    # a different active set, fast reads and a host-path kmodify chain
    p.submit(lambda s: [s.kput(3, "y", 1), s.kget(17, "ctr"),
                        s.kdelete(40, "nope"), s.kget(0, "k3"),
                        s.kmodify(255, "warm", lambda v, c: c + 1, 0),
                        s.kmodify_many(200, ["a", "b", "a"],
                                       ref("rmw:max", 4))])
    p.drain()
    p.tick(0.9)                     # every lease lapses: reads go round
    p.submit(lambda s: [s.kget(17, "ctr"), s.kget_vsn(255, "warm"),
                        s.kget_many(200, ["a", "b"])])
    p.drain()
    p.check()
    assert p.ts.sliced_launches >= 3 and p.ts.rmw_device_fastpath > 0
    assert p.ts.read_fastpath_hits > 0
    assert p.ts.payload_bytes < p.ts.payload_bytes_full_width / 2


def test_corrupt_flag_reaches_scrub_under_compaction(jb):
    """A launch sliced down to one active row still reports the
    integrity-gate failure and runs the same exchange; the scrub then
    finds the damage no read touched — equal to the JAX service."""
    import jax.numpy as jnp
    p = Lockstep(jb, 256, 3, 8, 4)
    p.submit(lambda s: [s.kput(e, "k", 40 + e) for e in range(0, 256, 5)])
    p.drain()
    slot = p.ts.key_slot[5]["k"]
    cold = p.ts.key_slot[10]["k"]
    leaf = np.asarray(p.js.state.tree_leaf).copy()
    leaf[5, 1, slot] ^= 0xDEAD
    leaf[10, 2, cold] ^= 0xBEEF
    p.js.state = p.js.state._replace(tree_leaf=jnp.asarray(leaf))
    p.ts.state.tree_leaf[5, 1, slot] ^= 0xDEAD
    p.ts.state.tree_leaf[10, 2, cold] ^= 0xBEEF
    for s in (p.js, p.ts):
        s.lease_until[:] = 0.0      # the read must take the device round
    p.submit(lambda s: s.kget(5, "k"))
    p.drain()
    assert p.ts.sliced_launches >= 1
    assert p.ts.corruptions >= 1 and p.futs[1][-1].value == ("ok", 45)
    reports = p.both(lambda s: s.scrub())
    assert reports[0] == reports[1] and reports[1]["replicas_damaged"] >= 1
    p.check()


@pytest.mark.parametrize("last_active", [True, False],
                         ids=["row-E-1-active", "row-E-1-idle"])
def test_full_step_sliced_plain_matches_jax(jb, last_active):
    import jax.numpy as jnp

    from riak_ensemble_tpu.ops import engine as jeng
    rng = np.random.default_rng(21 + last_active)
    e, m, s, k = 40, 3, 16, 4
    js = jeng.init_state(e, m, s)
    ts = interop.state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in js._fields}, device="cpu")
    f1_before = cuda_engine.engine_step_launches
    for step in range(4):
        rows = np.sort(rng.choice(e - 1, 5, replace=False))
        if last_active:
            rows = np.append(rows[:-1], e - 1)
        active = np.full(8, e, np.int32)          # three pads
        active[:rows.size] = rows
        planes = _step_inputs(rng, e, m, s, k, active)
        if step == 0:
            planes[0][:] = active < e             # elect every real row
        j_out = jeng.full_step_sliced(
            js, jnp.asarray(active), *(jnp.asarray(a) for a in planes[:7]),
            exp_epoch=jnp.asarray(planes[7]), exp_seq=jnp.asarray(planes[8]))
        js = j_out[0]
        t_in = [torch.from_numpy(a) for a in planes]
        before = [t.clone() for t in ts]
        ts2, won, res = teng.full_step_sliced(
            ts, active, *t_in[:7], exp_epoch=t_in[7], exp_seq=t_in[8])
        # rows were stepped IN PLACE, idle rows untouched
        assert all(a is b for a, b in zip(ts2, ts))
        idle = np.setdiff1d(np.arange(e), active)
        for a, b in zip(before, ts):
            assert torch.equal(a[idle], b[idle])
        assert np.array_equal(won.numpy(), np.asarray(j_out[1])), step
        for f in teng.KvResult._fields:
            assert np.array_equal(getattr(res, f).numpy(),
                                  np.asarray(getattr(j_out[2], f))), (step, f)
        got = interop.state_to_numpy(ts)
        for f in js._fields:
            assert np.array_equal(getattr(got, f),
                                  np.asarray(getattr(js, f))), (step, f)
        # pads: NOOP results, and all of them row E - 1's epoch check
        pads = slice(rows.size, None)
        assert not (won[pads].any() or res.committed[:, pads].any()
                    or res.get_ok[:, pads].any()
                    or res.tree_corrupt[:, pads].any())
        assert (res.quorum_ok[:, pads] == res.quorum_ok[:1, pads][:, :1]).all()
    assert cuda_engine.engine_step_launches == f1_before
    assert int(res.committed.sum()) > 0


def test_compact_off_keeps_full_width():
    svc = tb.BatchedEnsembleService(FixedClock(), 256, 3, 8, tick=None,
                                    max_ops_per_tick=4, device="cpu",
                                    compact=False)
    for _ in range(2):
        f = svc.kput(7, "k", 1)
        svc.flush()
        assert f.value[0] == "ok"
    assert svc.sliced_launches == 0 and svc.grid_occupancy == 1.0
    assert svc.payload_bytes == svc.payload_bytes_full_width > 0
