"""The port's anti-entropy exchange and scrub against the JAX package's.

Engine level: ``verify_trees``, ``exchange_step`` and ``rebuild_trees``
run on the same states in both packages — the cases of
``tests/test_engine_integrity.py`` (divergent replicas converge, data is
kept with no valid holder, an unreplaceable slot stays flagged, the
exchange needs a majority, an invalid newer object is ignored) and a
seeded stream with random damage, joint views and random ``run`` / ``up``
masks.

Service level: the corruption-triggered exchange, ``scrub()`` and the
``scrub_every_flushes`` cadence run in lockstep through the JAX service
on its oracle arm and the port's service on the CPU with
``compact=False`` (the harness of ``test_torch_kmodify.py``; one case at
both services' default compaction arm) — the flows of ``test_batched_host.py``
(``test_service_heals_device_corruption``,
``test_service_scrub_heals_cold_slot_damage``,
``test_periodic_scrub_cadence``) and ``test_read_fastpath.py``
(``test_corruption_detection_flags_and_exchange_clears``).  Futures,
packed buffers, scrub reports, ``corruptions``, ``repairs``,
``_corrupt_rows`` and every state plane must be equal.

Tolerance: exact equality everywhere.
"""

import types

import numpy as np
import pytest
import torch

from riak_ensemble_tpu_torch import interop
from riak_ensemble_tpu_torch.ops import engine as teng
from riak_ensemble_tpu_torch.parallel import batched_host as tb
from test_torch_kmodify import (  # noqa: F401  (harness)
    ORACLE_ENV, FixedClock, Pair, _record_packed)

E, M, S = 4, 5, 16


@pytest.fixture
def ref():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from riak_ensemble_tpu.ops import engine as jeng
    return types.SimpleNamespace(jnp=jnp, jeng=jeng)


def _to_port(js):
    return interop.state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in js._fields}, device="cpu")


def _assert_state_equal(js, ts, tag):
    tn = interop.state_to_numpy(ts)
    for f in teng.EngineState._fields:
        a, b = np.asarray(getattr(js, f)), getattr(tn, f)
        assert a.dtype == b.dtype and a.shape == b.shape, (tag, f)
        assert np.array_equal(a, b), (tag, f)


def _check_exchange(ref, js, run, up, tag):
    """Run verify / exchange / verify / rebuild on both packages from
    the same state; every output must be equal.  Returns the JAX
    outputs for the case's own assertions."""
    jnp, jeng = ref.jnp, ref.jeng
    ts = _to_port(js)
    for a, b in zip(jeng.verify_trees(js), teng.verify_trees(ts)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    js2, jdiv, jsync = jeng.exchange_step(js, jnp.asarray(run),
                                          jnp.asarray(up))
    ts2, tdiv, tsync = teng.exchange_step(ts, torch.from_numpy(run),
                                          torch.from_numpy(up))
    _assert_state_equal(js2, ts2, tag)
    _assert_state_equal(js, ts, f"{tag}: input left as it was")
    np.testing.assert_array_equal(np.asarray(jdiv), tdiv.numpy())
    np.testing.assert_array_equal(np.asarray(jsync), tsync.numpy())
    after = jeng.verify_trees(js2)
    for a, b in zip(after, teng.verify_trees(ts2)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    mask = np.arange(up.size).reshape(up.shape) % 3 == 0
    _assert_state_equal(jeng.rebuild_trees(js, jnp.asarray(mask)),
                        teng.rebuild_trees(ts, torch.from_numpy(mask)),
                        f"{tag}: rebuild")
    return js2, np.asarray(jdiv), np.asarray(jsync), after


def _seeded(ref, slot=3, vals=(10, 20, 30, 40)):
    jnp, jeng = ref.jnp, ref.jeng
    up = jnp.ones((E, M), bool)
    st, _ = jeng.elect_step(jeng.init_state(E, M, S), jnp.ones((E,), bool),
                            jnp.zeros((E,), jnp.int32), up)
    return _put(ref, st, slot, vals)


def _put(ref, st, slot, vals):
    jnp, jeng = ref.jnp, ref.jeng
    st, res = jeng.kv_step(
        st, jnp.full((E,), jeng.OP_PUT, jnp.int32),
        jnp.full((E,), slot, jnp.int32), jnp.asarray(vals, jnp.int32),
        jnp.ones((E,), bool), jnp.ones((E, M), bool))
    assert bool(res.committed.all())
    return st


def _case_divergent(ref):
    jnp, jeng = ref.jnp, ref.jeng
    st = _put(ref, _seeded(ref, slot=2, vals=(5, 6, 7, 8)), 9, [50] * E)
    st = st._replace(obj_seq=st.obj_seq.at[:, 3, 9].set(0),
                     obj_epoch=st.obj_epoch.at[:, 3, 9].set(0),
                     obj_val=st.obj_val.at[:, 3, 9].set(0))
    st = jeng.rebuild_trees(
        st, jnp.asarray(np.eye(1, M, 3, dtype=bool).repeat(E, 0)))
    return st._replace(obj_val=st.obj_val.at[:, 1, 2].set(666))


def _case_no_valid_holder(ref):
    st = _seeded(ref)
    return st._replace(tree_node=st.tree_node.at[:, :, 0, 0].set(
        ref.jnp.uint32(0xDEAD)))


def _case_unreplaceable(ref):
    st = _seeded(ref)
    return st._replace(obj_val=st.obj_val.at[:, :, 3].set(
        600 + ref.jnp.arange(M, dtype=ref.jnp.int32)))


def _case_invalid_newer(ref):
    st = _seeded(ref)
    return st._replace(obj_epoch=st.obj_epoch.at[:, 2, 3].set(9),
                       obj_seq=st.obj_seq.at[:, 2, 3].set(9),
                       obj_val=st.obj_val.at[:, 2, 3].set(123))


ALL_UP = np.ones((E, M), bool)
MINORITY_UP = np.array([[1, 1, 0, 0, 0]] * E, bool)


@pytest.mark.parametrize("case", ["divergent", "no_valid_holder",
                                  "unreplaceable", "majority",
                                  "invalid_newer"])
def test_exchange_cases_match_jax(ref, case):
    run = np.ones((E,), bool)
    if case == "divergent":
        js2, div, sync, (nb, lb) = _check_exchange(
            ref, _case_divergent(ref), run, ALL_UP, case)
        assert sync.all() and div[:, [1, 3]].all()
        assert not div[:, [0, 2, 4]].any()
        np.testing.assert_array_equal(np.asarray(js2.obj_val)[:, 3, 9], 50)
        assert not (nb.any() or lb.any())
    elif case == "no_valid_holder":
        js2, _, sync, (nb, lb) = _check_exchange(
            ref, _case_no_valid_holder(ref), run, ALL_UP, case)
        assert sync.all() and not (nb.any() or lb.any())
        np.testing.assert_array_equal(np.asarray(js2.obj_val)[:, :, 3].T,
                                      np.tile([10, 20, 30, 40], (M, 1)))
    elif case == "unreplaceable":
        js2, div, sync, (_, lb) = _check_exchange(
            ref, _case_unreplaceable(ref), run, ALL_UP, case)
        assert sync.all() and div.all() and lb.all()
    elif case == "majority":
        st = _seeded(ref)
        js2, _, sync, _ = _check_exchange(ref, st, run, MINORITY_UP, case)
        assert not sync.any()
        for f in st._fields:
            np.testing.assert_array_equal(np.asarray(getattr(st, f)),
                                          np.asarray(getattr(js2, f)))
    else:
        js2, _, sync, _ = _check_exchange(
            ref, _case_invalid_newer(ref), run, ALL_UP, case)
        assert sync.all()
        np.testing.assert_array_equal(np.asarray(js2.obj_val)[:, 2, 3],
                                      [10, 20, 30, 40])


@pytest.mark.parametrize("views,seed", [(None, 0), ([[0, 1, 2], [1, 2, 3, 4]],
                                                    1)])
def test_exchange_random_damage_matches_jax(ref, views, seed):
    """Seeded puts, then damage to objects, leaves and upper nodes on
    random replicas, with random run / up masks and joint views."""
    jnp, jeng = ref.jnp, ref.jeng
    rng = np.random.default_rng(seed)
    e, m, s = 6, 5, 32
    js = jeng.init_state(e, m, s, views=views)
    up = np.ones((e, m), bool)
    js, _ = jeng.elect_step(js, jnp.ones((e,), bool),
                            jnp.asarray(rng.integers(0, 2, e, np.int32)),
                            jnp.asarray(up))
    for _ in range(6):
        js, _ = jeng.kv_step(
            js, jnp.full((e,), jeng.OP_PUT, jnp.int32),
            jnp.asarray(rng.integers(0, s, e, np.int32)),
            jnp.asarray(rng.integers(1, 100, e, np.int32)),
            jnp.ones((e,), bool),
            jnp.asarray(rng.random((e, m)) < 0.8))
    ov, tl, tn = (np.array(js.obj_val), np.array(js.tree_leaf),
                  np.array(js.tree_node))
    for _ in range(8):
        a, b, c = rng.integers(0, e), rng.integers(0, m), rng.integers(0, s)
        ov[a, b, c] += 1
        a, b, c = rng.integers(0, e), rng.integers(0, m), rng.integers(0, s)
        tl[a, b, c, rng.integers(0, 4)] ^= np.uint32(1 << 7)
        a, b = rng.integers(0, e), rng.integers(0, m)
        tn[a, b, rng.integers(0, tn.shape[2]), 0] ^= np.uint32(3)
    js = js._replace(obj_val=jnp.asarray(ov), tree_leaf=jnp.asarray(tl),
                     tree_node=jnp.asarray(tn))
    run = rng.random(e) < 0.8
    up = rng.random((e, m)) < 0.8
    _, div, sync, _ = _check_exchange(ref, js, run, up, f"seed {seed}")
    assert sync.any() and div.any()


# ---------------------------------------------------------------------------
# The service flows


@pytest.fixture
def svc_pair(monkeypatch):
    """``svc_pair(fast, e, m, s, k, scrub_every)`` builds a lockstep
    Pair of the JAX service (oracle arm) and the port's (CPU)."""
    pytest.importorskip("jax")
    from riak_ensemble_tpu.parallel import batched_host as jb
    from riak_ensemble_tpu.types import NOTFOUND as J_NOTFOUND
    from riak_ensemble_tpu_torch.types import NOTFOUND as T_NOTFOUND

    def norm(x):
        if x is J_NOTFOUND or x is T_NOTFOUND:
            return "NOTFOUND"
        if isinstance(x, (list, tuple)):
            return type(x)(norm(y) for y in x)
        return x

    def make(fast=True, e=4, m=5, s=16, k=8, scrub_every=None,
             compact=False):
        for key, v in ORACLE_ENV.items():
            monkeypatch.setenv(key, v)
        if compact:
            monkeypatch.delenv("RETPU_COMPACT")
        monkeypatch.setenv("RETPU_FAST_READS", "1" if fast else "0")
        monkeypatch.delenv("RETPU_WIDE", raising=False)
        js = jb.BatchedEnsembleService(FixedClock(), e, m, s, tick=None,
                                       max_ops_per_tick=k,
                                       scrub_every_flushes=scrub_every)
        ts = tb.BatchedEnsembleService(FixedClock(), e, m, s, tick=None,
                                       max_ops_per_tick=k, device="cpu",
                                       scrub_every_flushes=scrub_every,
                                       compact=compact)
        ts.set_fast_reads(fast)
        assert js._fast_reads == ts._fast_reads == fast
        assert js._compact == ts._compact == compact
        bufs = ([], [])
        _record_packed(js, bufs[0])
        _record_packed(ts, bufs[1])
        return Pair(js, ts, bufs, norm)
    return make


def _damage(p, plane, idx, value):
    """The same out-of-band write on both arms' device state."""
    js = p.js.state
    p.js.state = js._replace(**{plane: getattr(js, plane).at[idx].set(
        value)})
    getattr(p.ts.state, plane)[idx] = value


def _check_healed(p):
    p.check()
    assert (p.js.corruptions, p.js.repairs) == (p.ts.corruptions,
                                                p.ts.repairs)
    from riak_ensemble_tpu.ops import engine as jeng
    for bad in (*jeng.verify_trees(p.js.state),
                *teng.verify_trees(p.ts.state)):
        assert not np.asarray(bad).any()


@pytest.mark.parametrize("fast,compact", [(True, False), (False, False),
                                          (True, True)],
                         ids=["fast", "nofast", "fast-default-arm"])
def test_service_heals_device_corruption_like_jax(svc_pair, fast, compact):
    # the default arm on 16 rows: each one-row launch pack-gathers
    p = svc_pair(fast, e=16 if compact else 4, compact=compact)
    for e in range(4):
        assert p.run(lambda s: s.kput(e, "k", b"v"))[0][0][0] == "ok"
        p.run(lambda s: s.kput(e, "j", b"w"))
    for e in range(4):
        _damage(p, "obj_val", (e, 2, p.ts.key_slot[e]["k"]), 424242)
    for e in range(4):
        for svc in (p.js, p.ts):
            svc.lease_until[:] = 0.0
        (g,), _ = p.run(lambda s: s.kget(e, "k"))
        assert g == ("ok", b"v")
    # the read's own repair fixed the copy in the round; the exchange
    # that followed found nothing left to re-sync
    assert p.ts.corruptions == 4 and p.ts.repairs == 0
    assert not p.ts._corrupt_rows.any()
    _check_healed(p)
    if compact:
        assert p.ts.payload_bytes < p.ts.payload_bytes_full_width
        assert p.js.payload_bytes == p.ts.payload_bytes


def test_service_scrub_heals_cold_slot_damage_like_jax(svc_pair):
    p = svc_pair(m=3)
    for e in range(4):
        p.run(lambda s: s.kput(e, "cold", b"c%d" % e))
        p.run(lambda s: s.kput(e, "hot", b"h%d" % e))
    _damage(p, "obj_val", (2, 1, p.ts.key_slot[2]["cold"]), 123456)
    p.js.state = p.js.state._replace(
        tree_node=p.js.state.tree_node.at[3, 2, 0, :].set(
            p.js._jnp.uint32(0xBAD)))
    p.ts.state.tree_node[3, 2, 0, :] = 0xBAD
    reps = [svc.scrub() for svc in (p.js, p.ts)]
    assert reps[0] == reps[1]
    assert reps[1]["replicas_damaged"] >= 2
    assert reps[1]["replicas_healed"] == reps[1]["replicas_damaged"]
    assert reps[1]["ensembles_swept"] >= 2
    assert [svc.scrub() for svc in (p.js, p.ts)] == [
        {"replicas_damaged": 0, "replicas_healed": 0,
         "ensembles_swept": 0}] * 2
    for e in range(4):
        assert p.run(lambda s: s.kget(e, "cold"))[0] == [("ok",
                                                          b"c%d" % e)]
        assert p.run(lambda s: s.kget(e, "hot"))[0] == [("ok", b"h%d" % e)]
    _check_healed(p)


def test_scrub_leaves_unhealable_rows_flagged_like_jax(svc_pair):
    """Every copy of a slot damaged: the scrub heals nothing there, and
    the row stays off the fast path exactly as in the reference."""
    p = svc_pair(m=3)
    p.run(lambda s: s.kput(1, "x", b"v"))
    slot = p.ts.key_slot[1]["x"]
    for peer in range(3):
        _damage(p, "obj_val", (1, peer, slot), 900 + peer)
    reps = [svc.scrub() for svc in (p.js, p.ts)]
    assert reps[0] == reps[1]
    assert reps[1]["replicas_healed"] < reps[1]["replicas_damaged"]
    assert p.ts._corrupt_rows.tolist() == [False, True, False, False]
    p.check()
    assert (p.js.corruptions, p.js.repairs) == (p.ts.corruptions,
                                                p.ts.repairs)


def test_periodic_scrub_cadence_like_jax(svc_pair):
    p = svc_pair(e=2, m=3, s=8, scrub_every=3)
    p.run(lambda s: s.kput(0, "cold", b"c"))
    _damage(p, "obj_val", (0, 1, p.ts.key_slot[0]["cold"]), 777777)
    for i in range(8):
        assert p.run(lambda s: s.kput(1, f"k{i}", b"v"))[0][0][0] == "ok"
    assert p.ts.repairs >= 1 and p.ts._scrubbed_at_flush > 0
    assert p.js._scrubbed_at_flush == p.ts._scrubbed_at_flush
    assert p.run(lambda s: s.kget(0, "cold"))[0] == [("ok", b"c")]
    _check_healed(p)


def test_corruption_detection_flags_and_exchange_clears_like_jax(svc_pair):
    p = svc_pair(m=3, s=8)
    p.run(lambda s: s.kput(0, "k", b"v"))
    _damage(p, "obj_val", (0, 2, p.ts.key_slot[0]["k"]), 424242)
    for svc in (p.js, p.ts):
        svc.lease_until[:] = 0.0
    (g,), n = p.run(lambda s: s.kget(0, "k"))
    assert g == ("ok", b"v") and n == 1
    assert p.ts.corruptions > 0 and not p.ts._corrupt_rows.any()
    # the same flush synced the row and renewed its lease: fast again
    (g,), n = p.run(lambda s: s.kget(0, "k"))
    assert g == ("ok", b"v") and n == 0
    _check_healed(p)
