"""The exchange and the scrub inside the port's service against the JAX
service: corruption healed on the device, random damage, the scrub cadence
and cold-slot damage (the step-level cases and the shared helpers are in
``test_torch_exchange.py``).
"""

import numpy as np
import pytest

from test_torch_exchange import (
    _check_exchange, _check_healed, _damage, ref, svc_pair)
from test_torch_reference_natives import reference_natives  # noqa: F401 (autouse)


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
