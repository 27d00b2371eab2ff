"""The port's lease-protected fast reads against the JAX package's.

The same lockstep harness as ``test_torch_kmodify.py`` (the JAX service
on its oracle arm, the port on the CPU, one fixed clock each), on both
arms of the fast path (``RETPU_FAST_READS`` / ``set_fast_reads``).  A
scripted stream reaches every miss reason a stream can reach — lease
held, lease lapsed and inside the safety margin (the clock moved), the
leader down, a pending write, the vsn mirror dropped by an election —
plus inline (device-native) values, tombstones, mixed ``kget_many``
batches and a read issued from inside a write's ack waiter; a seeded
random stream mixes them.  Futures, packed buffers, engine state, the
mirrors and the hit / miss counters (``read_fastpath_miss_reasons``
included) must be equal.  Tolerance: exact equality.

The corrupt-row flag's life (set by a detection, cleared once the
exchange syncs the row, kept while it cannot) and the opt-outs are
checked on the port alone; ``test_torch_exchange.py`` holds the same
flows against the JAX service.
"""

import numpy as np
import pytest

from riak_ensemble_tpu_torch import funref as tfunref
from riak_ensemble_tpu_torch.config import Config
from riak_ensemble_tpu_torch.ops import engine as eng
from riak_ensemble_tpu_torch.parallel import batched_host as tb
from test_torch_kmodify import FixedClock, pair  # noqa: F401  (fixture)


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "nofast"])
def test_fastread_scripted_stream_matches_jax(pair, fast):  # noqa: F811
    p = pair(fast, True)
    ts = p.ts
    reasons = ts.read_fastpath_miss_reasons

    # lease held: a committed write reads back with no device round
    (w,), _ = p.run(lambda s: s.kput(0, "a", b"v1"))
    (g,), n = p.run(lambda s: s.kget(0, "a"))
    assert g == ("ok", b"v1") and n == (0 if fast else 1)
    (gv,), _ = p.run(lambda s: s.kget_vsn(0, "a"))
    assert gv == ("ok", b"v1", w[1])
    assert ts.read_fastpath_hits == (2 if fast else 0)

    # the CAS token from a fast read is live
    (c,), _ = p.run(lambda s: s.kupdate(0, "a", gv[2], b"v2"))
    assert c[0] == "ok"

    # a pending write parks the read on the device round
    (pw, g), _ = p.run(lambda s: [s.kput(0, "a", b"v3"), s.kget(0, "a")])
    assert g == ("ok", b"v3")
    assert reasons.get("pending_write", 0) == (1 if fast else 0)

    # inside the safety margin, then a full lapse: no_lease
    horizon = float(ts.lease_until[0]) - ts.runtime.now
    p.tick(horizon - ts.config.read_margin() * 0.5)
    (g,), n = p.run(lambda s: s.kget(0, "a"))
    assert g == ("ok", b"v3") and n == 1
    p.tick(ts.config.lease() * 3)
    (g,), n = p.run(lambda s: s.kget(0, "a"))
    assert n == 1
    assert reasons.get("no_lease", 0) == (2 if fast else 0)

    # leader down: the election folds into the read's flush
    lead = int(ts.leader_np[0])
    for svc in (p.js, p.ts):
        svc.set_peer_up(0, lead, False)
    (g,), n = p.run(lambda s: s.kget(0, "a"))
    assert g == ("ok", b"v3") and n == 1
    assert reasons.get("no_leader", 0) == (1 if fast else 0)
    assert int(ts.leader_np[0]) != lead

    # another election with no covering read: the vsn mirror of the
    # row is dropped, value reads stay fast
    for svc in (p.js, p.ts):
        svc.set_peer_up(0, lead, True)
        svc.set_peer_up(0, int(svc.leader_np[0]), False)
    p.run(lambda s: s.kput(0, "other", b"x"))
    (gv,), n = p.run(lambda s: s.kget_vsn(0, "a"))
    assert n == 1
    assert reasons.get("vsn_unmirrored", 0) == (1 if fast else 0)
    (gv2,), n = p.run(lambda s: s.kget_vsn(0, "a"))
    assert gv2 == gv and n == (0 if fast else 1)
    (c,), _ = p.run(lambda s: s.kupdate(0, "a", gv2[2], b"v4"))
    assert c[0] == "ok"

    # inline values: an RMW slot serves its int32 from the mirror
    (r,), _ = p.run(lambda s: s.kmodify(1, "ctr", tfunref.ref("rmw:add",
                                                               5), 0))
    (g, gv), n = p.run(lambda s: [s.kget(1, "ctr"), s.kget_vsn(1, "ctr")])
    assert g == ("ok", 5) and gv == ("ok", 5, r[1])
    assert n == (0 if fast else 1)
    p.run(lambda s: s.kput(1, "ctr", b"blob"))
    (g,), _ = p.run(lambda s: s.kget(1, "ctr"))
    assert g == ("ok", b"blob")

    # tombstones read fast with their real version
    p.run(lambda s: s.kput(1, "t", b"v"))
    (d,), _ = p.run(lambda s: s.kdelete(1, "t"))
    (g,), _ = p.run(lambda s: s.kget(1, "t"))
    assert d[0] == "ok" and g == ("ok", "NOTFOUND")

    # a mixed kget_many: "y" rides the round behind its write
    p.run(lambda s: s.kput_many(2, ["x", "y"], [b"1", b"2"]))
    (pw, m), _ = p.run(lambda s: [s.kput(2, "y", b"2x"),
                                  s.kget_many(2, ["x", "y", "zz"],
                                              want_vsn=True)])
    assert m[0][:2] == ("ok", b"1") and m[1][:2] == ("ok", b"2x")
    assert m[2] == ("ok", "NOTFOUND", (0, 0))

    # a read issued from inside the write's ack waiter sees the write
    seen = ([], [])

    def put_then_read(i):
        def fn(s):
            f = s.kput(3, "w", b"acked")
            f.add_waiter(lambda _r: seen[i].append(s.kget(3, "w")))
            return f
        return fn
    futs = [put_then_read(0)(p.js), put_then_read(1)(p.ts)]
    p.futs[0].append(futs[0])
    p.futs[1].append(futs[1])
    p.drive([futs[1]])
    (gj,), (gt,) = seen
    assert gt.done == gj.done == fast
    p.drive([gt])
    assert p.norm(gt.value) == p.norm(gj.value) == ("ok", b"acked")
    p.futs[0].append(gj)
    p.futs[1].append(gt)
    p.check()


@pytest.mark.parametrize("fast,seed,compact", [
    (True, 3, False), (False, 4, False), (True, 5, True)],
    ids=["fast", "nofast", "fast-default-arm"])
def test_fastread_random_stream_matches_jax(pair, fast, seed,  # noqa: F811
                                            compact):
    # the stream touches rows 0-2; the default arm (compaction on) runs
    # on 12 rows, where those launches take the pack-gather strength
    e, m, s = 3, 3, 8
    p = pair(fast, True, e=12 if compact else e, m=m, s=s, k=4,
             compact=compact)
    rng = np.random.default_rng(seed)
    ref = tfunref.ref
    for step in range(40):
        for _ in range(int(rng.integers(1, 7))):
            ens = int(rng.integers(0, e))
            key = f"k{int(rng.integers(0, 5))}"
            op = int(rng.integers(0, 7))
            val = int(rng.integers(1, 1000))
            for i, svc in enumerate((p.js, p.ts)):
                if op == 0:
                    f = svc.kput(ens, key, val)
                elif op == 1:
                    f = svc.kget(ens, key)
                elif op == 2:
                    f = svc.kget_vsn(ens, key)
                elif op == 3:
                    f = svc.kget_many(ens, [key, "k0", "nope"],
                                      want_vsn=bool(val % 2))
                elif op == 4:
                    f = svc.kmodify(ens, "c" + key, ref("rmw:add", val), 0)
                elif op == 5:
                    f = svc.kdelete(ens, key)
                else:
                    f = svc.kmodify(ens, key, lambda v, c: 7, 0)
                p.futs[i].append(f)
        if step % 6 == 2:
            ens, peer = int(rng.integers(0, e)), int(rng.integers(0, m))
            up = bool(rng.integers(0, 3))
            for svc in (p.js, p.ts):
                svc.set_peer_up(ens, peer, up)
        if step % 3:
            p.flush()
        p.tick(float(rng.choice([0.05, 0.1, 0.2, 1.5])))
    for svc in (p.js, p.ts):
        svc.up[:] = True
        svc._up_dev = None
    p.check()
    if compact:
        assert p.ts.payload_bytes < p.ts.payload_bytes_full_width
    if fast:
        assert p.ts.read_fastpath_hits > 20, p.ts.read_fastpath_hits
        assert set(p.ts.read_fastpath_miss_reasons) >= {
            "no_lease", "pending_write"}


def _svc(**kw):
    return tb.BatchedEnsembleService(FixedClock(), 2, 3, 8, tick=None,
                                     device="cpu", **kw)


def _settle(svc, fut, n=10):
    for _ in range(n):
        if fut.done:
            return fut.value
        svc.flush()
    raise AssertionError("future never resolved")


def test_corrupt_row_flag_clears_once_the_exchange_syncs_it():
    """Damage a minority copy and force a device read: the launch flags
    the row, the exchange that runs in the same launch re-syncs it and
    clears the flag, and the next read of the row is fast again."""
    svc = _svc()
    assert _settle(svc, svc.kput(0, "k", b"v"))[0] == "ok"
    assert _settle(svc, svc.kput(1, "k", b"w"))[0] == "ok"
    slot = svc.key_slot[0]["k"]
    svc.state.obj_val[0, 2, slot] = 424242
    svc.lease_until[:] = 0.0  # force the device round
    assert _settle(svc, svc.kget(0, "k")) == ("ok", b"v")
    assert svc.corruptions > 0
    assert svc._corrupt_rows.tolist() == [False, False]
    g = svc.kget(0, "k")
    assert g.done and g.value == ("ok", b"v")
    assert "corrupt" not in svc.read_fastpath_miss_reasons
    assert not any(bad.any() for bad in eng.verify_trees(svc.state))


def test_corrupt_row_flag_stays_while_the_exchange_cannot_sync():
    """With only the damaged leader up, the exchange has no majority:
    the row stays flagged and its reads take the device round until a
    launch with the peers back up detects, repairs and syncs it."""
    svc = _svc()
    assert _settle(svc, svc.kput(0, "k", b"v"))[0] == "ok"
    slot = svc.key_slot[0]["k"]
    svc.state.obj_val[0, 0, slot] = 424242
    svc.set_peer_up(0, 1, False)
    svc.set_peer_up(0, 2, False)
    svc.lease_until[:] = 0.0
    assert _settle(svc, svc.kget(0, "k")) == "failed"
    assert svc._corrupt_rows.tolist() == [True, False]
    assert svc.repairs == 0
    svc.set_peer_up(0, 1, True)
    svc.set_peer_up(0, 2, True)
    g = svc.kget(0, "k")
    assert not g.done and svc.read_fastpath_miss_reasons["corrupt"] == 1
    assert _settle(svc, g) == ("ok", b"v")
    assert svc._corrupt_rows.tolist() == [False, False]
    assert not any(bad.any() for bad in eng.verify_trees(svc.state))


def test_opt_outs_and_margin_check():
    svc = _svc()
    assert _settle(svc, svc.kput(0, "a", b"v"))[0] == "ok"
    assert svc.kget(0, "a").done
    svc.set_fast_reads(False)
    g = svc.kget(0, "a")
    assert not g.done and svc.read_fastpath_miss_reasons["disabled"] == 1
    assert _settle(svc, g) == ("ok", b"v")
    svc.set_fast_reads(True)
    assert svc.kget(0, "a").value == ("ok", b"v")
    # trust_lease=False pins the path off, even when asked for
    off = _svc(config=Config(trust_lease=False))
    assert _settle(off, off.kput(0, "a", b"v"))[0] == "ok"
    off.set_fast_reads(True)
    assert not off._fast_reads and not off.kget(0, "a").done
    # a margin that does not fit inside the follower timeout refuses to
    # serve leased reads: at construction, and at every enable
    bad = Config(read_lease_margin=10.0)
    with pytest.raises(ValueError, match="read_margin"):
        _svc(config=bad)
    ok = _svc(config=Config(read_lease_margin=10.0, trust_lease=False))
    ok.config.trust_lease = True
    with pytest.raises(ValueError, match="read_margin"):
        ok.set_fast_reads(True)
