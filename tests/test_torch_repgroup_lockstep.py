"""The port's group against the JAX package's on the paths beyond the
core arms of ``test_torch_repgroup.py`` — the lockstep mirror of the
reference's ``test_tree_resync.py``, ``test_replace_hosts.py`` and
``test_follower_reads.py`` at 4 ensembles x 8 slots, on the CPU, with
threaded replica hosts in one process:

- tree catch-up: a replica killed, missing two flushes, and restarted
  from its data dir is healed by a tree patch (``troots`` / ``tleaves``
  probes, then ``tpatch``) in both packages alike;
- host membership: grow 3 -> 5 (the pinned, joint and collapse ``cfg``
  records, the joiners' installs), then a dead host replaced by a blank
  one;
- follower reads: every read verb answered by each package's replicas
  on the same grant schedule — served under a grant, refused for rows
  with an unconfirmed write, fenced by a higher promise, lapsed after
  the lease.

Each package runs the same script, the JAX package first; the port's
replicas then bind the ports the JAX run's replicas had, so the host
addresses inside ``cfg`` records, snapshots and WAL records are the
same bytes.  After every call the script waits until each frame the
leader posted has its answer and no tree probe is running, so both
packages walk their catch-up state machines through the same frames.
Compared: every frame each leader posted on each link (the ``hello``
nudges and the tree probes included), the group counters, the
futures, every lane, and the WAL files.  Tolerance: exact equality.
"""

import os
import socket
import time

import numpy as np
import pytest

from riak_ensemble_tpu_torch import wire as twire
from riak_ensemble_tpu_torch.config import Config as TConfig
from riak_ensemble_tpu_torch.config import fast_test_config as t_fast
from riak_ensemble_tpu_torch.parallel import repgroup as trg
from test_torch_compaction import norm
from test_torch_kmodify import FixedClock
from test_torch_reference_natives import reference_natives  # noqa: F401 (autouse)
from test_torch_wal import _tree

jax = pytest.importorskip("jax")

from riak_ensemble_tpu.config import Config as JConfig  # noqa: E402
from riak_ensemble_tpu.config import fast_test_config as j_fast  # noqa: E402
from riak_ensemble_tpu.parallel import repgroup as jrg  # noqa: E402
from test_torch_repgroup import (  # noqa: E402
    E, GROUP, K, S, _parts_bytes, _settle, _stop, _traffic, _wait_lanes,
    env)  # noqa: F401

LEADER_ADDR = ("leader.test", 1)
PACKAGES = ((jrg, j_fast, {}), (trg, t_fast, {"device": "cpu"}))
GROUP_KEYS = ("tree_resyncs", "tree_resync_bytes", "resyncs",
              "repl_delta_entries", "repl_full_entries", "repl_frames",
              "repl_bytes_shipped", "repl_bytes_sections",
              "repl_merge_cells", "quorum_failures", "applies")


class _Wire:
    """Every frame any leader link of ``rg`` posts, by replica port, as
    bytes (encoded frames) or as the tuple given (control frames), and
    every ticket, so the script can wait for each answer."""

    def __init__(self, monkeypatch, rg):
        self.frames, self.tickets = {}, []
        orig = rg.PeerLink.post
        rec = self

        def post(link, frame, on_done=None):
            if isinstance(frame, rg._EncodedParts):
                item = _parts_bytes(frame)
            elif isinstance(frame, rg._Encoded):
                item = frame.payload
            else:
                item = tuple(frame)
            rec.frames.setdefault(link.port, []).append(item)
            t = orig(link, frame, on_done)
            rec.tickets.append(t)
            return t
        monkeypatch.setattr(rg.PeerLink, "post", post)

    def quiesce(self, svc, budget=30.0):
        """Until every posted frame has its answer (or its failure) and
        no tree probe is running on any link."""
        end = time.monotonic() + budget
        while time.monotonic() < end:
            if all(t.event.is_set() for t in self.tickets) and all(
                    link.sync is None or link.sync.result is not None
                    for link in svc._links):
                return
            time.sleep(0.01)
        raise AssertionError("the links never went quiet")


def _replica(rg, fast, kw, root, name, port=0, **extra):
    return rg.ReplicaServer(E, GROUP, S, repl_port=port,
                            data_dir=os.path.join(root, name),
                            config=fast(), **kw, **extra)


def _leader(rg, fast, kw, root, srvs, **extra):
    return rg.ReplicatedService(
        FixedClock(), E, 1, S, group_size=GROUP,
        peers=[("127.0.0.1", s.repl_port) for s in srvs], ack_timeout=15.0,
        config=fast(), data_dir=os.path.join(root, "leader"),
        max_ops_per_tick=K, **kw, **extra)


def _kill(svc, srv):
    """An in-process host death: it stops answering, its ports close,
    the leader's connection to it drops (the script waits until the
    leader's link has seen it), and its WAL closes."""
    with srv._lock:
        srv._handle_repl = lambda frame: ("error", "host down")
    srv.stop()
    for link in svc._links:
        if link.port == srv.repl_port and link._sock is not None:
            try:
                link._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
    with srv._lock:
        if srv.svc._wal is not None:
            srv.svc._wal.close()
    end = time.monotonic() + 30.0
    while any(link.port == srv.repl_port and link.connected
              for link in svc._links):
        assert time.monotonic() < end, "the leader never saw the death"
        time.sleep(0.01)


def _beats(svc, rec, n):
    for _ in range(n):
        svc.heartbeat()
        rec.quiesce(svc)


def _round(svc, rec, ops, futs):
    """One settled round of ``ops(svc)``'s futures, then quiet links."""
    new = ops(svc)
    _settle(svc, new)
    futs += new
    svc.runtime.now += 0.25
    rec.quiesce(svc)


def _release(srvs):
    """Free the stopped hosts' ports for the next package's run: a
    listening socket closed while its accept thread waits stays bound
    until one more connection wakes that thread."""
    for s in srvs:
        for port in (s.repl_port, s.client_port):
            try:
                socket.create_connection(("127.0.0.1", port), 1.0).close()
            except OSError:
                pass
        end = time.monotonic() + 10.0
        while True:
            try:
                socket.create_server(("127.0.0.1", s.repl_port)).close()
                break
            except OSError:
                assert time.monotonic() < end, f"port {s.repl_port} held"
                time.sleep(0.02)


def _gap_ops(r):
    """Writes on ensembles 0 and 1 only: two of four rows diverge, so
    the tree probe chooses a patch (over half would mean the full
    snapshot)."""
    def ops(svc):
        return [svc.kput_many(e, ["k0", f"gap{r}"],
                              [b"g%d.%d" % (r, e), b"h%d" % r])
                for e in (0, 1)]
    return ops


def _traffic_ops(seed, r):
    def ops(svc):
        futs = []
        _traffic(np.random.default_rng(seed), svc, r, futs)
        return futs
    return ops


def _decoded(frames, op):
    """The recorded encoded frames whose verb is ``op``, decoded."""
    out = []
    for f in frames:
        if isinstance(f, bytes):
            d = twire.decode(f[trg._HDR.size:])
            if d[0] == op:
                out.append(d)
    return out


def _same_runs(runs, tmp_path, dirs):
    """Everything the two packages' runs recorded, equal."""
    (jr, tr) = runs
    assert [norm(v) for v in tr["futs"]] == [norm(v) for v in jr["futs"]]
    assert set(tr["frames"]) == set(jr["frames"])
    for port in jr["frames"]:
        assert tr["frames"][port] == jr["frames"][port], port
    for key in GROUP_KEYS:
        assert tr["group"][key] == jr["group"][key], key
    assert tr["lead"] == jr["lead"]
    assert tr["lanes"] == jr["lanes"]
    assert all(lane == jr["lead"] for lane in jr["lanes"])
    for sub in dirs:
        assert _tree(str(tmp_path / trg.__name__ / sub)) == \
            _tree(str(tmp_path / jrg.__name__ / sub)), sub


# -- tree catch-up ---------------------------------------------------------------


def _catchup_run(env, rg, fast, kw, root, ports):
    rec = _Wire(env, rg)
    srvs = [_replica(rg, fast, kw, root, f"r{i}", p)
            for i, p in enumerate(ports, start=1)]
    svc = _leader(rg, fast, kw, root, srvs)
    futs: list = []
    gone: list = []
    try:
        assert svc.takeover()
        rec.quiesce(svc)
        for r in range(2):
            _round(svc, rec, _traffic_ops(300 + r, r), futs)
        port = srvs[0].repl_port
        _kill(svc, srvs[0])
        for r in range(2):
            _round(svc, rec, _gap_ops(r), futs)    # 2 of 3 commit
        gone.append(srvs[0])
        srvs[0] = _replica(rg, fast, kw, root, "r1", port)
        _beats(svc, rec, 6)
        link = svc._links[0]
        assert link.connected and not link.needs_sync
        _round(svc, rec, _traffic_ops(310, 2), futs)
        lead, lanes = _wait_lanes(svc, srvs, rg)
        out = {"ports": [s.repl_port for s in srvs], "frames": rec.frames,
               "group": dict(svc.stats()["group"]), "lead": lead,
               "lanes": lanes, "futs": [f.value for f in futs]}
    finally:
        _stop(svc, srvs)
        _release(srvs + gone)
    return out


def test_restarted_replica_tree_patch_like_the_reference(env, tmp_path):
    """kill a replica, commit two flushes at 2 of 3, restart it from its
    data dir: both packages probe it (``troots``, ``tleaves`` for the two
    diverged rows), ship the same ``tpatch`` bytes, count the same
    catch-up bytes, and end with every lane and WAL file equal."""
    runs, ports = [], [0, 0]
    for rg, fast, kw in PACKAGES:
        runs.append(_catchup_run(env, rg, fast, kw,
                                 str(tmp_path / rg.__name__), ports))
        ports = runs[-1]["ports"]
    for run in runs:
        g = run["group"]
        assert g["tree_resyncs"] == 1 and g["resyncs"] == 0, g
        assert g["tree_resync_bytes"] > 0 and g["quorum_failures"] == 0
        ops = [f[0] for f in run["frames"][ports[0]] if isinstance(f, tuple)]
        assert "troots" in ops and "tleaves" in ops, ops
        patches = _decoded(run["frames"][ports[0]], "tpatch")
        assert len(patches) == 1
        assert {p[0] for p in patches[0][5]} <= {0, 1}
    _same_runs(runs, tmp_path, ("leader", "r1", "r2"))


# -- host membership -------------------------------------------------------------


def _membership_run(env, rg, fast, kw, root, ports):
    rec = _Wire(env, rg)
    srvs = [_replica(rg, fast, kw, root, f"r{i}", p)
            for i, p in enumerate(ports[:2], start=1)]
    svc = _leader(rg, fast, kw, root, srvs, self_addr=LEADER_ADDR)
    futs: list = []
    dead = srvs[1]

    def addr(s):
        return ("127.0.0.1", s.repl_port)
    try:
        assert svc.takeover()
        rec.quiesce(svc)
        _round(svc, rec, _traffic_ops(400, 0), futs)
        # grow 3 -> 5: two blank joiners
        srvs += [_replica(rg, fast, kw, root, f"r{i}", ports[i - 1])
                 for i in (3, 4)]
        five = [LEADER_ADDR] + [addr(s) for s in srvs]
        svc.update_members(five)
        rec.quiesce(svc)
        _round(svc, rec, _traffic_ops(401, 1), futs)   # joint window
        _beats(svc, rec, 6)
        st = svc.membership_status()
        assert not st["transition"] and set(map(tuple, st["hosts"])) == \
            set(five) and svc.group_size == 5
        # replace a dead host with a blank one
        dead = srvs.pop(1)
        _kill(svc, dead)
        _round(svc, rec, _traffic_ops(402, 2), futs)   # 4 of 5 commit
        srvs.append(_replica(rg, fast, kw, root, "r5", ports[4]))
        repl = [LEADER_ADDR] + [addr(s) for s in srvs]
        svc.update_members(repl)
        rec.quiesce(svc)
        _beats(svc, rec, 6)
        st = svc.membership_status()
        assert not st["transition"] and set(map(tuple, st["hosts"])) == \
            set(repl)
        assert sorted(link.port for link in svc._links) == \
            sorted(s.repl_port for s in srvs)
        _round(svc, rec, _traffic_ops(403, 3), futs)
        lead, lanes = _wait_lanes(svc, srvs, rg)
        out = {"ports": [s.repl_port for s in srvs[:1]] + [dead.repl_port]
               + [s.repl_port for s in srvs[1:]],
               "frames": rec.frames, "group": dict(svc.stats()["group"]),
               "lead": lead, "lanes": lanes, "futs": [f.value for f in futs],
               "cfg": svc.core.cfg}
    finally:
        _stop(svc, srvs)
        _release(srvs + [dead])
    return out


def test_grow_and_replace_hosts_like_the_reference(env, tmp_path):
    """Grow 3 -> 5 with writes in the joint window, then replace a dead
    host with a blank one: both packages ship the same ``cfg`` records
    and installs, count the same, fail no ack, and end with the same
    config, lanes and WAL files."""
    runs, ports = [], [0] * 5
    for rg, fast, kw in PACKAGES:
        runs.append(_membership_run(env, rg, fast, kw,
                                    str(tmp_path / rg.__name__), ports))
        ports = runs[-1]["ports"]
    for run in runs:
        g = run["group"]
        # each of the three joiners synced once: by a tree patch when
        # at most half its rows differ, else by the full install
        assert g["quorum_failures"] == 0, g
        assert g["resyncs"] + g["tree_resyncs"] == 3, g
        cfgs = [c for fl in run["frames"].values()
                for c in _decoded(fl, "cfg")]
        assert any(c[5] is not None for c in cfgs)      # a joint record
    assert runs[1]["cfg"] == runs[0]["cfg"]
    _same_runs(runs, tmp_path, ("leader", "r1", "r2", "r3", "r4", "r5"))


# -- follower reads --------------------------------------------------------------

LEASE = 4.0


def _lease_cfg(cls):
    return cls(ensemble_tick=0.05, lease_duration=LEASE, probe_delay=0.1,
               storage_delay=0.005, storage_tick=0.5, gossip_tick=0.2)


def _ask(rg, port, *frame):
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        rg.send_frame(s, frame)
        return rg.recv_frame(s)[1]


def _battery(rg, srv):
    """Every read verb on every row, from one replica's client port."""
    keys = ["k0", "k1"]
    lens = np.asarray([len(k) for k in keys], "<i4").tobytes()
    out = []
    for e in range(E):
        out += [_ask(rg, srv.client_port, 0, "kget", e, "k0"),
                _ask(rg, srv.client_port, 1, "kget_vsn", e, "k1"),
                _ask(rg, srv.client_port, 2, "kget_many", e,
                     ["k0", "k2", "absent"]),
                _ask(rg, srv.client_port, 3, "kget_slab", e, lens,
                     "".join(keys).encode()),
                _ask(rg, srv.client_port, 4, "kget", e, "ctr")]
    return [norm(x) for x in out]


def _granted(groups):
    """Beat every leader until each replica's window serves every row."""
    end = time.monotonic() + 30.0
    while time.monotonic() < end:
        for svc, _srvs in groups:
            svc.heartbeat()
            svc._drain_pending(block_all=True)
        if all(s.core._flw_serve_ok(e) for _svc, srvs in groups
               for s in srvs for e in range(E)):
            return
        time.sleep(0.02)
    raise AssertionError("the grants never landed")


def _answers(groups):
    """The battery from each replica of each package; the packages'
    answers must be equal, replica by replica."""
    got = [[_battery(rg, s) for s in srvs]
           for (_svc, srvs), rg in zip(groups, (jrg, trg))]
    assert got[1] == got[0]
    return got[1]


def test_follower_reads_answer_like_the_reference(env, tmp_path):
    """Both packages' replicas answer every read verb alike at each point
    of one grant schedule: served once granted, refused on rows with an
    acknowledged but unconfirmed write, served again at the next grant,
    refused at once after a higher promise, refused by all once the
    lease has run out; the served and blocked counts are equal too."""
    groups = []
    for rg, cfg, kw in ((jrg, JConfig, {}), (trg, TConfig,
                                             {"device": "cpu"})):
        root = str(tmp_path / rg.__name__)
        srvs = [_replica(rg, lambda: _lease_cfg(cfg), kw, root, n,
                         follower_reads=True) for n in ("r1", "r2")]
        svc = _leader(rg, lambda: _lease_cfg(cfg), kw, root, srvs,
                      follower_reads=True)
        groups.append((svc, srvs))
    futs = ([], [])
    try:
        for (svc, _srvs), fl in zip(groups, futs):
            assert svc.takeover()
            # the shape of the unconfirmed write below, launched once
            # here so that no first launch eats into the grant
            new = [svc.kput(e, "k0", b"old%d" % e) for e in (0, 1)]
            _settle(svc, new)
            fl += new
            new = [svc.kput_many(e, ["k0", "k1", "k2"],
                                 [b"a%d" % e, b"b%d" % e, b"c%d" % e])
                   for e in range(E)]
            new += [svc.kmodify(e, "ctr", trg.funref.ref("rmw:add", 2), 0)
                    for e in range(E)]
            _settle(svc, new)
            fl += new
        _granted(groups)
        served = _answers(groups)
        assert served[0][0] == ("ok", b"a0")
        # a write on rows 0 and 1, acknowledged, its grant not yet out:
        # those rows refuse, the others serve
        for (svc, _srvs), fl in zip(groups, futs):
            new = [svc.kput(e, "k0", b"new%d" % e) for e in (0, 1)]
            _settle(svc, new)
            fl += new
        fresh = _answers(groups)
        for rep in fresh:
            assert all(a == ("error", "not-leader") for a in rep[:10])
            assert rep[10:] == served[0][10:]
        _granted(groups)
        again = _answers(groups)
        assert again[0][0] == ("ok", b"new0") and again[1][0] == ("ok", b"new0")
        # a higher promise fences replica 0 at once; replica 1 serves on
        for _svc, srvs in groups:
            with srvs[0]._lock:
                assert srvs[0].core.handle_promise(
                    srvs[0].core.promised + 5)[1] is True
        fenced = _answers(groups)
        assert all(a == ("error", "not-leader") for a in fenced[0])
        assert fenced[1] == again[1]
        # past the lease every window lapses
        time.sleep(LEASE + 0.3)
        lapsed = _answers(groups)
        assert all(a == ("error", "not-leader") for rep in lapsed
                   for a in rep)
        assert [norm(f.value) for f in futs[1]] == \
            [norm(f.value) for f in futs[0]]
        for key in ("follower_reads_served", "follower_reads_blocked"):
            assert [s.svc.group_stats[key] for s in groups[1][1]] == \
                [s.svc.group_stats[key] for s in groups[0][1]], key
    finally:
        for svc, srvs in groups:
            _stop(svc, srvs)
