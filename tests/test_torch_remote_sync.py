"""The port's streamed Merkle exchange against the JAX package's.

``tests/test_remote_sync.py``'s three cases, each run through both
packages on the same trees: the 1M-segment exchange across a real
process boundary (a port server in a child process; the port's
``sync_diff`` and the reference's both descend against it and must find
the same divergent segments with the same traffic ledger), the
identical-tree exchange, and the shape-mismatch rejection.  The
servers' answers are compared as raw frames: for the same requests, a
port server and a reference server holding the same levels answer the
same bytes.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from riak_ensemble_tpu.ops import hash as jh  # noqa: E402
from riak_ensemble_tpu.synctree import remote_sync as jrs  # noqa: E402
from riak_ensemble_tpu_torch.ops import hash as th  # noqa: E402
from riak_ensemble_tpu_torch.ops import u32  # noqa: E402
from riak_ensemble_tpu_torch.parallel import repgroup as trg  # noqa: E402
from riak_ensemble_tpu_torch.synctree import remote_sync as trs  # noqa: E402

SEGS = 16 ** 5  # 1M segments — the reference synctree's design scale
WIDTH = 16
N_DIFFS = 37
SEED = 424242
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(u32.from_uint32(np.asarray(a)).copy())


def _mutations():
    rng = np.random.default_rng(SEED)
    ids = rng.choice(SEGS, N_DIFFS, replace=False).astype(np.int32)
    new = rng.integers(0, 2 ** 32, (N_DIFFS, th.LANES)).astype(np.uint32)
    return ids, new


def _port_base(segs=SEGS):
    idx = torch.arange(segs, dtype=torch.int32)
    return th.build(th.leaf_hash(idx, idx * 7 + 1), width=WIDTH)


def _ref_base(segs=SEGS):
    idx = jnp.arange(segs, dtype=jnp.uint32)
    return jh.build(jh.leaf_hash(idx, idx * 7 + 1), width=WIDTH)


_CHILD = textwrap.dedent(f"""
    import sys, time
    sys.path.insert(0, {ROOT!r})
    import numpy as np
    import torch
    from riak_ensemble_tpu_torch.ops import hash as th
    from riak_ensemble_tpu_torch.ops import u32
    from riak_ensemble_tpu_torch.synctree import remote_sync

    SEGS = {SEGS}; WIDTH = {WIDTH}; N_DIFFS = {N_DIFFS}; SEED = {SEED}
    idx = torch.arange(SEGS, dtype=torch.int32)
    levels = th.build(th.leaf_hash(idx, idx * 7 + 1), width=WIDTH)
    rng = np.random.default_rng(SEED)
    ids = rng.choice(SEGS, N_DIFFS, replace=False).astype(np.int32)
    new = rng.integers(0, 2 ** 32, (N_DIFFS, th.LANES)).astype(np.uint32)
    levels = th.update(levels, torch.from_numpy(ids),
                       torch.from_numpy(u32.from_uint32(new).copy()),
                       width=WIDTH)
    srv = remote_sync.TreeSyncServer(levels)
    print(f"port={{srv.port}}", flush=True)
    time.sleep(600)
""")

#: requests whose raw answers are compared across the two servers
_PROBES = [("meta",), ("nodes", 0, [0]), ("nodes", 1, list(range(16))),
           ("nodes", 5, [0, 5, SEGS - 1, SEGS + 3, -2]),
           ("nodes", 9, [0]), ("bogus",)]


def _raw_answers(port, probes):
    """Raw response frames (header and payload) for ``probes``."""
    out = []
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        for frame in probes:
            trg.send_frame(s, frame)
            head = trg._recv_exact(s, trg._HDR.size)
            (n,) = trg._HDR.unpack(head)
            out.append(head + trg._recv_exact(s, n))
    return out


def test_streamed_exchange_1m_segments_across_processes():
    proc = subprocess.Popen([sys.executable, "-c", _CHILD],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    ref_srv = None
    try:
        line = proc.stdout.readline()
        assert line.startswith("port="), proc.stderr.read()[-3000:]
        port = int(line.split("=")[1])

        local = _port_base()
        ref_local = _ref_base()
        found, stats = trs.sync_diff(local, "127.0.0.1", port, width=WIDTH)
        # the reference's client against the port's server: the same
        # descent, the same ledger
        rfound, rstats = jrs.sync_diff(ref_local, "127.0.0.1", port,
                                       width=WIDTH)
        ids, new = _mutations()
        assert sorted(found.tolist()) == sorted(ids.tolist())
        assert found.tolist() == rfound.tolist()
        assert stats == rstats

        # the reference's server holding the same tree answers the same
        # bytes as the port's
        ref_remote = jh.update(ref_local, jnp.asarray(ids),
                               jnp.asarray(new), width=WIDTH)
        ref_srv = jrs.TreeSyncServer(ref_remote)
        assert _raw_answers(port, _PROBES) == _raw_answers(ref_srv.port,
                                                           _PROBES)
        # and the port's client against it keeps its ledger
        found2, stats2 = trs.sync_diff(local, "127.0.0.1", ref_srv.port,
                                       width=WIDTH)
        assert found2.tolist() == found.tolist() and stats2 == stats

        height = len(local)
        assert stats["messages"] <= height + 1, stats
        remote_levels = th.update(local, torch.from_numpy(ids), _t(new),
                                  width=WIDTH)
        expect_cost = th.exchange_cost(local, remote_levels, width=WIDTH)
        assert stats["visited"] == expect_cost.tolist(), stats
        node_bytes = th.LANES * 4
        bound = (1 + N_DIFFS * WIDTH * height) * node_bytes * 2
        assert stats["bytes_rx"] <= bound, (stats, bound)
        assert stats["bytes_rx"] < SEGS * node_bytes / 100
    finally:
        if ref_srv is not None:
            ref_srv.close()
        proc.kill()
        proc.wait()


def test_exchange_identical_trees_costs_one_node():
    segs = 16 ** 3
    idx = torch.arange(segs, dtype=torch.int32)
    levels = th.build(th.leaf_hash(idx, idx), width=WIDTH)
    jidx = jnp.arange(segs, dtype=jnp.uint32)
    ref_levels = jh.build(jh.leaf_hash(jidx, jidx), width=WIDTH)
    srv = trs.TreeSyncServer(levels)
    ref_srv = jrs.TreeSyncServer(ref_levels)
    try:
        found, stats = trs.sync_diff(levels, "127.0.0.1", srv.port,
                                     width=WIDTH)
        rfound, rstats = jrs.sync_diff(ref_levels, "127.0.0.1",
                                       ref_srv.port, width=WIDTH)
        assert found.size == 0 and rfound.size == 0
        assert stats == rstats
        assert stats["visited"][0] == 1
        assert sum(stats["visited"]) == 1
        probes = [("meta",), ("nodes", 0, [0]),
                  ("nodes", 3, list(range(0, segs, 97)))]
        assert _raw_answers(srv.port, probes) == _raw_answers(ref_srv.port,
                                                              probes)
    finally:
        srv.close()
        ref_srv.close()


def test_exchange_shape_mismatch_rejected():
    segs = 16 ** 2
    levels = _port_base(segs)
    srv = trs.TreeSyncServer(levels)
    ref_srv = jrs.TreeSyncServer(_ref_base(segs))
    try:
        bigger = _port_base(segs * WIDTH)
        ref_bigger = _ref_base(segs * WIDTH)
        for port in (srv.port, ref_srv.port):
            with pytest.raises(ValueError) as pe:
                trs.sync_diff(bigger, "127.0.0.1", port, width=WIDTH)
            with pytest.raises(ValueError) as re_:
                jrs.sync_diff(ref_bigger, "127.0.0.1", port, width=WIDTH)
            assert str(pe.value) == str(re_.value)
    finally:
        srv.close()
        ref_srv.close()
