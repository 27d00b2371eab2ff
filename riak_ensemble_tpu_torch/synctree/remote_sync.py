"""Streamed Merkle exchange between OS processes — the
``synctree_remote.erl`` role for the DEVICE tree.

Port of ``riak_ensemble_tpu/synctree/remote_sync.py`` on the port's wire
codec, framing and acceptor (:mod:`..parallel.repgroup`).  The
reference proves its exchange streams level-by-level across a process
boundary and counts the messages/bytes it costs
(``test/synctree_remote.erl:24-38``); the descent fetches only the
children of differing buckets (``synctree.erl:372-417``), so traffic
is O(width · height · diffs), never O(keys).

A :class:`TreeSyncServer` exposes one host's levels (a tree of
:mod:`..ops.hash`, on the card or the CPU) over the wire, and
:func:`sync_diff` descends from another process — ONE level-batched
request per level, gathering only the differing parents' children on
BOTH sides: an index gather on the trees' device, then a copy of just
those nodes to the host, never a whole level.  Nodes travel as the
reference's little-endian uint32 ``[n, LANES]`` bytes (the port's int32
lanes hold the same bits), so the frames are the reference's byte for
byte.  The caller gets the divergent segment ids (what key repair must
fetch) plus a traffic ledger the tests assert the O-bound against.
"""

from __future__ import annotations

import socket
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from riak_ensemble_tpu_torch import wire
from riak_ensemble_tpu_torch.ops import hash as hashk
from riak_ensemble_tpu_torch.parallel.repgroup import (
    _ThreadedAcceptor, recv_frame, send_frame)


def _gather(level: torch.Tensor, ids) -> np.ndarray:
    """Nodes ``ids`` of one level as host uint32 ``[n, LANES]``: the
    gather runs where the level lies, and only the gathered nodes are
    copied off the device."""
    idx = torch.as_tensor(np.asarray(ids, np.int64), device=level.device)
    return level[idx].cpu().numpy().view(np.uint32)


class TreeSyncServer:
    """Serve one device tree's levels to remote exchange clients.

    Protocol (one response per request):
      ("meta",)             -> ("meta", n_levels, n_segments, lanes)
      ("nodes", level, ids) -> ("nodes", raw_uint32_bytes)  # [n, LANES]
    """

    def __init__(self, levels: hashk.Levels, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        self.levels = levels
        self._srv = _ThreadedAcceptor(host, port, self._serve)
        self.port = self._srv.port

    def _serve(self, sock: socket.socket) -> None:
        while True:
            try:
                frame = recv_frame(sock)
            except (ConnectionError, OSError, wire.WireError):
                return
            try:
                if frame[0] == "meta":
                    resp = ("meta", len(self.levels),
                            int(self.levels[-1].shape[0]), hashk.LANES)
                elif frame[0] == "nodes":
                    _, level, ids = frame
                    lvl = self.levels[int(level)]
                    ids = np.asarray(ids, np.int64).clip(
                        0, lvl.shape[0] - 1)
                    resp = ("nodes", _gather(lvl, ids).tobytes())
                else:
                    resp = ("error", "unknown-op")
            except Exception:
                resp = ("error", "bad-request")
            try:
                send_frame(sock, resp)
            except (ConnectionError, OSError):
                return

    def close(self) -> None:
        self._srv.close()


def sync_diff(levels: hashk.Levels, host: str, port: int,
              width: int = 16, timeout: float = 120.0
              ) -> Tuple[np.ndarray, Dict[str, Any]]:
    """Find every segment where the remote tree differs from
    ``levels``, exchanging O(width · height · diffs) traffic.

    Returns ``(segment_ids, stats)`` where stats carries the message
    count, bytes in each direction and per-level visited-node counts —
    the ledger ``test/synctree_remote.erl`` keeps across its process
    boundary, and what the tests bound against ``hash.exchange_cost``.
    """
    stats: Dict[str, Any] = {"messages": 0, "bytes_tx": 0,
                             "bytes_rx": 0, "visited": []}

    def call(sock, frame):
        payload = wire.encode(frame)
        stats["messages"] += 1
        stats["bytes_tx"] += len(payload) + 4
        send_frame(sock, frame)
        resp = recv_frame(sock)
        stats["bytes_rx"] += len(wire.encode(resp)) + 4
        return resp

    with socket.create_connection((host, port), timeout=timeout) as s:
        s.settimeout(timeout)
        meta = call(s, ("meta",))
        assert meta[0] == "meta", meta
        n_levels, segs, lanes = int(meta[1]), int(meta[2]), int(meta[3])
        if n_levels != len(levels) or lanes != hashk.LANES or \
                segs != int(levels[-1].shape[0]):
            raise ValueError(
                f"tree shape mismatch: remote {n_levels} levels/"
                f"{segs} segs, local {len(levels)}/"
                f"{int(levels[-1].shape[0])}")

        # root compare
        r = call(s, ("nodes", 0, [0]))
        remote = np.frombuffer(r[1], np.uint32).reshape(-1, lanes)
        local = _gather(levels[0], [0])
        diff = [0] if (remote[0] != local[0]).any() else []
        stats["visited"].append(1)

        for level in range(1, n_levels):
            if not diff:
                stats["visited"].append(0)
                continue
            child_ids: List[int] = []
            for p in diff:
                base = p * width
                child_ids.extend(range(base, base + width))
            r = call(s, ("nodes", level, child_ids))
            remote = np.frombuffer(r[1], np.uint32).reshape(-1, lanes)
            local = _gather(levels[level], child_ids)
            neq = (remote != local).any(axis=1)
            diff = [child_ids[i] for i in np.nonzero(neq)[0]]
            stats["visited"].append(len(child_ids))

    return np.asarray(diff, np.int64), stats
