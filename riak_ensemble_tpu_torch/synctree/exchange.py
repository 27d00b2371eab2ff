"""Tree exchange driver: sync a peer's Merkle tree with a trusted
majority of its ensemble.

Copied from ``riak_ensemble_tpu/synctree/exchange.py`` with its imports pointed at
this package, so the port imports nothing of the JAX package.

Mirrors ``src/riak_ensemble_exchange.erl``: spawned per exchange
(``start_exchange:23-31``); finds a trusted majority via an
``('exchange',)`` quorum round (required='quorum' if the local tree is
trusted, else 'other' — a majority *excluding* self,
``trust_majority:109-126``), falling back to an ``('all_exchange',)``
round with required='all' (``all_trust_majority:128-145``).  Then
verifies the local upper tree and pairwise-compares against each remote
tree, adopting remote hashes that are missing locally or strictly newer
(``valid_obj_hash(B, A)``, exchange.erl:85-98).  Reports
``exchange_complete`` / ``exchange_failed`` / tree_corrupted back to
the peer FSM.

Runs as a runtime Task; remote tree reads are wire-safe level-batched
xcalls (``tree_exchange_get_many`` — one round trip per level, the
start_exchange_level streaming of synctree_remote.erl) to the remote
peer's tree actor.  The remote tree name is fetched first via a
``tree_pid`` sync call (exchange.erl:71-72) so the M:N shared-tree
mapping keeps working.
"""

from __future__ import annotations

from typing import Any, List

from riak_ensemble_tpu_torch import msg as msglib
from riak_ensemble_tpu_torch.runtime import Future
from riak_ensemble_tpu_torch.synctree.tree import (
    NONE, Corrupted, compare_gen_streamed,
)


def start_exchange(peer, tree_name, peers, views, trusted: bool) -> None:
    """Spawn the exchange task (exchange.erl:23-31)."""
    peer.runtime.spawn_task(
        _perform_exchange(peer, tree_name, peers, views, trusted),
        name=f"exchange:{peer.name}")


def _perform_exchange(peer, tree_name, peers, views, trusted: bool):
    try:
        required = "quorum" if trusted else "other"
        fut = msglib.blocking_send_all(peer, ("exchange",), peer.id, peers,
                                       views, required)
        result = yield fut
        if result[0] == "quorum_met":
            remote_peers = [p for p, _ in result[1]]
        else:
            fut = msglib.blocking_send_all(peer, ("all_exchange",), peer.id,
                                           peers, views, "all")
            result = yield fut
            if result[0] == "quorum_met":
                remote_peers = [p for p, _ in result[1]]
            else:
                peer.runtime.post(peer.name, ("exchange_failed",))
                return
        yield from _perform_exchange2(peer, tree_name, remote_peers)
    except Corrupted:
        yield from _sync_tree_corrupted(peer)
    except Exception:
        peer.runtime.post(peer.name, ("exchange_failed",))


def _sync_tree_corrupted(peer):
    fut = Future()
    peer.runtime.post(peer.name, ("peer_sync", fut, ("tree_corrupted",)))
    yield fut


def _tree_call(peer, tree_name, request) -> Future:
    fut = Future()
    peer.send(tree_name, request + (fut,))
    return fut


def _perform_exchange2(peer, tree_name, remote_peers: List[Any]):
    # Remote reads are wire-safe xcalls (no Futures on the wire), so
    # the same protocol runs on the simulator and the TCP transport; a
    # dead/unreachable remote mid-exchange times out and fails the
    # exchange (the reference's monitor-crash path, exchange.erl:40-52).
    call_timeout = max(peer.config.quorum() * 10, 1.0)
    ok = yield _tree_call(peer, tree_name, ("tree_verify_upper",))
    if not ok:
        yield from _sync_tree_corrupted(peer)
        return
    height = yield _tree_call(peer, tree_name, ("tree_height",))
    for remote in remote_peers:
        remote_addr = peer.peer_addr(remote)
        if remote_addr is None:
            continue
        # Fetch the remote peer's tree name (tree_pid sync event).
        remote_tree = yield msglib.xcall(peer, remote_addr,
                                         ("tree_pid",), call_timeout)
        if remote_tree == "timeout" or remote_tree == "nack":
            peer.runtime.post(peer.name, ("exchange_failed",))
            return

        flags = {"local": False, "remote": False, "timeout": False}

        # Level-batched (streamed) fetches: one local call and ONE
        # remote round trip per level (compare_gen_streamed).
        def local_many(pairs):
            return _tree_call(peer, tree_name,
                              ("tree_exchange_get_many", tuple(pairs)))

        def remote_many(pairs):
            return msglib.xcall(peer, remote_tree,
                                ("tree_exchange_get_many", tuple(pairs)),
                                call_timeout)

        gen = compare_gen_streamed(
            height, _wrap_many(local_many, flags, "local"),
            _wrap_many(remote_many, flags, "remote"))
        diffs = yield from _drive(gen)
        if flags["timeout"]:
            peer.runtime.post(peer.name, ("exchange_failed",))
            return
        if flags["local"]:
            yield from _sync_tree_corrupted(peer)
            return
        if flags["remote"]:
            # Remote tree corrupt: tell it, then move on
            # (exchange.erl:102-108 throws; peer retries later).
            msglib.xcall(peer, remote_addr, ("tree_corrupted",),
                         call_timeout)
            peer.runtime.post(peer.name, ("exchange_failed",))
            return
        for key, (a, b) in diffs:
            if b is NONE:
                continue
            if a is NONE or _valid_obj_hash(b, a):
                yield _tree_call(peer, tree_name, ("tree_insert", key, b))
    peer.runtime.post(peer.name, ("exchange_complete",))


def _wrap_many(fetch_many, flags, side):
    """Translate per-entry 'corrupted' and whole-call 'timeout'
    replies of a batched fetch into Corrupted aborts."""
    def inner(pairs):
        raw = fetch_many(pairs)
        out = Future()

        def on(v):
            if v == "timeout":
                flags["timeout"] = True
                out.resolve([Corrupted(0, 0)] * len(pairs))
                return
            entries = []
            for item in v:
                if item == "corrupted":
                    flags[side] = True
                    entries.append(Corrupted(0, 0))
                else:
                    entries.append(item)
            out.resolve(entries)

        raw.add_waiter(on)
        return out

    return inner


def _drive(gen):
    """Run a compare_gen to completion, re-yielding its futures."""
    try:
        fut = next(gen)
        while True:
            value = yield fut
            fut = gen.send(value)
    except StopIteration as stop:
        return stop.value or []
    except Corrupted:
        return []


def _valid_obj_hash(b: bytes, a: bytes) -> bool:
    """Adopt remote hash only if tagged and >= local
    (riak_ensemble_peer:valid_obj_hash, peer.erl:1726-1729)."""
    return isinstance(b, bytes) and isinstance(a, bytes) and \
        b[:1] == b"\x00" and a[:1] == b"\x00" and b >= a
