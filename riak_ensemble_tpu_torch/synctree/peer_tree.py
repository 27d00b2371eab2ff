"""Tree-server actor: one synctree per peer, serialized access.

Copied from ``riak_ensemble_tpu/synctree/peer_tree.py`` with its imports pointed at
this package, so the port imports nothing of the JAX package.

Mirrors ``src/riak_ensemble_peer_tree.erl``: a gen_server owning the
tree, tracking the last ``corrupted`` location, with sync ops (get /
insert / exchange_get / top_hash / height / verify) and async ops that
reply by event to the owning peer FSM (``async_repair`` →
``repair_complete``, peer_tree.erl:127-129, 211-212, 264-277).

Message protocol (all sync ops carry a reply Future):
  ('tree_get', key, fut) -> hash | None | 'corrupted'
  ('tree_insert', key, objhash, fut) -> 'ok' | 'corrupted'
  ('tree_exchange_get', level, bucket, fut) -> bucket dict|'corrupted'
  ('tree_top_hash', fut) / ('tree_height', fut)
  ('tree_verify_upper', fut) / ('tree_verify', fut)
  ('tree_rehash', fut) / ('tree_rehash_upper', fut)
  ('tree_async_repair', owner_name)  -> sends ('repair_complete',)
"""

from __future__ import annotations

from typing import Optional, Tuple

from riak_ensemble_tpu_torch.runtime import Actor, Future, Runtime
from riak_ensemble_tpu_torch.synctree.tree import Corrupted, SyncTree


class PeerTree(Actor):
    def __init__(self, runtime: Runtime, name, node, tree: SyncTree) -> None:
        super().__init__(runtime, name, node)
        self.tree = tree
        self.corrupted: Optional[Tuple[int, int]] = None

    def handle(self, msg: Tuple) -> None:
        kind = msg[0]
        if kind == "xcall":
            # Wire-safe remote call: run the inner op with a local
            # future whose resolution replies over the transport
            # (remote exchange reads, synctree_remote.erl role).
            from riak_ensemble_tpu_torch import msg as msglib

            _, from_, inner = msg
            fut = Future()
            msglib.handle_xcall(self, from_, fut)
            self.handle(tuple(inner) + (fut,))
            return
        if kind == "tree_get":
            _, key, fut = msg
            result = self.tree.get(key)
            if isinstance(result, Corrupted):
                self.corrupted = (result.level, result.bucket)
                fut.resolve("corrupted")
            else:
                fut.resolve(result)
        elif kind == "tree_insert":
            _, key, objhash, fut = msg
            result = self.tree.insert(key, objhash)
            if isinstance(result, Corrupted):
                self.corrupted = (result.level, result.bucket)
                fut.resolve("corrupted")
            else:
                fut.resolve("ok")
        elif kind == "tree_exchange_get_many":
            # Level-batched exchange fetch (the start_exchange_level
            # streaming hook): one message covers a whole level's
            # buckets.
            _, pairs, fut = msg
            out = []
            for level, bucket in pairs:
                result = self.tree.exchange_get(level, bucket)
                if isinstance(result, Corrupted):
                    self.corrupted = (result.level, result.bucket)
                    out.append("corrupted")
                else:
                    out.append(result)
            fut.resolve(out)
        elif kind == "tree_exchange_get":
            _, level, bucket, fut = msg
            result = self.tree.exchange_get(level, bucket)
            if isinstance(result, Corrupted):
                self.corrupted = (result.level, result.bucket)
                fut.resolve("corrupted")
            else:
                fut.resolve(result)
        elif kind == "tree_top_hash":
            msg[1].resolve(self.tree.top_hash)
        elif kind == "tree_height":
            msg[1].resolve(self.tree.height)
        elif kind == "tree_verify_upper":
            msg[1].resolve(self.tree.verify_upper())
        elif kind == "tree_verify":
            msg[1].resolve(self.tree.verify())
        elif kind == "tree_rehash":
            self.tree.rehash()
            msg[1].resolve("ok")
        elif kind == "tree_rehash_upper":
            self.tree.rehash_upper()
            msg[1].resolve("ok")
        elif kind == "tree_async_repair":
            owner = msg[1]
            self._do_repair()
            self.send_local(owner, ("repair_complete",))

    def _do_repair(self) -> None:
        """Repair after detected corruption.

        Segment-level corruption: delete the corrupted segment, then
        full rehash (peer_tree.erl:264-277); the lost keys are healed
        by the subsequent exchange + read-path rewrite.

        Inner-node corruption: the reference merely clears the
        corrupted flag (peer_tree.erl:275-276) which can ping-pong with
        a failing verify_upper; we instead rehash from the leaf data
        (leaves are the truth, so this genuinely repairs inner nodes) —
        a strictly stronger recovery than the reference.
        """
        if self.corrupted is None:
            return
        level, bucket = self.corrupted
        if level == self.tree.height + 1:
            self.tree._bdelete((level, bucket))
        self.tree.rehash()
        self.corrupted = None
