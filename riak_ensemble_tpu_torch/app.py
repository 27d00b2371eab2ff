"""Application facade: per-node bring-up and the top-level API.

Copied from ``riak_ensemble_tpu/app.py`` with its imports pointed at
this package, so the port imports nothing of the JAX package.

The role of ``riak_ensemble_app.erl`` + ``riak_ensemble_sup.erl``: one
call starts a node's full stack in dependency order — routers, storage,
manager (the reference's rest_for_one order router_sup → storage →
peer_sup → manager, riak_ensemble_sup.erl:48-55; peers are started by
the manager's reconciliation, not statically).

``Node`` bundles the per-node handles and the user-facing operations
(enable/join/remove/create_ensemble/client), so application code reads
like the reference's public API surface:

    runtime = Runtime(seed)
    n0 = start(runtime, "node0", config, data_root="/data/n0")
    n0.enable()
    n1 = start(runtime, "node1", config, data_root="/data/n1")
    n1.join("node0")
    n0.create_ensemble("kv", peers)
    n0.client().kover("kv", key, value)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

from riak_ensemble_tpu_torch.client import Client
from riak_ensemble_tpu_torch.config import Config
from riak_ensemble_tpu_torch.manager import Manager
from riak_ensemble_tpu_torch.runtime import Runtime
from riak_ensemble_tpu_torch.storage import Storage
from riak_ensemble_tpu_torch.types import PeerId


@dataclass
class Node:
    runtime: Runtime
    node: str
    manager: Manager
    storage: Storage

    def enable(self, wait: float = 60.0) -> str:
        """Activate the cluster and wait for the root ensemble to
        elect (callers may join/write immediately after — the
        reference leaves that wait to the caller, we fold it in)."""
        result = self.manager.enable()
        if result != "ok":
            return result

        def root_leading() -> bool:
            peer = self.manager.local_peers.get(
                ("root", PeerId("root", self.node)))
            return peer is not None and peer.fsm_state == "leading"
        if not self.runtime.run_until(root_leading, wait, poll=0.05):
            return "timeout"
        return "ok"

    def join(self, other_node: str, timeout: float = 60.0):
        return self.runtime.await_future(
            self.manager.join_async(other_node, timeout), timeout + 5.0)

    def remove(self, target_node: str, timeout: float = 60.0):
        return self.runtime.await_future(
            self.manager.remove_async(target_node, timeout), timeout + 5.0)

    def create_ensemble(self, ensemble: Any, peers: Sequence[PeerId],
                        mod: str = "basic", args=(), timeout: float = 30.0):
        leader = peers[0] if peers else None
        return self.runtime.await_future(
            self.manager.create_ensemble(ensemble, leader, list(peers),
                                         mod, tuple(args), timeout),
            timeout + 5.0)

    def client(self) -> Client:
        return Client(self.runtime, self.node)

    def enabled(self) -> bool:
        return self.manager.enabled()

    def stop(self) -> None:
        """Stop this node's stack (manager stops; its peers follow on
        the next reconciliation of the surviving nodes)."""
        for key in list(self.manager.local_peers):
            self.manager.stop_peer(*key)
        self.runtime.stop_actor(self.manager.name)
        self.runtime.stop_actor(self.storage.name)


def start(runtime: Runtime, node: str, config: Optional[Config] = None,
          data_root: Optional[str] = None, **peer_kw) -> Node:
    """Start one node's stack (the app:start / sup tree analog)."""
    config = config if config is not None else Config()
    storage = Storage(runtime, node, config, data_root)
    manager = Manager(runtime, node, config, storage, **peer_kw)
    return Node(runtime=runtime, node=node, manager=manager,
                storage=storage)
