"""Directory: the manager-facing interface peers depend on.

Copied from ``riak_ensemble_tpu/directory.py`` with its imports pointed at
this package, so the port imports nothing of the JAX package.

This is exactly the slice of ``riak_ensemble_manager`` the peer FSM
calls on its hot paths (all ETS reads in the reference —
manager.erl:188-245): peer addressing, current/pending views, cluster
membership — plus the async update/gossip entry points
(``update_ensemble``, ``gossip_pending``, root gossip).

Two implementations:

- :class:`StaticDirectory` — fixed membership for unit/integration
  tests of single ensembles (the ens_test.erl pattern of one host
  hosting all peers, test/ens_test.erl:31-45).
- :class:`riak_ensemble_tpu_torch.manager.Manager` — the full gossiping
  cluster manager (one per node).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from riak_ensemble_tpu_torch.types import PeerId, Views, Vsn


class Directory:
    """Interface; see module docstring."""

    def get_peer_addr(self, ensemble, peer_id) -> Optional[Any]:
        raise NotImplementedError

    def get_views(self, ensemble) -> Optional[Tuple[Vsn, Views]]:
        raise NotImplementedError

    def get_pending(self, ensemble) -> Optional[Tuple[Vsn, Views]]:
        raise NotImplementedError

    def get_leader(self, ensemble) -> Optional[PeerId]:
        raise NotImplementedError

    def cluster(self) -> List[str]:
        raise NotImplementedError

    def update_ensemble(self, ensemble, peer_id, views, vsn) -> None:
        """Leader pushes committed views (manager.erl:150-155)."""

    def gossip_pending(self, ensemble, vsn, views) -> None:
        """Leader pushes pending views (manager.erl:168-173)."""

    def root_gossip(self, peer, vsn, peer_id, views) -> None:
        """Root leader pushes root views (riak_ensemble_root:gossip)."""

    def stop_peer(self, ensemble, peer_id) -> None:
        """Ask the supervisor to stop a peer (transition shutdown)."""


class StaticDirectory(Directory):
    def __init__(self, runtime) -> None:
        self.runtime = runtime
        self.peers: Dict[Tuple[Any, PeerId], Any] = {}
        self.views: Dict[Any, Tuple[Vsn, Views]] = {}
        self.pending: Dict[Any, Tuple[Vsn, Views]] = {}
        self.leaders: Dict[Any, Optional[PeerId]] = {}
        self.nodes: List[str] = []

    def register_peer(self, ensemble, peer_id, actor_name) -> None:
        self.peers[(ensemble, peer_id)] = actor_name
        if peer_id.node not in self.nodes:
            self.nodes.append(peer_id.node)

    def get_peer_addr(self, ensemble, peer_id):
        name = self.peers.get((ensemble, peer_id))
        if name is None or self.runtime.whereis(name) is None:
            return None
        return name

    def get_views(self, ensemble):
        return self.views.get(ensemble)

    def get_pending(self, ensemble):
        return self.pending.get(ensemble)

    def get_leader(self, ensemble):
        return self.leaders.get(ensemble)

    def cluster(self):
        return list(self.nodes)

    def update_ensemble(self, ensemble, peer_id, views, vsn) -> None:
        cur = self.views.get(ensemble)
        if cur is None or vsn > cur[0]:
            self.views[ensemble] = (vsn, views)
            self.leaders[ensemble] = peer_id

    def gossip_pending(self, ensemble, vsn, views) -> None:
        cur = self.pending.get(ensemble)
        if cur is None or vsn > cur[0]:
            self.pending[ensemble] = (vsn, views)

    def stop_peer(self, ensemble, peer_id) -> None:
        name = self.peers.pop((ensemble, peer_id), None)
        if name is not None and self.runtime.whereis(name) is not None:
            self.runtime.stop_actor(name)
