"""Root-ensemble operations: consensus-managed cluster metadata.

Copied from ``riak_ensemble_tpu/root.py`` with its imports pointed at
this package, so the port imports nothing of the JAX package.

Re-implementation of ``src/riak_ensemble_root.erl``: every cluster
mutation (join/remove/set_ensemble) is a ``kmodify`` on the key
``cluster_state`` of the distinguished root ensemble, with the mutator
function executed *inside the put FSM on the root leader*
(root.erl:74-114).  The default value for a first write is the calling
node's manager state (root_init, root.erl:118-119).

The mutators delegate to the vsn-guarded
:mod:`riak_ensemble_tpu_torch.state` functions and return ``"failed"`` on a
vsn conflict, which aborts the kmodify (root_call/root_cast,
root.erl:123-165).

``gossip`` is the root leader pushing its own committed views into the
consistent state via a kmodify *cast to itself*; on completion the
(possibly unchanged) state is handed to the local manager for epidemic
spread — through a backpressured singleton in the reference
(maybe_async_gossip, root.erl:167-185), here a plain post to the
manager actor, which serializes naturally.
"""

from __future__ import annotations

from typing import Any, Optional

from riak_ensemble_tpu_torch import funref
from riak_ensemble_tpu_torch import router as routerlib
from riak_ensemble_tpu_torch import state as statelib
from riak_ensemble_tpu_torch.runtime import Future
from riak_ensemble_tpu_torch.state import ClusterState
from riak_ensemble_tpu_torch.types import EnsembleInfo, PeerId, Views, Vsn

ROOT = "root"
KEY = "cluster_state"


def _call(mgr, target_node: str, fun, timeout: float) -> Future:
    """root.erl:74-90: kmodify on `target_node`'s root ensemble; the
    returned future resolves to "ok" | "failed" | "timeout"."""
    default = mgr.get_cluster_state()
    event = ("put", KEY, funref.ref("peer:kmodify"), [fun, default])
    fut = routerlib.sync_send_event_fut(mgr.runtime, target_node, ROOT,
                                        event, timeout)
    out = Future()

    def translate(result: Any) -> None:
        if isinstance(result, tuple) and result[0] == "ok":
            out.resolve("ok")
        else:
            out.resolve(result)

    fut.add_waiter(translate)
    return out


def _cast(mgr, target_node: str, fun, timeout: float = 5.0) -> None:
    """root.erl:92-108: fire-and-forget kmodify."""
    default = mgr.get_cluster_state()
    event = ("put", KEY, funref.ref("peer:kmodify"), [fun, default])
    routerlib.sync_send_event_fut(mgr.runtime, target_node, ROOT, event,
                                  timeout)


# The mutators are registered funrefs so root operations cross nodes as
# plain data (name + bound args), never as live functions — the analog
# of the reference shipping {Module, Function, Cmd} MFAs
# (root.erl:82,104); the executing root leader resolves them locally.


@funref.register("root:join")
def _join_fun(joining_node: str, vsn: Vsn, cs: ClusterState):
    out = statelib.add_member(vsn, joining_node, cs)
    return out if out is not None else "failed"


@funref.register("root:remove")
def _remove_fun(target_node: str, vsn: Vsn, cs: ClusterState):
    out = statelib.del_member(vsn, target_node, cs)
    return out if out is not None else "failed"


@funref.register("root:set_ensemble")
def _set_ensemble_fun(ensemble: Any, info: EnsembleInfo, _vsn: Vsn,
                      cs: ClusterState):
    out = statelib.set_ensemble(ensemble, info, cs)
    return out if out is not None else "failed"


@funref.register("root:update_ensemble")
def _update_ensemble_fun(ensemble: Any, leader: Optional[PeerId],
                         views: Views, vsn: Vsn, _vsn: Vsn,
                         cs: ClusterState):
    out = statelib.update_ensemble(vsn, ensemble, leader, views, cs)
    return out if out is not None else "failed"


def join(mgr, target_node: str, joining_node: str,
         timeout: float = 60.0) -> Future:
    """Add `joining_node` to the cluster via `target_node`'s root
    ensemble (root.erl:47-55, root_call {join,..}:123-130)."""
    return _call(mgr, target_node,
                 funref.ref("root:join", joining_node), timeout)


def remove(mgr, target_node: str, timeout: float = 60.0) -> Future:
    """Remove `target_node`, via the local root (root.erl:57-65)."""
    return _call(mgr, mgr.node,
                 funref.ref("root:remove", target_node), timeout)


def set_ensemble(mgr, ensemble: Any, info: EnsembleInfo,
                 timeout: float = 10.0) -> Future:
    """Create/overwrite an ensemble record (root.erl:38-45,139-145)."""
    return _call(mgr, mgr.node,
                 funref.ref("root:set_ensemble", ensemble, info), timeout)


def update_ensemble(mgr, ensemble: Any, leader: Optional[PeerId],
                    views: Views, vsn: Vsn) -> None:
    """root.erl:34-36,159-165 (cast)."""
    _cast(mgr, mgr.node,
          funref.ref("root:update_ensemble", ensemble, leader, views,
                     vsn))


def gossip(mgr, peer, vsn: Vsn, leader: PeerId, views: Views) -> None:
    """Root leader pushes its committed views into the root state and
    relays the result to the local manager (root.erl:68-70,149-158)."""
    info = EnsembleInfo(vsn=vsn, leader=leader,
                        views=tuple(tuple(v) for v in views), seq=None)

    def fun(_vsn: Vsn, cs: ClusterState):
        out = statelib.set_ensemble(ROOT, info, cs)
        # maybe_async_gossip on both branches (root.erl:149-158)
        mgr.runtime.post(mgr.name, ("gossip", out if out is not None
                                    else cs))
        return out if out is not None else "failed"

    # Cast directly to the issuing peer itself (root.erl:68-70 sends to
    # the root leader's own pid).  This never leaves the node, so the
    # mutator stays a live closure (resolve passes it through).
    fut = Future()
    mgr.runtime.post(peer.name, ("peer_sync", fut,
                                 ("put", KEY, funref.ref("peer:kmodify"),
                                  [fun, mgr.get_cluster_state()])))
