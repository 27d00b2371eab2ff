"""One cluster story for both planes: the scale path advertised
through the consensus-backed cluster directory.

Copied from ``riak_ensemble_tpu/service_directory.py`` with its imports
pointed at this package, so the port imports nothing of the JAX package.
Registration runs through the port's :mod:`.manager` and root ensemble.

The reference has a single ensemble directory — the root ensemble's
``cluster_state``, reconciled by every manager
(``riak_ensemble_manager.erl:610-641``) — and every ensemble, whatever
its backend, is discovered through it.  This module gives the BATCHED
service plane the same citizenship: a running svcnode registers its
service under a ``("svc", name)`` ensemble id with ``mod="service"``
(a directory-only backend: empty member views, so manager
reconciliation starts no actor peers for it), carrying the TCP
address + shape in ``args``.  Registration flows through the root
ensemble's kmodify like any create_ensemble (strong consistency),
then gossip propagates it to every node; any node's client resolves
the service plane from its local directory cache and dials the
svcnode front-end.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

#: EnsembleInfo.mod marker for directory-only (scale-plane) entries.
SERVICE_MOD = "service"


def service_id(name: Any) -> Tuple[str, Any]:
    return ("svc", name)


def register_service(mgr, runtime, name: Any, host: str, port: int,
                     shape: Tuple[int, int, int],
                     timeout: float = 30.0):
    """Advertise a batched service in the cluster directory (runs the
    full create_ensemble path through the root ensemble —
    manager.erl:157-166 — with no peers to start).  ``shape`` is
    (n_ens, n_peers, n_slots) so clients can validate addressing.
    ``mgr`` is the local node's Manager.  Returns the create result
    ("ok" | error tuple)."""
    fut = mgr.create_ensemble(service_id(name), None, [],
                              SERVICE_MOD,
                              (host, int(port), tuple(shape)), timeout)
    return runtime.await_future(fut, timeout + 5.0)


def resolve_service(directory, name: Any
                    ) -> Optional[Dict[str, Any]]:
    """Look a service plane up in the (gossip-replicated) directory:
    ``{"host", "port", "shape"}`` or None.  Works on any node once
    gossip has propagated the registration."""
    info = directory.known_ensembles().get(service_id(name))
    if info is None or info.mod != SERVICE_MOD:
        return None
    host, port, shape = info.args
    return {"host": host, "port": port, "shape": tuple(shape)}


def list_services(directory) -> Dict[Any, Dict[str, Any]]:
    """Every advertised service plane in the directory."""
    out = {}
    for ens_id, info in directory.known_ensembles().items():
        if (isinstance(ens_id, tuple) and len(ens_id) == 2
                and ens_id[0] == "svc" and info.mod == SERVICE_MOD):
            host, port, shape = info.args
            out[ens_id[1]] = {"host": host, "port": port,
                              "shape": tuple(shape)}
    return out
