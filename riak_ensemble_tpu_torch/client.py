"""Public K/V client API.

Copied from ``riak_ensemble_tpu/client.py`` with its imports pointed at
this package, so the port imports nothing of the JAX package.

Re-implementation of ``src/riak_ensemble_client.erl``: thin wrappers
over the peer K/V operations, routed to the ensemble leader through
the router pool, with raw protocol results translated to
``("error", reason)`` tuples (translate, client.erl:119-132) and a
local enabled-check returning ``("error", "unavailable")`` when the
node's cluster is not enabled (maybe, client.erl:134-143).

``kmodify`` is intentionally not exposed (root-ensemble internal use
only — client.erl:22-24).

This is the SCALAR actor-plane client (one op, one FSM round).  The
scale path's network client is :class:`riak_ensemble_tpu_torch.svcnode.
ServiceClient`, whose ``kput_many``/``kget_many`` are slab-native:
batches in the slab subset ride the zero-copy ``kput_slab``/
``kget_slab`` wire verbs straight into the service's slab-resident
enqueue half (docs/ARCHITECTURE.md §12).
"""

from __future__ import annotations

from typing import Any

from riak_ensemble_tpu_torch import funref
from riak_ensemble_tpu_torch import router as routerlib
from riak_ensemble_tpu_torch.manager import manager_name
from riak_ensemble_tpu_torch.runtime import Runtime
from riak_ensemble_tpu_torch.types import NOTFOUND, Obj


def translate(result: Any):
    """client.erl:119-132."""
    if isinstance(result, tuple) and result[0] == "ok":
        return result
    if result in ("unavailable", "timeout", "failed"):
        return ("error", result)
    return ("error", "timeout")


class Client:
    """K/V operations issued from one node of the cluster."""

    def __init__(self, runtime: Runtime, node: str) -> None:
        self.runtime = runtime
        self.node = node

    def _maybe(self, fn):
        mgr = self.runtime.whereis(manager_name(self.node))
        if mgr is None or not mgr.enabled():
            return ("error", "unavailable")
        return fn()

    def _sync(self, ensemble, event, timeout: float):
        return translate(routerlib.sync_send_event(
            self.runtime, self.node, ensemble, event, timeout))

    # -- API (client.erl:34-116) ---------------------------------------

    def kget(self, ensemble, key, timeout: float = 10.0, opts=()):
        """Linearizable read.  When ``Config.trust_lease`` holds, the
        ensemble leader answers from its local state inside an
        unexpired lease without a fresh quorum round (peer.erl's
        leased read; the batched scale plane's analog is the
        lease-protected fast path in
        :mod:`riak_ensemble_tpu_torch.parallel.batched_host`, surfaced over
        the wire by :mod:`riak_ensemble_tpu_torch.svcnode`)."""
        return self._maybe(lambda: self._sync(
            ensemble, ("get", key, tuple(opts)), timeout))

    def kupdate(self, ensemble, key, current: Obj, new,
                timeout: float = 10.0):
        return self._maybe(lambda: self._sync(
            ensemble, ("put", key, funref.ref("peer:kupdate"),
                       [current, new]), timeout))

    def kput_once(self, ensemble, key, value, timeout: float = 10.0):
        return self._maybe(lambda: self._sync(
            ensemble, ("put", key, funref.ref("peer:kput_once"), [value]),
            timeout))

    def kover(self, ensemble, key, value, timeout: float = 10.0):
        return self._maybe(lambda: self._sync(
            ensemble, ("overwrite", key, value), timeout))

    def kdelete(self, ensemble, key, timeout: float = 10.0):
        return self.kover(ensemble, key, NOTFOUND, timeout)

    def ksafe_delete(self, ensemble, key, current: Obj,
                     timeout: float = 10.0):
        return self.kupdate(ensemble, key, current, NOTFOUND, timeout)
