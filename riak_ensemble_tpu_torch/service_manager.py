"""Consensus-managed membership for the scale plane.

Copied from ``riak_ensemble_tpu/service_manager.py`` with its imports
pointed at this package, so the port imports nothing of the JAX package.
The tenant rows live on the port's
:class:`.parallel.batched_host.BatchedEnsembleService`, on the card by
default: adopting a tenant is a ``create_ensemble`` on the device state,
a view change an ``update_members`` (``engine.reconfig_step``, K1 for
each gate), and a handoff's export one device gather of the row's object
planes (:func:`gather_obj_planes`) copied off the card at once.

The reference's cluster story is one loop: every mutation flows
through the root ensemble's kmodify (``riak_ensemble_root.erl:38-45``),
gossip replicates the state, and every node's manager reconciles —
starting wanted-but-missing peers and stopping running-but-unwanted
ones (``riak_ensemble_manager.erl:610-641``, ``check_peers:697-715``).
Round 3 bridged the scale plane's *endpoints* into that story
(:mod:`.service_directory`); tenant ensembles were
still managed by direct ``create_ensemble``/``update_members`` calls
on one process.  This module finishes the story:

- **Tenant registry in cluster state.**  A scale-plane tenant is an
  ensemble record ``("svct", name)`` with ``mod="svc_tenant"`` and NO
  peer members (so actor reconciliation starts no processes for it),
  created/retired through the root ensemble exactly like any other
  ensemble and spread by gossip.
- **Derived placement.**  A tenant's owner is not stored — it is the
  rendezvous-hash winner over the svcnodes REGISTERED in the same
  directory (``service_directory``).  Registering a new svcnode
  through the root is therefore the entire join protocol: gossip
  carries the registration, every reconciler recomputes placement,
  and tenants rebalance with no further writes — "ensembles move via
  gossip alone".
- **Reconciliation loop.**  :class:`ServiceReconciler` (one per node
  owning a :class:`BatchedEnsembleService`) is ``check_peers`` for
  tenants: create wanted-but-missing rows, retire
  running-but-unwanted ones, and apply per-tenant view changes from
  the registry through ``update_members``.
- **Handoff.**  When placement moves a tenant away, the retiring
  owner atomically exports the tenant's keyed data and destroys the
  row IN THE SAME TICK (no flush in between: late writes fail fast —
  clients retry against the directory rather than writing into a
  dropped copy), then offers the export to the new owner, which
  imports before serving.  Objects move WITH their {epoch, seq}
  versions (a version-preserving install, not a re-ingest), so a
  client's CAS token survives the placement move — the reference's
  membership-change semantics (replace_members_test.erl:26-30,
  doc/Readme.md:156-167); the importing row's ballot epoch rises past
  the installed maximum, so post-move writes version-dominate.

v1 boundaries (documented, not hidden): a tenant is placed on ONE
svcnode (the repgroup is the cross-host availability story; compose
by making the owner a replication-group leader); writes racing the
exact export tick fail fast rather than forward.
"""

from __future__ import annotations

import hashlib
from dataclasses import replace
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

import torch

from riak_ensemble_tpu_torch import funref
from riak_ensemble_tpu_torch import service_directory as sd
from riak_ensemble_tpu_torch import state as statelib
from riak_ensemble_tpu_torch.runtime import Future

TENANT_MOD = "svc_tenant"


def tenant_id(name: Any) -> Tuple[str, Any]:
    return ("svct", name)


def create_tenant(mgr, runtime, name: Any,
                  view: Optional[List[bool]] = None,
                  timeout: float = 30.0):
    """Register a tenant through the root ensemble
    (manager.erl:157-166 → root:set_ensemble).  Placement is derived,
    so creation carries only the per-tenant peer view (None = all
    peers of the owning service)."""
    if view is not None:
        view = [bool(b) for b in view]
        if not any(view):
            raise ValueError(
                "a tenant view needs at least one member")
    fut = mgr.create_ensemble(
        tenant_id(name), None, [], TENANT_MOD, (view,), timeout)
    return runtime.await_future(fut, timeout + 5.0)


@funref.register("svct:set_args")
def _set_args_fun(ens_id: Any, args: Tuple, _vsn, cs):
    """Root-FSM mutator: read-modify-write of a tenant record ON THE
    CURRENT consensus state (root.erl:74-90 discipline) — a
    local-replica RMW would let a stale gossip copy no-op a retire or
    silently drop one of two concurrent updates."""
    cur = cs.ensembles.get(ens_id)
    if cur is None:
        return "failed"
    info = replace(cur, vsn=(cur.vsn[0], cur.vsn[1] + 1),
                   args=tuple(args))
    out = statelib.set_ensemble(ens_id, info, cs)
    return out if out is not None else "failed"


def _mutate_args(mgr, runtime, name: Any, args: Tuple,
                 timeout: float):
    from riak_ensemble_tpu_torch import root as rootlib

    fut = rootlib._call(mgr, mgr.node,
                        funref.ref("svct:set_args", tenant_id(name),
                                   tuple(args)), timeout)
    return runtime.await_future(fut, timeout + 5.0)


def retire_tenant(mgr, runtime, name: Any, timeout: float = 30.0):
    """Retire a tenant cluster-wide: an atomic root-FSM update marks
    its record retired at the next vsn.  Returns "failed" when the
    root has no such tenant (e.g. the record hasn't reached consensus
    yet — retry, don't assume done).  Reconcilers destroy local rows
    on convergence."""
    return _mutate_args(mgr, runtime, name, ("retired",), timeout)


def set_tenant_view(mgr, runtime, name: Any, view: List[bool],
                    timeout: float = 30.0):
    """Consensus-managed per-tenant membership change: the new view
    lands in the registry through an atomic root-FSM update, gossips,
    and every owner's reconciler drives it into the device arrays via
    update_members — never a direct call on the service."""
    view = [bool(b) for b in view]
    if not any(view):
        raise ValueError("a tenant view needs at least one member")
    return _mutate_args(mgr, runtime, name, (view,), timeout)


def tenants(directory) -> Dict[Any, Optional[List[bool]]]:
    """name -> view for every live tenant in the local directory."""
    out = {}
    for ens_id, info in directory.known_ensembles().items():
        if (isinstance(ens_id, tuple) and len(ens_id) == 2
                and ens_id[0] == "svct" and info.mod == TENANT_MOD
                and tuple(info.args) != ("retired",)):
            out[ens_id[1]] = info.args[0] if info.args else None
    return out


def place(name: Any, svcnodes: List[Any]) -> Optional[Any]:
    """Rendezvous (highest-random-weight) placement: deterministic
    from (tenant, registered svcnode set) alone, so every node
    computes the same owner from its gossip replica with no placement
    writes; adding a svcnode moves ~1/N of tenants (the minimal
    reshuffle, unlike mod-N)."""
    if not svcnodes:
        return None

    def weight(node):
        h = hashlib.blake2b(repr((name, node)).encode(),
                            digest_size=8).digest()
        return int.from_bytes(h, "big")
    return max(sorted(svcnodes, key=repr), key=weight)


def gather_obj_planes(state, ens: int, slots: np.ndarray) -> np.ndarray:
    """Row ``ens``'s ``obj_epoch`` / ``obj_seq`` / ``obj_val`` planes at
    ``slots``, as one int32 ``[3, M, n]`` array: one gather on the
    device that holds the state, one copy to the host."""
    idx = torch.from_numpy(np.asarray(slots, np.int64)).to(
        state.obj_epoch.device)
    rows = torch.stack([state.obj_epoch[ens], state.obj_seq[ens],
                        state.obj_val[ens]])                  # [3, M, S]
    return rows.index_select(2, idx).cpu().numpy()


class ServiceReconciler:
    """check_peers for the scale plane: converge the LOCAL batched
    service onto the gossip-replicated tenant registry + svcnode
    directory.

    ``svc_name`` is this node's registration name in
    ``service_directory``; ``resolve(svc_name)`` returns a handle to
    another node's reconciler (tests: a dict of in-process
    reconcilers; deployment: a ServiceClient dialed from the
    directory address).  The handle needs ``offer_handoff`` and
    ``has_tenant``.
    """

    def __init__(self, runtime, mgr, svc, svc_name: Any,
                 resolve: Callable[[Any], Optional["ServiceReconciler"]],
                 poll: float = 0.25) -> None:
        assert svc.dynamic, "tenant reconciliation needs dynamic=True"
        self.runtime = runtime
        self.mgr = mgr
        self.svc = svc
        self.svc_name = svc_name
        self.resolve = resolve
        self.poll = poll
        #: handoffs offered by retiring owners, pending import
        self._inbox: Dict[Any, List[Tuple[Any, Any]]] = {}
        #: tenants whose import future hasn't resolved yet
        self._importing: Dict[Any, Any] = {}
        #: bounded import retries per tenant (persistent quorum loss
        #: must surface, not spin)
        self._import_attempts: Dict[Any, int] = {}
        self.max_import_attempts = 8
        #: in-flight import payloads, for per-key result verification
        self._import_data: Dict[Any, Tuple] = {}
        #: grace ticks before creating a missing tenant EMPTY (gives a
        #: live retiring owner time to offer the handoff instead)
        self._want_since: Dict[Any, int] = {}
        self.empty_grace_ticks = 8
        self._tick_no = 0
        #: poll=None -> caller-driven tick() (WallRuntime deployments
        #: and repgroup owners drive it from their own loops)
        self._timer = (runtime.schedule(poll, self._on_tick)
                       if poll is not None else None)

    # -- handoff surface (called by peer reconcilers) -----------------------

    def offer_handoff(self, name: Any, data: List[Tuple[Any, Any]]
                      ) -> bool:
        """A retiring owner pushes a tenant's exported keyed data."""
        self._inbox.setdefault(name, []).extend(data)
        return True

    def has_tenant(self, name: Any) -> bool:
        return self.svc.resolve_ensemble(name) is not None \
            or name in self._importing

    # -- the loop -----------------------------------------------------------

    def stop(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def _on_tick(self) -> None:
        try:
            self.tick()
        finally:
            if self._timer is not None:
                self._timer = self.runtime.schedule(self.poll,
                                                    self._on_tick)

    def tick(self) -> None:
        """One reconciliation pass (manager.erl:610-641 discipline).
        Exception-shielded HERE, not in the timer wrapper, so
        caller-driven (poll=None) loops get the same crash isolation
        — one bad pass (malformed registry data, a repgroup lifecycle
        losing its quorum) must never kill the owner's drive loop."""
        try:
            self._tick_body()
        except Exception:
            import traceback
            self.svc._emit("svc_reconcile_error",
                           {"error": traceback.format_exc(limit=8)})

    def _tick_body(self) -> None:
        self._tick_no += 1
        reg = tenants(self.mgr)
        nodes = sorted(sd.list_services(self.mgr), key=repr)
        mine = {n for n in reg if place(n, nodes) == self.svc_name}
        running = set(self.svc._ens_names)

        # grace bookkeeping only matters while a tenant is wanted
        # here: entries for tenants that left placement before local
        # creation would accumulate forever and poison the grace
        # window on a much-later name reuse
        for name in [n for n in self._want_since if n not in mine]:
            del self._want_since[name]

        # retire: running but no longer placed here (moved/retired) —
        # atomic export+destroy (late writes fail fast), then offer.
        # A tenant mid-import is NOT retired yet: destroying it would
        # fail the queued import ops and forward only the flushed
        # subset — the move waits one import cycle.
        # Each tenant's pass is contained: one malformed registry
        # record (wrong-length view, a racing destroy) must not wedge
        # reconciliation for every later-sorted tenant.
        for name in sorted(running - mine, key=repr):
            if name in self._importing:
                continue
            self._contained(self._retire_local, name, reg, nodes)

        # create: placed here but not running
        for name in sorted(mine - running, key=repr):
            if name in self._importing:
                continue
            self._contained(self._adopt, name, reg[name])

        # view changes from the registry → device arrays; and late
        # handoffs for tenants we already adopted empty (grace lapsed
        # or the retiring owner was transiently unreachable) merge in
        # create-if-missing — local writes made since stay newest
        for name in sorted(mine & running, key=repr):
            self._contained(self._apply_view, name, reg[name])
            if name in self._inbox and name not in self._importing:
                self._contained(self._import, name,
                                self._inbox.pop(name),
                                create_only=True)

        # resolved imports: verify per-key results — 'failed' entries
        # (no quorum that flush) re-queue for a bounded retry instead
        # of silently serving partial data
        for name in [n for n, f in self._importing.items() if f.done]:
            fut = self._importing.pop(name)
            self._contained(self._check_import, name, fut)

    def _contained(self, fn, name, *args, **kw) -> None:
        try:
            fn(name, *args, **kw)
        except Exception:
            import traceback
            self.svc._emit("svc_reconcile_tenant_error",
                           {"name": name,
                            "error": traceback.format_exc(limit=8)})

    def _retire_local(self, name: Any, reg, nodes) -> None:
        svc = self.svc
        ens = svc.resolve_ensemble(name)
        if ens is None:
            return
        new_owner = place(name, nodes) if name in reg else None
        data = self._export(ens)
        # leftover inbox data (a handoff that raced this move) rides
        # along for keys our committed export doesn't cover — it is
        # strictly older, so export entries win
        stale = self._inbox.pop(name, None)
        if stale:
            have = {e[0] for e in data}
            data += [e for e in stale if e[0] not in have]
        svc.destroy_ensemble(name)
        self._want_since.pop(name, None)
        self._import_attempts.pop(name, None)
        if new_owner is None or not data:
            return
        target = self.resolve(new_owner)
        if target is not None:
            target.offer_handoff(name, data)
        # an unreachable new owner loses the push; it will adopt the
        # tenant empty after its grace window — same availability
        # floor as the reference when a node dies holding unhanded
        # data (durability story: compose owners from repgroups)

    def _export(self, ens: int) -> List[Tuple[Any, Any, Tuple]]:
        """Snapshot a tenant's keyed data — WITH versions — from the
        host mirrors + one device gather; synchronous (no flush),
        which is what makes export+destroy atomic within one tick.
        Entries are (key, payload, (epoch, seq)).

        Versions are the per-slot MAX (epoch, seq) across the UP
        member lanes: on a leaderless row, lane 0 can
        lag a quorum-committed write (e.g. it was down when the write
        committed), and exporting its stale version would pair the
        newest payload with an old (epoch, seq) — CAS tokens minted
        from the true version would then fail after the install, the
        exact continuity the handoff exists to preserve.  Any
        quorum-committed version is held by at least one up lane of
        the committing quorum, so the masked lexicographic max is the
        committed version (a live leader's lane can never exceed it).
        """
        svc = self.svc
        # settle in-flight launches first: at pipeline_depth > 1 a
        # write may be committed-but-unresolved (slot_handle fills at
        # resolve), and exporting without it while destroy's own
        # drain then ACKS it would lose an acked write across the
        # handoff.  Settling only the launch pipeline keeps the
        # export+destroy tick atomic (no new ops are admitted here).
        svc._drain_launches()
        items = [(key, slot) for key, slot in svc.key_slot[ens].items()
                 if svc.slot_handle[ens].get(slot, 0)]
        if not items:
            return []
        slots = np.asarray([s for _k, s in items], np.int32)
        lanes = svc.up[ens] & svc.member_np[ens]        # [M]
        if not lanes.any():
            lanes = svc.member_np[ens].copy()
        if not lanes.any():
            lanes[0] = True
        eps_l, sqs_l, vls_l = gather_obj_planes(
            svc.engine.gather_state(svc.state), ens, slots)
        mask = lanes[:, None]
        # lexicographic max: epoch first, then seq among max-epoch
        # lanes; a slot with no copy on any masked lane exports (0, 0)
        eps = np.maximum(np.where(mask, eps_l, -1).max(0), 0)   # [n]
        sqs = np.maximum(np.where(mask & (eps_l == eps[None, :]),
                                  sqs_l, -1).max(0), 0)
        # the winning version's value — device-native (inline RMW)
        # slots export IT as the payload: their value lives in the
        # engine arrays, not the handle store (slot_handle holds the
        # -1 sentinel)
        vls = np.where(mask & (eps_l == eps[None, :])
                       & (sqs_l == sqs[None, :]), vls_l,
                       np.iinfo(np.int32).min).max(0)
        out = []
        for (key, slot), ve, vs, dv in zip(items, eps, sqs, vls):
            h = svc.slot_handle[ens][slot]
            payload = int(dv) if h == -1 else svc.values[h]
            out.append((key, payload, (int(ve), int(vs))))
        return out

    def _bad_view(self, name: Any, view) -> bool:
        """Malformed registry views (no members, or a length that
        doesn't match this service's peer count) surface as traces,
        never as crashed ticks."""
        if view is None:
            return False
        if not any(view) or len(view) != self.svc.n_peers:
            self.svc._emit("svc_tenant_bad_view",
                           {"name": name, "view": list(view)})
            return True
        return False

    def _adopt(self, name: Any, view) -> None:
        svc = self.svc
        if self._bad_view(name, view):
            return
        first = self._want_since.setdefault(name, self._tick_no)
        if name not in self._inbox and self._tick_no - first < \
                self.empty_grace_ticks:
            # a live retiring owner may still be about to offer; only
            # create EMPTY once the grace window passes
            if self._anyone_else_has(name):
                return
        row = svc.create_ensemble(
            name, None if view is None else np.asarray(view, bool))
        if row is None:
            return  # no capacity: retried next tick, inbox KEPT
        self._want_since.pop(name, None)
        data = self._inbox.pop(name, None)
        if data:
            self._import(name, data)
        self.svc._emit("svc_tenant_adopt",
                       {"name": name, "imported": len(data or ())})

    def _import(self, name: Any, data: List[Tuple],
                create_only: bool = False) -> None:
        """Start an import for an adopted tenant via the
        version-preserving install (CAS continuity across the move).
        With ``create_only`` (late handoffs merging into a live
        tenant) only keys with NO committed local copy install —
        local writes made since the empty adoption stay newest, and
        keep their local versions.  Legacy 2-tuple entries (no
        version) install at (1, 1): still CAS-able, visibly
        pre-move."""
        svc = self.svc
        row = svc.resolve_ensemble(name)
        if row is None:
            self._inbox.setdefault(name, []).extend(data)
            return
        if create_only:
            sh = svc.slot_handle[row]
            ks = svc.key_slot[row]
            data = [e for e in data
                    if not (ks.get(e[0]) is not None
                            and sh.get(ks[e[0]], 0))]
            if not data:
                return
        items = [(e[0], (e[2] if len(e) > 2 else (1, 1)), e[1])
                 for e in data]
        self._import_data[name] = (data, create_only)
        fut = Future()
        try:
            fut.resolve(svc.install_objs(row, items))
        except Exception:
            # lost quorum mid-install (repgroup owners): the whole
            # batch retries through the bounded path
            fut.resolve(["failed"] * len(items))
        self._importing[name] = fut

    def _check_import(self, name: Any, fut) -> None:
        """Verify per-key import results; re-queue genuine failures
        (no quorum that flush) for a bounded retry — a silently
        partial import is data loss with no signal."""
        svc = self.svc
        data, create_only = self._import_data.pop(
            name, ((), False))
        results = fut.value if isinstance(fut.value, list) else []
        if len(results) < len(data):
            # an unrecognized/truncated result shape must default to
            # LOST, not to success — this function exists to prevent
            # silent partial imports
            results = list(results) + ["failed"] * (len(data)
                                                    - len(results))
        row = svc.resolve_ensemble(name)
        lost: List[Tuple] = []
        for entry, res in zip(data, results):
            key = entry[0]
            if isinstance(res, tuple) and res[0] == "ok":
                continue
            # a 'failed' key that nonetheless holds a committed local
            # copy (raced local write — local wins) needs no retry
            if row is not None:
                slot = svc.key_slot[row].get(key)
                if slot is not None and \
                        svc.slot_handle[row].get(slot, 0):
                    continue
            lost.append(entry)
        if not lost:
            self._import_attempts.pop(name, None)
            return
        n = self._import_attempts.get(name, 0) + 1
        self._import_attempts[name] = n
        if n >= self.max_import_attempts:
            svc._emit("svc_tenant_import_giveup",
                      {"name": name, "keys": len(lost), "attempts": n})
            return
        svc._emit("svc_tenant_import_retry",
                  {"name": name, "keys": len(lost), "attempt": n})
        self._inbox.setdefault(name, []).extend(lost)

    def _anyone_else_has(self, name: Any) -> bool:
        for other in sd.list_services(self.mgr):
            if other == self.svc_name:
                continue
            peer = self.resolve(other)
            if peer is not None and peer.has_tenant(name):
                return True
        return False

    def _apply_view(self, name: Any, view) -> None:
        if view is None or self._bad_view(name, view):
            return
        svc = self.svc
        ens = svc.resolve_ensemble(name)
        if ens is None:
            return
        want = np.asarray(view, bool)
        cur = svc.member_np[ens]
        pending = (svc._desired_mask[ens] or svc._pending_mask[ens]
                   or svc._queued_mask[ens])
        if (cur == want).all() or pending:
            return
        sel = np.zeros((svc.n_ens,), bool)
        sel[ens] = True
        nv = svc.member_np.copy()
        nv[ens] = want
        svc.update_members(sel, nv)
