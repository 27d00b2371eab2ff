"""Versioned cluster state with newest-wins gossip merge.

Copied from ``riak_ensemble_tpu/state.py`` with its imports pointed at
this package, so the port imports nothing of the JAX package.

Re-implementation of ``src/riak_ensemble_state.erl`` (222 LoC): a
pure-functional record ``#cluster_state{id, enabled, members,
ensembles, pending}`` whose every mutator is vsn-guarded (only a
strictly newer vsn may overwrite — ``newer/2``,
``riak_ensemble_state.erl:213-219``) and whose gossip merge is
field-wise newest-vsn-wins (``merge/2``, ``:171-211``).  This is the
eventually-consistent convergence layer that sits UNDER the strongly
consistent root-ensemble data: the authoritative copy of this state
lives as the ``cluster_state`` key in the root ensemble and is mutated
only through root kmodify operations (:mod:`riak_ensemble_tpu_torch.root`);
manager gossip then spreads it epidemically.

All mutators return the new state, or ``None`` on a vsn conflict (the
reference's ``error``).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, FrozenSet, Optional, Tuple

from riak_ensemble_tpu_torch.types import EnsembleInfo, Views, Vsn

#: The reference's vsn0() (riak_ensemble_state.erl:221-222); `undefined`
#: current-vsns compare as this minimum.
VSN0: Vsn = (-1, 0)


def _newer(cur: Optional[Vsn], new: Optional[Vsn]) -> bool:
    """riak_ensemble_state.erl:213-219 (strictly greater wins)."""
    cur = VSN0 if cur is None else cur
    new = VSN0 if new is None else new
    return new > cur


@dataclass(frozen=True)
class ClusterState:
    """``#cluster_state{}`` (riak_ensemble_state.erl:37-42)."""

    id: Any
    enabled: bool = False
    members_vsn: Vsn = VSN0
    members: FrozenSet[str] = frozenset()
    ensembles: Dict[Any, EnsembleInfo] = field(default_factory=dict)
    pending: Dict[Any, Tuple[Vsn, Views]] = field(default_factory=dict)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, ClusterState):
            return NotImplemented
        return (self.id == other.id and self.enabled == other.enabled
                and self.members_vsn == other.members_vsn
                and self.members == other.members
                and self.ensembles == other.ensembles
                and self.pending == other.pending)

    __hash__ = None  # type: ignore[assignment]


def new_state(cluster_id: Any) -> ClusterState:
    """riak_ensemble_state:new/1."""
    return ClusterState(id=cluster_id)


def enable(cs: ClusterState) -> Optional[ClusterState]:
    """riak_ensemble_state:enable/1 — error if already enabled."""
    if cs.enabled:
        return None
    return replace(cs, enabled=True)


def add_member(vsn: Vsn, node: str, cs: ClusterState
               ) -> Optional[ClusterState]:
    """riak_ensemble_state.erl:93-102."""
    if not _newer(cs.members_vsn, vsn):
        return None
    return replace(cs, members_vsn=vsn, members=cs.members | {node})


def del_member(vsn: Vsn, node: str, cs: ClusterState
               ) -> Optional[ClusterState]:
    """riak_ensemble_state.erl:104-113."""
    if not _newer(cs.members_vsn, vsn):
        return None
    return replace(cs, members_vsn=vsn, members=cs.members - {node})


def set_ensemble(ensemble: Any, info: EnsembleInfo, cs: ClusterState
                 ) -> Optional[ClusterState]:
    """riak_ensemble_state.erl:115-132 — insert or overwrite if newer."""
    cur = cs.ensembles.get(ensemble)
    if not _newer(cur.vsn if cur else None, info.vsn):
        return None
    ensembles = dict(cs.ensembles)
    ensembles[ensemble] = info
    return replace(cs, ensembles=ensembles)


def update_ensemble(vsn: Vsn, ensemble: Any, leader, views: Views,
                    cs: ClusterState) -> Optional[ClusterState]:
    """riak_ensemble_state.erl:134-151 — update leader/views of a KNOWN
    ensemble only (unknown → error)."""
    cur = cs.ensembles.get(ensemble)
    if cur is None or not _newer(cur.vsn, vsn):
        return None
    ensembles = dict(cs.ensembles)
    ensembles[ensemble] = replace(cur, vsn=vsn, leader=leader,
                                  views=tuple(tuple(v) for v in views))
    return replace(cs, ensembles=ensembles)


def set_pending(vsn: Vsn, ensemble: Any, views: Views, cs: ClusterState
                ) -> Optional[ClusterState]:
    """riak_ensemble_state.erl:153-169."""
    cur = cs.pending.get(ensemble)
    if not _newer(cur[0] if cur else None, vsn):
        return None
    pending = dict(cs.pending)
    pending[ensemble] = (vsn, tuple(tuple(v) for v in views))
    return replace(cs, pending=pending)


def merge(a: ClusterState, b: ClusterState) -> ClusterState:
    """Gossip merge (riak_ensemble_state.erl:171-211): ignore foreign
    clusters once enabled; otherwise field-wise newest-vsn-wins."""
    if a.enabled and a.id != b.id:
        return a
    if _newer(a.members_vsn, b.members_vsn):
        members_vsn, members = b.members_vsn, b.members
    else:
        members_vsn, members = a.members_vsn, a.members
    ensembles = dict(a.ensembles)
    for ens, info_b in b.ensembles.items():
        info_a = ensembles.get(ens)
        if info_a is None or _newer(info_a.vsn, info_b.vsn):
            ensembles[ens] = info_b
    pending = dict(a.pending)
    for ens, pb in b.pending.items():
        pa = pending.get(ens)
        if pa is None or _newer(pa[0], pb[0]):
            pending[ens] = pb
    return replace(a, members_vsn=members_vsn, members=members,
                   ensembles=ensembles, pending=pending)
