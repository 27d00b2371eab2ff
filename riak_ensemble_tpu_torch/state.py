"""The cluster-state record the wire codec carries.

Copied from ``riak_ensemble_tpu/state.py``: :class:`ClusterState`
(``#cluster_state{}``, riak_ensemble_state.erl:37-42) with its field
names, order and equality, and ``VSN0``.  The reference module's
vsn-guarded mutators and gossip merge serve its scalar manager plane,
which the port does not have, and are not copied.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, FrozenSet, Tuple

from riak_ensemble_tpu_torch.types import EnsembleInfo, Views, Vsn

#: The reference's vsn0() (riak_ensemble_state.erl:221-222); `undefined`
#: current-vsns compare as this minimum.
VSN0: Vsn = (-1, 0)


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
