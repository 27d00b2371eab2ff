"""Client-visible sentinels and errors, and the wire's record types.

Copied unchanged from ``riak_ensemble_tpu/types.py``: ``_NotFound`` /
``NOTFOUND``, the ``Timeout`` / ``Failed`` exceptions, and the records
the restricted wire codec carries (:class:`PeerId`, :class:`Obj`,
:class:`Fact`, :class:`EnsembleInfo`, with their field names and order,
so :mod:`.wire` encodes them byte for byte as the reference does).  The
port keeps its own copy so it imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, NamedTuple, Optional, Tuple


class _NotFound:
    """Singleton sentinel for missing keys / tombstones.

    The reference uses the atom ``notfound`` both as a read miss and as
    the value written by ``kdelete`` (a tombstone object whose value is
    ``notfound``).
    """

    _instance: Optional["_NotFound"] = None

    def __new__(cls) -> "_NotFound":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "NOTFOUND"

    def __bool__(self) -> bool:
        return False


NOTFOUND = _NotFound()


class PeerId(NamedTuple):
    """Peer identity ``{Id, Node}`` (riak_ensemble_types.hrl:2)."""

    name: Any
    node: str

    def __repr__(self) -> str:  # compact for traces
        return f"{self.name}@{self.node}"


#: A view is an ordered list of peer ids; ``views`` is a list of views
#: (joint consensus holds quorums in every view simultaneously).
View = Tuple[PeerId, ...]
Views = Tuple[View, ...]

#: A version is a (epoch, seq) pair, ordered lexicographically.
Vsn = Tuple[int, int]


@dataclass(frozen=True)
class Obj:
    """A versioned K/V object (``#obj{}``,
    ``src/riak_ensemble_basic_backend.erl:42-45``)."""

    epoch: int
    seq: int
    key: Any
    value: Any

    @property
    def vsn(self) -> Vsn:
        return (self.epoch, self.seq)

    def with_value(self, value: Any) -> "Obj":
        return replace(self, value=value)


@dataclass(frozen=True)
class Fact:
    """Per-ensemble replicated consensus fact (``#fact{}``,
    ``src/riak_ensemble_peer.erl:84-101``)."""

    epoch: int
    seq: int
    leader: Optional[PeerId]
    views: Views
    view_vsn: Optional[Vsn] = None
    pend_vsn: Optional[Vsn] = None
    commit_vsn: Optional[Vsn] = None
    pending: Optional[Tuple[Vsn, Views]] = None

    @property
    def vsn(self) -> Vsn:
        return (self.epoch, self.seq)


@dataclass(frozen=True)
class EnsembleInfo:
    """Manager-side record of one ensemble (``#ensemble_info{}``,
    ``include/riak_ensemble_types.hrl:20-26``)."""

    vsn: Vsn
    leader: Optional[PeerId]
    views: Views
    seq: Optional[Vsn]
    mod: str = "basic"
    args: Tuple[Any, ...] = ()


# ---------------------------------------------------------------------------
# Client-visible results (std_reply(), riak_ensemble_types.hrl:8)

class Timeout(Exception):
    pass


class Failed(Exception):
    pass
