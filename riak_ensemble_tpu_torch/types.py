"""Core data model: objects, facts, peer identity, ensemble info.

Copied from ``riak_ensemble_tpu/types.py`` with its imports pointed at
this package, so the port imports nothing of the JAX package.

Semantics match the reference's type layer
(``include/riak_ensemble_types.hrl:1-27``) and the peer's ``#fact{}``
record (``src/riak_ensemble_peer.erl:84-101``), re-expressed as
immutable Python dataclasses.  Versions are ``(epoch, seq)`` pairs
ordered lexicographically — the single most load-bearing comparison in
the whole protocol (``latest_obj``: ``src/riak_ensemble_backend.erl
:132-143``; ``latest_fact``: ``src/riak_ensemble_peer.erl:2031-2040``).
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


#: An ensemble id is an arbitrary hashable term; the distinguished root
#: ensemble is the atom-like string "root" (riak_ensemble_root.erl).
EnsembleId = Any

#: A view is an ordered list of peer ids; ``views`` is a list of views
#: (joint consensus holds quorums in every view simultaneously).
View = Tuple[PeerId, ...]
Views = Tuple[View, ...]

#: A version is a (epoch, seq) pair, ordered lexicographically.
Vsn = Tuple[int, int]

#: Sort key treating None vsns as minimal (reference orders `undefined`
#: before any tuple; Python can't compare None < tuple natively).
VSN_MIN: Vsn = (-1, -1)


def vsn_key(vsn: Optional[Vsn]) -> Vsn:
    return VSN_MIN if vsn is None else vsn


@dataclass(frozen=True)
class Obj:
    """A versioned K/V object (``#obj{}``,
    ``src/riak_ensemble_basic_backend.erl:42-45``).

    ``epoch``/``seq`` form the object version: epoch is the leader era
    that last wrote it, seq the per-epoch object sequence number
    (``obj_sequence``, ``src/riak_ensemble_peer.erl:1776-1791``).
    """

    epoch: int
    seq: int
    key: Any
    value: Any

    @property
    def vsn(self) -> Vsn:
        return (self.epoch, self.seq)

    def with_value(self, value: Any) -> "Obj":
        return replace(self, value=value)


def latest_obj(a: Obj, b: Obj) -> Obj:
    """Pick the newer of two object versions
    (``riak_ensemble_backend:latest_obj/3``, backend.erl:132-143)."""
    return a if a.vsn >= b.vsn else b


@dataclass(frozen=True)
class Fact:
    """Per-ensemble replicated consensus fact (``#fact{}``,
    ``src/riak_ensemble_peer.erl:84-101``).

    - ``epoch``/``seq``: current ballot number; seq resets to 0 on new
      epoch and increments per committed fact change.
    - ``leader``: peer id of the epoch's elected leader.
    - ``views``: current list of member views (joint consensus: more
      than one view while a membership change is in flight).
    - ``view_vsn``: vsn at which the current views took effect.
    - ``pend_vsn``: vsn that committed the current *pending* view.
    - ``commit_vsn``: pend_vsn of the last pending view that has since
      been transitioned to (no longer pending).
    - ``pending``: ``(vsn, views)`` — proposed next views published to
      the manager for gossip before transition; ``None`` when no
      pending change has ever been proposed (the reference's
      ``undefined``, distinguished from ``(vsn, ())`` by
      ``stable_views``, peer.erl:705-713).
    """

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


def latest_fact(a: Fact, b: Fact) -> Fact:
    """Newer-of-two facts by (epoch, seq)
    (``riak_ensemble_peer:latest_fact/2``, peer.erl:2031-2040)."""
    return a if (a.epoch, a.seq) >= (b.epoch, b.seq) else b


def initial_fact(views: Views) -> Fact:
    """A fresh fact for a newly-created ensemble (``reload_fact``
    not-found branch, ``riak_ensemble_peer.erl:2190-2194``: epoch=0,
    seq=0, view_vsn={0,0}, leader=undefined)."""
    return Fact(epoch=0, seq=0, leader=None, view_vsn=(0, 0),
                views=tuple(tuple(v) for v in views))


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


def term_order(v: Any) -> Tuple:
    """Total order over mixed-type terms (the Erlang term-order analog:
    numbers < strings < everything else).  Peer ids mix integer and
    string names (``{root, Node}`` vs ``{2, Node}``) and the usort of
    members must be deterministic and identical on every peer."""
    if isinstance(v, bool):
        return (1, 0, repr(v))
    if isinstance(v, (int, float)):
        return (0, v, "")
    if isinstance(v, str):
        return (1, 0, v)
    if isinstance(v, tuple):
        return (2, 0, tuple(term_order(x) for x in v))
    return (3, 0, repr(v))


def peer_order(p: PeerId) -> Tuple:
    return (term_order(p.name), term_order(p.node))


def members_of(views: Views) -> Tuple[PeerId, ...]:
    """Canonical sorted union of all views (``compute_members`` =
    ``lists:usort(lists:append(Views))``,
    ``src/riak_ensemble_peer.erl:2077-2081``)."""
    seen = set()
    for view in views:
        seen.update(view)
    return tuple(sorted(seen, key=peer_order))


# ---------------------------------------------------------------------------
# Client-visible results (std_reply(), riak_ensemble_types.hrl:8)

class Timeout(Exception):
    pass


class Failed(Exception):
    pass


class Unavailable(Exception):
    pass
