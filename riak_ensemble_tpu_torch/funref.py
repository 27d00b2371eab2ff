"""Symbolic references to registered modify functions.

Copied unchanged from ``riak_ensemble_tpu/funref.py`` (the whole
module: the registry, the device mod-fun table, the merge classes and
the nine host-mirror table funs).  The port keeps its own copy so it
imports nothing of the JAX package; the two registries are separate
dicts.  A funref is the plain tuple ``("fn", name, bound)``, so the
same tuple addresses the same function in either package.

The reference never ships closures between nodes: a kmodify carries an
``{Module, Function, Args}`` triple and the put FSM applies it by name
(``riak_ensemble_peer.erl:303-317``, ``riak_ensemble_root.erl:82,104``).
Protocol events carry ``("fn", name, bound_args)`` tuples and the
executing service resolves the name against a process-local registry
of functions registered at import time.  Live callables pass through
:func:`resolve` untouched.

**The device mod-fun table.**  A registered name may additionally be
*device-expressible*: a small fixed family of int32 modify functions
(add/sub/max/min/set/band/bor/bxor with one bound int32 operand, plus
put-if-absent) that the engine runs INSIDE a consensus round as an
``OP_RMW`` op — the fun code rides the op's ``exp_epoch`` plane and
the operand its ``val`` plane (:mod:`.ops.engine`).  The service's
kmodify fast-paths funrefs that resolve to table entries: the read,
the fun and the commit fuse into ONE device round, so device RMWs can
never CAS-conflict.  Every table entry is ALSO registered as an
ordinary host mod-fun with bit-identical int32 (wraparound) semantics,
so the host-fallback path computes the same values.
"""

from __future__ import annotations

import functools
import numbers
from typing import Any, Callable, Dict, Optional, Tuple

_REGISTRY: Dict[str, Callable] = {}

TAG = "fn"

#: device mod-fun table codes — the ``exp_epoch`` plane of an
#: ``OP_RMW`` row carries one of these (ops/engine.py imports them
#: from here).
RMW_ADD = 0     # cur + operand            (absent/tombstone cur = 0)
RMW_SUB = 1     # cur - operand
RMW_MAX = 2     # max(cur, operand)
RMW_MIN = 3     # min(cur, operand)
RMW_SET = 4     # operand (unconditional overwrite)
RMW_BAND = 5    # cur & operand
RMW_BOR = 6    # cur | operand
RMW_BXOR = 7    # cur ^ operand
RMW_PIA = 8     # put-if-absent: operand iff nothing committed

#: name -> fun code for device-expressible registered funs
_DEVICE: Dict[str, int] = {}

# -- commutative-replication classification (docs/ARCHITECTURE.md §18) -------
#
# Every device-table fun is tagged by how its applications compose:
#
# - COMMUTATIVE  — add/sub: N applications fold into ONE operand
#   (the int32-wraparound sum; sub is add of the negated operand), so
#   the apply stream can ship a merged operand instead of N cells;
# - SEMILATTICE  — max/min/band/bor: idempotent + commutative +
#   associative, N operands fold by the fun itself;
# - ORDERED      — set/bxor/put_if_absent: the outcome depends on the
#   application ORDER (set: last writer; bxor: parity is commutative
#   but a merged operand could not report per-op computed values;
#   put-if-absent: first writer) — these never leave the per-entry
#   sequenced path.
#
# The fold target is a MERGE class (the wire's per-cell fun byte):
# sub normalizes into MERGE_ADD with a negated operand, so mixed
# add/sub traffic on one slot still coalesces into one cell.

ORDERED = 0
COMMUTATIVE = 1
SEMILATTICE = 2

#: merge-section cell fun codes (disjoint from the RMW_* table codes:
#: they name the FOLD, not the op — applied replica-side against the
#: lane's own current value)
MERGE_ADD = 0   # cur + folded operand (int32 wraparound)
MERGE_MAX = 1   # max(cur, folded operand)
MERGE_MIN = 2   # min(cur, folded operand)
MERGE_AND = 3   # cur & folded operand
MERGE_OR = 4    # cur | folded operand

#: RMW fun code -> replication class
RMW_CLASS: Dict[int, int] = {
    RMW_ADD: COMMUTATIVE,
    RMW_SUB: COMMUTATIVE,
    RMW_MAX: SEMILATTICE,
    RMW_MIN: SEMILATTICE,
    RMW_BAND: SEMILATTICE,
    RMW_BOR: SEMILATTICE,
    RMW_SET: ORDERED,
    RMW_BXOR: ORDERED,
    RMW_PIA: ORDERED,
}

#: RMW fun code -> merge-class code (absent for ORDERED funs)
MERGE_OF: Dict[int, int] = {
    RMW_ADD: MERGE_ADD,
    RMW_SUB: MERGE_ADD,
    RMW_MAX: MERGE_MAX,
    RMW_MIN: MERGE_MIN,
    RMW_BAND: MERGE_AND,
    RMW_BOR: MERGE_OR,
}


def merge_class(code: int) -> Optional[int]:
    """The merge-class code a device RMW fun folds into, or None when
    the fun is ORDERED (must stay on the sequenced path)."""
    return MERGE_OF.get(code)


def fold_operand(code: int, acc: int, operand: int) -> int:
    """Fold one more operand of RMW fun ``code`` into the running
    merged operand ``acc`` — host-exact int32 semantics (the same
    arithmetic the engine kernel and the merge apply run), so leader-
    coalesced and replica-merged values are bit-identical."""
    if code == RMW_ADD:
        return i32(acc + operand)
    if code == RMW_SUB:
        # normalized into MERGE_ADD: subtracting v1 then v2 is adding
        # -(v1 + v2) under int32 wraparound
        return i32(acc - operand)
    if code == RMW_MAX:
        return max(acc, operand)
    if code == RMW_MIN:
        return min(acc, operand)
    if code == RMW_BAND:
        return acc & operand
    if code == RMW_BOR:
        return acc | operand
    raise ValueError(f"fold of ordered RMW fun {code}")


def fold_seed(code: int, operand: int) -> int:
    """The merged-operand seed for the FIRST op of a coalesced cell:
    identity-adjusted for the normalizing funs (sub seeds with the
    negated operand so the cell's merge class is MERGE_ADD)."""
    return i32(-operand) if code == RMW_SUB else i32(operand)


def merge_apply(mcls: int, cur: int, operand: int) -> int:
    """Host mirror of the replica's compiled merge-scatter: apply one
    merged cell against the lane's current value — used for cells
    whose current value was produced earlier in the same apply run
    (the device still holds the pre-run value), and by the
    equivalence tests as the oracle."""
    if mcls == MERGE_ADD:
        return i32(int(cur) + int(operand))
    if mcls == MERGE_MAX:
        return max(int(cur), int(operand))
    if mcls == MERGE_MIN:
        return min(int(cur), int(operand))
    if mcls == MERGE_AND:
        return int(cur) & int(operand)
    if mcls == MERGE_OR:
        return int(cur) | int(operand)
    raise ValueError(f"unknown merge class {mcls}")


def register(name: str) -> Callable[[Callable], Callable]:
    """Decorator: make `fn` addressable on the wire as `name`."""
    def deco(fn: Callable) -> Callable:
        assert name not in _REGISTRY, f"duplicate funref {name}"
        _REGISTRY[name] = fn
        return fn
    return deco


def ref(name: str, *bound: Any) -> Tuple:
    """A wire-safe reference to registered function `name`, with
    `bound` prepended to its call arguments (the Args of an MFA)."""
    assert name in _REGISTRY, f"unregistered funref {name}"
    return (TAG, name, tuple(bound))


def resolve(spec: Any) -> Callable:
    """Spec → callable.  Callables pass through; ``("fn", name,
    bound)`` resolves against the registry; anything else raises."""
    if callable(spec):
        return spec
    if (isinstance(spec, tuple) and len(spec) == 3 and spec[0] == TAG
            and spec[1] in _REGISTRY):
        fn = _REGISTRY[spec[1]]
        return functools.partial(fn, *spec[2]) if spec[2] else fn
    raise ValueError(f"unresolvable function spec: {spec!r}")


# -- device mod-fun table -----------------------------------------------------


def register_device(name: str, code: int
                    ) -> Callable[[Callable], Callable]:
    """Decorator: register ``fn`` as BOTH an ordinary host mod-fun
    (addressable as ``name``) and a device-table entry with fun code
    ``code``.  ``fn`` is the HOST MIRROR — called as
    ``fn(operand, vsn, cur)`` with an int ``cur`` — and must match
    the engine's int32 semantics exactly (tests/test_torch_funref.py
    pins this against the engine's table)."""
    def deco(fn: Callable) -> Callable:
        register(name)(fn)
        _DEVICE[name] = code
        return fn
    return deco


def is_int32(x: Any) -> bool:
    """An int32-expressible integer operand/default: any Integral
    EXCEPT bool (``ref("rmw:add", True)`` is a caller bug, not an
    operand of 1) — numpy integer scalars qualify, so operands pulled
    from ndarrays don't silently demote to the host retry path."""
    return (isinstance(x, numbers.Integral)
            and not isinstance(x, bool)
            and -(1 << 31) <= int(x) < (1 << 31))


def device_entry(spec: Any) -> Optional[Tuple[int, int]]:
    """``(fun_code, operand)`` when ``spec`` is a funref whose name is
    in the device table and whose bound args are exactly one int32
    operand; None otherwise (the caller keeps the host retry path)."""
    if (isinstance(spec, tuple) and len(spec) == 3 and spec[0] == TAG
            and spec[1] in _DEVICE):
        bound = spec[2]
        if len(bound) == 1 and is_int32(bound[0]):
            return _DEVICE[spec[1]], int(bound[0])
    return None


def device_code(spec: Any) -> Optional[int]:
    """The table code of a funref's NAME alone, whatever its bound
    operand looks like — callers that must route by SEMANTICS (the
    service's put-if-absent delegation) need this even when the
    operand is not int32-expressible, or a non-int operand would
    silently fall into the generic fn path and lose the routing."""
    if isinstance(spec, tuple) and len(spec) == 3 and spec[0] == TAG:
        return _DEVICE.get(spec[1])
    return None


def i32(x: int) -> int:
    """int32 wraparound — the host mirror of device arithmetic."""
    return ((int(x) + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _cur_int(cur: Any) -> int:
    """The host mirror's view of the current value: device RMW reads
    an absent key (or a tombstone) as 0; the service's host path hands
    the fun ``default`` (0) in that case, so ints pass through and
    anything else is a caller error surfacing as a contained
    exception."""
    return int(cur)


@register_device("rmw:add", RMW_ADD)
def _rmw_add(operand, vsn, cur):
    return i32(_cur_int(cur) + operand)


@register_device("rmw:sub", RMW_SUB)
def _rmw_sub(operand, vsn, cur):
    return i32(_cur_int(cur) - operand)


@register_device("rmw:max", RMW_MAX)
def _rmw_max(operand, vsn, cur):
    return max(_cur_int(cur), operand)


@register_device("rmw:min", RMW_MIN)
def _rmw_min(operand, vsn, cur):
    return min(_cur_int(cur), operand)


@register_device("rmw:set", RMW_SET)
def _rmw_set(operand, vsn, cur):
    return operand


@register_device("rmw:band", RMW_BAND)
def _rmw_band(operand, vsn, cur):
    return _cur_int(cur) & operand


@register_device("rmw:bor", RMW_BOR)
def _rmw_bor(operand, vsn, cur):
    return _cur_int(cur) | operand


@register_device("rmw:bxor", RMW_BXOR)
def _rmw_bxor(operand, vsn, cur):
    return _cur_int(cur) ^ operand


@register_device("rmw:put_if_absent", RMW_PIA)
def _rmw_pia(operand, vsn, cur):
    # value 0 is the engine's tombstone/absent encoding, which is what
    # the host path's default-of-0 hands us for an absent key.  NOTE:
    # the service never routes put-if-absent through this mirror on a
    # host-payload key (a live payload of int 0 would read as absent)
    # — it takes the exact-contract kput_once (0,0)-CAS instead; this
    # fn exists for the registry and direct int-domain callers.
    return operand if _cur_int(cur) == 0 else "failed"
