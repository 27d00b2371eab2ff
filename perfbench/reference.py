"""The plain reference: a per-key linearizable K/V store.

It follows the operations of one ensemble in the order they were
submitted and works out, with no help from the program, what each one
must answer: a write is acknowledged with the version ``(epoch, seq)``,
where ``epoch`` is the ballot of the ensemble's one election (1: a fresh
ensemble's first) and ``seq`` counts the ensemble's acknowledged writes;
a read answers the value and version of the key's last acknowledged
write.  It imports nothing of the program: values are the ``bytes`` the
benchmark made, and it reads the program's answers only to judge them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

#: the ballot epoch of an ensemble after its first election
FIRST_EPOCH = 1

GET, PUT = 0, 1


class Ensemble:
    """One ensemble's store: key -> (value, (epoch, seq))."""

    __slots__ = ("epoch", "seq", "kv")

    def __init__(self) -> None:
        self.epoch = FIRST_EPOCH
        self.seq = 0
        self.kv: Dict[Any, Tuple[bytes, Tuple[int, int]]] = {}

    def put(self, key: Any, value: bytes) -> Tuple[int, int]:
        self.seq += 1
        vsn = (self.epoch, self.seq)
        self.kv[key] = (value, vsn)
        return vsn

    def get(self, key: Any):
        """The key's (value, version); None if never written."""
        return self.kv.get(key)


class Tally:
    """The counts the comparison reports; each must read 0."""

    def __init__(self) -> None:
        self.get_mismatch = 0
        self.put_vsn_mismatch = 0
        self.failed = 0
        self.unanswered = 0
        self.compared = 0

    def as_dict(self) -> Dict[str, int]:
        return {"get_mismatch": self.get_mismatch,
                "put_vsn_mismatch": self.put_vsn_mismatch,
                "failed_ops": self.failed,
                "unanswered_ops": self.unanswered}


def ok(r: Any) -> bool:
    """Whether one op's answer acknowledges it."""
    return isinstance(r, tuple) and len(r) >= 2 and r[0] == "ok"


def replay(history: List[tuple], tally: Tally) -> Ensemble:
    """Run one ensemble's history, ``(kind, keys, values, answer)`` in
    submit order (``answer``: the answers the program resolved, in key
    order, or None if they never came), through the model, and count
    each answer that differs.
    A write the program failed is taken as not applied."""
    ens = Ensemble()
    for kind, keys, values, answer in history:
        if answer is None:
            tally.unanswered += len(keys)
            answer = [None] * len(keys)
        if kind == PUT:
            for key, value, r in zip(keys, values, answer):
                tally.compared += 1
                if not ok(r):
                    tally.failed += r is not None
                    continue
                vsn = ens.put(key, value)
                if tuple(r[1]) != vsn:
                    tally.put_vsn_mismatch += 1
        else:
            for key, r in zip(keys, answer):
                tally.compared += 1
                if not ok(r):
                    tally.failed += r is not None
                    continue
                want = ens.get(key)
                if want is None:
                    good = not isinstance(r[1], bytes)
                else:
                    good = (len(r) == 3 and r[1] == want[0]
                            and tuple(r[2]) == want[1])
                if not good:
                    tally.get_mismatch += 1
    return ens


def compare_reads(ens: Ensemble, keys: List[Any], answer: Any) -> int:
    """Reads of ``keys`` answered after the window (``answer``: a list of
    ``("ok", value, vsn)``) that differ from the model's final state."""
    if not isinstance(answer, list):
        return len(keys)
    bad = 0
    for key, r in zip(keys, answer):
        want = ens.get(key)
        if want is None:
            bad += 1
            continue
        if not ok(r) or len(r) != 3 or r[1] != want[0] \
                or tuple(r[2]) != want[1]:
            bad += 1
    return bad


def replica_short(ens: Ensemble, replicas: Dict[Any, List[tuple]],
                  quorum: int) -> int:
    """Keys whose last acknowledged write is held by fewer than
    ``quorum`` replicas: ``replicas[key]`` lists each replica's
    ``(value, (epoch, seq))`` as the store holds it."""
    short = 0
    for key, (value, vsn) in ens.kv.items():
        held = sum(1 for v, s in replicas.get(key, ())
                   if s == vsn and v == value)
        if held < quorum:
            short += 1
    return short
