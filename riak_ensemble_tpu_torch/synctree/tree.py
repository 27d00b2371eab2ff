"""Self-validating fixed-shape Merkle hash trie.

Copied from ``riak_ensemble_tpu/synctree/tree.py`` with its imports pointed at
this package, so the port imports nothing of the JAX package.

Mirrors ``src/synctree.erl``:

- Keys map to one of ``segments`` leaf buckets via md5
  (``get_segment``, synctree.erl:251-253); inner levels have
  ``width``-way fan-out, ``height = log_width(segments)``
  (synctree.erl:88-89, 270-284).
- Every traversal verifies hashes root→leaf (``get_path``,
  synctree.erl:302-320) and reports ``Corrupted(level, bucket)``.
- ``insert`` recomputes the path hashes up to a new top hash
  (synctree.erl:189-209); bucket hash = md5 over the bucket's hash
  values in key order, tagged ``\\x00`` (synctree.erl:255-259).
- Exchange: level-by-level bucket diff (``compare``/``exchange_level``,
  synctree.erl:380-417) over pluggable accessor functions, cost
  O(width·height·diffs) not O(keys).
- Repair: bottom-up ``rehash`` (equivalent to the reference's DFS
  recompute, synctree.erl:489-535, but driven by the set of existing
  buckets so it is O(live buckets)); BFS ``verify``
  (synctree.erl:549-571).
- ``corrupt`` deliberately loses a leaf entry without fixing hashes —
  the corruption-test hook (synctree.erl:241-247).

Storage backends provide dict-like ``fetch/store/exists/store_batch``
(:mod:`riak_ensemble_tpu_torch.synctree.backends`).
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, Generator, List, Optional, Tuple

from riak_ensemble_tpu_torch.synctree.backends import DictBackend

#: marker for "missing on this side" in exchange deltas
#: (riak_ensemble_util:orddict_delta, util.erl:115-141)
NONE = "$none"

DEFAULT_WIDTH = 16
DEFAULT_SEGMENTS = 1024 * 1024


class Corrupted(Exception):
    """Raised internally; surfaced as a return value like the
    reference's {corrupted, Level, Bucket}."""

    def __init__(self, level: int, bucket: int) -> None:
        super().__init__(f"corrupted at {level}/{bucket}")
        self.level = level
        self.bucket = bucket


def term_key(key: Any):
    """Total order over heterogeneous keys (erlang term order spirit:
    numbers < strings < bytes < tuples)."""
    if isinstance(key, bool):
        return (1, str(key))
    if isinstance(key, (int, float)):
        return (0, key)
    if isinstance(key, str):
        return (1, key)
    if isinstance(key, bytes):
        return (2, key)
    if isinstance(key, tuple):
        return (3, tuple(term_key(k) for k in key))
    return (4, repr(key))


def ensure_binary(key: Any) -> bytes:
    """synctree.erl:261-268."""
    if isinstance(key, int) and not isinstance(key, bool):
        return key.to_bytes(8, "big", signed=True)
    if isinstance(key, str):
        return key.encode("utf-8")
    if isinstance(key, bytes):
        return key
    return repr(key).encode("utf-8")


def hash_bucket(bucket: Dict[Any, bytes]) -> bytes:
    """md5 over the bucket's hash values in key order, tagged with a
    hash-method byte (synctree.erl:255-259)."""
    h = hashlib.md5()
    for k in sorted(bucket, key=term_key):
        h.update(bucket[k])
    return b"\x00" + h.digest()


class SyncTree:
    def __init__(self, tree_id: Any = None, width: int = DEFAULT_WIDTH,
                 segments: int = DEFAULT_SEGMENTS, backend=None) -> None:
        self.id = tree_id
        self.width = width
        self.segments = segments
        # By design segments is a power of width and width a power of 2
        # (synctree.erl:270-284).
        height = round(__import__("math").log(segments, width))
        assert width ** height == segments, "segments must be width^height"
        shift = round(__import__("math").log2(width))
        assert 2 ** shift == width, "width must be a power of 2"
        self.height = height
        self.shift = shift
        self.shift_max = shift * height
        self.backend = backend if backend is not None else DictBackend()
        self._buffer: List[Tuple] = []
        # Reload top hash from storage (synctree.erl:174-177).
        self.top_hash: Optional[bytes] = self._bfetch((0, 0), None)

    def _loc(self, loc):
        """Namespace backend keys by tree id so many trees can share
        one storage engine (the synctree_leveldb key layout
        ``<<0, TreeId, Level, Bucket>>``, synctree_leveldb.erl:104-109;
        exercised by the shared synctree_path mapping)."""
        return loc if self.id is None else (self.id,) + loc

    def _bfetch(self, loc, default=None):
        return self.backend.fetch(self._loc(loc), default)

    def _bstore(self, loc, value) -> None:
        self.backend.store(self._loc(loc), value)

    def _bexists(self, loc) -> bool:
        return self.backend.exists(self._loc(loc))

    def _bdelete(self, loc) -> None:
        self.backend.delete(self._loc(loc))

    def _bkeys(self):
        """This tree's (level, bucket) keys, prefix-stripped."""
        for k in self.backend.keys():
            if self.id is None:
                yield k
            elif isinstance(k, tuple) and len(k) == 3 and k[0] == self.id:
                yield k[1:]

    # -- basic ops ---------------------------------------------------------

    def get_segment(self, key: Any) -> int:
        digest = hashlib.md5(ensure_binary(key)).digest()
        return int.from_bytes(digest, "big") % self.segments

    def _fetch(self, level: int, bucket: int) -> Dict[Any, bytes]:
        return dict(self._bfetch((level, bucket), {}))

    def get_path(self, segment: int):
        """Verified root→leaf path; returns list of ((level, bucket),
        bucket_dict) leaf-first, or raises Corrupted
        (synctree.erl:302-340)."""
        n = self.shift_max
        level = 1
        up_hashes = {0: self.top_hash}
        acc = []
        while True:
            bucket = segment >> n
            expected = up_hashes.get(bucket)
            hashes = self._fetch(level, bucket)
            acc.insert(0, ((level, bucket), hashes))
            if not self._verify_hash(expected, hashes):
                raise Corrupted(level, bucket)
            if n == 0:
                return acc
            up_hashes = hashes
            n -= self.shift
            level += 1

    @staticmethod
    def _verify_hash(expected: Optional[bytes],
                     hashes: Dict[Any, bytes]) -> bool:
        """synctree.erl:322-340: a missing expectation admits only an
        empty bucket."""
        if expected is None:
            return not hashes
        return hash_bucket(hashes) == expected

    def insert(self, key: Any, value: bytes):
        """Insert and rehash the path; returns None or Corrupted
        (synctree.erl:189-209)."""
        assert isinstance(value, bytes)
        segment = self.get_segment(key)
        try:
            path = self.get_path(segment)
        except Corrupted as c:
            return c
        child_key: Any = key
        child_hash = value
        updates = []
        for (level, bucket), hashes in path:
            hashes[child_key] = child_hash
            updates.append(((level, bucket), hashes))
            child_key = bucket
            child_hash = hash_bucket(hashes)
        updates.append(((0, 0), child_hash))
        for loc, val in updates[:-1]:
            self._bstore(loc, val)
        self._bstore((0, 0), child_hash)
        self.top_hash = child_hash
        return None

    def get(self, key: Any):
        """Verified read: bytes | None (notfound) | Corrupted
        (synctree.erl:215-231)."""
        if self.top_hash is None:
            return None
        segment = self.get_segment(key)
        try:
            path = self.get_path(segment)
        except Corrupted as c:
            return c
        (_loc, leaf) = path[0]
        return leaf.get(key)

    def exchange_get(self, level: int, bucket: int):
        """Verified hashes of one bucket for the exchange protocol;
        level 0 returns [(0, top_hash)] (synctree.erl:233-237,
        verified_hashes:288-298)."""
        if level == 0 and bucket == 0:
            return {0: self.top_hash}
        # Walk down the ancestor chain of `bucket`: at depth d (1-based)
        # the ancestor is bucket >> shift*(level-d), verifying each
        # bucket against its parent's entry.
        up_hashes = {0: self.top_hash}
        hashes: Dict[Any, bytes] = {}
        for d in range(1, level + 1):
            b = bucket >> (self.shift * (level - d))
            expected = up_hashes.get(b)
            hashes = self._fetch(d, b)
            if not self._verify_hash(expected, hashes):
                return Corrupted(d, b)
            up_hashes = hashes
        return hashes

    def corrupt(self, key: Any) -> None:
        """Silently lose a leaf entry (test hook, synctree.erl:241-247)."""
        segment = self.get_segment(key)
        loc = (self.height + 1, segment)
        hashes = self._fetch(*loc)
        hashes.pop(key, None)
        self._bstore(loc, hashes)

    def corrupt_upper(self, key: Any, level: int = 1) -> None:
        """Corrupt an inner node on key's path (test hook for the
        corrupt_upper intercept, test/synctree_intercepts.erl:30-41)."""
        segment = self.get_segment(key)
        bucket = segment >> (self.shift_max - self.shift * (level - 1))
        loc = (level, bucket)
        hashes = self._fetch(*loc)
        if hashes:
            k = sorted(hashes, key=term_key)[0]
            hashes[k] = b"\x00" + b"\xde\xad" * 8
            self._bstore(loc, hashes)

    # -- repair ------------------------------------------------------------

    def rehash_upper(self) -> None:
        self._rehash(self.height)

    def rehash(self) -> None:
        self._rehash(self.height + 1)

    def _rehash(self, max_depth: int) -> None:
        """Recompute hashes bottom-up from live buckets.  Equivalent to
        the reference's full DFS (synctree.erl:489-535) because a
        missing bucket hashes to nothing and contributes no entry, but
        O(live buckets) instead of O(width^height)."""
        # Live buckets at max_depth level.
        level_buckets = sorted(
            {b for (lvl, b) in self._bkeys() if lvl == max_depth})
        child_hashes: Dict[int, bytes] = {}
        for b in level_buckets:
            content = self._fetch(max_depth, b)
            if content:
                child_hashes[b] = hash_bucket(content)
        for level in range(max_depth - 1, 0, -1):
            existing = {b for (lvl, b) in self._bkeys() if lvl == level}
            parents: Dict[int, Dict[int, bytes]] = {}
            for child, h in child_hashes.items():
                parents.setdefault(child >> self.shift, {})[child] = h
            child_hashes = {}
            for b in sorted(set(parents) | existing):
                content = parents.get(b, {})
                if content:
                    self._bstore((level, b), content)
                    child_hashes[b] = hash_bucket(content)
                elif self._bexists((level, b)):
                    self._bdelete((level, b))
        if child_hashes:
            assert set(child_hashes) == {0}
            self.top_hash = child_hashes[0]
            self._bstore((0, 0), self.top_hash)
        else:
            if self._bexists((0, 0)):
                self._bdelete((0, 0))
            self.top_hash = None

    # -- verification ------------------------------------------------------

    def verify_upper(self) -> bool:
        return self._verify(self.height)

    def verify(self) -> bool:
        return self._verify(self.height + 1)

    def _verify(self, max_depth: int) -> bool:
        """Top-down BFS hash check (synctree.erl:549-571)."""
        def check(level: int, bucket: int, up_hash) -> bool:
            hashes = self._fetch(level, bucket)
            if not self._verify_hash(up_hash, hashes):
                return False
            if level == max_depth:
                return True
            return all(check(level + 1, child, h)
                       for child, h in hashes.items())

        return check(1, 0, self.top_hash)


# ---------------------------------------------------------------------------
# Exchange protocol (synctree.erl:352-417)


def orddict_delta(a: Dict, b: Dict) -> List[Tuple[Any, Tuple[Any, Any]]]:
    """Symmetric diff: [(key, (a_val|NONE, b_val|NONE))], key-ordered
    (riak_ensemble_util:orddict_delta)."""
    out = []
    for k in sorted(set(a) | set(b), key=term_key):
        va = a.get(k, NONE)
        vb = b.get(k, NONE)
        if va != vb:
            out.append((k, (va, vb)))
    return out


def compare_gen(height: int, local: Callable, remote: Callable
                ) -> Generator:
    """Level-by-level diff as a generator (so remote accessors may be
    asynchronous).  ``local(level, bucket)`` / ``remote(level, bucket)``
    return a Future resolving to a bucket dict or Corrupted.

    Yields the futures it needs; returns the list of final-level key
    deltas ``[(key, (local_hash|NONE, remote_hash|NONE))]``.  Raises
    Corrupted if either side reports corruption.

    Mirrors ``synctree:compare/exchange/exchange_level/exchange_final``
    (synctree.erl:372-417).
    """
    final = height + 1
    level = 0
    diff: List[int] = [0]
    acc: List = []
    while diff:
        next_diff: List = []
        for bucket in diff:
            a = yield local(level, bucket)
            if isinstance(a, Corrupted):
                raise a
            b = yield remote(level, bucket)
            if isinstance(b, Corrupted):
                raise b
            delta = orddict_delta(a, b)
            if level == final:
                acc.extend(delta)
            else:
                next_diff.extend(bk for bk, _ in delta)
        if level == final:
            break
        diff = next_diff
        level += 1
    return acc


def compare_gen_streamed(height: int, local_many: Callable,
                         remote_many: Callable) -> Generator:
    """Level-batched diff: ONE fetch per side per level, covering every
    bucket the descent needs — the reference's streaming exchange
    (``start_exchange_level`` prefetch hook, exercised by
    synctree_remote.erl:24-38).  Cuts a WAN exchange from
    O(width·height·diffs) round trips to O(height).

    ``local_many/remote_many(pairs)`` take a list of (level, bucket)
    and return a Future resolving to a list of bucket dicts (or
    Corrupted entries).  Raises Corrupted on either side's corruption.
    """
    final = height + 1
    level = 1
    diff: List[int] = [0]
    acc: List = []
    # level 0: the root hashes
    a0 = yield local_many([(0, 0)])
    b0 = yield remote_many([(0, 0)])
    for v in (a0[0], b0[0]):
        if isinstance(v, Corrupted):
            raise v
    if not orddict_delta(a0[0], b0[0]):
        return acc
    while diff and level <= final:
        pairs = [(level, b) for b in diff]
        a_buckets = yield local_many(pairs)
        b_buckets = yield remote_many(pairs)
        next_diff: List[int] = []
        for a, b in zip(a_buckets, b_buckets):
            if isinstance(a, Corrupted):
                raise a
            if isinstance(b, Corrupted):
                raise b
            delta = orddict_delta(a, b)
            if level == final:
                acc.extend(delta)
            else:
                next_diff.extend(bk for bk, _ in delta)
        diff = next_diff
        level += 1
    return acc


def local_compare(t1: SyncTree, t2: SyncTree) -> List:
    """Synchronous compare of two in-process trees
    (synctree.erl:361-369)."""
    from riak_ensemble_tpu_torch.runtime import Future

    def acc_of(tree):
        def fetch(level, bucket):
            fut = Future()
            fut.resolve(tree.exchange_get(level, bucket))
            return fut
        return fetch

    gen = compare_gen(t1.height, acc_of(t1), acc_of(t2))
    result = None
    try:
        fut = next(gen)
        while True:
            fut = gen.send(fut.value)
    except StopIteration as stop:
        result = stop.value
    return result
