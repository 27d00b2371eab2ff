"""The one traffic generator: a mix is a JSON file of parameters.

``traffic/<mix>.json`` names:

- ``clients``: closed-loop clients, each with one request outstanding; a
  request is one keyed op, as a YCSB client thread sends it;
- ``read_share``: each request is a read with this probability, else an
  update that writes the whole record.

A request's key is drawn as YCSB's ``requestdistribution=zipfian`` draws
it (:class:`perfbench.zipf.ScrambledZipfian` over the records), and the
request goes to the ensemble that owns its key.

The configuration (``configs/<config>.json``) holds the key space and the
record size.  Client ``c``'s ``n``-th request is the same for a seed
whatever the timing: requests come in blocks of ``BLOCK`` per client, and
block ``b`` is drawn from ``(seed, b)`` alone.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from perfbench.zipf import ScrambledZipfian, fnv64

#: requests per client drawn at once
BLOCK = 8
#: distinct random tails a seed's values draw from; each value is made
#: distinct by the stamp in front of its tail
VALUE_POOL = 1 << 16
#: bytes of the stamp: the record id and the write's serial number
STAMP = struct.Struct("<QQ")
#: ensembles, drawn from the seed, that the reference follows op by op
CHECK_ENSEMBLES = 256

_LOAD_STREAM = 0xFFFF_FFFF
_VALUE_STREAM = 0xFFFF_FFFE
_SAMPLE_STREAM = 0xFFFF_FFFD


def _seed_words(seed: int) -> List[int]:
    s = int(seed) & ((1 << 64) - 1)
    return [s & 0xFFFF_FFFF, s >> 32]


def stream(seed: int, tag: int) -> np.random.Generator:
    """The generator of one stream of a seed (block number or tag)."""
    return np.random.default_rng(
        np.random.SeedSequence(_seed_words(seed) + [int(tag)]))


class KeySpace:
    """The configuration's records: names, owning ensembles and values.

    Record ``i`` is named as YCSB names it under its default hashed insert
    order, ``key_prefix`` + ``fnv64(i)`` in decimal, and lives on the
    ensemble its name hashes to (CRC-32 of the name, modulo the ensemble
    count), as Riak places a key on the preflist its hash falls in."""

    def __init__(self, cfg: dict) -> None:
        self.n_ens = int(cfg["n_ens"])
        self.count = int(cfg["record_count"])
        prefix = cfg["key_prefix"]
        if cfg["key_hash"] != "crc32":
            raise ValueError(f"key_hash {cfg['key_hash']!r}")
        self.names = [prefix + str(h)
                      for h in fnv64(np.arange(self.count)).tolist()]
        self.ens_of = np.fromiter(
            (zlib.crc32(n.encode()) % self.n_ens for n in self.names),
            np.int64, self.count)
        per = np.bincount(self.ens_of, minlength=self.n_ens)
        if per.max() > int(cfg["n_slots"]):
            raise ValueError(f"an ensemble owns {per.max()} records, over "
                             f"n_slots = {cfg['n_slots']}")
        order = np.argsort(self.ens_of, kind="stable")
        bounds = np.searchsorted(self.ens_of[order], np.arange(self.n_ens + 1))
        #: records of ensemble e: ``order[bounds[e]:bounds[e + 1]]``
        self.order, self.bounds = order, bounds
        self.value_bytes = int(cfg["value_bytes"])
        if self.value_bytes < STAMP.size:
            raise ValueError(f"value_bytes under the {STAMP.size}-byte stamp")

    def records_of(self, e: int) -> np.ndarray:
        return self.order[self.bounds[e]:self.bounds[e + 1]]

    def tails(self, seed: int) -> List[bytes]:
        """The pool of random tails a seed's values draw from."""
        n = self.value_bytes - STAMP.size
        raw = stream(seed, _VALUE_STREAM).bytes(VALUE_POOL * n)
        return [raw[i * n:(i + 1) * n] for i in range(VALUE_POOL)]


def value(tails: List[bytes], rec: int, serial: int, tail: int) -> bytes:
    """The value of one write: record id and write serial, then a tail."""
    return STAMP.pack(rec, serial) + tails[tail]


@dataclass
class Block:
    """``BLOCK`` requests of every client: global record ids
    ``rec [C, B]``, ``read [C, B]`` and tail indices ``val [C, B]``."""

    rec: np.ndarray
    read: np.ndarray
    val: np.ndarray


class Traffic:
    """A mix over a key space, for one seed."""

    def __init__(self, mix: dict, keys: KeySpace, seed: int) -> None:
        self.mix, self.keys, self.seed = mix, keys, seed
        self.clients = int(mix["clients"])
        self.read_share = float(mix["read_share"])
        self._zipf = ScrambledZipfian(keys.count)
        self._blocks: Dict[int, Block] = {}

    def block(self, b: int) -> Block:
        blk = self._blocks.get(b)
        if blk is None:
            blk = self._draw(b)
            self._blocks[b] = blk
            # clients run at most a block apart in a closed loop
            for old in [x for x in self._blocks if x < b - 1]:
                del self._blocks[old]
        return blk

    def _draw(self, b: int) -> Block:
        rng = stream(self.seed, b)
        shape = (self.clients, BLOCK)
        rec = self._zipf.draw(rng, shape)
        read = rng.random(shape) < self.read_share
        val = rng.integers(0, VALUE_POOL, shape, dtype=np.int64)
        return Block(rec, read, val)

    def request(self, client: int, n: int) -> Tuple[int, int, bool, int, int]:
        """Client ``client``'s ``n``-th request: (ensemble, record id,
        read, tail index, write serial).  Serials start at 1; the load
        phase writes serial 0."""
        blk = self.block(n // BLOCK)
        j = n % BLOCK
        rec = int(blk.rec[client, j])
        return (int(self.keys.ens_of[rec]), rec, bool(blk.read[client, j]),
                int(blk.val[client, j]), n * self.clients + client + 1)

    def load_values(self) -> np.ndarray:
        """The tail index of each record's loaded value."""
        rng = stream(self.seed, _LOAD_STREAM)
        return rng.integers(0, VALUE_POOL, self.keys.count, dtype=np.int64)

    def sample_ensembles(self) -> np.ndarray:
        """The ensembles the reference follows, drawn from the seed."""
        n = min(CHECK_ENSEMBLES, self.keys.n_ens)
        rng = stream(self.seed, _SAMPLE_STREAM)
        return np.sort(rng.choice(self.keys.n_ens, size=n, replace=False)
                       ).astype(np.int64)

