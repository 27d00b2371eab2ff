"""Each traffic file's mix and sizes, the key space, and determinism by
seed."""

import zlib

import numpy as np
import pytest

from perfbench import harness
from perfbench.traffic import (BLOCK, CHECK_ENSEMBLES, STAMP, VALUE_POOL,
                               KeySpace, Traffic, value)
from perfbench.zipf import fnv64

MAN = harness.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
CFG = harness.config(MAN, "riak_sc_mem")


@pytest.fixture(scope="module")
def keys():
    return KeySpace(CFG)


def _traffic(keys, cell, seed):
    mx = harness.mix(harness.workload(MAN, cell)["traffic"])
    return mx, Traffic(mx, keys, seed)


@pytest.mark.parametrize("cell", CELLS)
def test_requests_are_the_seed_s(keys, cell):
    _, t = _traffic(keys, cell, 2 ** 31 + 101)
    _, again = _traffic(keys, cell, 2 ** 31 + 101)
    _, other = _traffic(keys, cell, 2 ** 31 + 102)
    for c, n in ((0, 0), (t.clients - 1, BLOCK + 3), (t.clients // 2, 40)):
        assert t.request(c, n) == again.request(c, n)
    blk, oth = t.block(0), other.block(0)
    assert not (np.array_equal(blk.rec, oth.rec)
                and np.array_equal(blk.val, oth.val))
    assert np.array_equal(t.sample_ensembles(), again.sample_ensembles())


@pytest.mark.parametrize("cell", CELLS)
def test_mix_and_sizes(keys, cell):
    mx, t = _traffic(keys, cell, 2 ** 31 + 103)
    blk = t.block(1)
    c = mx["clients"]
    assert blk.rec.shape == blk.read.shape == blk.val.shape == (c, BLOCK)
    assert blk.rec.min() >= 0 and blk.rec.max() < CFG["record_count"]
    assert blk.val.min() >= 0 and blk.val.max() < VALUE_POOL
    reads = np.concatenate([t.block(b).read.ravel() for b in range(4)])
    assert abs(reads.mean() - mx["read_share"]) < 0.01
    e, rec, _, _, serial = t.request(7, 9)
    assert e == keys.ens_of[rec] and serial == 9 * c + 7 + 1
    s = t.sample_ensembles()
    assert len(s) == CHECK_ENSEMBLES and len(set(s.tolist())) == len(s)


@pytest.mark.parametrize("cell", CELLS)
def test_keys_are_ycsb_s_scrambled_zipfian(keys, cell):
    # YCSB's ScrambledZipfian: the hottest record takes about 1 / ZETAN
    # (3.8 %) of the draws, and the hot records lie scattered over the ids
    _, t = _traffic(keys, cell, 2 ** 31 + 104)
    recs = np.concatenate([t.block(b).rec.ravel() for b in range(40)])
    counts = np.bincount(recs, minlength=CFG["record_count"])
    top = counts.max() / recs.size
    assert 0.03 < top < 0.045
    hot = np.argsort(counts)[-20:]
    assert hot.max() - hot.min() > CFG["record_count"] // 4
    assert (counts > 0).sum() > 0.1 * recs.size


def test_key_space_is_ycsb_s_names_on_riak_s_ring(keys):
    assert len(keys.names) == CFG["record_count"]
    assert keys.names[0] == "user" + str(fnv64([0])[0])
    assert len(set(keys.names)) == CFG["record_count"]
    g = 12345
    assert keys.ens_of[g] == zlib.crc32(keys.names[g].encode()) \
        % CFG["n_ens"]
    per = np.bincount(keys.ens_of, minlength=CFG["n_ens"])
    assert per.min() > 0 and per.max() <= CFG["n_slots"]
    assert per.sum() == CFG["record_count"]
    e = int(keys.ens_of[g])
    assert g in keys.records_of(e).tolist()


def test_every_value_is_distinct_and_of_the_record_size(keys):
    tails = keys.tails(5)
    assert len(tails) == VALUE_POOL
    a = value(tails, 3, 0, 9)
    b = value(tails, 3, 1, 9)
    c = value(tails, 4, 0, 9)
    assert len(a) == CFG["value_bytes"] and len({a, b, c}) == 3
    assert a[STAMP.size:] == tails[9]
    assert keys.tails(5)[9] == tails[9] and keys.tails(6)[9] != tails[9]


def test_a_key_space_over_its_slots_is_refused():
    with pytest.raises(ValueError):
        KeySpace(dict(CFG, n_slots=900))
