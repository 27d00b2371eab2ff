"""The resolve half's host passes in the port — the C++ unpack and mirror
scatter — against their plain versions and the JAX package's passes, and
the port's oracle arm (``native_enqueue=False, native_resolve=False``)
against the JAX service's ``RETPU_NATIVE_ENQUEUE=0 RETPU_NATIVE_RESOLVE=0``
arm in lockstep (the mirror of ``tests/test_native_resolve.py``):

- fuzzed packed payloads through ``NativeResolve.unpack``, the plain
  ``unpack_results`` and the JAX package's ``NativeResolve.unpack``:
  full-width, pack-gather and sliced layouts, want_vsn on and off, K = 0;
  a short payload is refused (the port raises);
- fuzzed flushes through ``NativeResolve.scatter_mirrors``, the plain
  ``scatter_mirrors_plain`` and the JAX package's pass: the same mirror
  slabs, duplicate slots, invalid slots, reads of slots a write in the
  same flush flipped, ``ack_reads`` off;
- the lockstep streams of ``test_torch_native_enqueue`` on the oracle arm,
  fast reads on and off, compaction on and off, depth 1 and 2.

The reference's WAL, delta-section and commutative-fold cases wait for the
WAL and replication slices.  Tolerance: exact equality everywhere.
"""

import numpy as np
import pytest

from riak_ensemble_tpu_torch.ops import engine as teng
from riak_ensemble_tpu_torch.parallel import resolve_native as trn
from test_torch_native_enqueue import Pair

OPS = (teng.OP_PUT, teng.OP_CAS, teng.OP_GET, teng.OP_RMW)


@pytest.fixture
def jb():
    pytest.importorskip("jax")
    from riak_ensemble_tpu.parallel import batched_host as jb
    return jb


@pytest.fixture
def jnat(monkeypatch):
    pytest.importorskip("jax")
    monkeypatch.delenv("RETPU_NATIVE_RESOLVE", raising=False)
    from riak_ensemble_tpu.parallel import resolve_native
    nat = resolve_native.get()
    assert nat is not None, "the JAX package's host library did not load"
    return nat


def _pack(won, quorum, corrupt, committed, get_ok, found, value, vsn,
          want_vsn):
    """The packed payload's layout (``_pack_results_body``) on the host."""
    flags = np.concatenate([won.ravel(), quorum.ravel(), corrupt.ravel(),
                            committed.ravel(), get_ok.ravel(),
                            found.ravel()]).astype(bool)
    ints = [value.ravel().astype(np.int32)]
    if want_vsn:
        ints += [vsn[..., 0].ravel().astype(np.int32),
                 vsn[..., 1].ravel().astype(np.int32)]
    return np.concatenate([np.packbits(flags),
                           np.concatenate(ints).view(np.uint8)])


@pytest.mark.parametrize("seed", range(3))
def test_unpack_fuzz(jnat, seed):
    tnat = trn.get()
    rng = np.random.default_rng(seed)
    modes = set()
    for trial in range(50):
        e = int(rng.integers(4, 48))
        m = int(rng.integers(1, 6))
        k = int(rng.integers(0, 10)) if trial % 5 else 0
        want_vsn = bool(rng.integers(0, 2))
        mode = trial % 3               # full / pack-gather / sliced
        modes.add((mode, k == 0))
        if mode == 0:
            active, aw, sliced = None, e, False
        else:
            na = int(rng.integers(1, e))
            active = np.sort(rng.choice(e, na, replace=False)).astype(
                np.int32)
            aw = 8
            while aw < na:
                aw <<= 1
            aw = max(min(aw, e), na)
            sliced = mode == 2
        hw = aw if sliced else e
        bits = [rng.random(s) < 0.5 for s in
                (hw, hw, (hw, m), (k, aw), (k, aw), (k, aw))]
        value = rng.integers(-2 ** 31, 2 ** 31, (k, aw),
                             dtype=np.int64).astype(np.int32)
        vsn = rng.integers(0, 2 ** 31, (k, aw, 2)).astype(np.int32)
        flat = _pack(*bits, value, vsn, want_vsn)
        a_width = 0 if active is None else aw
        plain = trn.unpack_results(flat, e, m, k, want_vsn, active=active,
                                   a_width=a_width, sliced=sliced)
        got = tnat.unpack(flat, e, m, k, want_vsn, active, a_width, sliced)
        ref = jnat.unpack(flat, e, m, k, want_vsn, active, a_width, sliced)
        for name, a, b, c in zip(("won", "quorum", "corrupt", "committed",
                                  "get_ok", "found", "value", "vsn"),
                                 plain, got, ref):
            if a is None:
                assert b is None and c is None, name
                continue
            assert a.dtype == b.dtype == c.dtype, name
            assert np.array_equal(a, b) and np.array_equal(b, c), \
                (seed, trial, name, mode)
    assert len(modes) == 6


def test_unpack_refuses_a_short_payload(jnat):
    tnat = trn.get()
    args = (16, 3, 4, True, None, 0, False)
    with pytest.raises(ValueError, match="does not hold"):
        tnat.unpack(np.zeros((3,), np.uint8), *args)
    assert jnat.unpack(np.zeros((3,), np.uint8), *args) is None
    with pytest.raises(ValueError, match="active column"):
        tnat.unpack(np.zeros((4096,), np.uint8), 16, 3, 4, True,
                    np.asarray([3, 16], np.int32), 8, False)


def _flush(rng, e, s, k):
    """A random flush: op planes over every kind, committed / served
    bits, values with zeros (tombstones), invalid slots, and the taken
    columns with their round counts."""
    kind = rng.choice(np.asarray([teng.OP_NOOP, *OPS], np.int32), (k, e))
    slot = rng.integers(-1, s + 1, (k, e)).astype(np.int32)
    slot[rng.random((k, e)) < 0.5] = rng.integers(0, 3)  # duplicates
    committed, get_ok, found = (rng.random((k, e)) < 0.6 for _ in range(3))
    value = rng.integers(-3, 4, (k, e)).astype(np.int32)
    vsn = rng.integers(0, 50, (k, e, 2)).astype(np.int32)
    cols = np.sort(rng.choice(e, int(rng.integers(0, e + 1)),
                              replace=False)).astype(np.int32)
    kcounts = rng.integers(0, k + 1, cols.size).astype(np.int32)
    return kind, slot, committed, get_ok, found, value, vsn, cols, kcounts


def _slabs(rng, e, s):
    return [rng.integers(0, 9, (e, s, 2)).astype(np.int32),
            rng.random((e, s)) < 0.5,
            rng.integers(-9, 9, (e, s)).astype(np.int32),
            rng.random((e, s)) < 0.5]


@pytest.mark.parametrize("seed", range(3))
def test_scatter_mirrors_fuzz(jnat, seed):
    tnat = trn.get()
    rng = np.random.default_rng(100 + seed)
    for trial in range(40):
        e = int(rng.integers(1, 20))
        s = int(rng.integers(1, 6))
        k = int(rng.integers(1, 9))
        kind, slot, committed, get_ok, found, value, vsn, cols, kcounts = \
            _flush(rng, e, s, k)
        ack_reads = bool(trial % 4)
        want_vsn = bool(trial % 3)
        inline_cls = rng.random((e, s)) < 0.5
        base = _slabs(rng, e, s)
        outs = [[x.copy() for x in base] for _ in range(3)]
        args = (e, s, kind, slot, committed, get_ok, found, value,
                vsn if want_vsn else None, cols, kcounts, ack_reads, OPS)
        tnat.scatter_mirrors(*args, *outs[0], inline_cls)
        trn.scatter_mirrors_plain(*args, *outs[1], inline_cls)
        assert jnat.scatter_mirrors(*args, *outs[2], inline_cls)
        for name, a, b, c in zip(("vsn_np", "vsn_ok", "inl_np", "inl_ok"),
                                 *outs):
            assert np.array_equal(a, b) and np.array_equal(b, c), \
                (seed, trial, name)


def test_scatter_mirrors_refuses_bad_slabs():
    tnat = trn.get()
    rng = np.random.default_rng(5)
    e, s, k = 4, 3, 2
    kind, slot, committed, get_ok, found, value, vsn, cols, kcounts = \
        _flush(rng, e, s, k)
    slabs = _slabs(rng, e, s)
    args = (e, s, kind, slot, committed, get_ok, found, value, vsn)
    with pytest.raises(TypeError, match="vsn_np"):
        tnat.scatter_mirrors(*args, cols, kcounts, True, OPS,
                             slabs[0][:, :, ::-1], *slabs[1:],
                             np.zeros((e, s), bool))
    with pytest.raises(ValueError, match="outside"):
        tnat.scatter_mirrors(*args, np.asarray([e], np.int32),
                             np.asarray([1], np.int32), True, OPS, *slabs,
                             np.zeros((e, s), bool))


@pytest.mark.parametrize("fast,compact,depth", [
    (True, True, 1), (True, True, 2), (False, True, 1), (True, False, 2),
    (False, False, 1)])
def test_oracle_arm_matches_jax_oracle(jb, monkeypatch, fast, compact,
                                       depth):
    """The port's ``False`` arms against the JAX ``=0`` arms: the per-entry
    pack and the per-op resolve loops on both sides."""
    p = Pair(jb, monkeypatch, "oracle", fast, compact, depth)
    p.run(seed=40 + depth + 2 * fast + 4 * compact)
    p.check()
    ts = p.ts
    assert ts.completion_wakes == ts.native_resolve_flushes == 0
    assert ts.fallback_resolve_flushes == ts.flushes > 0
