"""The port's host synctree against the JAX package's.

``tests/test_synctree.py``'s ten cases (basic, corrupt and exchange on
both backends, the identical-tree exchange, the file backend's reload,
the message-counting and streamed exchanges, the shared tree path and
the reconcile property over eight seeds), each run on
``riak_ensemble_tpu.synctree`` and ``riak_ensemble_tpu_torch.synctree``
with the same inputs: every result, every tree's top hash and every
bucket its backend holds are equal, and the file backends' logs are
equal byte for byte.
"""

import random

import pytest

pytest.importorskip("jax")

from riak_ensemble_tpu import runtime as jrt  # noqa: E402
from riak_ensemble_tpu.synctree import backends as jbe  # noqa: E402
from riak_ensemble_tpu.synctree import tree as jtree  # noqa: E402
from riak_ensemble_tpu_torch import runtime as trt  # noqa: E402
from riak_ensemble_tpu_torch.synctree import backends as tbe  # noqa: E402
from riak_ensemble_tpu_torch.synctree import tree as ttree  # noqa: E402

SIDES = {"ref": (jtree, jbe, jrt), "port": (ttree, tbe, trt)}


def h(n: int) -> bytes:
    return n.to_bytes(8, "big")


def build(mods, n, backend=None, width=16, segments=16**3):
    tree, be, _rt = mods
    t = tree.SyncTree(width=width, segments=segments,
                      backend=backend if backend is not None
                      else be.DictBackend())
    for i in range(n, 0, -1):
        assert t.insert(i, h(i * 10)) is None
    return t


def state(t):
    """A tree's top hash and every (level, bucket) it stores."""
    def bucket(v):
        return sorted(v.items(), key=repr) if isinstance(v, dict) else v
    return (t.top_hash,
            sorted(((k, bucket(t.backend.fetch(k)))
                    for k in t.backend.keys()), key=repr))


def both(fn, tmp_path=None):
    """``fn(mods, dir)`` on each package; results and tree states must
    be equal.  ``fn`` returns ``(result, [trees])``."""
    out = {}
    for side, mods in SIDES.items():
        d = None
        if tmp_path is not None:
            d = tmp_path / side
            d.mkdir()
        result, trees = fn(mods, d)
        out[side] = (_plain(result), [state(t) for t in trees])
    assert out["ref"] == out["port"]
    if tmp_path is not None:
        ref_files = sorted(p.name for p in (tmp_path / "ref").iterdir())
        assert ref_files == sorted(
            p.name for p in (tmp_path / "port").iterdir())
        for name in ref_files:
            assert (tmp_path / "ref" / name).read_bytes() == \
                (tmp_path / "port" / name).read_bytes(), name
    return out["port"][0]


def _plain(x):
    """Corrupted results compare by (class name, level, bucket)."""
    if isinstance(x, (jtree.Corrupted, ttree.Corrupted)):
        return ("Corrupted", x.level, x.bucket)
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if x is jtree.NONE or x is ttree.NONE:
        return "<NONE>"
    return x


def make_backend(mods, kind, d, name="t"):
    be = mods[1]
    if kind == "dict":
        return be.DictBackend()
    return be.FileBackend(path=str(d / f"{name}.log"))


def _close(*trees):
    for t in trees:
        if hasattr(t.backend, "close"):
            t.backend.close()


@pytest.mark.parametrize("kind", ["dict", "file"])
def test_basic(kind, tmp_path):
    def run(mods, d):
        t = build(mods, 100, make_backend(mods, kind, d))
        got = [t.get(42), t.insert(42, h(42)), t.get(42)]
        _close(t)
        return got, [t]
    assert both(run, tmp_path) == [h(420), None, h(42)]


@pytest.mark.parametrize("kind", ["dict", "file"])
def test_corrupt(kind, tmp_path):
    def run(mods, d):
        t = build(mods, 10, make_backend(mods, kind, d))
        got = [t.get(4)]
        t.corrupt(4)
        got.append(t.get(4))
        t.rehash()
        got.append(t.get(4))
        _close(t)
        return got, [t]
    got = both(run, tmp_path)
    assert got[0] == h(40) and got[1][0] == "Corrupted" and got[2] is None


@pytest.mark.parametrize("kind", ["dict", "file"])
def test_exchange(kind, tmp_path):
    num, diff = 50, 10

    def run(mods, d):
        t1 = build(mods, num, make_backend(mods, kind, d, "a"))
        t2 = build(mods, num - diff, make_backend(mods, kind, d, "b"))
        got = sorted(mods[0].local_compare(t1, t2))
        _close(t1, t2)
        return got, [t1, t2]
    got = both(run, tmp_path)
    assert got == [(n, (h(n * 10), "<NONE>"))
                   for n in range(num - diff + 1, num + 1)]


def test_exchange_identical_trees_zero_diff():
    def run(mods, _d):
        t1, t2 = build(mods, 50), build(mods, 50)
        return [t1.top_hash == t2.top_hash,
                mods[0].local_compare(t1, t2)], [t1, t2]
    assert both(run) == [True, []]


def test_file_backend_reload(tmp_path):
    def run(mods, d):
        path = str(d / "tree.log")
        t = build(mods, 30, mods[1].FileBackend(path=path))
        top = t.top_hash
        t.backend.close()
        t2 = mods[0].SyncTree(width=16, segments=16**3,
                              backend=mods[1].FileBackend(path=path))
        got = [t2.top_hash == top, t2.get(7), t2.verify()]
        t2.backend.close()
        return got, [t2]
    assert both(run, tmp_path) == [True, h(70), True]


def _drive(gen):
    try:
        fut = next(gen)
        while True:
            fut = gen.send(fut.value)
    except StopIteration as stop:
        return stop.value


def test_remote_exchange_message_counts():
    num, diff = 10, 4

    def run(mods, _d):
        tree, _be, rt = mods
        local_tree, remote_tree = build(mods, num), build(mods, num - diff)
        stats = {"msgs": 0}

        def local(level, bucket):
            fut = rt.Future()
            fut.resolve(local_tree.exchange_get(level, bucket))
            return fut

        def remote(level, bucket):
            stats["msgs"] += 1
            fut = rt.Future()
            fut.resolve(remote_tree.exchange_get(level, bucket))
            return fut

        key_diff = _drive(tree.compare_gen(local_tree.height, local, remote))
        return [sorted(key_diff), stats["msgs"],
                local_tree.height], [local_tree, remote_tree]
    key_diff, msgs, height = both(run)
    assert len(key_diff) == diff
    assert msgs <= (height + 2) * diff * 2


def _many_of(rt, tree, stats=None):
    def fetch_many(pairs):
        if stats is not None:
            stats["remote_calls"] += 1
        fut = rt.Future()
        fut.resolve([tree.exchange_get(lv, b) for lv, b in pairs])
        return fut
    return fetch_many


def test_streamed_exchange_round_trips():
    num, diff = 200, 60

    def run(mods, _d):
        tree, _be, rt = mods
        lt, rtree = build(mods, num), build(mods, num - diff)
        stats = {"remote_calls": 0}
        key_diff = _drive(tree.compare_gen_streamed(
            lt.height, _many_of(rt, lt), _many_of(rt, rtree, stats)))
        return [sorted(key_diff), stats["remote_calls"], lt.height], \
            [lt, rtree]
    key_diff, calls, height = both(run)
    assert len(key_diff) == diff and calls <= height + 2


def test_streamed_matches_unbatched():
    def run(mods, _d):
        tree, _be, rt = mods
        got, trees = [], []
        for n1, n2 in ((50, 40), (30, 30), (1, 0)):
            t1, t2 = build(mods, n1), build(mods, n2)
            streamed = sorted(_drive(tree.compare_gen_streamed(
                t1.height, _many_of(rt, t1), _many_of(rt, t2))))
            got.append((streamed, sorted(tree.local_compare(t1, t2))))
            trees += [t1, t2]
        return got, trees
    for streamed, unbatched in both(run):
        assert streamed == unbatched


def test_shared_tree_path():
    def run(mods, _d):
        tree, be, _rt = mods
        shared = be.DictBackend()
        ta = tree.SyncTree(tree_id=b"peerA", segments=16**3, backend=shared)
        tb = tree.SyncTree(tree_id=b"peerB", segments=16**3, backend=shared)
        got = [ta.insert("k", h(1)), tb.insert("k", h(2)), ta.get("k"),
               tb.get("k")]
        return got, [ta, tb]
    assert both(run) == [None, None, h(1), h(2)]


@pytest.mark.parametrize("seed", range(8))
def test_reconcile_property(seed):
    def run(mods, _d):
        tree = mods[0]
        rng = random.Random(seed)
        universe = list(range(200))
        common = {k: h(rng.randrange(1 << 30)) for k in universe
                  if rng.random() < 0.6}
        only_a = {k: h(rng.randrange(1 << 30)) for k in universe
                  if k not in common and rng.random() < 0.5}
        differ = {k for k in common if rng.random() < 0.2}
        ta = tree.SyncTree(segments=16**3)
        tb = tree.SyncTree(segments=16**3)
        expect = {}
        for k, v in common.items():
            assert ta.insert(k, v) is None
            if k in differ:
                v2 = h(int.from_bytes(v, "big") ^ 1)
                assert tb.insert(k, v2) is None
                expect[k] = (v, v2)
            else:
                assert tb.insert(k, v) is None
        for k, v in only_a.items():
            assert ta.insert(k, v) is None
            expect[k] = (v, tree.NONE)
        delta = dict(tree.local_compare(ta, tb))
        assert delta == expect
        got = [sorted(delta.items())]
        for k, (va, _vb) in delta.items():
            assert tb.insert(k, va) is None
        got += [ta.top_hash == tb.top_hash, tree.local_compare(ta, tb)]
        return got, [ta, tb]
    _delta, same, rest = both(run)
    assert same and rest == []
