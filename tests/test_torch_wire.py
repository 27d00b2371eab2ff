"""The port's restricted wire codec against the JAX package's.

Mirrors ``tests/test_wire.py`` and ``tests/test_wire_coverage.py``:

- every allowlisted value (all record types, big ints, nesting near the
  depth limit, seeded structural fuzz, raw-buffer frames) encodes to the
  SAME bytes through the port's C++ codec (``csrc/host/wirecodec.cc``,
  built with g++ here), the port's Python codec and the reference's
  Python codec; each package decodes the other's frames into its own
  record classes, so a frame crosses packages through bytes;
- hostile frames (truncations, unknown tags and records, nesting bombs,
  bad utf-8, unhashable members, random and mutated byte soup) raise
  ``WireError`` in both of the port's decoders alike;
- a codec that cannot be built raises; only ``RETPU_NO_NATIVE_WIRE=1``
  pins the Python codec;
- every frame a ``ServiceClient`` / ``ServiceServer`` session puts on
  the wire (the coverage audit's counterpart for the port's front end)
  survives both codecs byte-equal.

Tolerance: exact bytes.
"""

import asyncio
import sys

import numpy as np
import pytest
from test_torch_reference_natives import reference_natives  # noqa: F401 (autouse)

from riak_ensemble_tpu_torch import state as tstate
from riak_ensemble_tpu_torch import types as ttypes
from riak_ensemble_tpu_torch import wire
from riak_ensemble_tpu_torch.ops import build


def _ref():
    pytest.importorskip("jax")
    from riak_ensemble_tpu import state as jstate
    from riak_ensemble_tpu import types as jtypes
    from riak_ensemble_tpu import wire as jwire
    return jwire, jtypes, jstate


def cases(types, state):
    """The allowlisted corpus, built from one package's record classes."""
    P, O, F, E = types.PeerId, types.Obj, types.Fact, types.EnsembleInfo
    nf = types.NOTFOUND
    deep = None
    for _ in range(31):           # one under the depth limit
        deep = (deep,)
    return [
        None, True, False, 0, 1, -1, 127, 128, -128, -129, 2 ** 63,
        -(2 ** 63) - 1, 2 ** 80, -(2 ** 80), 1.5, -0.0, float("inf"),
        "", "node0", "ünïcode", b"", b"\x00\xffpayload",
        (), (1, 2), [1, [2, [3]]], {"a": 1, 2: (3,)}, {1, 2},
        frozenset({3}), nf, deep,
        P(1, "node0"), P("root", "node1"),
        O(epoch=3, seq=7, key="k", value=b"v"),
        O(epoch=1, seq=1, key=("composite", 2), value=nf),
        F(epoch=2, seq=5, leader=P(0, "n0"),
          views=((P(0, "n0"), P(1, "n1")),), view_vsn=(1, 0),
          pend_vsn=None, commit_vsn=(0, 0),
          pending=((2, 1), ((P(1, "n1"),),))),
        E(vsn=(1, 2), leader=None, views=((P(0, "n0"),),), seq=None),
        state.ClusterState(
            id=("node0", 123.5), enabled=True, members_vsn=(1, 0),
            members=frozenset({"node0", "node1"}),
            ensembles={"root": E(vsn=(0, 1), leader=P("root", "node0"),
                                 views=((P("root", "node0"),),),
                                 seq=(1, 1))},
            pending={"root": ((1, 1), ((P(2, "node2"),),))}),
        (7, "kput", 3, "key", b"val"),
        (9, [("ok", (1, 2)), "failed", ("ok", nf, (3, 4))]),
    ]


def _gen(rng, types, depth=0):
    """One seeded random allowlisted value (structural fuzz)."""
    c = int(rng.integers(11 if depth < 5 else 6))
    if c == 0:
        return None
    if c == 1:
        return bool(rng.integers(2))
    if c == 2:
        return int(rng.integers(-2 ** 40, 2 ** 40)) << int(rng.integers(40))
    if c == 3:
        return float(rng.normal())
    if c == 4:
        return bytes(rng.integers(0, 256, int(rng.integers(0, 12)),
                                  dtype=np.uint8))
    if c == 5:
        return "".join(chr(int(rng.integers(32, 1000)))
                       for _ in range(int(rng.integers(0, 8))))
    n = int(rng.integers(0, 4))
    if c == 6:
        return tuple(_gen(rng, types, depth + 1) for _ in range(n))
    if c == 7:
        return [_gen(rng, types, depth + 1) for _ in range(n)]
    if c == 8:
        return {int(rng.integers(100)): _gen(rng, types, depth + 1)
                for _ in range(n)}
    if c == 9:
        return frozenset(int(rng.integers(1000)) for _ in range(n))
    return types.Obj(int(rng.integers(9)), int(rng.integers(9)),
                     f"k{int(rng.integers(5))}",
                     types.PeerId(int(rng.integers(10)), "n1"))


def test_native_codec_is_the_ports_own_build():
    mod = wire._native_codec()
    assert mod is not None
    assert mod.__file__.startswith(build.BUILD_DIR)
    assert "wirecodec" not in sys.modules.get("riak_ensemble_tpu.wire",
                                              wire).__name__


@pytest.mark.parametrize("i", range(len(cases(ttypes, tstate))))
def test_corpus_bytes_equal_across_codecs_and_packages(i):
    jwire, jtypes, jstate = _ref()
    got, want = cases(ttypes, tstate)[i], cases(jtypes, jstate)[i]
    b = wire.encode_py(got)
    assert wire._native_codec().encode(got) == b
    assert jwire.encode_py(want) == b
    # each package decodes the other's bytes into its own classes
    for back in (wire.decode(b), wire.decode_py(b)):
        assert type(back) is type(got) and back == got
    assert jwire.decode_py(b) == want
    if got is ttypes.NOTFOUND:
        assert wire.decode(b) is got and jwire.decode_py(b) is want


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_bytes_equal_across_codecs_and_packages(seed):
    jwire, jtypes, _ = _ref()
    mod = wire._native_codec()
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(300):
        got, want = _gen(ra, ttypes), _gen(rb, jtypes)
        b = wire.encode_py(got)
        assert mod.encode(got) == b == jwire.encode_py(want)
        assert mod.decode(b) == got and wire.decode_py(b) == got
        assert jwire.decode_py(b) == want


def test_raw_frames_equal_across_packages():
    jwire, _, _ = _ref()
    lens = np.asarray([1, 3, 0, 2], np.int32)
    arena = b"abcdef"
    val = (4, "kput_slab", 3, wire.Raw(lens), wire.Raw(arena), True)
    parts = wire.encode_parts(val)
    jparts = jwire.encode_parts((4, "kput_slab", 3, jwire.Raw(lens),
                                 jwire.Raw(arena), True))
    frame = b"".join(bytes(p) for p in parts)
    assert frame == b"".join(bytes(p) for p in jparts)
    for dec in (wire.decode, wire.decode_py, jwire.decode_py):
        out = dec(frame)
        assert out[:3] == (4, "kput_slab", 3) and out[5] is True
        assert bytes(out[4]) == arena
        assert np.array_equal(np.frombuffer(out[3], np.int32), lens)
    with pytest.raises(wire.WireError):
        wire.encode(wire.Raw(b"x"))      # a Raw needs encode_parts


HOSTILE = [
    b"Q", b"R\x7f", b"t\x01" * 64 + b"N", b"l\x01" * 40 + b"N",
    b"t" + bytes([0x80, 0x80, 0x80, 0x80, 0x80, 0x01]),
    b"s\x01\xff", b"e\x01l\x00", b"z\x01l\x00", b"d\x01l\x00N",
    b"iN", b"i\x80", b"B\x01\x05N", b"B\x01\x00r\x05", b"N N",
]


@pytest.mark.parametrize("blob", HOSTILE, ids=lambda b: b.hex()[:16])
def test_hostile_frames_raise_wire_error(blob):
    for dec in (wire.decode, wire.decode_py):
        with pytest.raises(wire.WireError):
            dec(blob)


def test_truncations_and_encode_bombs_raise():
    payload = wire.encode((1, "abc", b"xyz", ttypes.PeerId(1, "n")))
    for cut in range(len(payload)):
        for dec in (wire.decode, wire.decode_py):
            with pytest.raises(wire.WireError):
                dec(payload[:cut])
    v = []
    for _ in range(1000):
        v = [v]
    s = []
    s.append(s)

    class Evil:
        pass
    for bad in (v, s, Evil(), lambda: None, object()):
        for enc in (wire.encode, wire.encode_py):
            with pytest.raises(wire.WireError):
                enc(bad)


@pytest.mark.parametrize("seed", range(2))
def test_random_and_mutated_bytes_agree(seed):
    """Byte soup and mutated valid frames: both of the port's decoders
    give the same value or both raise WireError, and agree with the
    reference's decoder."""
    jwire, _, _ = _ref()
    mod = wire._native_codec()
    rng = np.random.default_rng(1000 + seed)
    base = wire.encode_py(
        {"k": (ttypes.PeerId(1, "n1"), [1.5, ttypes.NOTFOUND, -2 ** 70,
                                        "déjà"], frozenset({1, 2}),
               b"\x00\xff")})
    for i in range(3000):
        if i % 2:
            blob = bytes(rng.integers(0, 256, int(rng.integers(1, 40)),
                                      dtype=np.uint8))
        else:
            blob = bytearray(base)
            for _m in range(int(rng.integers(1, 4))):
                op = int(rng.integers(3))
                if op == 0 and blob:
                    blob[int(rng.integers(len(blob)))] ^= \
                        1 << int(rng.integers(8))
                elif op == 1 and len(blob) > 1:
                    del blob[int(rng.integers(len(blob))):]
                else:
                    blob.extend(rng.integers(0, 256, 2, dtype=np.uint8))
            blob = bytes(blob)
        outs = []
        for dec, err in ((wire.decode_py, wire.WireError),
                         (mod.decode, wire.WireError),
                         (jwire.decode_py, jwire.WireError)):
            try:
                outs.append(("ok", wire.encode_py(dec(blob))
                             if dec is not jwire.decode_py
                             else jwire.encode_py(dec(blob))))
            except err:
                outs.append(("err",))
        assert outs[0] == outs[1] == outs[2], blob.hex()


def test_failed_build_raises_and_env_pins_python(monkeypatch):
    monkeypatch.setattr(wire, "_NATIVE", None)
    monkeypatch.setattr(wire, "_NATIVE_TRIED", False)
    monkeypatch.setattr(build, "HOST_CXX", "/nonexistent/g++")
    monkeypatch.delenv("RETPU_NO_NATIVE_WIRE", raising=False)
    with pytest.raises(RuntimeError, match="wire"):
        wire.encode(1)
    monkeypatch.setattr(wire, "_NATIVE_TRIED", False)
    monkeypatch.setenv("RETPU_NO_NATIVE_WIRE", "1")
    assert wire._native_codec() is None
    assert wire.encode((1, "x")) == wire.encode_py((1, "x"))
    assert wire.decode(wire.encode_py((1, "x"))) == (1, "x")


def test_no_pickle_on_the_wire():
    import inspect

    from riak_ensemble_tpu_torch import netruntime, svcnode
    for mod in (netruntime, svcnode, wire):
        assert "import pickle" not in inspect.getsource(mod)
        assert "pickle.loads" not in inspect.getsource(mod).replace(
            "``pickle.loads``", "")


def test_every_session_frame_is_wire_safe(monkeypatch):
    """The front end's coverage audit: every request and response frame
    of a ServiceClient session against the port's server (keyed verbs,
    slab verbs, lifecycle, stats / health / metrics / controller /
    fleet) decodes in the reference's codec and re-encodes to the same
    bytes in the port's three codecs."""
    jwire, _, _ = _ref()
    from riak_ensemble_tpu_torch import funref, svcnode
    from riak_ensemble_tpu_torch.config import fast_test_config
    frames = []
    enc, enc_parts = wire.encode, wire.encode_parts

    def spy(v):
        b = enc(v)
        frames.append(b)
        return b

    def spy_parts(v):
        parts = enc_parts(v)
        frames.append(b"".join(bytes(p) for p in parts))
        return parts
    monkeypatch.setattr(wire, "encode", spy)
    monkeypatch.setattr(wire, "encode_parts", spy_parts)

    async def session():
        srv = await svcnode.serve(4, 3, 16, config=fast_test_config(),
                                  device="cpu", dynamic=True)
        c = svcnode.ServiceClient(srv.host, srv.port)
        await c.connect()
        row = (await c.create_ensemble("orders"))[1]
        await c.kput(row, "k", b"v")
        await c.kput_many(row, ["a", "b"], [b"1", b"2"])
        await c.kput_many(row, [("t", 1)], [b"x"])     # list verb
        await c.kget_many(row, ["a", "b", "zz"], want_vsn=True)
        vsn = (await c.kget_vsn(row, "a"))[2]
        await c.kupdate(row, "a", vsn, b"3")
        await c.kmodify(row, "ctr", funref.ref("rmw:add", 2), 0)
        await c.kdelete(row, "b")
        for verb in (c.stats(), c.health(), c.health(row), c.metrics(),
                     c.metrics("prometheus"), c.controller(),
                     c.fleet_health(), c.fleet_metrics("prometheus"),
                     c.resolve_ensemble("orders")):
            await verb
        await c.close()
        await srv.stop()
    asyncio.run(session())
    assert len(frames) > 30
    mod = wire._native_codec()
    for b in frames:
        v = wire.decode_py(b)
        if b[:1] != b"B":
            assert enc(v) == wire.encode_py(v) == mod.encode(v) == b
            assert jwire.encode_py(jwire.decode_py(b)) == b
