"""Kernel F1 (``ops/cuda_engine.py``, ``csrc/engine_step.cu``) on the CPU.

F1 runs only on a CUDA card: ``chip_smoke.py`` phase 3b holds it against
``full_step_plain`` there, bit for bit; the ``cuda``-marked tests below
hold it against both ``full_step_plain`` and the JAX package's
``full_step``, and launch it on a second card.  Here, on the CPU:

- the module imports without nvcc and builds nothing;
- a CPU state takes the plain path of ``full_step`` / ``kv_step_scan`` /
  ``kv_step`` and launches nothing;
- the contract checks raise on bad dtypes, shapes and sizes;
- the kernel's hash arithmetic, transcribed lane for lane into numpy
  (the quad's 16-child fold with its stirs, the leaf hash),
  with the fold constants the wrapper hands the kernel, equals the JAX
  package's ``hash.fold`` / ``obj_leaf_hash``;
- ``kv_step`` is the K = 1 ``kv_step_scan``, in both packages (the
  identity the dispatch relies on);
- the library name moves with every shared header.

Tolerance: exact equality.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from riak_ensemble_tpu_torch import interop
from riak_ensemble_tpu_torch.ops import build, cuda_engine, cuda_quorum
from riak_ensemble_tpu_torch.ops import engine as teng


def _planes(rng, e, m, s, k):
    up = rng.random((e, m)) < 0.85
    elect = rng.random(e) < 0.5
    cand = rng.integers(-1, m + 1, e).astype(np.int32)
    kind = rng.integers(0, 5, (k, e)).astype(np.int32)
    slot = rng.integers(-1, s + 1, (k, e)).astype(np.int32)
    val = rng.integers(-5, 50, (k, e)).astype(np.int32)
    lease = rng.random((k, e)) < 0.3
    exp_e = np.where(kind == teng.OP_RMW, rng.integers(0, 9, (k, e)),
                     rng.integers(0, 3, (k, e))).astype(np.int32)
    exp_s = rng.integers(0, 3, (k, e)).astype(np.int32)
    return [torch.from_numpy(a) for a in
            (elect, cand, kind, slot, val, lease, up, exp_e, exp_s)]


def _equal_states(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _copy(st):
    return teng.EngineState(*(t.clone() for t in st))


def test_module_imports_and_builds_nothing():
    assert cuda_engine._fn is None
    assert not hasattr(build, "_libs") or "engine_step" not in build._libs
    assert os.path.exists(os.path.join(build.CSRC_DIR, "engine_step.cu"))
    assert "engine_step" in build.sources()


def test_cpu_state_takes_the_plain_path():
    rng = np.random.default_rng(0)
    e, m, s, k = 6, 5, 32, 4
    f1_before = cuda_engine.engine_step_launches
    k1_before = cuda_quorum.quorum_launches
    st = teng.init_state(e, m, s, device="cpu")
    ref = _copy(st)
    for _ in range(3):
        p = _planes(rng, e, m, s, k)
        st, won, res = teng.full_step(st, *p[:7], exp_epoch=p[7],
                                      exp_seq=p[8])
        ref, rwon, rres = teng.full_step_plain(ref, *p[:7], exp_epoch=p[7],
                                               exp_seq=p[8])
        assert torch.equal(won, rwon) and _equal_states(st, ref)
        assert all(torch.equal(a, b) for a, b in zip(res, rres))
        st, res = teng.kv_step_scan(st, *p[2:7], p[7], p[8])
        ref, rres = teng.kv_step_scan_plain(ref, *p[2:7], p[7], p[8])
        assert _equal_states(st, ref)
        assert all(torch.equal(a, b) for a, b in zip(res, rres))
    assert res.committed.any()
    assert cuda_engine.engine_step_launches == f1_before
    assert cuda_quorum.quorum_launches == k1_before


def _args(e=4, m=5, s=16, k=3, v=2):
    st = teng.init_state(e, m, s, n_views=v, device="cpu")
    p = _planes(np.random.default_rng(1), e, m, s, k)
    return st, p


@pytest.mark.parametrize("case", [
    "kind int64", "lease int32", "up shape", "slot shape", "elect alone",
    "cand int64", "exp_epoch shape", "tree_node rows", "leader shape",
    "too many peers", "too many views", "too many rounds",
    "too much shared memory", "not contiguous", "epoch 1-D",
])
def test_contract_checks_raise(case):
    st, (elect, cand, kind, slot, val, lease, up, exp_e, exp_s) = _args()
    kw = {}
    if case == "kind int64":
        kind = kind.long()
    elif case == "lease int32":
        lease = lease.int()
    elif case == "up shape":
        up = up[:, :3]
    elif case == "slot shape":
        slot = slot[:2]
    elif case == "elect alone":
        cand = None
    elif case == "cand int64":
        cand = cand.long()
    elif case == "exp_epoch shape":
        exp_e = exp_e[:, :2]
    elif case == "tree_node rows":
        st = st._replace(tree_node=st.tree_node[:, :, :0].contiguous())
    elif case == "leader shape":
        st = st._replace(leader=st.leader[:, None])
    elif case == "too many peers":
        st, (elect, cand, kind, slot, val, lease, up, exp_e, exp_s) = \
            _args(m=33)
    elif case == "too many views":
        st, (elect, cand, kind, slot, val, lease, up, exp_e, exp_s) = \
            _args(v=9)
    elif case == "too many rounds":
        k = cuda_engine.MAX_ROUNDS + 1
        kind = slot = val = exp_e = exp_s = torch.zeros((k, 4), dtype=torch.int32)
        lease = torch.zeros((k, 4), dtype=torch.bool)
    elif case == "too much shared memory":
        st, (elect, cand, kind, slot, val, lease, up, exp_e, exp_s) = \
            _args(e=1, m=8, s=1100)
    elif case == "not contiguous":
        val = torch.zeros((4, 3), dtype=torch.int32).t()
    elif case == "epoch 1-D":
        st = st._replace(epoch=st.epoch[:, 0])
    with pytest.raises((TypeError, ValueError)):
        cuda_engine.check_contract(st, elect, cand, kind, slot, val, lease,
                                   up, exp_e, exp_s, **kw)


def test_contract_admits_every_shape_the_port_runs():
    """The shapes of the tests, the service defaults and chip_smoke.py
    lie inside the contract."""
    for e, m, s, v, k in [(16, 5, 32, 2, 4), (10_001, 5, 128, 2, 64),
                          (4, 3, 8, 2, 8), (10, 7, 33, 2, 8),
                          (2, 32, 16, 2, 8), (3, 5, 1024, 2, 16),
                          (3, 5, 16, 2, 0), (3, 5, 1, 2, 1)]:
        st = teng.init_state(e, m, s, n_views=v, device="cpu")
        p = _planes(np.random.default_rng(2), e, m, s, k)
        cuda_engine.check_contract(st, *p)
        cuda_engine.check_contract(st, None, None, *p[2:])
    assert cuda_engine.shared_bytes(5, 128, 9) == 19_328


def test_engine_step_refuses_a_cpu_state():
    st, p = _args()
    with pytest.raises(ValueError, match="cuda"):
        cuda_engine.engine_step(st, *p)


@pytest.mark.parametrize("s", [1, 2, 15, 16, 17, 33, 128, 256, 1000, 4096,
                               65537])
def test_n_uppers_is_the_trie_size(s):
    assert cuda_engine.n_uppers(s) == sum(teng.tree_sizes(s))


def _fmix(h):
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _kernel_fold(children, consts):
    """engine_step.cu fold_quad, lane for lane: 32 lanes = 8 quads x
    hash lane li; lane li of quad q sums hash lane li of the 16 children
    in the order q, q + 1, ... (mod 16), then the two quad shuffles.
    Every quad folds the same children here, so all eight must agree."""
    salt, mul = consts[:16], consts[16:]
    lanes = np.arange(32)
    li, rot = lanes & 3, lanes >> 2
    liu = li.astype(np.uint32)
    acc = np.zeros(32, dtype=np.uint32)
    for i in range(16):
        c = (i + rot) & 15
        acc = acc + _fmix((children[c, li] ^ salt[c]) * mul[c] + liu)
    quad = lanes & ~3
    acc = _fmix(acc ^ acc[quad | ((li + 3) & 3)])
    acc = acc ^ acc[quad | ((li + 2) & 3)]
    out = _fmix(acc ^ np.uint32(16))
    for q in range(8):                  # every quad holds the parent
        assert np.array_equal(out[4 * q:4 * q + 4], out[:4])
    return out[:4]


def _kernel_leaf(e, s, v):
    """engine_step.cu leaf_lane for lanes 0..3."""
    e, s, v = (np.uint32(x & 0xFFFFFFFF) for x in (e, s, v))
    base = np.array([e ^ _rotl(v, 5), s ^ _rotl(v, 9), e ^ _rotl(s, 7),
                     s ^ _rotl(e, 11)], dtype=np.uint32)
    return _fmix(base * np.uint32(0xCC9E2D51)
                 + np.arange(4, dtype=np.uint32))


def test_kernel_hash_arithmetic_matches_jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from riak_ensemble_tpu.ops import hash as jhash
    consts = cuda_engine.fold_consts().numpy().view(np.uint32)
    # the reference's own trace-time constants (hash.py fold)
    pos = np.arange(16, dtype=np.uint32)
    want_salt = jhash._fmix(pos * jhash._C2 + np.uint32(0x9E3779B9))
    want_mul = jhash._fmix(pos * jhash._F1 + jhash._C1) | np.uint32(1)
    np.testing.assert_array_equal(consts, np.concatenate([want_salt,
                                                          want_mul]))
    rng = np.random.default_rng(3)
    kids = rng.integers(0, 2 ** 32, (40, 16, 4), dtype=np.uint32)
    kids[0] = 0
    kids[1, 9:] = 0                     # a zero-padded short block
    kids[2] = 0xFFFFFFFF
    want = np.asarray(jhash.fold(jnp.asarray(kids)))
    for i in range(len(kids)):
        np.testing.assert_array_equal(_kernel_fold(kids[i], consts),
                                      want[i])
    vals = rng.integers(-2 ** 31, 2 ** 31, (64, 3), dtype=np.int64)
    vals[:4] = [[0, 0, 0], [2 ** 31 - 1, -2 ** 31, -1], [1, 1, 1],
                [-2 ** 31, 0, 2 ** 31 - 1]]
    want = np.asarray(jhash.obj_leaf_hash(
        *(jnp.asarray(vals[:, i].astype(np.int32)) for i in range(3))))
    for i, (e, s, v) in enumerate(vals.tolist()):
        np.testing.assert_array_equal(_kernel_leaf(e, s, v), want[i])


def test_kv_step_is_the_one_round_scan_against_jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from riak_ensemble_tpu.ops import engine as jeng
    e, m, s = 7, 5, 16
    rng = np.random.default_rng(4)
    js = jeng.init_state(e, m, s)
    js, _ = jeng.elect_step(js, jnp.ones((e,), bool),
                            jnp.zeros((e,), jnp.int32), jnp.ones((e, m), bool))
    for step in range(5):
        p = [a.numpy() for a in _planes(rng, e, m, s, 1)]
        row = [p[i][0] for i in (2, 3, 4, 5)]
        js_a, jr_a = jeng.kv_step(js, *map(jnp.asarray, row),
                                  jnp.asarray(p[6]),
                                  exp_epoch=jnp.asarray(p[7][0]),
                                  exp_seq=jnp.asarray(p[8][0]))
        js_b, jr_b = jeng.kv_step_scan(js, *(jnp.asarray(p[i])
                                             for i in (2, 3, 4, 5)),
                                       jnp.asarray(p[6]),
                                       exp_epoch=jnp.asarray(p[7]),
                                       exp_seq=jnp.asarray(p[8]))
        ts = interop.state_from_numpy(
            {f: np.asarray(getattr(js, f)) for f in js._fields},
            device="cpu")
        ts_a, tr_a = teng.kv_step(_copy(ts), *map(torch.from_numpy, row),
                                  torch.from_numpy(p[6]),
                                  torch.from_numpy(p[7][0]),
                                  torch.from_numpy(p[8][0]))
        ts_b, tr_b = teng.kv_step_scan(
            _copy(ts), *(torch.from_numpy(p[i]) for i in (2, 3, 4, 5)),
            torch.from_numpy(p[6]), torch.from_numpy(p[7]),
            torch.from_numpy(p[8]))
        for f in js._fields:
            a = np.asarray(getattr(js_a, f))
            assert np.array_equal(a, np.asarray(getattr(js_b, f))), f
            for t in (ts_a, ts_b):
                assert np.array_equal(
                    a, getattr(interop.state_to_numpy(t), f)), (step, f)
        for f in jr_a._fields:
            a = np.asarray(getattr(jr_a, f))
            assert np.array_equal(a, np.asarray(getattr(jr_b, f))[0]), f
            assert np.array_equal(a, getattr(tr_a, f).numpy()), f
            assert np.array_equal(a, getattr(tr_b, f)[0].numpy()), f
        js = js_a


def test_library_name_moves_with_every_shared_header(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    before = {n: build._lib_path(n) for n in build.sources()}
    assert before == {n: build._lib_path(n) for n in build.sources()}
    with open(csrc / "quorum_common.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: build._lib_path(n) for n in build.sources()}
    assert all(after[n] != before[n] for n in before)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert all(build._lib_path(n) != after[n] for n in after)


@pytest.mark.cuda
def test_f1_matches_plain_on_card():
    """F1 on the card equals ``full_step_plain`` and the JAX package's
    ``full_step`` on the same inputs: every state plane, ``won`` and every
    result plane, exactly."""
    if not torch.cuda.is_available():
        pytest.skip("F1 is a CUDA kernel: no CUDA device is visible")
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from riak_ensemble_tpu.ops import engine as jeng
    rng = np.random.default_rng(5)
    e, m, s, k = 257, 5, 128, 8
    js = jeng.init_state(e, m, s)
    st = interop.state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in js._fields}, device="cuda")
    ref = _copy(st)
    for step in range(4):
        host = _planes(rng, e, m, s, k)
        p = [t.cuda() for t in host]
        before = cuda_engine.engine_step_launches
        st, won, res = teng.full_step(st, *p[:7], exp_epoch=p[7],
                                      exp_seq=p[8])
        ref, rwon, rres = teng.full_step_plain(ref, *p[:7], exp_epoch=p[7],
                                               exp_seq=p[8])
        js, jwon, jres = jeng.full_step(
            js, *(jnp.asarray(t.numpy()) for t in host[:7]),
            exp_epoch=jnp.asarray(host[7].numpy()),
            exp_seq=jnp.asarray(host[8].numpy()))
        torch.cuda.synchronize()
        assert cuda_engine.engine_step_launches == before + 1
        assert torch.equal(won, rwon) and _equal_states(st, ref)
        assert all(torch.equal(a, b) for a, b in zip(res, rres))
        assert np.array_equal(won.cpu().numpy(), np.asarray(jwon)), step
        got = interop.state_to_numpy(st)
        for f in js._fields:
            assert np.array_equal(getattr(got, f),
                                  np.asarray(getattr(js, f))), (step, f)
        for f in jres._fields:
            assert np.array_equal(getattr(res, f).cpu().numpy(),
                                  np.asarray(getattr(jres, f))), (step, f)
    assert int(res.committed.sum()) > 0


@pytest.mark.cuda
def test_f1_launches_on_a_second_card():
    """F1 on cuda:1 while cuda:0 is the current device, after a launch on
    cuda:0, at a shape whose shared memory (S = 1,024, M = 5: ~151 KB a
    block) needs the kernel's limit raised on each card: both launches
    equal ``full_step_plain`` (whose quorum runs through K1 on a card)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    rng = np.random.default_rng(6)
    e, m, s, k = 64, 5, 1024, 8
    assert cuda_engine.shared_bytes(m, s, cuda_engine.n_uppers(s)) > 48 << 10
    torch.cuda.set_device(0)
    for idx in (0, 1):
        dev = torch.device("cuda", idx)
        st = teng.init_state(e, m, s, device=dev)
        ref = _copy(st)
        for step in range(2):
            p = [t.to(dev) for t in _planes(rng, e, m, s, k)]
            before = cuda_engine.engine_step_launches
            st, won, res = teng.full_step(st, *p[:7], exp_epoch=p[7],
                                          exp_seq=p[8])
            ref, rwon, rres = teng.full_step_plain(
                ref, *p[:7], exp_epoch=p[7], exp_seq=p[8])
            torch.cuda.synchronize(dev)
            assert cuda_engine.engine_step_launches == before + 1
            assert torch.equal(won, rwon) and _equal_states(st, ref), \
                (idx, step)
            assert all(torch.equal(a, b) for a, b in zip(res, rres))
        assert int(res.committed.sum()) > 0
