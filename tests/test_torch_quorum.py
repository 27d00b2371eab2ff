"""The port's quorum predicates against the JAX package's.

- torch ``quorum_met_batch`` == JAX ``quorum_met_batch`` in every
  required mode (per-ensemble and shared view masks, self votes);
- ``quorum_met_eplain`` (K1's plain version) == JAX
  ``quorum_met_epallas(..., interpret=True)`` == JAX
  ``quorum_met_batch(self_idx=-1)``, including E not a multiple of the
  Pallas block, inactive views, V = 8 and M = 128;
- ``quorum_met_splain`` (K2's plain version) == JAX
  ``quorum_met_pallas(..., interpret=True)`` == JAX ``quorum_met_batch``
  on one shared mask, on the cases of ``tests/test_pallas_quorum.py``
  (every mode x 2 seeds, a singleton view, E not a multiple of the
  block) plus self indices outside ``[0, M)`` and inactive trailing
  views;
- the scalar copy == the original on random replies.

All comparisons are integer: the tolerance is exact equality.  Inputs
come from numpy seeds.  The CUDA tests of K1 and K2 themselves skip
here.
"""

import random
import types

import numpy as np
import pytest
import torch

from riak_ensemble_tpu_torch.ops import cuda_quorum
from riak_ensemble_tpu_torch.ops import quorum as tq


@pytest.fixture
def ref():
    """The JAX package's predicates (JAX on the CPU, Pallas in
    interpret mode, as its own tests run them)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from riak_ensemble_tpu.ops import quorum as jq
    from riak_ensemble_tpu.ops.pallas_quorum import (
        quorum_met_epallas, quorum_met_pallas)

    return types.SimpleNamespace(jnp=jnp, jq=jq, epallas=quorum_met_epallas,
                                 pallas=quorum_met_pallas)


def _votes(rng, shape, m):
    valid = rng.random(shape + (m,)) < 0.45
    nack = (rng.random(shape + (m,)) < 0.35) & ~valid
    return valid, nack


def _masks(rng, e, v, m, inactive=0.3):
    mask = rng.random((e, v, m)) < 0.6
    mask[:, 0, rng.integers(0, m)] = True
    mask[rng.random(e) < inactive, 1:] = False
    return mask


@pytest.mark.parametrize("required", tq.REQUIRED_MODES)
@pytest.mark.parametrize("shared", [False, True])
def test_quorum_met_batch_matches_jax(ref, required, shared):
    jnp, jq = ref.jnp, ref.jq
    rng = np.random.default_rng(3 + shared)
    e, v, m = 300, 3, 7
    valid, nack = _votes(rng, (e,), m)
    mask = _masks(rng, 1 if shared else e, v, m)
    if shared:
        mask = mask[0]
    self_idx = rng.integers(-1, m, (e,)).astype(np.int32)
    want = np.asarray(jq.quorum_met_batch(
        jnp.asarray(valid), jnp.asarray(nack), jnp.asarray(mask),
        jnp.asarray(self_idx), required=required))
    got = tq.quorum_met_batch(
        torch.from_numpy(valid), torch.from_numpy(nack),
        torch.from_numpy(mask), torch.from_numpy(self_idx),
        required=required)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("e,v,m,inactive", [
    (700, 2, 5, 0.3),      # E not a multiple of the 512-row Pallas block
    (512, 3, 5, 1.0),      # only view 0 active: inactive padding views
    (129, 8, 128, 0.5),    # V = 8 and M = 128, the kernel's limits
    (64, 4, 3, 0.0),       # every view active
])
def test_eplain_matches_epallas_and_batch(ref, e, v, m, inactive):
    jnp, jq = ref.jnp, ref.jq
    rng = np.random.default_rng(e + v + m)
    valid, nack = _votes(rng, (e,), m)
    mask = _masks(rng, e, v, m, inactive)
    pallas = np.asarray(ref.epallas(
        jnp.asarray(valid), jnp.asarray(nack), jnp.asarray(mask),
        interpret=True))
    batch = np.asarray(jq.quorum_met_batch(
        jnp.asarray(valid), jnp.asarray(nack), jnp.asarray(mask),
        jnp.full((e,), -1, jnp.int32)))
    got = cuda_quorum.quorum_met_eplain(
        torch.from_numpy(valid), torch.from_numpy(nack),
        torch.from_numpy(mask))
    np.testing.assert_array_equal(pallas, batch)
    np.testing.assert_array_equal(got.numpy(), pallas)
    # the CPU wrapper is the plain version, with no kernel launch
    before = cuda_quorum.quorum_launches
    via = cuda_quorum.quorum_met_e(torch.from_numpy(valid),
                                   torch.from_numpy(nack),
                                   torch.from_numpy(mask))
    assert torch.equal(via, got)
    assert cuda_quorum.quorum_launches == before


@pytest.mark.parametrize("w", [1, 3])
def test_eplain_shared_mask_rows(ref, w):
    """Rows r of a [E*W, M] call read mask r // W — the engine's
    round call — equal to the JAX predicate on the widened mask."""
    jnp, jq = ref.jnp, ref.jq
    rng = np.random.default_rng(40 + w)
    e, v, m = 50, 2, 5
    valid, nack = _votes(rng, (e, w), m)
    mask = _masks(rng, e, v, m)
    wide = np.broadcast_to(mask[:, None], (e, w, v, m))
    want = np.asarray(jq.quorum_met_batch(
        jnp.asarray(valid), jnp.asarray(nack), jnp.asarray(wide),
        jnp.full((e, w), -1, jnp.int32)))
    got = cuda_quorum.quorum_met_eplain(
        torch.from_numpy(valid.reshape(e * w, m)),
        torch.from_numpy(nack.reshape(e * w, m)),
        torch.from_numpy(mask), w)
    np.testing.assert_array_equal(got.numpy().reshape(e, w), want)


def test_all_unmet_rows_report_first_view(ref):
    """Every view active and unmet: the first-unmet choice is view 0
    (argmin's first minimum), so its nack decides."""
    jnp = ref.jnp
    e, v, m = 8, 3, 5
    valid = np.zeros((e, m), bool)
    nack = np.zeros((e, m), bool)
    nack[:4, :3] = True                 # view 0 nacked in rows 0-3
    mask = np.zeros((e, v, m), bool)
    mask[:, 0] = True
    mask[:, 1:, :2] = True
    want = np.asarray(ref.epallas(
        jnp.asarray(valid), jnp.asarray(nack), jnp.asarray(mask),
        interpret=True))
    got = cuda_quorum.quorum_met_eplain(torch.from_numpy(valid),
                                        torch.from_numpy(nack),
                                        torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:4] == tq.NACK).all() and (want[4:] == tq.UNDECIDED).all()


def test_wrapper_rejects_bad_inputs():
    v = torch.zeros((4, 5), dtype=torch.bool)
    mask = torch.ones((4, 2, 5), dtype=torch.bool)
    with pytest.raises(TypeError):
        cuda_quorum.quorum_met_e(v.to(torch.int32), v, mask)
    with pytest.raises(ValueError):
        cuda_quorum.quorum_met_e(v, v, mask[:3])
    with pytest.raises(ValueError):
        cuda_quorum.quorum_met_e(v, v[:3], mask)


def _k2_check(ref, valid, nack, mask, self_idx, required="quorum",
              block_e=256):
    """K2's plain version (and the CPU wrapper) against the Pallas
    kernel in interpret mode and the JAX batched predicate."""
    jnp, jq = ref.jnp, ref.jq
    args = [jnp.asarray(a) for a in (valid, nack, mask, self_idx)]
    pallas = np.asarray(ref.pallas(*args, required=required,
                                   block_e=block_e, interpret=True))
    batch = np.asarray(jq.quorum_met_batch(*args, required=required))
    targs = [torch.from_numpy(np.ascontiguousarray(a))
             for a in (valid, nack, mask, self_idx)]
    got = cuda_quorum.quorum_met_splain(*targs, required)
    before = cuda_quorum.quorum_s_launches
    via = cuda_quorum.quorum_met_s(*targs, required)
    assert cuda_quorum.quorum_s_launches == before
    np.testing.assert_array_equal(pallas, batch)
    assert got.dtype == torch.int8 and torch.equal(via, got)
    np.testing.assert_array_equal(got.numpy(), pallas)
    return pallas


def _shared_views(rng, v, m):
    """The JAX test's views: view 0 full, later ones random or empty."""
    views = [list(range(m))]
    for _ in range(v - 1):
        if rng.random() < 0.5:
            views.append(sorted(rng.choice(m, size=rng.integers(1, m + 1),
                                           replace=False).tolist()))
    return tq.views_to_mask(views, v, m)


@pytest.mark.parametrize("required", tq.REQUIRED_MODES)
@pytest.mark.parametrize("seed", [0, 1])
def test_splain_matches_pallas(ref, required, seed):
    rng = np.random.default_rng(seed)
    e, m, v = 100, 7, 3
    mask = _shared_views(rng, v, m)
    valid = rng.random((e, m)) < 0.45
    nack = (rng.random((e, m)) < 0.3) & ~valid
    self_idx = rng.integers(-1, m, (e,)).astype(np.int32)
    _k2_check(ref, valid, nack, mask, self_idx, required)


@pytest.mark.parametrize("case", ["singleton", "block_padding",
                                  "self_outside", "inactive_trailing"])
def test_splain_edge_cases(ref, case):
    rng = np.random.default_rng(21)
    if case == "singleton":
        # the self vote alone meets quorum in a one-peer view
        mask = tq.views_to_mask([[0]], 1, 1)
        valid = np.zeros((4, 1), bool)
        self_idx = np.asarray([0, 0, -1, -1], np.int32)
        got = _k2_check(ref, valid, valid, mask, self_idx)
        assert got.tolist() == [tq.MET, tq.MET, tq.UNDECIDED, tq.UNDECIDED]
        return
    if case == "block_padding":
        e, m = 300, 5
        mask = tq.views_to_mask([list(range(m))], 1, m)
        valid = rng.random((e, m)) < 0.5
        nack = (rng.random((e, m)) < 0.2) & ~valid
        _k2_check(ref, valid, nack, mask, np.zeros((e,), np.int32))
        return
    e, m = 200, 6
    if case == "self_outside":
        mask = _shared_views(rng, 3, m)
        self_idx = rng.choice([-1, -5, m, m + 3, 0, m - 1],
                              e).astype(np.int32)
    else:   # views 2 and 3 have no members: padding, always met
        mask = np.zeros((4, m), bool)
        mask[0] = True
        mask[1, :3] = True
        self_idx = rng.integers(-1, m, (e,)).astype(np.int32)
    valid = rng.random((e, m)) < 0.45
    nack = (rng.random((e, m)) < 0.3) & ~valid
    for required in tq.REQUIRED_MODES:
        _k2_check(ref, valid, nack, mask, self_idx, required)


def test_s_wrapper_rejects_bad_inputs():
    v = torch.zeros((4, 5), dtype=torch.bool)
    mask = torch.ones((2, 5), dtype=torch.bool)
    si = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_quorum.quorum_met_s(v, v, mask, si, required="most")
    with pytest.raises(ValueError):
        cuda_quorum.quorum_met_s(v, v, mask[None].expand(4, 2, 5), si)
    with pytest.raises(ValueError):
        cuda_quorum.quorum_met_s(v, v, mask[:, :4], si)
    with pytest.raises(ValueError):
        cuda_quorum.quorum_met_s(v, v, mask, si.long())
    with pytest.raises(TypeError):
        cuda_quorum.quorum_met_s(v.to(torch.int32), v, mask, si)


def test_scalar_copy_matches_original(ref):
    jq = ref.jq
    rnd = random.Random(5)
    peers = [f"p{i}" for i in range(6)]
    for _ in range(600):
        views = [rnd.sample(peers, rnd.randint(1, 6))
                 for _ in range(rnd.randint(0, 3))]
        replies = [(p, rnd.choice(["ok", "nack", "x"]))
                   for p in rnd.sample(peers, rnd.randint(0, 6))]
        self_id = rnd.choice(peers + ["other"])
        required = rnd.choice(tq.REQUIRED_MODES)
        extra = rnd.choice([None, lambda r: len(r) % 2 == 0])
        assert tq.quorum_met(replies, self_id, views, required, extra) == \
            jq.quorum_met(replies, self_id, views, required, extra)
    assert (tq.views_to_mask([[0, 2], [1]], 3, 4)
            == jq.views_to_mask([[0, 2], [1]], 3, 4)).all()


@pytest.mark.cuda
def test_k1_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 is a CUDA kernel")
    rng = np.random.default_rng(9)
    for e, w, v, m in [(10_000, 1, 2, 5), (1001, 4, 2, 5), (77, 1, 8, 128)]:
        valid, nack = _votes(rng, (e * w,), m)
        mask = _masks(rng, e, v, m)
        args = [torch.from_numpy(a).cuda() for a in (valid, nack, mask)]
        before = cuda_quorum.quorum_launches
        got = cuda_quorum.quorum_met_e(*args, w)
        plain = cuda_quorum.quorum_met_eplain(*args, w)
        torch.cuda.synchronize()
        assert cuda_quorum.quorum_launches == before + 1
        assert torch.equal(got.cpu(), plain.cpu())


@pytest.mark.cuda
def test_k2_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K2 is a CUDA kernel")
    rng = np.random.default_rng(10)
    for e, v, m in [(10_000, 2, 5), (10_001, 3, 7), (77, 128, 128),
                    (300, 1, 1)]:
        valid, nack = _votes(rng, (e,), m)
        mask = _masks(rng, 1, v, m)[0]
        self_idx = rng.integers(-2, m + 2, (e,)).astype(np.int32)
        args = [torch.from_numpy(a).cuda()
                for a in (valid, nack, mask, self_idx)]
        for required in tq.REQUIRED_MODES:
            before = cuda_quorum.quorum_s_launches
            got = cuda_quorum.quorum_met_s(*args, required)
            plain = cuda_quorum.quorum_met_splain(*args, required)
            torch.cuda.synchronize()
            assert cuda_quorum.quorum_s_launches == before + 1
            assert torch.equal(got.cpu(), plain.cpu()), (e, v, m, required)


@pytest.mark.cuda
def test_k1_k2_launch_on_a_second_card():
    """K1 and K2 on cuda:1 while cuda:0 is the current device equal their
    plain versions there (each wrapper launches on its tensors' card)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    rng = np.random.default_rng(11)
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 1)
    e, w, v, m = 1001, 2, 2, 5
    valid, nack = _votes(rng, (e * w,), m)
    args = [torch.from_numpy(a).to(dev)
            for a in (valid, nack, _masks(rng, e, v, m))]
    got = cuda_quorum.quorum_met_e(*args, w)
    plain = cuda_quorum.quorum_met_eplain(*args, w)
    assert torch.equal(got.cpu(), plain.cpu())
    valid, nack = _votes(rng, (e,), m)
    self_idx = rng.integers(-2, m + 2, (e,)).astype(np.int32)
    args = [torch.from_numpy(a).to(dev)
            for a in (valid, nack, _masks(rng, 1, v, m)[0], self_idx)]
    for required in tq.REQUIRED_MODES:
        got = cuda_quorum.quorum_met_s(*args, required)
        plain = cuda_quorum.quorum_met_splain(*args, required)
        assert torch.equal(got.cpu(), plain.cpu()), required
