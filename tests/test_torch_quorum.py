"""The port's quorum predicates against the JAX package's.

- torch ``quorum_met_batch`` == JAX ``quorum_met_batch`` in every
  required mode (per-ensemble and shared view masks, self votes);
- ``quorum_met_eplain`` (K1's plain version) == JAX
  ``quorum_met_epallas(..., interpret=True)`` == JAX
  ``quorum_met_batch(self_idx=-1)``, including E not a multiple of the
  Pallas block, inactive views, V = 8 and M = 128;
- the scalar copy == the original on random replies.

All comparisons are integer: the tolerance is exact equality.  Inputs
come from numpy seeds.  The CUDA test of K1 itself skips here.
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
    from riak_ensemble_tpu.ops.pallas_quorum import quorum_met_epallas

    return types.SimpleNamespace(jnp=jnp, jq=jq, epallas=quorum_met_epallas)


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
