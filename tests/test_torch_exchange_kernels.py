"""Kernels X1 (the exchange) and R1 (the reconfig step) on the card.

X1 (``csrc/exchange_step.cu``) against ``engine.exchange_step_plain`` and
R1 (``csrc/reconfig_step.cu``) against ``engine.reconfig_step_plain`` /
``reconfig_propose_plain`` / ``reconfig_transition_plain``, on seeded
states built with torch on the CPU and copied to the card: every state
plane, ``diverged`` / ``synced`` and ``installed`` / ``collapsed``
bit-equal; one launch per call, K1 none; rows whose replicas agree at
M = 33 to 128, where each replica's ``diverged`` bit counts.  And ``engine.keep_rows``: the
kept rows written back undo an in-place exchange.

Every test here is marked ``cuda`` and skips without a card; the file
imports no JAX, so it runs as is on the card's machine
(``python -m pytest --noconftest -q -m cuda
tests/test_torch_exchange_kernels.py``).  Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

from riak_ensemble_tpu_torch.ops import (
    cuda_exchange, cuda_quorum, cuda_reconfig)
from riak_ensemble_tpu_torch.ops import engine as teng
from riak_ensemble_tpu_torch.ops import hash as hashk


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("X1 and R1 are CUDA kernels: no CUDA device is visible")
    return torch.device("cuda")


def store(rng: np.random.Generator, e: int, m: int, s: int,
          v: int = 2) -> teng.EngineState:
    """A CPU state whose replicas mostly agree, some stale, with damaged
    objects, leaves and upper nodes, joint views on half the rows and
    holders at epochs below -1 on some slots; rows [E/4, E/2) agree on
    every object and leaf and have one damaged upper node."""
    clean = np.zeros((e, 1, 1), bool)
    clean[e // 4: e // 2] = True

    def agree(lo, hi):
        x = np.broadcast_to(rng.integers(lo, hi, (e, 1, s)), (e, m, s)).copy()
        stale = (rng.random((e, m, s)) < 0.2) & ~clean
        x[stale] = rng.integers(lo, hi, int(stale.sum()))
        return x.astype(np.int32)
    ep, sq, vl = agree(0, 4), agree(0, 4), agree(-3, 4)
    low = (rng.random((e, 1, s)) < 0.1) & (rng.random((e, m, s)) < 0.8)
    ep[low] = -3
    st = teng.init_state(e, m, s, n_views=v, device="cpu")
    oe, os_, ov = (torch.from_numpy(x) for x in (ep, sq, vl))
    leaf = hashk.obj_leaf_hash(oe, os_, ov)
    hit = (rng.random((e, m, s)) < 0.05) & ~clean
    leaf[torch.from_numpy(hit)] ^= 1 << 7
    node = teng.build_uppers(leaf)
    u = node.shape[2]
    n = max(1, e // 4)
    node[torch.from_numpy(rng.integers(0, e, n)),
         torch.from_numpy(rng.integers(0, m, n)),
         torch.from_numpy(rng.integers(0, u, n)), 1] ^= 3
    rows = np.arange(e // 4, e // 2)
    node[torch.from_numpy(rows),
         torch.from_numpy(rng.integers(0, m, rows.size)),
         torch.from_numpy(rng.integers(0, u, rows.size)), 2] ^= 1 << 20
    ov[torch.from_numpy((rng.random((e, m, s)) < 0.03) & ~clean)] ^= 1
    vm = rng.random((e, v, m)) < 0.7
    vm[:, 0, 0] = True
    vm[rng.random(e) < 0.5, 1:] = False
    return st._replace(obj_epoch=oe, obj_seq=os_, obj_val=ov,
                       tree_leaf=leaf.contiguous(),
                       tree_node=node.contiguous(),
                       view_mask=torch.from_numpy(vm))


def agreeing_store(rng: np.random.Generator, e: int, m: int, s: int,
                   v: int = 2) -> teng.EngineState:
    """A CPU state whose replicas agree on every object and leaf: a slot
    holds one object at an epoch >= 0 in every replica, or is empty (all
    zero); then on about 2 % of (row, replica) pairs one leaf, one object
    or one upper node is damaged.  Most heard replicas are not diverged,
    so a wrong ``diverged`` bit of any one replica shows."""
    seq = rng.integers(0, 4, (e, 1, s))
    ep = np.where(seq > 0, rng.integers(0, 4, (e, 1, s)), 0)
    vl = np.where(seq > 0, rng.integers(-3, 4, (e, 1, s)), 0)
    oe, os_, ov = (torch.from_numpy(np.broadcast_to(x, (e, m, s)).astype(
        np.int32)) for x in (ep, seq, vl))
    leaf = hashk.obj_leaf_hash(oe, os_, ov).contiguous()
    node = teng.build_uppers(leaf).contiguous()
    n = max(3, e * m // 50)
    row, rep, slot = (torch.from_numpy(rng.integers(0, hi, n))
                      for hi in (e, m, s))
    kind = rng.integers(0, 3, n)
    for k, plane in enumerate((leaf, ov, node)):
        at = torch.from_numpy(kind == k)
        if k == 0:
            plane[row[at], rep[at], slot[at], 0] ^= 1 << 7
        elif k == 1:
            plane[row[at], rep[at], slot[at]] ^= 1
        else:
            u = torch.from_numpy(rng.integers(0, node.shape[2],
                                              int(at.sum())))
            plane[row[at], rep[at], u, 1] ^= 3
    vm = np.ones((e, v, m), bool)
    vm[:, 1:] = rng.random((e, v - 1, m)) < 0.7
    vm[rng.random(e) < 0.5, 1:] = False
    st = teng.init_state(e, m, s, n_views=v, device="cpu")
    return st._replace(obj_epoch=oe, obj_seq=os_, obj_val=ov,
                       tree_leaf=leaf, tree_node=node,
                       view_mask=torch.from_numpy(vm))


def on(st, dev):
    return teng.EngineState(*(t.to(dev).contiguous() for t in st))


def assert_states(want, got, where):
    for f, a, b in zip(teng.EngineState._fields, want, got):
        assert torch.equal(a.cpu(), b.cpu()), (where, f)


@pytest.mark.cuda
def test_x1_matches_plain_on_card():
    """X1 equals ``exchange_step_plain`` on every plane, ``diverged`` and
    ``synced``: three flagged rows, every third row and every row, at
    M = 5 / 33 / 128 and S = 1 / 32 / 128 / 4,096, one launch a call
    and no K1 launch."""
    dev = _card()
    rng = np.random.default_rng(21)
    for e, m, s in [(1000, 5, 128), (300, 33, 32), (64, 128, 16),
                    (50, 3, 1), (20, 5, 4096)]:
        cpu = store(rng, e, m, s)
        up = rng.random((e, m)) < 0.85
        up[: e // 4] = True
        for name, run in (("3 rows", np.isin(np.arange(e), [0, e // 2,
                                                            e - 1])),
                          ("every third", np.arange(e) % 3 == 0),
                          ("every row", np.ones(e, bool))):
            want = teng.exchange_step_plain(cpu, torch.from_numpy(run),
                                            torch.from_numpy(up))
            st = on(cpu, dev)
            x1, k1 = cuda_exchange.exchange_launches, \
                cuda_quorum.quorum_launches
            got = teng.exchange_step(st, torch.from_numpy(run).to(dev),
                                     torch.from_numpy(up).to(dev))
            torch.cuda.synchronize()
            assert got[0] is st
            assert cuda_exchange.exchange_launches == x1 + 1
            assert cuda_quorum.quorum_launches == k1
            where = (e, m, s, name)
            assert_states(want[0], st, where)
            assert torch.equal(want[1], got[1].cpu()), where
            assert torch.equal(want[2], got[2].cpu()), where


@pytest.mark.cuda
def test_x1_agreeing_rows_on_card():
    """X1 equals ``exchange_step_plain`` on rows whose replicas agree
    except for a few damaged ones, at M = 33 / 40 / 66 / 128 (four-word
    peer masks; replicas on both sides of every mask word, and S = 200
    re-walks a thread's second slot): the plain version finds most heard
    replicas not diverged, so each replica's ``diverged`` bit is held
    against it."""
    dev = _card()
    rng = np.random.default_rng(24)
    for e, m, s in [(200, 33, 32), (200, 40, 128), (100, 66, 200),
                    (64, 128, 16)]:
        cpu = agreeing_store(rng, e, m, s)
        up = rng.random((e, m)) < 0.9
        up[: e // 4] = True
        for name, run in (("every third", np.arange(e) % 3 == 0),
                          ("every row", np.ones(e, bool))):
            want = teng.exchange_step_plain(cpu, torch.from_numpy(run),
                                            torch.from_numpy(up))
            synced = want[2].numpy()
            wide = want[1].numpy()[synced][:, 32:]
            assert synced.any() and wide.mean() < 0.25, (e, m, s, name)
            st = on(cpu, dev)
            got = teng.exchange_step(st, torch.from_numpy(run).to(dev),
                                     torch.from_numpy(up).to(dev))
            torch.cuda.synchronize()
            where = (e, m, s, name)
            assert_states(want[0], st, where)
            assert torch.equal(want[1], got[1].cpu()), where
            assert torch.equal(want[2], got[2].cpu()), where


@pytest.mark.cuda
def test_r1_matches_plain_on_card():
    """R1 equals the plain twins: ``reconfig_step`` (propose and
    transition in one pass), ``reconfig_propose`` (given versions) and
    ``reconfig_transition``, on seeded proposals and up masks with
    leaderless rows and versions at the int32 maximum, at M = 5 and 33;
    one launch a call and no K1 launch."""
    dev = _card()
    rng = np.random.default_rng(22)
    for e, m in [(4096, 5), (777, 33)]:
        st = teng.init_state(e, m, 4, device=dev)
        st, _ = teng.elect_step(st, torch.ones(e, dtype=torch.bool,
                                               device=dev),
                                torch.zeros(e, dtype=torch.int32,
                                            device=dev),
                                torch.ones((e, m), dtype=torch.bool,
                                           device=dev))
        st.leader[: e // 10] = -1
        st.pend_vsn[torch.from_numpy(rng.random(e) < 0.1).to(dev)] = \
            2 ** 31 - 1
        st.view_vsn[1] = 2 ** 31 - 1
        for rnd in range(6):
            prop, nv, up, run = (torch.from_numpy(x).to(dev) for x in (
                rng.random(e) < 0.5, rng.random((e, m)) < 0.7,
                rng.random((e, m)) < 0.85, rng.random(e) < 0.7))
            vsn = torch.from_numpy(rng.integers(-2, 12, e).astype(
                np.int32)).to(dev)
            calls = [
                (teng.reconfig_step, teng.reconfig_step_plain,
                 (prop, nv, up)),
                (teng.reconfig_propose, teng.reconfig_propose_plain,
                 (prop, nv, vsn, up)),
                (teng.reconfig_transition, teng.reconfig_transition_plain,
                 (run, up)),
            ]
            fn, plain, args = calls[rnd % 3]
            want = plain(teng.EngineState(*(t.clone() for t in st)), *args)
            r1, k1 = cuda_reconfig.reconfig_launches, \
                cuda_quorum.quorum_launches
            got = fn(st, *args)
            torch.cuda.synchronize()
            assert cuda_reconfig.reconfig_launches == r1 + 1
            assert cuda_quorum.quorum_launches == k1
            assert got[0] is st
            assert_states(want[0], st, (e, m, rnd))
            for a, b in zip(want[1:], got[1:]):
                assert torch.equal(a, b), (e, m, rnd)


@pytest.mark.cuda
def test_keep_rows_undoes_an_in_place_exchange_on_card():
    """``engine.keep_rows`` before X1, then its function: every plane is
    back as it was, the kept rows' and the others'."""
    dev = _card()
    rng = np.random.default_rng(23)
    e, m, s = 500, 5, 128
    st = on(store(rng, e, m, s), dev)
    before = teng.EngineState(*(t.clone() for t in st))
    run = rng.random(e) < 0.3
    restore = teng.keep_rows(st, np.flatnonzero(run))
    teng.exchange_step(st, torch.from_numpy(run).to(dev),
                       torch.ones((e, m), dtype=torch.bool, device=dev))
    assert any(not torch.equal(a, b) for a, b in zip(before, st))
    restore()
    torch.cuda.synchronize()
    assert_states(before, st, "restored")
