"""The exchange and reconfig kernels' designs (X1, R1) on the CPU.

X1 (``csrc/exchange_step.cu``) and R1 (``csrc/reconfig_step.cu``) run only
on a CUDA card.  This file holds what their designs rest on, against the
JAX package's ``exchange_step`` / ``reconfig_*`` on seeded numpy inputs
(E = 24, S = 32, V = 2, M = 5 and M = 33, damaged stores, random ``run``
and ``up`` masks):

- (a) ``exchange_step_plain`` (X1's oracle, and the CPU path) equals the
  JAX ``exchange_step`` on every plane, ``diverged`` and ``synced``;
- (b) rows outside ``run`` keep every plane bit for bit and report False
  (X1 reads only their ``run`` byte and writes only their results);
- (c) the exchange of the gathered run rows, scattered back, equals the
  whole-store exchange (the work is per row), and ``engine.keep_rows`` /
  ``MeshState.keep_rows`` write a stepped row back (the scrub's rollback);
- (d) a numpy transcription of X1, one row (one thread block) at a time —
  the gate, the node verdicts from the stored children, the slot pass's
  two walks and the level-by-level rebuild from the new leaves of only the
  replicas with a written leaf or a failed verdict — equals the JAX
  exchange, holders with epochs below -1 included;
- (e) a numpy transcription of R1, one row a thread, equals the JAX
  ``reconfig_step``, ``reconfig_propose`` and ``reconfig_transition``,
  with leaderless rows and ``pend_vsn`` at the int32 maximum;
- (f) the X1 and R1 wrappers raise on a wrong dtype, shape or device, on
  a non-contiguous plane, and on M > 128 or V > 8.

Tolerance: exact equality everywhere.  The kernels themselves are held
against their plain versions on the card in
``tests/test_torch_exchange_kernels.py`` and by ``chip_smoke.py``.
"""

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from riak_ensemble_tpu_torch.ops import cuda_exchange, cuda_reconfig  # noqa: E402
from riak_ensemble_tpu_torch.ops import engine as teng  # noqa: E402
from riak_ensemble_tpu_torch.parallel import batched_host as tb  # noqa: E402
from riak_ensemble_tpu_torch.parallel.mesh import mesh_engine  # noqa: E402
from test_torch_f1_design import (  # noqa: E402
    STATE, U32, Tree, bits, fold, leaf_hash, quorum_met_bits, to_numpy,
    to_torch)

E, S, V = 24, 32, 2
I32_MAX, I32_MIN = 2 ** 31 - 1, -2 ** 31


@pytest.fixture(scope="module")
def je():
    from riak_ensemble_tpu.ops import engine as je
    return je


def exchange_state(rng, m, e=E, s=S, v=V):
    """A numpy state (trees uint32) with replicas that mostly agree, some
    stale, some damaged objects, leaves and upper nodes, joint views on
    some rows and holders at epochs below -1 on others; a quarter of the
    rows agree on every object and leaf and have one damaged node."""
    ep = np.broadcast_to(rng.integers(0, 4, (e, 1, s)), (e, m, s)).copy()
    sq = np.broadcast_to(rng.integers(0, 4, (e, 1, s)), (e, m, s)).copy()
    vl = np.broadcast_to(rng.integers(-3, 4, (e, 1, s)), (e, m, s)).copy()
    clean = np.zeros(e, bool)                    # rows damaged in
    clean[e // 4: e // 2] = True                 # their nodes only
    stale = (rng.random((e, m, s)) < 0.2) & ~clean[:, None, None]
    ep[stale] = rng.integers(0, 4, stale.sum())
    sq[stale] = rng.integers(0, 4, stale.sum())
    vl[stale] = rng.choice([I32_MIN, -1, 0, 5, I32_MAX], stale.sum())
    low = rng.random((e, 1, s)) < 0.1            # holders below -1
    ep = np.where(low & (rng.random((e, m, s)) < 0.8), -3, ep)
    st = {f: np.zeros(sh, np.int32) for f, sh in (
        ("epoch", (e, m)), ("fact_seq", (e, m)), ("view_vsn", (e,)),
        ("pend_vsn", (e,)), ("commit_vsn", (e,)), ("obj_seq_ctr", (e,)))}
    st["leader"] = np.full(e, -1, np.int32)
    st["obj_epoch"], st["obj_seq"], st["obj_val"] = (
        x.astype(np.int32) for x in (ep, sq, vl))
    leaves = leaf_hash(ep.ravel(), sq.ravel(), vl.ravel()).reshape(e, m, s, 4)
    hit = (rng.random((e, m, s)) < 0.05) & ~clean[:, None, None]
    leaves[hit, rng.integers(0, 4)] ^= U32(1 << 7)
    st["tree_leaf"] = leaves
    uppers = teng.build_uppers(torch.from_numpy(leaves.view(np.int32)))
    nodes = uppers.numpy().view(U32).copy()
    u = nodes.shape[2]
    picks = (rng.integers(0, e, 6), rng.integers(0, m, 6),
             rng.integers(0, u, 6), rng.integers(0, 4, 6))
    nodes[picks] ^= U32(3)
    rows = np.flatnonzero(clean)
    nodes[rows, rng.integers(0, m, rows.size), rng.integers(0, u, rows.size),
          rng.integers(0, 4, rows.size)] ^= U32(1 << 20)
    st["tree_node"] = nodes
    vm = rng.random((e, v, m)) < 0.7
    vm[:, 0, 0] = True
    vm[rng.random(e) < 0.5, 1:] = False
    st["view_mask"] = vm
    # damaged objects whose leaves stay as they were
    obj = (rng.random((e, m, s)) < 0.03) & ~clean[:, None, None]
    st["obj_val"][obj] ^= 1
    return st


def run_up(rng, m, e=E):
    run = rng.random(e) < 0.6
    up = rng.random((e, m)) < 0.85
    up[: e // 4] = True                          # rows where all are heard
    return run, up


def jax_state(je, st):
    import jax.numpy as jnp
    return je.EngineState(**{f: jnp.asarray(st[f]) for f in STATE})


def jax_exchange(je, st, run, up):
    import jax.numpy as jnp
    js, div, syn = je.exchange_step(jax_state(je, st), jnp.asarray(run),
                                    jnp.asarray(up))
    return ({f: np.asarray(getattr(js, f)) for f in STATE},
            np.asarray(div), np.asarray(syn))


def assert_planes(want, got, where):
    for f in STATE:
        assert np.array_equal(np.asarray(want[f]), np.asarray(got[f])), \
            (where, f)


# ---------------------------------------------------------------------------
# X1's design, one row (one block) at a time


def x1_model(st, run, up):
    """Kernel X1 on a numpy state ``st`` (trees uint32), in place, a row
    at a time as one block steps it (the kernel's blocks take the run
    rows in any order; a row reads and writes only its own planes).
    Returns ``(diverged [E, M], synced [E])``."""
    e, m, s = st["obj_epoch"].shape
    v = st["view_mask"].shape[1]
    tree = Tree(s)
    diverged = np.zeros((e, m), bool)
    synced = np.zeros(e, bool)
    for row in range(e):
        if not run[row]:
            continue                 # only its `run` byte is read
        views = [bits(st["view_mask"][row, j]) for j in range(v)]
        member = 0
        for vb in views:
            member |= vb
        heard = bits(up[row]) & member
        if quorum_met_bits(heard, 0, views) != 1:
            continue
        rs = [r for r in range(m) if (heard >> r) & 1]
        leaf, node = st["tree_leaf"][row], st["tree_node"][row]
        oe, os_, ov = (st[f][row] for f in ("obj_epoch", "obj_seq",
                                             "obj_val"))
        div = 0
        # replica pass, first half: every stored node against the fold
        # of its stored children (the old leaves)
        for r in rs:
            for n in range(tree.u):
                lvl, pidx = tree.level_of(n)
                kids = tree.children(leaf[r], node[r], lvl, pidx)
                if (fold(kids) != node[r, n]).any():
                    div |= 1 << r
        rebuild = div                # a failed verdict: rebuild its levels
        # slot pass: a thread a slot, two walks over the heard replicas
        for sl in range(s):
            ok, n_hold, best = 0, 0, None
            for r in rs:
                lok = bool((leaf_hash(oe[r, sl], os_[r, sl], ov[r, sl])
                            == leaf[r, sl]).all())
                if not lok:
                    continue
                ok |= 1 << r
                if os_[r, sl] <= 0:
                    continue
                n_hold += 1
                cand = (int(oe[r, sl]), int(os_[r, sl]), int(ov[r, sl]))
                best = cand if best is None else max(best, cand)
            found = best is not None and (n_hold == m or best[0] >= -1)
            w = best if found else (0, 0, 0)
            nl = leaf_hash(*w) if found else None
            for r in rs:
                mismatch = (int(oe[r, sl]), int(os_[r, sl]),
                            int(ov[r, sl])) != w
                lok = bool((ok >> r) & 1)
                if mismatch or not lok:
                    div |= 1 << r
                if not found:
                    continue
                if mismatch:
                    oe[r, sl], os_[r, sl], ov[r, sl] = w
                if mismatch or not lok:
                    leaf[r, sl] = nl
                    rebuild |= 1 << r
        # replica pass, second half: the levels rebuilt from the new
        # leaves, leafward -> root, of the replicas with a written leaf or
        # a failed verdict only: any other heard replica's rebuild equals
        # its stored levels
        for lvl, (off, size) in enumerate(zip(tree.offs, tree.sizes)):
            for r in rs:
                if not (rebuild >> r) & 1:
                    continue
                for pidx in range(size):
                    kids = tree.children(leaf[r], node[r], lvl, pidx)
                    node[r, off + pidx] = fold(kids)
        diverged[row] = [(heard >> r) & 1 and (div >> r) & 1
                         for r in range(m)]
        synced[row] = True
    return diverged, synced


# ---------------------------------------------------------------------------
# R1's design, one row a thread


def _wrap(x):
    return (int(x) + 2 ** 31) % 2 ** 32 - 2 ** 31


def r1_model(st, propose, new_view, vsn, run, up):
    """Kernel R1 on a numpy state, in place: ``propose`` None proposes
    nothing, ``vsn`` None is ``pend_vsn + 1``, ``run`` None is
    ``~propose``.  Returns ``(installed [E], collapsed [E])``."""
    e, m = st["epoch"].shape
    v = st["view_mask"].shape[1]
    installed = np.zeros(e, bool)
    collapsed = np.zeros(e, bool)
    for row in range(e):
        views = [bits(st["view_mask"][row, j]) for j in range(v)]
        up_b = bits(up[row])
        leader = int(st["leader"][row])
        le = int(st["epoch"][row, leader]) if 0 <= leader < m else 0
        at_lead = bits(st["epoch"][row] == le)

        def gate():
            member = 0
            for vb in views:
                member |= vb
            heard = up_b & member
            ack = heard & at_lead
            ok = quorum_met_bits(ack, heard & ~ack, views) == 1
            return heard, ok and leader >= 0

        def bump(heard):
            for r in range(m):
                if (heard >> r) & 1:
                    st["fact_seq"][row, r] = _wrap(st["fact_seq"][row, r]
                                                   + 1)
        prop = propose is not None and bool(propose[row])
        rn = bool(run[row]) if run is not None else not prop
        if prop or rn:
            heard, commit_ok = gate()
        pend = int(st["pend_vsn"][row])
        if prop:
            vs = int(vsn[row]) if vsn is not None else _wrap(pend + 1)
            nv = bits(new_view[row])
            installed[row] = (commit_ok and nv != 0 and views[-1] == 0
                              and vs > pend)
            if installed[row]:
                views = [nv] + views[:-1]
                st["view_vsn"][row] = _wrap(st["view_vsn"][row] + 1)
                st["pend_vsn"][row] = pend = vs
                bump(heard)
                if rn:
                    heard, commit_ok = gate()
        if rn:
            collapsed[row] = any(views[1:]) and commit_ok
            if collapsed[row]:
                views = views[:1] + [0] * (v - 1)
                st["view_vsn"][row] = _wrap(st["view_vsn"][row] + 1)
                st["commit_vsn"][row] = pend
                bump(heard)
        for j in range(v):
            st["view_mask"][row, j] = [(views[j] >> r) & 1
                                       for r in range(m)]
    return installed, collapsed


def reconfig_state(rng, m, e=E, v=V):
    st = exchange_state(rng, m, e, 4, v)
    st["epoch"] = rng.integers(0, 3, (e, m)).astype(np.int32)
    st["fact_seq"] = rng.integers(0, 5, (e, m)).astype(np.int32)
    st["fact_seq"][0, 0] = I32_MAX
    st["leader"] = rng.integers(-1, m, e).astype(np.int32)
    st["leader"][:3] = -1
    st["view_vsn"] = rng.integers(0, 9, e).astype(np.int32)
    st["view_vsn"][1] = I32_MAX
    st["pend_vsn"] = rng.integers(0, 9, e).astype(np.int32)
    st["pend_vsn"][rng.random(e) < 0.2] = I32_MAX
    st["commit_vsn"] = rng.integers(0, 9, e).astype(np.int32)
    return st


# ---------------------------------------------------------------------------
# (a)-(c): the plain exchange


@pytest.mark.parametrize("m", [5, 33])
def test_exchange_plain_equals_jax(je, m):
    """(a) ``exchange_step_plain`` and the CPU dispatch equal the JAX
    ``exchange_step`` on every plane, ``diverged`` and ``synced``, over
    two seeded rounds (the second on the first's output)."""
    rng = np.random.default_rng(100 + m)
    st = exchange_state(rng, m)
    for rnd in range(2):
        run, up = run_up(rng, m)
        want, jdiv, jsyn = jax_exchange(je, st, run, up)
        for fn in (teng.exchange_step_plain, teng.exchange_step):
            ts, div, syn = fn(to_torch(st), torch.from_numpy(run),
                              torch.from_numpy(up))
            assert_planes(want, to_numpy(ts), (m, rnd, fn.__name__))
            assert np.array_equal(jdiv, div.numpy()), (m, rnd)
            assert np.array_equal(jsyn, syn.numpy()), (m, rnd)
        assert jsyn.any() and jdiv.any() and not jsyn.all()
        st = want


@pytest.mark.parametrize("m", [5, 33])
def test_rows_outside_run_untouched_and_rows_independent(m):
    """(b) rows outside ``run`` keep every plane bit for bit and report
    False; (c) the exchange of the gathered run rows, scattered back,
    equals the whole-store exchange; and ``engine.keep_rows`` (one state
    and a mesh state of four CPU shards) writes the run rows back after
    they were stepped in place, as ``scrub()`` does when X1 raises, while
    the engine adapters' ``keep_rows`` keep nothing on the CPU."""
    rng = np.random.default_rng(200 + m)
    st = exchange_state(rng, m)
    run, up = run_up(rng, m)
    ts, div, syn = teng.exchange_step_plain(
        to_torch(st), torch.from_numpy(run), torch.from_numpy(up))
    got = to_numpy(ts)
    out = ~run
    for f in STATE:
        assert np.array_equal(got[f][out], st[f][out]), f
    assert not div.numpy()[out].any() and not syn.numpy()[out].any()
    idx = np.flatnonzero(run)
    sub = {f: st[f][idx] for f in STATE}
    ts2, div2, syn2 = teng.exchange_step_plain(
        to_torch(sub), torch.ones(idx.size, dtype=torch.bool),
        torch.from_numpy(up[idx]))
    scattered = {f: st[f].copy() for f in STATE}
    for f, x in to_numpy(ts2).items():
        scattered[f][idx] = x
    assert_planes(got, scattered, m)
    want_div = np.zeros_like(div.numpy())
    want_div[idx] = div2.numpy()
    want_syn = np.zeros_like(syn.numpy())
    want_syn[idx] = syn2.numpy()
    assert np.array_equal(div.numpy(), want_div)
    assert np.array_equal(syn.numpy(), want_syn)
    # the rollback: keep the run rows, step them in place, write them back
    se = mesh_engine(4, devices=["cpu"] * 4)
    for state in (to_torch(st), se.shard_state(to_torch(st))):
        one = isinstance(state, teng.EngineState)
        restore = teng.keep_rows(state, idx) if one \
            else state.keep_rows(idx)
        # the service's engine adapters keep nothing on the CPU, where the
        # exchange returns new tensors
        nothing = (tb._LocalEngine if one else se).keep_rows(state, idx)
        shards = [state] if one else list(state.shards.values())
        planes = ("obj_epoch", "obj_seq", "obj_val", "tree_leaf",
                  "tree_node")
        for shard in shards:
            for f in planes:
                getattr(shard, f).fill_(7)
        nothing()
        assert all((getattr(sh, f) == 7).all() for sh in shards
                   for f in planes)
        restore()
        back = to_numpy(state if one else se.gather_state(state))
        kept = {f: np.where(np.isin(np.arange(E), idx).reshape(
            (E,) + (1,) * (st[f].ndim - 1)), st[f], back[f]) for f in STATE}
        assert_planes(kept, back, (m, one))
        assert not all(np.array_equal(back[f], st[f]) for f in STATE)


# ---------------------------------------------------------------------------
# (d): X1's design


@pytest.mark.parametrize("m", [5, 33])
def test_x1_design_equals_jax(je, m):
    """(d) the numpy transcription of X1 equals the JAX exchange over two
    seeded rounds, and its epochs-below--1 case is exercised."""
    rng = np.random.default_rng(300 + m)
    st = exchange_state(rng, m)
    for rnd in range(2):
        run, up = run_up(rng, m)
        want, jdiv, jsyn = jax_exchange(je, st, run, up)
        got = {f: st[f].copy() for f in STATE}
        div, syn = x1_model(got, run, up)
        assert_planes(want, got, (m, rnd))
        assert np.array_equal(jdiv, div) and np.array_equal(jsyn, syn)
        st = want
    assert (st["obj_epoch"] < -1).any()


# ---------------------------------------------------------------------------
# (e): R1's design


def test_r1_design_equals_jax_reconfig(je):
    """(e) the numpy transcription of R1 equals the JAX ``reconfig_step``
    (a propose and a transition in one pass), ``reconfig_propose`` (with
    given versions) and ``reconfig_transition``, at M = 5 and 33, with
    leaderless rows, ``pend_vsn`` / ``view_vsn`` / ``fact_seq`` at the
    int32 maximum and empty proposed views."""
    import jax.numpy as jnp
    for m in (5, 33):
        rng = np.random.default_rng(400 + m)
        st = reconfig_state(rng, m)
        for rnd in range(3):
            up = rng.random((E, m)) < 0.85
            prop = rng.random(E) < 0.5
            nv = rng.random((E, m)) < 0.6
            nv[rng.random(E) < 0.1] = False
            vsn = rng.integers(-2, 12, E).astype(np.int32)
            run = rng.random(E) < 0.7
            cases = [
                ("reconfig_step", (prop, nv, up), (prop, nv, None, None)),
                ("reconfig_propose", (prop, nv, vsn, up),
                 (prop, nv, vsn, np.zeros(E, bool))),
                ("reconfig_transition", (run, up), (None, None, None, run)),
            ]
            for name, jargs, margs in cases:
                out = getattr(je, name)(jax_state(je, st),
                                        *map(jnp.asarray, jargs))
                want = {f: np.asarray(getattr(out[0], f)) for f in STATE}
                got = {f: st[f].copy() for f in STATE}
                inst, coll = r1_model(got, *margs, up)
                assert_planes(want, got, (m, rnd, name))
                if name == "reconfig_step":
                    assert np.array_equal(np.asarray(out[1]), inst)
                    assert np.array_equal(np.asarray(out[2]), coll)
                elif name == "reconfig_propose":
                    assert np.array_equal(np.asarray(out[1]), inst)
                    assert not coll.any()
                else:
                    assert np.array_equal(np.asarray(out[1]), coll)
                    assert not inst.any()
                st = want


# ---------------------------------------------------------------------------
# (f): the wrappers' contracts


def test_x1_r1_wrappers_raise_outside_their_contracts():
    """(f) X1 and R1 raise on a CPU state (they run on the card only),
    and their contract checks on a wrong dtype, shape or device, a
    non-contiguous plane, M > 128 or V > 8."""
    st = teng.init_state(4, 5, 16, device="cpu")
    run = torch.ones(4, dtype=torch.bool)
    up = torch.ones((4, 5), dtype=torch.bool)
    with pytest.raises(ValueError, match="cuda"):
        cuda_exchange.exchange_step(st, run, up)
    with pytest.raises(ValueError, match="cuda"):
        cuda_reconfig.reconfig_step(st, run, up, None, None, up)
    cuda_exchange.check_contract(st, run, up)
    cuda_reconfig.check_contract(st, run, up, None, None, up)
    meta = torch.ones(4, dtype=torch.bool, device="meta")
    bad_x = [
        (TypeError, st, run.to(torch.uint8), up),
        (ValueError, st, run[:3], up),
        (ValueError, st, meta, up),
        (ValueError, st, run, torch.ones((5, 4), dtype=torch.bool).t()),
        (ValueError, st._replace(obj_val=st.obj_val.transpose(1, 2)
                                 .contiguous().transpose(1, 2)), run, up),
        (TypeError, st._replace(obj_seq=st.obj_seq.long()), run, up),
    ]
    for exc, s_, r_, u_ in bad_x:
        with pytest.raises(exc):
            cuda_exchange.check_contract(s_, r_, u_)
    bad_r = [
        (TypeError, st, run, up, run, None),
        (ValueError, st, run, None, None, None),
        (ValueError, st, None, None, None, meta),
        (ValueError,
         st._replace(fact_seq=torch.zeros((5, 4), dtype=torch.int32).t()),
         None, None, None, run),
    ]
    for exc, s_, p_, nv_, vs_, rn_ in bad_r:
        with pytest.raises(exc):
            cuda_reconfig.check_contract(s_, p_, nv_, vs_, rn_, up)
    wide = teng.init_state(2, 129, 16, device="cpu")
    many = teng.init_state(2, 5, 16, n_views=9, device="cpu")
    for big, m in ((wide, 129), (many, 5)):
        r2 = torch.ones(2, dtype=torch.bool)
        u2 = torch.ones((2, m), dtype=torch.bool)
        with pytest.raises(ValueError, match="takes"):
            cuda_exchange.check_contract(big, r2, u2)
        with pytest.raises(ValueError, match="takes"):
            cuda_reconfig.check_contract(big, None, None, None, r2, u2)
