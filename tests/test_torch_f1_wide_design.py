"""Kernel F1's wide mode (``csrc/engine_step.cu``, ``kWide``), in numpy.

F1's wide mode runs only on a CUDA card.  Its algorithm is not the plain
version's: besides the integrity verdicts and the one refold at the end
that scalar F1 keeps (``tests/test_torch_f1_design.py`` holds those), it
runs the W lanes of a group at the same time.  This file holds a numpy
transcription of that, one ensemble (one thread block) at a time, and
drives it against ``full_step_wide_plain``, ``full_step_wide_sliced_plain``
(and ``kv_step_scan_wide_plain``) and the JAX package's ``full_step_wide``
/ ``full_step_wide_sliced`` on seeded inputs with damage between steps.
Equality is exact: every state plane (tree hashes included), ``won`` and
every result lane, NOOP and pad lanes included.

What the transcription keeps from the kernel:

- a group's lanes go in passes of ``L = warps * (32 // M)`` lanes (a warp
  holds ``32 // M`` segments of M threads, thread = replica); every live
  lane of a pass decides from the shared state as it stands, and only
  then does any lane of the pass write.  A later pass of the same group
  decides after the earlier passes wrote: the model leans on the
  argument that no lane reads what another lane of its group writes (the
  slots of a group's live lanes are distinct, BAD bits do not change
  inside a group) — were that wrong, it would differ from the plain step;
- a committing lane's seq is the counter plus the commits of the group's
  lanes up to and including its own (a ballot and a popcount in the warp,
  a scan over the warps), and the counter moves by the pass's total;
- ``nst[r, n]`` holds BAD (1) and DIRTY (2), ``sst[r, s]`` the same for a
  slot's leaf.  A write stores its object and ``sst = DIRTY`` at once and
  ORs DIRTY into its path's nodes — every lane under a node stores the
  same value — and the group's end clears BAD where DIRTY, four state
  bytes a word, once any write of the group crossed a BAD node;
- the group's ``tree_corrupt`` row is the OR of its live lanes' corrupt
  replicas, stored at the group's end;
- as in scalar F1: verdicts up front for every heard replica of a staged
  row, the DIRTY leaves hashed and the DIRTY nodes refolded once at the
  end, only the replicas that wrote written back.

The model at eight warps a block is in
``tests/test_torch_f1_wide_design_8warps.py``; the sliced launches, the JAX
steps and the design's counts in ``tests/test_torch_f1_wide_design_sliced.py``.
"""

import numpy as np
import pytest
import torch

from riak_ensemble_tpu_torch.ops import engine as teng
from riak_ensemble_tpu_torch.ops import schedule as tsch
from test_torch_f1_design import (
    I32_MIN, OP_CAS, OP_GET, OP_PUT, OP_RMW, U32, Tree, _i32, _rmw, _tres,
    assert_results_equal, assert_states_equal, bits, damage, epoch_check,
    fold, leaf_hash, popc, quorum_met_bits, stream, to_numpy, to_torch)

BAD, DIRTY = 1, 2


# ---------------------------------------------------------------------------
# One launch


def launch(st, elect, cand, kind, slot, val, lease, up, exp_e, exp_s,
           active_idx=None, warps=1):
    """One wide F1 launch on a numpy state ``st`` in place: ``[G, C, W]``
    op planes, ``warps`` warps a block.  Returns ``(won, results,
    counts)``."""
    e_rows, m = st["epoch"].shape
    g_n, cols, w = kind.shape
    tree = Tree(st["obj_epoch"].shape[2])
    lanes = (g_n, cols, w)
    res = {"committed": np.zeros(lanes, bool),
           "get_ok": np.zeros(lanes, bool),
           "found": np.zeros(lanes, bool),
           "value": np.zeros(lanes, np.int32),
           "obj_vsn": np.zeros(lanes + (2,), np.int32),
           "quorum_ok": np.zeros(lanes, bool),
           "tree_corrupt": np.zeros((g_n, cols, m), bool)}
    won = np.zeros(cols, bool)
    counts = {"verdict_folds": 0, "refold_folds": 0, "leaf_verdicts": 0,
              "leaf_writes": 0, "live_rounds": 0, "staged_rows": 0,
              "written_replicas": 0, "shared_bad": 0, "healed_read": 0}
    # the pads read row E - 1 as it stood before the launch
    pad_ballot = (st["epoch"][-1].copy(), int(st["leader"][-1]))
    for col in range(cols):
        row = col if active_idx is None else int(active_idx[col])
        if row >= e_rows:
            views = _views(st, e_rows - 1)
            heard = bits(up[e_rows - 1]) & _union(views)
            ok, _, _ = epoch_check(pad_ballot[0], pad_ballot[1], heard, m,
                                   views)
            res["quorum_ok"][:, col] = ok
        else:
            won[col] = _block(st, tree, row, col, elect, cand, kind, slot,
                              val, lease, up, exp_e, exp_s, warps, res,
                              counts)
    return (won if elect is not None else None), res, counts


def _views(st, row):
    return [bits(st["view_mask"][row, j])
            for j in range(st["view_mask"].shape[1])]


def _union(views):
    out = 0
    for vb in views:
        out |= vb
    return out


def _decide(ctx, op, pe, ps, pv, leaf_ok, path_bad):
    """A live lane's decision over the replicas' objects at its slot and
    their verdicts: the kernel's ``decide`` after ``_latest_among``."""
    heard_m, heard, views, n_member, epoch_ok, leader_up, lead_epoch = ctx
    kd, v, ls, ee, es = op
    ok_m = heard_m & leaf_ok & ~path_bad
    okmask = bits(ok_m)
    h = ok_m & (ps > 0)
    emax = int(pe[h].max()) if h.any() else -1
    hs = h & (pe == emax)
    smax = int(ps[hs].max()) if hs.any() else -1
    hv = hs & (ps == smax)
    vmax = int(pv[hv].max()) if hv.any() else I32_MIN
    obj_found = smax > 0
    rd_epoch, rd_seq = max(emax, 0), max(smax, 0)
    rd_val = vmax if obj_found else 0
    found = obj_found and rd_val != 0
    all_ok = popc(okmask) == n_member
    is_put, is_get = kd == OP_PUT, kd == OP_GET
    is_cas, is_rmw = kd == OP_CAS, kd == OP_RMW
    get_gate = is_get and leader_up and (ls or epoch_ok)
    stale = obj_found and rd_epoch != lead_epoch
    rewrite = get_gate and stale and epoch_ok
    nf = get_gate and not obj_found
    nf_quorum = quorum_met_bits(okmask, heard & ~okmask, views) == 1
    nf_write = nf and not all_ok and epoch_ok and nf_quorum
    get_ok = (get_gate and obj_found and (not stale or rewrite)) or \
        (nf and (all_ok or nf_write))
    exp_absent = ee == 0 and es == 0
    vsn_match = ((obj_found and rd_epoch == ee and rd_seq == es)
                 or (exp_absent and obj_found and rd_val == 0)
                 or (exp_absent and not obj_found and nf_quorum))
    new_rmw = _rmw(ee, rd_val, v)
    rmw_commit = is_rmw and epoch_ok and (
        ((obj_found and rd_val == 0) or (not obj_found and nf_quorum))
        if ee == teng.RMW_PIA else (obj_found or nf_quorum))
    commit = (is_put and epoch_ok) or (is_cas and epoch_ok and vsn_match) \
        or rewrite or nf_write or rmw_commit
    wval = v if (is_put or is_cas) else new_rmw if is_rmw else \
        rd_val if rewrite else 0
    plain_read = get_ok and obj_found and not rewrite
    divergent = heard_m & ((pe != rd_epoch) | (ps != rd_seq) | ~leaf_ok
                           | path_bad)
    served = get_ok and obj_found
    return {"commit": commit, "get_ok": get_ok, "found": found and get_ok,
            "value": new_rmw if rmw_commit else (rd_val if get_ok and found
                                                 else 0),
            "vsn": (lead_epoch if commit else (rd_epoch if served else 0),
                    rd_seq if served else 0),
            "do_write": (heard_m & commit) | (plain_read & divergent),
            "write": (lead_epoch if commit else rd_epoch, rd_seq,
                      wval if commit else rd_val),
            "corrupt": (path_bad | ~leaf_ok) & heard_m}


def _block(st, tree, row, col, elect, cand, kind, slot, val, lease, up,
           exp_e, exp_s, warps, res, counts):
    m = st["epoch"].shape[1]
    s = st["obj_epoch"].shape[2]
    g_n, _, w = kind.shape
    views = _views(st, row)
    heard = bits(up[row]) & _union(views)
    heard_m = np.array([(heard >> r) & 1 for r in range(m)], bool)
    epoch_m = st["epoch"][row].copy()
    fact_m = st["fact_seq"][row].copy()
    leader = int(st["leader"][row])
    ctr = int(st["obj_seq_ctr"][row])
    won = False
    if elect is not None:
        next_epoch = max([int(x) for x in epoch_m[heard_m]] + [-1]) + 1
        c = int(cand[col])
        won = bool(elect[col]) and 0 <= c < m and bool((heard >> c) & 1) \
            and quorum_met_bits(heard, 0, views) == 1
        if won:
            epoch_m[heard_m] = next_epoch
            fact_m[heard_m] = 0
            leader, ctr = c, 0
    epoch_ok, lead_epoch, leader_up = epoch_check(epoch_m, leader, heard, m,
                                                  views)
    ctx = (heard_m, heard, views, popc(_union(views)), epoch_ok, leader_up,
           lead_epoch)

    kinds, slots = kind[:, col], slot[:, col]                   # [G, W]
    live = np.isin(kinds, (OP_GET, OP_PUT, OP_CAS, OP_RMW)) & \
        (slots >= 0) & (slots < s)
    res["quorum_ok"][:, col] = epoch_ok
    res["get_ok"][:, col] = (~live & (kinds == OP_GET) & leader_up
                             & (lease[:, col] | epoch_ok))
    if live.any():
        counts["staged_rows"] += 1
        oe = st["obj_epoch"][row].copy()
        os_ = st["obj_seq"][row].copy()
        ov = st["obj_val"][row].copy()
        leaf = st["tree_leaf"][row].copy()
        node = st["tree_node"][row].copy()
        nst = np.zeros((m, tree.u), np.uint8)
        sst = np.zeros((m, s), np.uint8)
        for r in np.nonzero(heard_m)[0]:
            bad = (leaf_hash(oe[r], os_[r], ov[r]) != leaf[r]).any(-1)
            sst[r] = np.where(bad, BAD, 0)
            counts["leaf_verdicts"] += s
            for n in range(tree.u):
                lvl, pidx = tree.level_of(n)
                got = fold(tree.children(leaf[r], node[r], lvl, pidx))
                nst[r, n] = BAD if (got != node[r, n]).any() else 0
                counts["verdict_folds"] += 1
        wrote = np.zeros(m, bool)
        per_pass = warps * (32 // m)
        for g in range(g_n):
            corrupt = np.zeros(m, bool)
            heal = False
            bad_readers = {}    # (replica, BAD node): the lanes that read it
            healers = []        # (replica, BAD node, lane) written over
            for base in range(0, w, per_pass):
                todo = [j for j in range(base, min(base + per_pass, w))
                        if live[g, j]]
                # every lane of the pass decides before any lane writes
                made = []
                for j in todo:
                    counts["live_rounds"] += 1
                    sc = int(slots[g, j])
                    path = tree.path(sc)
                    leaf_ok = ~heard_m | ((sst[:, sc] & BAD) == 0)
                    path_bad = heard_m & np.array(
                        [any(nst[r, n] & BAD for n in path)
                         for r in range(m)])
                    for r in np.nonzero(heard_m)[0]:
                        for n in path:
                            if nst[r, n] & BAD:
                                bad_readers.setdefault((r, n), set()).add(j)
                    op = (int(kinds[g, j]), int(val[g, col, j]),
                          bool(lease[g, col, j]), int(exp_e[g, col, j]),
                          int(exp_s[g, col, j]))
                    d = _decide(ctx, op, oe[:, sc].copy(), os_[:, sc].copy(),
                                ov[:, sc].copy(), leaf_ok, path_bad)
                    made.append((j, sc, path, path_bad, d))
                # the seqs: a prefix count of the pass's commits
                upto = 0
                for j, sc, path, path_bad, d in made:
                    if d["commit"]:
                        upto += 1
                        seq = _i32(ctr + upto)
                        d["write"] = (d["write"][0], seq, d["write"][2])
                        d["vsn"] = (d["vsn"][0], seq)
                ctr = _i32(ctr + upto)
                for j, sc, path, path_bad, d in made:
                    dw = d["do_write"]
                    if dw.any():
                        oe[dw, sc], os_[dw, sc], ov[dw, sc] = d["write"]
                        sst[dw, sc] = DIRTY
                        for n in path:
                            nst[dw, n] |= DIRTY
                            healers += [(r, n, j) for r in np.nonzero(dw)[0]
                                        if nst[r, n] & BAD]
                        wrote |= dw
                        heal |= bool((dw & path_bad).any())
                    corrupt |= d["corrupt"]
                    res["committed"][g, col, j] = d["commit"]
                    res["get_ok"][g, col, j] = d["get_ok"]
                    res["found"][g, col, j] = d["found"]
                    res["value"][g, col, j] = d["value"]
                    res["obj_vsn"][g, col, j] = d["vsn"]
            # the group ends
            res["tree_corrupt"][g, col] = corrupt
            counts["shared_bad"] += sum(len(v) > 1
                                        for v in bad_readers.values())
            counts["healed_read"] += sum(
                bool(bad_readers.get((r, n), set()) - {j})
                for r, n, j in healers)
            if heal:
                flat = nst.reshape(-1)
                pad = np.zeros(-flat.size % 4, np.uint8)
                words = np.concatenate([flat, pad]).view("<u4")
                words &= ~((words >> U32(1)) & U32(0x01010101))
                nst = words.view(np.uint8)[:flat.size].reshape(nst.shape)

        # the end of the launch, as scalar F1
        r_w, s_w = np.nonzero(sst & DIRTY)
        leaf[r_w, s_w] = leaf_hash(oe[r_w, s_w], os_[r_w, s_w],
                                   ov[r_w, s_w])
        counts["leaf_writes"] += len(r_w)
        for lvl, (off, size) in enumerate(zip(tree.offs, tree.sizes)):
            for r in range(m):
                for pidx in range(size):
                    if nst[r, off + pidx] & DIRTY:
                        node[r, off + pidx] = fold(
                            tree.children(leaf[r], node[r], lvl, pidx))
                        counts["refold_folds"] += 1
        for r in np.nonzero(wrote)[0]:
            counts["written_replicas"] += 1
            st["obj_epoch"][row, r] = oe[r]
            st["obj_seq"][row, r] = os_[r]
            st["obj_val"][row, r] = ov[r]
            st["tree_leaf"][row, r] = leaf[r]
            st["tree_node"][row, r] = node[r]

    heal = heard_m & leader_up & (epoch_m < lead_epoch)
    epoch_m[heal] = lead_epoch
    st["epoch"][row] = epoch_m
    st["fact_seq"][row] = fact_m
    st["leader"][row] = leader
    st["obj_seq_ctr"][row] = ctr
    return won


# ---------------------------------------------------------------------------
# Inputs


def wide_slots(rng, k, cols, s, chains, aimed=False):
    """``[K, C]`` slots that schedule to one group (distinct in every
    column) or, with ``chains``, to two (each of K/2 slots twice), with a
    few invalid slots: below 0, and past S distinct by row.  ``aimed``:
    slots 0-15 (one level-0 node) first."""
    n = k // 2 if chains else k
    keys = rng.random((s, cols)) - aimed * (np.arange(s) < 16)[:, None]
    first = np.argsort(keys, axis=0)[:n]
    if chains:
        again = first[np.argsort(rng.random((n, cols)), axis=0),
                      np.arange(cols)[None, :]]
        first = np.concatenate([first, again])
    bad = rng.random((k, cols))
    past = s + np.arange(k)[:, None]
    return np.where(bad < 0.05, -1, np.where(bad > 0.96, past, first)
                    ).astype(np.int32)


def plan_of(rng, leader, e, m, s, k, chains, aimed=False, pattern="mixed"):
    """A step's election planes and its ``[G, E, W]`` plan: the scalar
    design's stream with :func:`wide_slots`, scheduled."""
    elect, cand, kind, slot, val, lease, up, exp_e, exp_s = stream(
        rng, leader, e, m, s, k, pattern)
    slot = wide_slots(rng, k, e, s, chains, aimed)
    plan = tsch.schedule_wide(kind, slot, val, lease, exp_e, exp_s)
    assert plan.kind.shape[0] == (2 if chains else 1)
    return elect, cand, up, plan


def ops_of(plan):
    return [np.ascontiguousarray(x) for x in (
        plan.kind, plan.slot, plan.val, plan.lease_ok, plan.exp_epoch,
        plan.exp_seq)]


# ---------------------------------------------------------------------------
# The model against the plain wide steps

#: (name, E, M, S, K (ops a column before scheduling), views, steps,
#: chains, aimed, elect every step)
CASES = [
    ("W=64, G=1", 5, 5, 128, 64, None, 3, False, False, True),
    ("W=64, G=2", 5, 5, 128, 64, None, 3, True, False, True),
    ("joint views", 5, 5, 128, 32, [[0, 1, 2], [1, 2, 3, 4]], 3, True,
     False, True),
    ("M=3 S=33", 5, 3, 33, 16, None, 3, True, False, True),
    ("M=7 S=16", 5, 7, 16, 16, None, 3, False, False, True),
    ("M=32 S=16", 3, 32, 16, 16, None, 2, True, False, True),
    ("shared corrupt node", 6, 5, 128, 32, None, 4, True, True, True),
    ("no election", 5, 5, 33, 16, None, 3, True, False, False),
]


@pytest.mark.parametrize("warps", [1])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_wide_design_equals_plain(case, warps):
    """At one warp a block (one pass per segment count); eight warps are
    in ``test_torch_f1_wide_design_8warps.py``."""
    design_equals_plain(case, warps)


def design_equals_plain(case, warps):
    """``CASES`` entry ``case`` through the model at ``warps`` warps a
    block against the plain wide steps, every step."""
    name, e, m, s, k, views, steps, chains, aimed, every = case
    rng = np.random.default_rng(200 + CASES.index(case))
    state = teng.init_state(e, m, s, views=views, device="cpu")
    st = to_numpy(state)
    seen = {"commits": 0, "corrupt": 0, "invalid": 0, "shared_bad": 0,
            "healed_read": 0}
    for step in range(steps):
        if step:
            damage(rng, st, max(e, 4))
            if aimed:   # the level-0 node over slots 0-15, every row
                reps = rng.integers(0, m, e)
                st["tree_node"][np.arange(e), reps, 0, 1] ^= U32(0x40)
            state = to_torch(st)
        elect, cand, up, plan = plan_of(rng, st["leader"], e, m, s, k,
                                        chains, aimed)
        if step == 0:
            elect[:] = True
            cand[:] = up.argmax(1)
        ops = ops_of(plan)
        T = torch.from_numpy
        if every or step == 0:
            state, want_won, want = teng.full_step_wide_plain(
                state, T(elect), T(cand), *map(T, ops[:4]), T(up),
                T(ops[4]), T(ops[5]))
            want_won = want_won.numpy()
            el, cd = elect, cand
        else:
            state, want = teng.kv_step_scan_wide_plain(
                state, *map(T, ops[:4]), T(up), T(ops[4]), T(ops[5]))
            want_won = el = cd = None
        won, got, counts = launch(st, el, cd, *ops[:4], up, *ops[4:],
                                  warps=warps)
        where = (name, warps, step)
        assert_results_equal(want_won, _tres(want), won, got, where)
        assert_states_equal(to_numpy(state), st, where)
        seen["commits"] += int(got["committed"].sum())
        seen["corrupt"] += int(got["tree_corrupt"].sum())
        seen["invalid"] += int(((plan.kind > 0) & ((plan.slot < 0)
                                                   | (plan.slot >= s))).sum())
        for key in ("shared_bad", "healed_read"):
            seen[key] += counts[key]
    assert seen["commits"] and seen["corrupt"] and seen["invalid"], \
        (name, seen)
    if aimed:
        # two lanes of one group under one corrupt node, and a lane that
        # healed a node another lane of its group read as corrupt
        assert seen["shared_bad"] and seen["healed_read"], (name, seen)

