"""Chip smoke test of riak_ensemble_tpu_torch on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit (``nvcc``)::

    python3 chip_smoke.py [--profile PATH]

Phases (each raises on failure, so any failure exits non-zero):

1. build every CUDA kernel of the package from ``csrc/`` with nvcc;
2. hold kernel K1 (``ops/cuda_quorum.py``) against its plain torch
   version on the card — exact equality — at the main-path shape and
   the edge cases, and time both;
2b. the same for kernel K2 (the shared-mask quorum predicate, every
   required mode), which no service path calls;
3. run the fused engine step on CUDA (K1) and on the CPU (plain
   version) over one seeded op stream and require every state plane
   and result field to be bit-equal;
4. drive the keyed service at full size — 10,000 ensembles x 5 peers x
   128 slots, K = 64 — through ``execute()`` and ``kput_many`` /
   ``kget_many`` with a peer down, read every acknowledged put back,
   and require K1 to launch exactly K + 2 times per launch;
5. at the same size, read-modify-write and lease fast reads: ``OP_RMW``
   rows through ``execute()`` checked against int32 sums and maxima
   computed on the host, ``kmodify_many`` with duplicate keys
   (coalesced), 16 concurrent host-path ``kmodify`` increments of one
   key on each of 64 ensembles (exactly +16 within a stated flush
   bound), and ``kget_many`` of everything written, served by the fast
   path and checked against the acknowledged values.

It prints the card (``nvidia-smi``), one JSON line of kernel numbers,
and as its last line ``{"ok": true, "device": {...}}``.  It exits
non-zero without that line when no CUDA device is visible.  With
``--profile PATH`` it also traces one full-size flush with
torch.profiler and writes the table to PATH.
"""

import json
import os
import statistics
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

from riak_ensemble_tpu_torch import funref, interop
from riak_ensemble_tpu_torch.ops import build
from riak_ensemble_tpu_torch.ops import cuda_quorum
from riak_ensemble_tpu_torch.ops import engine as eng
from riak_ensemble_tpu_torch.ops.quorum import REQUIRED_MODES
from riak_ensemble_tpu_torch.parallel.batched_host import (
    BatchedEnsembleService, WallRuntime)

#: H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
#: K1 does int32 adds and compares, outside the tensor cores.  An
#: H100 SM has 64 INT32 lanes against 128 FP32 lanes, so the int32 peak
#: is half the data sheet's 67 TFLOP/s float32 row.  K1 is byte-bound
#: by more than 5x at this rate
INT32_OPS_PER_S = 33.5e12

E_FULL, M_FULL, S_FULL, K_FULL = 10_000, 5, 128, 64


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, reps: int = 5) -> float:
    """Median over ``reps`` of the mean ms per call of ``fn`` across
    ``iters`` back-to-back calls, timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / iters)
    return statistics.median(per)


# ---------------------------------------------------------------------------
# Phase 2: K1 against its plain version


def k1_inputs(g: torch.Generator, e: int, w: int, v: int, m: int,
              inactive: float = 0.25, all_unmet: bool = False):
    valid = torch.rand((e * w, m), generator=g) < 0.5
    nack = (torch.rand((e * w, m), generator=g) < 0.5) & ~valid
    mask = torch.rand((e, v, m), generator=g) < 0.6
    mask[:, 0, 0] = True                       # view 0 always active
    mask[: int(e * inactive), 1:] = False      # trailing views inactive
    if all_unmet:
        # every view active and unmet: the first-unmet argmin sees an
        # all-zero row and must pick view 0 (first minimum)
        mask[:] = True
        valid[:] = False
        nack = torch.rand((e * w, m), generator=g) < 0.5
    return valid, nack, mask


def phase_k1(dev: torch.device):
    g = torch.Generator().manual_seed(1)
    cases = [
        ("main path [10000, 5], V=2", E_FULL, 1, 2, 5, {}),
        ("round call, rows share a mask (W=4)", E_FULL, 4, 2, 5, {}),
        ("E not a multiple of the block", 10_001, 1, 2, 5, {}),
        ("M=128, V=8", 777, 1, 8, 128, {}),
        ("inactive views only past view 0", 4096, 1, 3, 5,
         {"inactive": 1.0}),
        ("all views unmet (argmin tie)", 4096, 1, 4, 5,
         {"all_unmet": True}),
    ]
    for name, e, w, v, m, kw in cases:
        valid, nack, mask = k1_inputs(g, e, w, v, m, **kw)
        dv, dn, dm = valid.to(dev), nack.to(dev), mask.to(dev)
        got = cuda_quorum.quorum_met_e(dv, dn, dm, w)
        plain = cuda_quorum.quorum_met_eplain(dv, dn, dm, w)
        cpu = cuda_quorum.quorum_met_eplain(valid, nack, mask, w)
        torch.cuda.synchronize()
        if not (torch.equal(got.cpu(), plain.cpu())
                and torch.equal(plain.cpu(), cpu)):
            raise AssertionError(f"K1 disagrees with its plain version: "
                                 f"{name}")
        counts = torch.bincount(cpu.long() + 1, minlength=3).tolist()
        print(f"K1 == plain  {name}: rows={e * w} "
              f"[NACK, UNDECIDED, MET]={counts}")
    # timing at the main-path shape (the elect/context/round calls)
    valid, nack, mask = (t.to(dev) for t in k1_inputs(g, E_FULL, 1, 2, 5))
    k1_ms = cuda_ms(lambda: cuda_quorum.quorum_met_e(valid, nack, mask),
                    iters=200)
    plain_ms = cuda_ms(
        lambda: cuda_quorum.quorum_met_eplain(valid, nack, mask), iters=50)
    nbytes = 2 * valid.numel() + mask.numel() + valid.shape[0]
    ops = 3 * mask.numel()    # count, heard, nack adds per (row, view, peer)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"K1 at [10000, 5], V=2: kernel {k1_ms:.6f} ms, plain "
          f"{plain_ms:.6f} ms, bound {bound_ms * 1e3:.4f} us "
          f"({nbytes} B)")
    return {"ms": k1_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err": 0}


# ---------------------------------------------------------------------------
# Phase 2b: K2 against its plain version


def k2_inputs(g: torch.Generator, e: int, v: int, m: int,
              self_lo: int = -1, self_hi: Optional[int] = None,
              empty_views: int = 0):
    valid = torch.rand((e, m), generator=g) < 0.45
    nack = (torch.rand((e, m), generator=g) < 0.35) & ~valid
    mask = torch.rand((v, m), generator=g) < 0.6
    mask[0] = True                              # view 0: every peer
    if empty_views:
        mask[v - empty_views:] = False          # inactive trailing views
    hi = m if self_hi is None else self_hi
    self_idx = torch.randint(self_lo, hi, (e,), generator=g,
                             dtype=torch.int32)
    return valid, nack, mask, self_idx


def device_us_per_launch(fn, name: str, n: int = 50) -> float:
    """Device time per launch of the kernel whose name contains
    ``name``, from torch.profiler over ``n`` back-to-back calls."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages() if name in ev.key]
    count = sum(ev.count for ev in evs)
    if count != n:
        raise AssertionError(f"profiler saw {count} launches of {name}")
    return sum(ev.self_device_time_total for ev in evs) / count


def phase_k2(dev: torch.device, profile: Optional[str] = None):
    g = torch.Generator().manual_seed(2)
    cases = [
        ("headline [10000, 5], V=2", 10_000, 2, 5, {}),
        ("E not a multiple of the block", 10_001, 3, 7, {}),
        ("singleton view", 300, 1, 1, {}),
        ("self_idx outside [0, M)", 4096, 2, 5,
         {"self_lo": -6, "self_hi": 11}),
        ("inactive trailing views", 4096, 4, 5, {"empty_views": 2}),
        ("M=128, V=128", 777, 128, 128, {}),
    ]
    for name, e, v, m, kw in cases:
        args = k2_inputs(g, e, v, m, **kw)
        dargs = [t.to(dev) for t in args]
        counts = []
        for required in REQUIRED_MODES:
            got = cuda_quorum.quorum_met_s(*dargs, required)
            plain = cuda_quorum.quorum_met_splain(*dargs, required)
            cpu = cuda_quorum.quorum_met_splain(*args, required)
            torch.cuda.synchronize()
            if not (torch.equal(got.cpu(), plain.cpu())
                    and torch.equal(plain.cpu(), cpu)):
                raise AssertionError(f"K2 disagrees with its plain "
                                     f"version: {name}, {required}")
            counts.append(torch.bincount(cpu.long() + 1,
                                         minlength=3).tolist())
        print(f"K2 == plain  {name}: rows={e}, [NACK, UNDECIDED, MET] "
              f"per mode {dict(zip(REQUIRED_MODES, counts))}")
    valid, nack, mask, self_idx = (t.to(dev) for t in
                                   k2_inputs(g, E_FULL, 2, 5))
    k2_ms = cuda_ms(lambda: cuda_quorum.quorum_met_s(
        valid, nack, mask, self_idx), iters=200)
    plain_ms = cuda_ms(lambda: cuda_quorum.quorum_met_splain(
        valid, nack, mask, self_idx), iters=50)
    e, m = valid.shape
    v = mask.shape[0]
    # each input read once (valid, nack, mask bytes; int32 self_idx),
    # the int8 result written once
    nbytes = 2 * e * m + v * m + 4 * e + e
    ops = 2 * e * v * m       # heard and nack adds per (row, view, peer)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"K2 at [10000, 5], V=2, quorum: kernel {k2_ms:.6f} ms, plain "
          f"{plain_ms:.6f} ms, bound {bound_ms * 1e3:.4f} us "
          f"({nbytes} B)")
    if profile:
        us = device_us_per_launch(lambda: cuda_quorum.quorum_met_s(
            valid, nack, mask, self_idx), "quorum_met_shared_kernel")
        print(f"profile: K2 {us:.3f} us device time per launch")
    return {"ms": k2_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err": 0}


# ---------------------------------------------------------------------------
# Phase 3: engine on CUDA against the engine on the CPU


def engine_stream(rng: np.random.Generator, e: int, m: int, s: int,
                  k: int, steps: int):
    """Seeded full_step inputs covering elections, puts, gets, CAS,
    every RMW code, tombstones (put of 0), a down peer and leases off."""
    for step in range(steps):
        up = np.ones((e, m), bool)
        if step >= 2:
            up[rng.integers(0, e, e // 8), rng.integers(0, m, e // 8)] = False
        elect = np.zeros(e, bool) if step % 3 else rng.random(e) < 0.7
        cand = rng.integers(-1, m, e).astype(np.int32)
        kind = rng.integers(0, 5, (k, e)).astype(np.int32)
        slot = rng.integers(-1, s + 1, (k, e)).astype(np.int32)
        val = rng.integers(0, 1000, (k, e)).astype(np.int32)
        val[rng.random((k, e)) < 0.1] = 0                  # tombstones
        exp_e = np.where(kind == eng.OP_RMW,
                         rng.integers(0, 9, (k, e)),
                         rng.integers(0, 3, (k, e))).astype(np.int32)
        exp_s = rng.integers(0, 3, (k, e)).astype(np.int32)
        lease = rng.random((k, e)) < (0.0 if step % 2 else 0.5)
        yield elect, cand, kind, slot, val, lease, up, exp_e, exp_s


def phase_engine(dev: torch.device) -> None:
    e, m, s, k = 512, 5, 128, 16
    st_cpu = eng.init_state(e, m, s, device="cpu")
    st_gpu = eng.init_state(e, m, s, device=dev)
    rng = np.random.default_rng(7)
    flagged = 0
    for step, planes in enumerate(engine_stream(rng, e, m, s, k, 8)):
        if step == 4:
            # out-of-band damage on two replicas: the integrity gate
            # and read repair must agree on both devices
            for st in (st_cpu, st_gpu):
                st.obj_val[3, 1, :] += 1
                st.tree_leaf[5, 2, :, 0] ^= 1
        cpu_in = [torch.from_numpy(p) for p in planes]
        gpu_in = [t.to(dev) for t in cpu_in]
        st_cpu, won_c, res_c = eng.full_step(
            st_cpu, *cpu_in[:7], exp_epoch=cpu_in[7], exp_seq=cpu_in[8])
        st_gpu, won_g, res_g = eng.full_step(
            st_gpu, *gpu_in[:7], exp_epoch=gpu_in[7], exp_seq=gpu_in[8])
        a = interop.state_to_numpy(st_cpu)
        b = interop.state_to_numpy(st_gpu)
        for f in eng.EngineState._fields:
            if not np.array_equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"engine step {step}: state plane "
                                     f"{f} differs CUDA vs CPU")
        ra, rb = interop.result_to_numpy(res_c), interop.result_to_numpy(
            res_g)
        for f in eng.KvResult._fields:
            if not np.array_equal(getattr(ra, f), getattr(rb, f)):
                raise AssertionError(f"engine step {step}: result {f} "
                                     f"differs CUDA vs CPU")
        if not torch.equal(won_c, won_g.cpu()):
            raise AssertionError(f"engine step {step}: won differs")
        flagged += int(res_c.tree_corrupt.sum())
    if not flagged:
        raise AssertionError("the damaged replicas were never flagged")
    print(f"engine CUDA == CPU: E={e} M={m} S={s} K={k}, 8 steps, "
          f"commits={int(st_cpu.obj_seq_ctr.sum())}, "
          f"corrupt flags={flagged}")


# ---------------------------------------------------------------------------
# Phase 4: the keyed service at full size


class LaunchCheck:
    """Holds every launch of ``svc`` to the K + 2 K1-launches contract
    (a flush() that chains follow-up launches is checked per launch)
    and counts the launches."""

    def __init__(self, svc: BatchedEnsembleService) -> None:
        self.launches = 0
        launch = svc._launch

        def checked(*args, **kwargs):
            before = cuda_quorum.quorum_launches
            out = launch(*args, **kwargs)
            got = cuda_quorum.quorum_launches - before
            want = svc.last_launch_k + 2
            if got != want:
                raise AssertionError(f"K1 launched {got} times in a launch "
                                     f"of K={svc.last_launch_k}, want "
                                     f"{want}")
            self.launches += 1
            return out
        svc._launch = checked


def phase_service(dev: torch.device, card: str,
                  profile: Optional[str] = None):
    e, m, s, k = E_FULL, M_FULL, S_FULL, K_FULL
    rng = np.random.default_rng(11)
    svc = BatchedEnsembleService(WallRuntime(), e, m, s, tick=None,
                                 max_ops_per_tick=k, device=dev)
    torch.cuda.synchronize()
    LaunchCheck(svc)
    cuda_quorum.quorum_launches = 0            # the main path's run
    rows = np.arange(k)[:, None]
    slots = ((rows + rng.integers(0, s, (1, e))) % s).astype(np.int32)
    put, get = (np.full((k, e), op, np.int32)
                for op in (eng.OP_PUT, eng.OP_GET))
    flush_ms, n_ops = [], 0

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        flush_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    # execute(): 64 puts per ensemble (elections fold into the first
    # launch), then every slot read back, twice over
    for rnd in range(2):
        vals = rng.integers(1, 2 ** 31 - 1, (k, e)).astype(np.int32)
        committed, _, _, _ = timed(lambda: svc.execute(put, slots, vals))
        _, get_ok, found, value = timed(
            lambda: svc.execute(get, slots, np.zeros_like(vals)))
        n_ops += 2 * k * e
        if not committed.all():
            raise AssertionError(f"round {rnd}: {int((~committed).sum())} "
                                 f"puts not acknowledged")
        if not (get_ok.all() and found.all()
                and np.array_equal(value, vals)):
            raise AssertionError(f"round {rnd}: acknowledged puts did not "
                                 f"read back")
    # mixed planes: even rows overwrite a slot, the odd row after each
    # reads that slot back inside the same launch
    mixed = np.where(rows % 2 == 0, eng.OP_PUT,
                     eng.OP_GET).astype(np.int32).repeat(e, axis=1)
    pair_slots = slots[rows[:, 0] & ~1]
    vals2 = rng.integers(1, 2 ** 31 - 1, (k, e)).astype(np.int32)
    committed, get_ok, found, value = timed(
        lambda: svc.execute(mixed, pair_slots, vals2))
    n_ops += k * e
    if not (committed[0::2].all() and get_ok[1::2].all()
            and found[1::2].all()):
        raise AssertionError("mixed flush: ops not served")
    if not np.array_equal(value[1::2], vals2[0::2]):
        raise AssertionError("mixed flush: a read missed the put before it")

    # keyed surface on a subset, with each subset ensemble's leader down
    sub = rng.choice(e, 256, replace=False)
    keys = [f"user:{i}" for i in range(48)]
    puts = {}
    for ens in sub.tolist():
        vals = [f"v{ens}:{i}" for i in range(len(keys))]
        puts[ens] = (svc.kput_many(ens, keys, vals), vals)
    timed(svc.flush)
    for ens, (fut, _) in puts.items():
        if not (fut.done and all(r[0] == "ok" for r in fut.value)):
            raise AssertionError(f"kput_many on {ens}: {fut.value!r}")
    old_leader = svc.leader_np[sub].copy()
    for ens in sub.tolist():
        svc.set_peer_up(ens, int(svc.leader_np[ens]), False)
    gets = {ens: svc.kget_many(ens, keys) for ens in sub.tolist()}
    timed(svc.flush)
    n_ops += 2 * len(sub) * len(keys)
    if (svc.leader_np[sub] == old_leader).any():
        raise AssertionError("a down leader was not replaced")
    for ens, fut in gets.items():
        want = [("ok", v) for v in puts[ens][1]]
        if fut.value != want:
            raise AssertionError(f"kget_many on {ens} after the election "
                                 f"did not read the puts back")
    launches = cuda_quorum.quorum_launches
    torch.cuda.synchronize()
    mem = torch.cuda.memory_allocated(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    state_bytes = sum(t.numel() * t.element_size() for t in svc.state)
    ex_ms = flush_ms[1:5]     # execute flushes after the electing one
    ex_ops_s = 4 * k * e / (sum(ex_ms) / 1e3)
    print(f"service {e}x{m}x{s} K={k} [{card}]: execute flush median "
          f"{statistics.median(ex_ms):.3f} ms, {ex_ops_s:.1f} ops/s "
          f"(4 steady flushes of {k * e} ops); first flush (10k "
          f"elections + puts) {flush_ms[0]:.3f} ms; keyed flushes "
          f"{flush_ms[5]:.3f} / {flush_ms[6]:.3f} ms "
          f"({len(sub)} ensembles x {len(keys)} keys)")
    print(f"service memory [{card}]: engine state {state_bytes} B, "
          f"allocated {mem} B, peak {peak} B; K1 launches {launches} "
          f"over {len(flush_ms)} flushes (K + 2 each)")
    if profile:
        profile_flush(svc, put, slots, card, profile)
    return launches


# ---------------------------------------------------------------------------
# Phase 5: read-modify-write and lease fast reads at full size

#: flush() calls within which 16 concurrent host-path increments of one
#: key must all land (the reference's storm bound, 4 calls per op)
STORM_N = 16
STORM_FLUSH_BOUND = 4 * STORM_N


def i32(x: np.ndarray) -> np.ndarray:
    """int32 wraparound of an int64 array."""
    return ((x + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int64)


def phase_rmw(dev: torch.device, card: str):
    e, m, s, k = E_FULL, M_FULL, S_FULL, K_FULL
    rng = np.random.default_rng(12)
    svc = BatchedEnsembleService(WallRuntime(), e, m, s, tick=None,
                                 max_ops_per_tick=k, device=dev)
    torch.cuda.synchronize()
    chk = LaunchCheck(svc)
    cuda_quorum.quorum_launches = 0            # this path's run

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3

    # (a) execute(): K rows of OP_RMW per ensemble over 8 hot slots,
    # each row rmw:add or rmw:max with an int32 operand; the first
    # launch also elects every ensemble.  Every row's computed value is
    # held against the int32 fold computed here, row by row.
    hot = 8
    rows = np.arange(k)[:, None]
    hot_slot = np.broadcast_to((rows % hot).astype(np.int32), (k, e)).copy()
    rmw = np.full((k, e), eng.OP_RMW, np.int32)
    ref = np.zeros((hot, e), np.int64)
    rmw_ms = []
    for rnd in range(2):
        code = np.where(rng.random((k, e)) < 0.5, funref.RMW_ADD,
                        funref.RMW_MAX).astype(np.int32)
        opd = rng.integers(-2 ** 30, 2 ** 30, (k, e)).astype(np.int32)
        (committed, _, _, value), ms = timed(
            lambda: svc.execute(rmw, hot_slot, opd, code))
        rmw_ms.append(ms)
        want = np.empty((k, e), np.int64)
        for j in range(k):
            cur = ref[j % hot]
            nxt = np.where(code[j] == funref.RMW_ADD, i32(cur + opd[j]),
                           np.maximum(cur, opd[j]))
            ref[j % hot] = want[j] = nxt
        if not committed.all():
            raise AssertionError(f"RMW round {rnd}: "
                                 f"{int((~committed).sum())} rows not "
                                 f"committed")
        if not np.array_equal(value, want):
            raise AssertionError(f"RMW round {rnd}: computed values differ "
                                 f"from the host's int32 fold")

    # (b) kmodify_many with every key four times: rmw:add then rmw:max,
    # each folded into one row per key (one flush each)
    pick = rng.choice(e, 256 + 64, replace=False).tolist()
    sub_b, sub_c = pick[:256], pick[256:]
    keys = [f"ctr:{i}" for i in range(8)]
    coalesced0 = svc.rmw_enqueue_coalesced
    many_ms = []
    for fun in (funref.ref("rmw:add", 3), funref.ref("rmw:max", 20)):
        futs = [svc.kmodify_many(ens, keys * 4, fun) for ens in sub_b]
        n, ms = timed(lambda: drive(svc, futs, 2))
        many_ms.append(ms)
        if n != 1:
            raise AssertionError(f"kmodify_many took {n} flush calls")
        for f in futs:
            if not all(r[0] == "ok" for r in f.value):
                raise AssertionError(f"kmodify_many: {f.value!r}")
    coalesced = svc.rmw_enqueue_coalesced - coalesced0
    if coalesced != 2 * 24 * len(sub_b):
        raise AssertionError(f"kmodify_many coalesced {coalesced} ops")

    # (c) host path: 16 concurrent increments by a callable of one key
    # on each of 64 ensembles (read -> fn -> CAS, chained, backed off)
    launches0 = chk.launches
    conflicts0 = svc.rmw_conflicts
    storm = {ens: [svc.kmodify(ens, "hot", lambda vsn, cur: cur + 1, 0,
                               retries=4 * STORM_N)
                   for _ in range(STORM_N)] for ens in sub_c}
    n_storm, storm_ms = timed(lambda: drive(
        svc, [f for fl in storm.values() for f in fl], STORM_FLUSH_BOUND))
    storm_launches = chk.launches - launches0
    for ens, fl in storm.items():
        if not all(f.value[0] == "ok" for f in fl):
            raise AssertionError(f"kmodify storm on {ens}: "
                                 f"{[f.value for f in fl]!r}")

    # (a) read-back: one execute() GET row per hot slot
    get = np.full((hot, e), eng.OP_GET, np.int32)
    (_, get_ok, found, value), get_ms = timed(
        lambda: svc.execute(get, hot_slot[:hot], np.zeros((hot, e),
                                                          np.int32)))
    if not (get_ok.all() and np.array_equal(found, ref != 0)
            and np.array_equal(np.where(found, value, 0), ref)):
        raise AssertionError("RMW slots did not read back the host's "
                             "int32 fold")

    # (d) every key written in (b) and (c), read while the leases the
    # last flush renewed hold: all served by the fast path
    hits0, miss0 = svc.read_fastpath_hits, svc.read_fastpath_misses
    t0 = time.perf_counter()
    got_b = [svc.kget_many(ens, keys) for ens in sub_b]
    got_c = [svc.kget_many(ens, ["hot"], want_vsn=True) for ens in sub_c]
    fast_s = time.perf_counter() - t0
    n_reads = len(sub_b) * len(keys) + len(sub_c)
    hits = svc.read_fastpath_hits - hits0
    if hits != n_reads or svc.read_fastpath_misses != miss0:
        raise AssertionError(
            f"fast reads: {hits} of {n_reads} served, misses "
            f"{svc.read_fastpath_miss_reasons}")
    for f in got_b:
        if not (f.done and f.value == [("ok", 20)] * len(keys)):
            raise AssertionError(f"kmodify_many keys read {f.value!r}")
    for ens, f in zip(sub_c, got_c):
        last = max(tuple(g.value[1]) for g in storm[ens])
        if not (f.done and f.value == [("ok", STORM_N, last)]):
            raise AssertionError(f"storm key on {ens} read {f.value!r}, "
                                 f"last acked vsn {last}")
    launches = cuda_quorum.quorum_launches
    print(f"rmw {e}x{m}x{s} K={k} [{card}]: execute OP_RMW flush "
          f"{rmw_ms[0]:.3f} ms (with {e} elections) / {rmw_ms[1]:.3f} ms "
          f"({k * e} ops each); read-back flush (K={hot}) "
          f"{get_ms:.3f} ms; kmodify_many flushes {many_ms[0]:.3f} / "
          f"{many_ms[1]:.3f} ms ({len(sub_b)} ensembles x {4 * len(keys)}"
          f" ops, {coalesced} coalesced)")
    print(f"rmw host path [{card}]: {len(sub_c)} ensembles x {STORM_N} "
          f"increments of one key in {n_storm} flush calls (bound "
          f"{STORM_FLUSH_BOUND}), {storm_launches} launches, "
          f"{storm_ms:.3f} ms, {svc.rmw_conflicts - conflicts0} CAS "
          f"conflicts retried")
    print(f"fast reads [{card}]: {n_reads} keys in {fast_s * 1e3:.3f} ms, "
          f"{fast_s / n_reads * 1e6:.3f} us/op; K1 launches {launches} "
          f"over {chk.launches} launches (K + 2 each)")
    return launches


def drive(svc: BatchedEnsembleService, futs, bound: int) -> int:
    """flush() until ``futs`` resolve; the number of calls, which must
    stay within ``bound``."""
    n = 0
    while not all(f.done for f in futs):
        if n >= bound:
            raise AssertionError(f"futures unresolved after {n} flush "
                                 f"calls")
        svc.flush()
        n += 1
    torch.cuda.synchronize()
    return n


def profile_flush(svc, kind, slots, card: str, path: str) -> None:
    """torch.profiler over one steady execute() flush: device kernel
    time by name and the device's busy share of the flush wall time."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    vals = np.ones(kind.shape, np.int32)
    svc.execute(kind, slots, vals)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc.execute(kind, slots, vals)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    # device rows only: the aten rows repeat their kernels' time
    kernels = [ev for ev in events
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(ev.self_device_time_total for ev in kernels)
    n_kern = sum(ev.count for ev in kernels)
    k1 = [ev for ev in kernels if "quorum_met_kernel" in ev.key]
    k1_n = sum(ev.count for ev in k1)
    k1_us = sum(ev.self_device_time_total for ev in k1) / max(k1_n, 1)
    table = events.table(sort_by="self_device_time_total", row_limit=25)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"[{card}] one execute() flush, wall {wall_us:.1f} us, "
                f"device kernel time {dev_us:.1f} us\n{table}\n")
    print(f"profile [{card}]: flush wall {wall_us:.1f} us (profiled), "
          f"device kernel time {dev_us:.1f} us (busy "
          f"{dev_us / wall_us:.3f}), {n_kern} kernels; K1 {k1_n} "
          f"launches, {k1_us:.3f} us device time each")
    # host enqueue of the fused step alone vs the device finishing it
    dev = svc.device
    e = svc.n_ens

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    args = (t(np.zeros(e, bool)), t(np.zeros(e, np.int32)), t(kind),
            t(slots), t(vals), t(np.ones(kind.shape, bool)), svc._up_device())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svc.state, _, _ = eng.full_step(svc.state, *args)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"profile [{card}]: full_step host enqueue "
          f"{(t1 - t0) * 1e3:.3f} ms, then device drain "
          f"{(t2 - t1) * 1e3:.3f} ms")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    profile = (argv[argv.index("--profile") + 1]
               if "--profile" in argv else None)
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    secs = build.build_all()
    print(f"build: {time.perf_counter() - t0:.3f} s wall "
          f"({', '.join(f'{n}.cu {v:.3f} s' for n, v in secs.items())})")
    for name, text in build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    k1 = phase_k1(dev)
    cuda_quorum.quorum_s_launches = 0
    k2 = phase_k2(dev, profile)
    k2_launches = cuda_quorum.quorum_s_launches
    phase_engine(dev)
    cuda_quorum.quorum_s_launches = 0
    by_path = {"phase4 keyed service": phase_service(dev, card, profile),
               "phase5 rmw + fast reads": phase_rmw(dev, card)}
    k2_main = cuda_quorum.quorum_s_launches
    if not all(by_path.values()):
        raise AssertionError(f"K1 did not launch on a path: {by_path}")
    kernels = [{
        "name": "K1 quorum_met_e", "route": "cuda",
        "source": "riak_ensemble_tpu_torch/csrc/quorum.cu",
        "replaces": "riak_ensemble_tpu/ops/pallas_quorum.py:172",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": None}, {
        "name": "K2 quorum_met_s", "route": "cuda",
        "source": "riak_ensemble_tpu_torch/csrc/quorum.cu",
        "replaces": "riak_ensemble_tpu/ops/pallas_quorum.py:83",
        "launches": k2_launches, "main_path_launches": k2_main,
        "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
        "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"], "library_ms": None}]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
