"""Chip smoke test of riak_ensemble_tpu_torch on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit (``nvcc``)::

    python3 chip_smoke.py [--profile PATH]

Phases (each raises on failure, so any failure exits non-zero):

1. build every CUDA kernel of the package from ``csrc/`` with nvcc and,
   at the same time, the service's host passes (``csrc/host/*.cc``) with
   g++;
2. hold kernel K1 (``ops/cuda_quorum.py``) against its plain torch
   version on the card — exact equality — at the main-path shape and
   the edge cases, and time both;
2b. the same for kernel K2 (the shared-mask quorum predicate, every
   required mode), which no service path calls;
3. run the fused engine step on CUDA (kernel F1) and on the CPU (plain
   version) over one seeded op stream and require every state plane
   and result field to be bit-equal;
3b. hold F1 (``ops/cuda_engine.py``, ``csrc/engine_step.cu``) against
   its plain version ``full_step_plain`` on the card, bit for bit on
   every state plane, ``won`` and every result plane, at the headline
   shape and the edge shapes (E = 10,001, M = 3 / 7 / 32, joint views,
   K = 0 and 1, S = 16 / 33 / 1,024, no election), over seeded streams
   with down leaders and peers, every RMW code at the int32 edges,
   invalid slots, tombstones and out-of-band damage to objects, leaves
   and upper nodes; time F1 and its plain version;
3c. the anti-entropy exchange at full size: damage replicas in a
   service, check that the corruption-triggered exchange and
   ``scrub()`` heal them, that K1 launches on this path, and that
   ``repairs``, ``corruptions``, ``_corrupt_rows``, the scrub reports
   and the state equal a CPU service driven through the same sequence;
4. drive the keyed service at full size — 10,000 ensembles x 5 peers x
   128 slots, K = 64 — through ``execute()`` and ``kput_many`` /
   ``kget_many`` with a peer down, read every acknowledged put back,
   and require F1 to launch exactly once per launch and K1 never;
5. at the same size, read-modify-write and lease fast reads: ``OP_RMW``
   rows through ``execute()`` checked against int32 sums and maxima
   computed on the host, ``kmodify_many`` with duplicate keys
   (coalesced), 16 concurrent host-path ``kmodify`` increments of one
   key on each of 64 ensembles (exactly +16 within a stated flush
   bound), and ``kget_many`` of everything written, served by the fast
   path and checked against the acknowledged values;
6. active-column compaction and the launch pipeline: (a) F1 in sliced
   mode against ``full_step_sliced_plain`` on the card, bit for bit, at
   the headline shape with a lone active column, 256 and 2,048 (each with
   electing rows and row E - 1 active before the pads) and at the edge
   shapes of 3b, timed at A = 256 and 2,048; (b) the keyed service at
   the headline size with 256 of 10,000 ensembles active, compacted
   against ``compact=False`` (equal results; payload bytes, sliced and F1
   launches, median flush time per arm); (c) a stream of K = 64 flushes
   through ``execute_async`` at depth 2 against ``execute`` at depth 1
   (equal results and final state; wall per flush; the host's settle of
   launch N returning while launch N + 1 still runs on the card);
7. the host passes of the service's default arm: (a) one mixed keyed
   flush of the phase-4 pattern with a sliced A = 256 payload and a
   full-width one, and one flush of phase 5's RMW traffic (RMW and CAS
   rows, sliced A = 512), the inputs of every pass (the pending-slab
   pack, the completion-slab gather, the unpack, the mirror scatter) replayed
   through the C++ pass and its plain version, equal byte for byte and
   timed per call; (b) the phase-4 keyed pattern and the 6(c) execute
   stream at depth 1 and 2 on the default arm and on
   ``native_enqueue=False, native_resolve=False``: equal futures, mirror
   slabs, engine state and exchange counters, one completion-slab wake
   per settled flush with ops, the median flush and the host split per
   arm;
8. durable acks, at the headline shape on the default arm with a data
   dir per run (``tempfile.mkdtemp()``, ``wal_sync="fsync"``): (a) 6(b)'s
   keyed pattern with bytes payloads at depth 1 and 2 — the host split
   with its ``wal`` stage, WAL records, bytes and fsyncs per flush — then
   the service dropped without a save and restored on the card: every
   acknowledged put reads back and a new write commits; (b) ``save`` then
   ``restore``, every state plane ``torch.equal``, both timed; (c) one
   keyed flush's WAL records through the C++ encode + ``log_arena`` and
   through the Python walk + ``log``: arena byte-equal to the protocol-4
   pickles, equal store contents, byte-identical files; (d) 6(c)'s stream
   with a data dir, 2 flushes at depth 1 and 2 at depth 2 (WAL ms and
   records per flush); (e) a launch failure injected through ``engine=``:
   its ops fail, the stepped state stands (the donated contract), the
   next flush serves.  6(c) also runs its stream as CUDA int32 planes
   (device-resident ``execute``): bit-equal results, no op-plane byte
   staged for the device.

Phases 4-8 run the service's default (native) host arm.

It prints the card (``nvidia-smi``), one JSON line of kernel numbers
(with the host passes' times under ``host``), and as its last line
``{"ok": true, "device": {...}}``.  It exits
non-zero without that line when no CUDA device is visible.  With
``--profile PATH`` it also traces one full-size flush with
torch.profiler (kernels per flush, device time, F1's device time per
launch) and writes the table to PATH, and prints the device's busy share
of the depth-1 and depth-2 streams of phase 6(c).
"""

import gc
import json
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from riak_ensemble_tpu_torch import funref, interop
from riak_ensemble_tpu_torch.ops import build
from riak_ensemble_tpu_torch.ops import cuda_engine, cuda_quorum
from riak_ensemble_tpu_torch.ops import engine as eng
from riak_ensemble_tpu_torch.ops.quorum import REQUIRED_MODES
from riak_ensemble_tpu_torch.parallel import enqueue_native, resolve_native
from riak_ensemble_tpu_torch.parallel.batched_host import (
    BatchedEnsembleService, WallRuntime, _LocalEngine)
from riak_ensemble_tpu_torch.parallel.wal import ServiceWAL

#: H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
#: The kernels do int32 arithmetic outside the tensor cores.  An H100 SM
#: issues 64 int32 operations per clock (half its 128 float32 lanes):
#: 132 SMs x 64 x 1.98 GHz.  (The data sheet's 67 TFLOP/s float32 row
#: counts a fused multiply-add as two operations.)
INT32_OPS_PER_S = 132 * 64 * 1.98e9

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
    dev_us = device_us_per_launch(
        lambda: cuda_quorum.quorum_met_e(valid, nack, mask),
        "quorum_met_kernel")
    print(f"K1 at [10000, 5], V=2: kernel {k1_ms:.6f} ms, plain "
          f"{plain_ms:.6f} ms, {dev_us:.3f} us device time per launch, "
          f"bound {bound_ms * 1e3:.4f} us ({nbytes} B)")
    return {"ms": k1_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err": 0, "device_us": dev_us}


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
    ``name``, from torch.profiler over ``n`` back-to-back calls (averaged
    over the launches the trace holds: it may drop one of a window)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages() if name in ev.key]
    count = sum(ev.count for ev in evs)
    if not n - 2 <= count <= n:
        raise AssertionError(f"profiler saw {count} of {n} launches of "
                             f"{name}")
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
    cuda_engine.engine_step_launches = 0
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
    if cuda_engine.engine_step_launches != 8:
        raise AssertionError(f"F1 launched {cuda_engine.engine_step_launches}"
                             f" times over 8 CUDA steps")
    print(f"engine CUDA (F1) == CPU: E={e} M={m} S={s} K={k}, 8 steps, "
          f"commits={int(st_cpu.obj_seq_ctr.sum())}, "
          f"corrupt flags={flagged}")


# ---------------------------------------------------------------------------
# Phase 3b: F1 against its plain version

I32_MAX, I32_MIN = 2 ** 31 - 1, -2 ** 31

#: (name, E, M, S, K, views, steps, elect every step)
F1_CASES = [
    ("headline 10000x5x128 K=64", E_FULL, M_FULL, S_FULL, K_FULL, None, 3,
     True),
    ("E=10001", 10_001, 5, 128, 8, None, 2, True),
    ("M=3", 2048, 3, 128, 8, None, 3, True),
    ("M=7 S=33 (unaligned object rows, short level)", 2048, 7, 33, 8, None,
     3, True),
    ("M=32 S=16 (one level, 8 warps)", 512, 32, 16, 8, None, 3, True),
    ("joint views", 2048, 5, 128, 8, [[0, 1, 2], [1, 2, 3, 4]], 3, True),
    ("K=0 (election only)", 4096, 5, 128, 0, None, 3, True),
    ("K=1", 4096, 5, 128, 1, None, 3, True),
    ("S=16 (small)", 4096, 5, 16, 8, None, 3, True),
    ("S=1024 (large)", 1024, 5, 1024, 16, None, 2, True),
    ("no election: kv_step_scan, then kv_step", 2048, 5, 128, 8, None, 3,
     False),
]


def f1_stream(rng: np.random.Generator, leader: np.ndarray, e: int, m: int,
              s: int, k: int):
    """One step's full_step inputs: elections with bogus candidates, down
    leaders and down peers, every op kind and RMW code (and one unknown
    code), operands at the int32 edges, invalid slots and tombstones;
    one column in seven runs put/RMW-add at INT32_MAX and put/RMW-sub at
    INT32_MIN on one slot, so the wraparound is certain to run."""
    up = rng.random((e, m)) < 0.9
    down = (rng.random(e) < 0.15) & (leader >= 0) & (leader < m)
    up[np.nonzero(down)[0], leader[down]] = False
    elect = rng.random(e) < 0.5
    cand = rng.integers(-1, m + 1, e).astype(np.int32)
    kind = rng.integers(0, 5, (k, e)).astype(np.int32)
    slot = rng.integers(-2, s + 2, (k, e)).astype(np.int32)
    val = rng.integers(-1000, 1000, (k, e)).astype(np.int32)
    edge = rng.random((k, e))
    val[edge < 0.1] = 0
    val[(edge >= 0.1) & (edge < 0.15)] = I32_MAX
    val[(edge >= 0.15) & (edge < 0.2)] = I32_MIN
    exp_e = np.where(kind == eng.OP_RMW, rng.integers(0, 10, (k, e)),
                     rng.integers(0, 3, (k, e))).astype(np.int32)
    exp_s = rng.integers(0, 4, (k, e)).astype(np.int32)
    lease = rng.random((k, e)) < 0.3
    cols = np.arange(0, e, 7)
    for j, (op, v, fn) in enumerate([
            (eng.OP_PUT, I32_MAX, 0), (eng.OP_RMW, I32_MAX, eng.RMW_ADD),
            (eng.OP_PUT, I32_MIN, 0), (eng.OP_RMW, 1, eng.RMW_SUB)][:k]):
        kind[j, cols], slot[j, cols], val[j, cols] = op, 3 % s, v
        exp_e[j, cols] = fn
    return elect, cand, kind, slot, val, lease, up, exp_e, exp_s


def damage(rng: np.random.Generator, states, n: int) -> None:
    """The same out-of-band damage on every state: object values, leaf
    lanes and upper-node lanes of random replicas."""
    st = states[0]
    e, m, s = st.obj_val.shape
    u = st.tree_node.shape[2]
    picks = [(rng.integers(0, e, n), rng.integers(0, m, n),
              rng.integers(0, s, n)) for _ in range(2)]
    nodes = (rng.integers(0, e, n), rng.integers(0, m, n),
             rng.integers(0, u, n))
    lane = rng.integers(0, 4, n)
    for st in states:
        dev = st.obj_val.device

        def ix(t):
            return torch.as_tensor(t, device=dev, dtype=torch.int64)
        a, b, c = map(ix, picks[0])
        st.obj_val[a, b, c] += 1
        a, b, c = map(ix, picks[1])
        st.tree_leaf[a, b, c, ix(lane)] ^= 1 << 9
        a, b, c = map(ix, nodes)
        st.tree_node[a, b, c, ix(lane)] ^= 3


def diff_fields(a, b, fields) -> list:
    """Fields whose planes differ (compared on the host, bit for bit)."""
    return [f for f in fields
            if not torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())]


def copy_state(st):
    return eng.EngineState(*(t.clone() for t in st))


def f1_case(dev, name, e, m, s, k, views, steps, elect_every, seed):
    """Run one case's steps through F1 and through the plain version
    from the same state; raise on any difference.  Returns counts of
    what the stream exercised."""
    rng = np.random.default_rng(seed)
    st_f1 = eng.init_state(e, m, s, views=views, device=dev)
    st_pl = copy_state(st_f1)
    stats = {"won": 0, "commits": 0, "corrupt": 0, "get_ok": 0}
    for step in range(steps):
        if step:
            damage(rng, (st_f1, st_pl), max(e // 40, 4))
        leader = st_pl.leader.cpu().numpy()
        planes = [torch.from_numpy(p).to(dev)
                  for p in f1_stream(rng, leader, e, m, s, k)]
        elect, cand, kind, slot, val, lease, up, exp_e, exp_s = planes
        if elect_every or step == 0:
            st_f1, won_f, res_f = eng.full_step(
                st_f1, elect, cand, kind, slot, val, lease, up,
                exp_epoch=exp_e, exp_seq=exp_s)
            st_pl, won_p, res_p = eng.full_step_plain(
                st_pl, elect, cand, kind, slot, val, lease, up,
                exp_epoch=exp_e, exp_seq=exp_s)
            if not torch.equal(won_f.cpu(), won_p.cpu()):
                raise AssertionError(f"F1 {name}, step {step}: won differs")
            stats["won"] += int(won_p.sum())
        elif step == 1:
            st_f1, res_f = eng.kv_step_scan(st_f1, kind, slot, val, lease,
                                            up, exp_e, exp_s)
            st_pl, res_p = eng.kv_step_scan_plain(st_pl, kind, slot, val,
                                                  lease, up, exp_e, exp_s)
        else:
            row = [t[0] for t in (kind, slot, val, lease, exp_e, exp_s)]
            st_f1, res_f = eng.kv_step(st_f1, *row[:4], up, *row[4:])
            st_pl, res_p = eng.kv_step_scan_plain(
                st_pl, *(t[None] for t in row[:4]), up,
                *(t[None] for t in row[4:]))
            res_p = eng.KvResult(*(t[0] for t in res_p))
        torch.cuda.synchronize()
        bad = (diff_fields(st_f1, st_pl, eng.EngineState._fields)
               + diff_fields(res_f, res_p, eng.KvResult._fields))
        if bad:
            raise AssertionError(f"F1 {name}, step {step}: {bad} differ "
                                 f"from the plain version")
        stats["commits"] += int(res_p.committed.sum())
        stats["corrupt"] += int(res_p.tree_corrupt.sum())
        stats["get_ok"] += int(res_p.get_ok.sum())
    return stats


def f1_work(st, up: np.ndarray, committed: np.ndarray,
            rows: Optional[np.ndarray] = None) -> tuple:
    """(bytes, int32 ops) F1 needs for one full_step on these inputs —
    for a sliced step, of the ``rows`` it steps (``committed`` is then
    A-wide, its pad columns never commit).  Bytes: every state plane of
    the stepped rows read once and the ballot, object and tree planes
    written once, every input and result plane once.  Ops: per ensemble
    and round, the integrity gate of every replica (its leaf hash and one
    16-child fold per upper level) and, for every replica that commits
    (this run's commits x the ensemble's up members), the new leaf hash
    and its path's folds; read repairs are not counted."""
    e, m, s = st.obj_val.shape
    u = st.tree_node.shape[2]
    v = st.view_mask.shape[1]
    k, a = committed.shape
    heard = up & st.view_mask.any(1).cpu().numpy()
    if rows is not None:
        e = len(rows)
        heard = heard[rows]
        committed = committed[:, :e]
    nlev = len(eng.tree_sizes(s))
    rw = 3 * e * m * s * 4 + e * m * s * 16 + e * m * u * 16 + 2 * e * m * 4 \
        + 2 * e * 4
    nbytes = (2 * rw + e * v * m + e * m + 5 * a
              + k * a * (5 * 4 + 1)                  # op planes
              + k * a * (4 + 4 + 8 + m) + a)         # results, won
    # a fold: 16 children x 4 lanes x (xor, mul, add, 8 for fmix, sum)
    # plus 4 lanes x 19 for the stir and seal; a leaf hash 4 x 13
    fold, leaf = 16 * 4 * 12 + 4 * 19, 4 * 13
    writers = int((committed * heard.sum(1)[None, :]).sum())
    ops = k * e * m * (leaf + 4 + nlev * (fold + 4)) \
        + writers * (leaf + nlev * fold)
    return nbytes, ops


def bound(nbytes: int, ops: int) -> tuple:
    """(bytes ms, int32 ops ms, bound ms) at the card's published peaks."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return bytes_ms, ops_ms, max(bytes_ms, ops_ms)


def phase_f1(dev: torch.device, card: str):
    for i, (name, e, m, s, k, views, steps, every) in enumerate(F1_CASES):
        t0 = time.perf_counter()
        stats = f1_case(dev, name, e, m, s, k, views, steps, every, 100 + i)
        print(f"F1 == plain  {name}: E={e} M={m} S={s} K={k}, {steps} "
              f"steps, {stats} ({time.perf_counter() - t0:.1f} s)")
        if k and not (stats["commits"] and stats["corrupt"]):
            raise AssertionError(f"F1 case {name} exercised no commits or "
                                 f"no integrity flags: {stats}")
    # timing at the headline shape
    e, m, s, k = E_FULL, M_FULL, S_FULL, K_FULL
    rng = np.random.default_rng(99)
    st = eng.init_state(e, m, s, device=dev)
    planes = [torch.from_numpy(p).to(dev) for p in f1_stream(
        rng, np.full(e, -1, np.int32), e, m, s, k)]
    args = planes[:7]
    kw = {"exp_epoch": planes[7], "exp_seq": planes[8]}
    st, _, res = eng.full_step(st, *args, **kw)    # elect, fill the store
    torch.cuda.synchronize()
    f1_ms = cuda_ms(lambda: eng.full_step(st, *args, **kw), iters=10)
    st_pl = copy_state(st)
    plain_ms = cuda_ms(lambda: eng.full_step_plain(st_pl, *args, **kw),
                       iters=1, reps=3)
    nbytes, ops = f1_work(st, planes[6].cpu().numpy(),
                          res.committed.cpu().numpy())
    bytes_ms, ops_ms, bound_ms = bound(nbytes, ops)
    dev_us = device_us_per_launch(lambda: eng.full_step(st, *args, **kw),
                                  "engine_step_kernel", n=20)
    print(f"F1 at {e}x{m}x{s} K={k} [{card}]: full_step {f1_ms:.6f} ms per "
          f"call back to back, {dev_us:.3f} us device time per launch; "
          f"plain {plain_ms:.3f} ms; bound {bound_ms:.6f} ms = max(bytes "
          f"{nbytes} B -> {bytes_ms:.6f} ms, int32 ops {ops} -> "
          f"{ops_ms:.6f} ms)")
    return {"ms": f1_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err": 0, "device_us": dev_us}


# ---------------------------------------------------------------------------
# Phase 3c: the anti-entropy exchange at full size, CUDA against CPU


class FixedClock:
    """A runtime whose clock only the caller moves: the CUDA and CPU
    services see the same lease times."""

    def __init__(self) -> None:
        self.now = 100.0

    def schedule(self, delay, fn):
        raise RuntimeError("caller-driven flush only")


def phase_exchange(dev: torch.device, card: str, e: int = E_FULL,
                   m: int = M_FULL, s: int = S_FULL) -> int:
    """Damage replicas, read the hot slot (corruption-triggered exchange),
    scrub twice; the CUDA service must match a CPU service driven through
    the same sequence.  Returns K1's launches on the CUDA path."""
    k = 4
    rng = np.random.default_rng(13)
    svcs = [BatchedEnsembleService(FixedClock(), e, m, s, tick=None,
                                   max_ops_per_tick=k, device=d)
            for d in (dev, "cpu")]
    put = np.full((k, e), eng.OP_PUT, np.int32)
    slots = np.broadcast_to(np.arange(k, dtype=np.int32)[:, None],
                            (k, e)).copy()
    vals = rng.integers(1, 2 ** 31 - 1, (k, e)).astype(np.int32)
    hot = np.arange(0, e, 3)       # slot 0 object on replica 1
    node = np.arange(0, e, 5)      # replica 2's first upper node
    cold = np.arange(0, e, 11)     # slot 2 object on replica 3: never read
    out = []
    for svc in svcs:
        committed, _, _, _ = svc.execute(put, slots, vals)
        if not committed.all():
            raise AssertionError("exchange phase: puts not acknowledged")
        st, d = svc.state, svc.state.obj_val.device
        st.obj_val[torch.as_tensor(hot, device=d), 1, 0] += 7
        st.tree_node[torch.as_tensor(node, device=d), 2, 0, 1] ^= 0x55
        st.obj_val[torch.as_tensor(cold, device=d), 3, 2] += 1
    for i, svc in enumerate(svcs):
        if i == 0:
            torch.cuda.synchronize()
            cuda_quorum.quorum_launches = 0     # the exchange path's run
            cuda_engine.engine_step_launches = 0
        svc.lease_until[:] = 0.0
        got = svc.execute(np.full((1, e), eng.OP_GET, np.int32),
                          np.zeros((1, e), np.int32),
                          np.zeros((1, e), np.int32))
        after_read = (svc.corruptions, svc.repairs,
                      svc._corrupt_rows.copy())
        reports = [svc.scrub(), svc.scrub()]
        if i == 0:
            torch.cuda.synchronize()
            k1 = cuda_quorum.quorum_launches
            f1 = cuda_engine.engine_step_launches
        out.append((got, after_read, reports, svc.corruptions,
                    svc.repairs, svc._corrupt_rows.copy()))
    (got, after_read, reports, corr, rep, rows), cpu = out
    _, value = got[0], got[3]
    if not (got[1].all() and np.array_equal(value[0], vals[0])):
        raise AssertionError("exchange phase: the damaged slot did not "
                             "read back")
    if not (after_read[0] > 0 and not after_read[2].any()):
        raise AssertionError(f"exchange phase: detection / sync wrong: "
                             f"{after_read}")
    first, second = reports
    if not (first["replicas_damaged"] > 0
            and first["replicas_healed"] == first["replicas_damaged"]
            and second == {"replicas_damaged": 0, "replicas_healed": 0,
                           "ensembles_swept": 0}):
        raise AssertionError(f"exchange phase: scrub reports {reports}")
    if any(bad.any() for bad in eng.verify_trees(svcs[0].state)):
        raise AssertionError("exchange phase: damage left after the scrub")
    for a, b in zip(got, cpu[0]):
        if not np.array_equal(a, b):
            raise AssertionError("exchange phase: read results differ CUDA "
                                 "vs CPU")
    if not (after_read[:2] == cpu[1][:2]
            and np.array_equal(after_read[2], cpu[1][2])
            and reports == cpu[2] and (corr, rep) == cpu[3:5]
            and np.array_equal(rows, cpu[5])):
        raise AssertionError(f"exchange phase: counters differ CUDA vs "
                             f"CPU: {out[0][1:5]} vs {cpu[1:5]}")
    bad = diff_fields(svcs[0].state, svcs[1].state, eng.EngineState._fields)
    if bad:
        raise AssertionError(f"exchange phase: state planes {bad} differ "
                             f"CUDA vs CPU")
    if k1 != 2 or f1 != 1:
        raise AssertionError(f"exchange phase: K1 launched {k1} times (want "
                             f"2: the launch's exchange and the scrub's), "
                             f"F1 {f1} (want 1)")
    print(f"exchange {e}x{m}x{s} [{card}]: read flush flagged "
          f"{after_read[0]} replicas, exchange repairs {after_read[1]}; "
          f"scrub {first}; then {second}; corruptions {corr}, repairs "
          f"{rep} — equal to the CPU run; K1 launches {k1}, F1 {f1}")
    return k1


# ---------------------------------------------------------------------------
# Phase 4: the keyed service at full size


class LaunchCheck:
    """Holds the enqueue half of every launch of ``svc`` to one F1 launch
    and no K1 launch (a flush() that chains follow-up launches is checked
    per launch) and counts the launches."""

    def __init__(self, svc: BatchedEnsembleService) -> None:
        self.launches = 0
        launch = svc._launch_enqueue

        def checked(*args, **kwargs):
            f1, k1 = cuda_engine.engine_step_launches, \
                cuda_quorum.quorum_launches
            out = launch(*args, **kwargs)
            got = (cuda_engine.engine_step_launches - f1,
                   cuda_quorum.quorum_launches - k1)
            if got != (1, 0):
                raise AssertionError(f"a launch ran F1 {got[0]} times and "
                                     f"K1 {got[1]} times, want 1 and 0")
            self.launches += 1
            return out
        svc._launch_enqueue = checked


def reset_counts() -> None:
    """Every kernel's launch count to 0, just before a path runs."""
    cuda_engine.engine_step_launches = 0
    cuda_engine.engine_step_sliced_launches = 0
    cuda_quorum.quorum_launches = 0
    cuda_quorum.quorum_s_launches = 0


def read_counts() -> dict:
    return {"F1": cuda_engine.engine_step_launches,
            "F1 sliced": cuda_engine.engine_step_sliced_launches,
            "K1": cuda_quorum.quorum_launches,
            "K2": cuda_quorum.quorum_s_launches}


def phase_service(dev: torch.device, card: str,
                  profile: Optional[str] = None):
    e, m, s, k = E_FULL, M_FULL, S_FULL, K_FULL
    rng = np.random.default_rng(11)
    torch.cuda.reset_peak_memory_stats(dev)
    svc = BatchedEnsembleService(WallRuntime(), e, m, s, tick=None,
                                 max_ops_per_tick=k, device=dev)
    torch.cuda.synchronize()
    chk = LaunchCheck(svc)
    reset_counts()                             # the main path's run
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
    counts = read_counts()
    if counts["F1"] != chk.launches:
        raise AssertionError(f"phase 4: F1 launched {counts['F1']} times "
                             f"in {chk.launches} service launches")
    torch.cuda.synchronize()
    mem = torch.cuda.memory_allocated(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    state_bytes = sum(t.numel() * t.element_size() for t in svc.state)
    ex_ms = flush_ms[1:5]     # execute flushes after the electing one
    ex_ops_s = 4 * k * e / (sum(ex_ms) / 1e3)
    print(f"service {e}x{m}x{s} K={k} [{card}]: execute flush median "
          f"{statistics.median(ex_ms):.3f} ms, {ex_ops_s:.1f} ops/s "
          f"(all ops of 4 steady flushes of {k * e} over their summed "
          f"time); first flush (10k "
          f"elections + puts) {flush_ms[0]:.3f} ms; keyed flushes "
          f"{flush_ms[5]:.3f} / {flush_ms[6]:.3f} ms "
          f"({len(sub)} ensembles x {len(keys)} keys)")
    print(f"service memory [{card}]: engine state {state_bytes} B, "
          f"allocated {mem} B, peak {peak} B; launches {counts} over "
          f"{len(flush_ms)} flushes")
    if profile:
        profile_flush(svc, put, slots, card, profile)
    return counts


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
    reset_counts()                             # this path's run

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
    counts = read_counts()
    if counts["F1"] != chk.launches:
        raise AssertionError(f"phase 5: F1 launched {counts['F1']} times "
                             f"in {chk.launches} service launches")
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
          f"{fast_s / n_reads * 1e6:.3f} us/op; launches {counts} over "
          f"{chk.launches} service launches")
    return counts


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


# ---------------------------------------------------------------------------
# Phase 6: active-column compaction and the launch pipeline

#: (name, E, M, S, K, views, steps, real rows, bucket, row E - 1 active)
F1_SLICED_CASES = [
    ("headline, a lone column", E_FULL, M_FULL, S_FULL, K_FULL, None, 2, 1,
     8, True),
    ("headline, 256 active", E_FULL, M_FULL, S_FULL, K_FULL, None, 3, 250,
     256, True),
    ("headline, 2048 active", E_FULL, M_FULL, S_FULL, K_FULL, None, 2,
     2000, 2048, True),
    ("headline, 256 active, row E-1 idle after the first step", E_FULL,
     M_FULL, S_FULL, K_FULL, None, 3, 250, 256, False),
    ("M=3", 2048, 3, 128, 8, None, 3, 120, 128, True),
    ("M=7 S=33 (unaligned object rows, short level)", 2048, 7, 33, 8, None,
     3, 120, 128, True),
    ("M=32 S=16 (one level, 8 warps)", 512, 32, 16, 8, None, 3, 60, 64,
     True),
    ("joint views", 2048, 5, 128, 8, [[0, 1, 2], [1, 2, 3, 4]], 3, 120, 128,
     True),
    ("K=0 (election only)", 4096, 5, 128, 0, None, 2, 500, 512, True),
    ("K=1", 4096, 5, 128, 1, None, 3, 500, 512, True),
]


def sliced_inputs(rng: np.random.Generator, leader: np.ndarray, e: int,
                  m: int, s: int, k: int, n_real: int, bucket: int,
                  last_active: bool, elect_all: bool):
    """A sliced step's inputs: ``n_real`` distinct active rows (row E - 1
    among them when ``last_active``) then pads (index E) up to
    ``bucket``; the phase 3b stream's planes taken at those columns,
    the pads NOOP and not electing."""
    pool = e - 1
    rows = rng.choice(pool, n_real - last_active, replace=False)
    if last_active:
        rows = np.append(rows, e - 1)
    active = np.full(bucket, e, np.int32)
    active[:n_real] = np.sort(rows)
    real = active < e
    col = np.minimum(active, e - 1)
    elect, cand, kind, slot, val, lease, up, exp_e, exp_s = f1_stream(
        rng, leader, e, m, s, k)

    def cols(p):
        out = np.ascontiguousarray(p[:, col])
        out[:, ~real] = 0
        return out

    def vec(p):
        out = np.ascontiguousarray(p[col])
        out[~real] = 0
        return out
    if elect_all:       # every real row elects, with a valid candidate
        elect_a = real.copy()
        cand_a = np.where(real, up[col].argmax(1), 0).astype(np.int32)
    else:
        elect_a, cand_a = vec(elect), vec(cand)
    planes = [elect_a, cand_a, cols(kind), cols(slot), cols(val),
              cols(lease), up, cols(exp_e), cols(exp_s)]
    return active, planes


def f1_sliced_case(dev, name, e, m, s, k, views, steps, n_real, bucket,
                   last_active, seed):
    """Run one case's sliced steps through F1 and through
    ``full_step_sliced_plain`` from the same state; raise on any
    difference.  Returns counts of what the stream exercised."""
    rng = np.random.default_rng(seed)
    st_f1 = eng.init_state(e, m, s, views=views, device=dev)
    st_pl = copy_state(st_f1)
    stats = {"won": 0, "commits": 0, "corrupt": 0, "pad_quorum_ok": 0}
    for step in range(steps):
        if step:
            damage(rng, (st_f1, st_pl), max(n_real // 8, 4))
        # row E - 1 is active in the first step either way (it elects a
        # leader there), so an idle row E - 1 has a live ballot for the
        # pads to read
        active, planes = sliced_inputs(
            rng, st_pl.leader.cpu().numpy(), e, m, s, k, n_real, bucket,
            last_active or step == 0, elect_all=step == 0)
        t = [torch.from_numpy(p).to(dev) for p in planes]
        kw = {"exp_epoch": t[7], "exp_seq": t[8]}
        before = cuda_engine.engine_step_sliced_launches
        st_f1, won_f, res_f = eng.full_step_sliced(st_f1, active, *t[:7],
                                                   **kw)
        st_pl, won_p, res_p = eng.full_step_sliced_plain(st_pl, active,
                                                         *t[:7], **kw)
        torch.cuda.synchronize()
        if cuda_engine.engine_step_sliced_launches != before + 1:
            raise AssertionError(f"F1 sliced {name}: no sliced launch")
        if not torch.equal(won_f.cpu(), won_p.cpu()):
            raise AssertionError(f"F1 sliced {name}, step {step}: won "
                                 f"differs")
        bad = (diff_fields(st_f1, st_pl, eng.EngineState._fields)
               + diff_fields(res_f, res_p, eng.KvResult._fields))
        if bad:
            raise AssertionError(f"F1 sliced {name}, step {step}: {bad} "
                                 f"differ from full_step_sliced_plain")
        stats["won"] += int(won_p.sum())
        stats["commits"] += int(res_p.committed.sum())
        stats["corrupt"] += int(res_p.tree_corrupt.sum())
        stats["pad_quorum_ok"] += int(res_p.quorum_ok[:, n_real:].sum())
    return stats


def time_sliced(dev, card: str, n_real: int, bucket: int) -> dict:
    """Sliced F1 at the headline shape with ``n_real`` active rows in an
    A = ``bucket`` grid: ms per call back to back, device µs per launch,
    the plain version, and the bound of the stepped rows' work."""
    e, m, s, k = E_FULL, M_FULL, S_FULL, K_FULL
    rng = np.random.default_rng(98 + bucket)
    st = eng.init_state(e, m, s, device=dev)
    active, planes = sliced_inputs(rng, np.full(e, -1, np.int32), e, m, s,
                                   k, n_real, bucket, True, elect_all=True)
    t = [torch.from_numpy(p).to(dev) for p in planes]
    args, kw = t[:7], {"exp_epoch": t[7], "exp_seq": t[8]}
    st, _, res = eng.full_step_sliced(st, active, *args, **kw)  # elect, fill
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: eng.full_step_sliced(st, active, *args, **kw),
                 iters=10)
    dev_us = device_us_per_launch(
        lambda: eng.full_step_sliced(st, active, *args, **kw),
        "engine_step_kernel", n=20)
    st_pl = copy_state(st)
    plain_ms = cuda_ms(lambda: eng.full_step_sliced_plain(
        st_pl, active, *args, **kw), iters=1, reps=3)
    nbytes, ops = f1_work(st, planes[6], res.committed.cpu().numpy(),
                          rows=active[:n_real])
    bytes_ms, ops_ms, bound_ms = bound(nbytes, ops)
    print(f"F1 sliced at {e}x{m}x{s} K={k}, A={bucket} ({n_real} rows) "
          f"[{card}]: full_step_sliced {ms:.6f} ms per call back to back, "
          f"{dev_us:.3f} us device time per launch; plain {plain_ms:.3f} "
          f"ms; bound {bound_ms:.6f} ms = max(bytes {nbytes} B -> "
          f"{bytes_ms:.6f} ms, int32 ops {ops} -> {ops_ms:.6f} ms)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "device_us": dev_us, "rows": n_real, "max_abs_err": 0,
            "library_ms": None}


def phase_f1_sliced(dev: torch.device, card: str) -> dict:
    total = {"corrupt": 0, "pad_quorum_ok": 0}
    for i, case in enumerate(F1_SLICED_CASES):
        name, e, m, s, k, views, steps, n_real, bucket, last = case
        t0 = time.perf_counter()
        stats = f1_sliced_case(dev, name, e, m, s, k, views, steps, n_real,
                               bucket, last, 200 + i)
        print(f"F1 sliced == plain  {name}: E={e} M={m} S={s} K={k} "
              f"A={bucket} ({n_real} rows), {steps} steps, {stats} "
              f"({time.perf_counter() - t0:.1f} s)")
        if not stats["won"] or (k and not stats["commits"]):
            raise AssertionError(f"F1 sliced case {name} exercised no "
                                 f"election or no commit: {stats}")
        for key in total:
            total[key] += stats[key]
    if not all(total.values()):
        raise AssertionError(f"the sliced cases raised no integrity flag or "
                             f"no pad quorum: {total}")
    return {f"A={b}": time_sliced(dev, card, n, b)
            for n, b in ((250, 256), (2000, 2048))}


def keyed_rounds(svc: BatchedEnsembleService, dev: torch.device, sub: list,
                 keys: list, ms: list, enc=str) -> list:
    """The phase-4 keyed pattern on the ensembles ``sub``: three rounds of
    ``kput_many`` then ``kget_many`` of ``keys`` (every active leader down
    after the second round's puts), the reads after the leases lapse, then
    a damaged replica on three rows whose read flags it (the settle runs
    the exchange).  Payloads are ``enc(text)`` (str by default; phase 8
    passes bytes, the C++ WAL encode's subset).  Appends each flush's
    wall ms to ``ms``; returns every future's value, and raises when an
    acknowledged put does not read back."""
    results = []

    def timed_flush(futs):
        for _ in range(8):
            if all(f.done for f in futs):
                return
            t0 = time.perf_counter()
            svc.flush()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        raise AssertionError("keyed pattern: futures unresolved after 8 "
                             "flushes")
    for rnd in range(3):
        puts = [svc.kput_many(x, keys, [enc(f"v{rnd}:{x}:{i}")
                                        for i in range(len(keys))])
                for x in sub]
        timed_flush(puts)
        results.append([f.value for f in puts])
        if rnd == 1:            # every active leader down: elections
            for x in sub:
                svc.set_peer_up(x, int(svc.leader_np[x]), False)
        svc.runtime.now += 1.0  # leases lapse: the reads go round
        gets = [svc.kget_many(x, keys) for x in sub]
        timed_flush(gets)
        results.append([f.value for f in gets])
        want = [[("ok", enc(f"v{rnd}:{x}:{i}")) for i in range(len(keys))]
                for x in sub]
        if results[-1] != want:
            raise AssertionError(f"keyed pattern round {rnd}: acknowledged "
                                 f"puts did not read back")
    hot = sub[:3]
    slot = svc.key_slot[hot[0]]["user:0"]
    svc.state.obj_val[torch.as_tensor(hot, device=dev), 1, slot] += 5
    svc.runtime.now += 1.0
    gets = [svc.kget_many(x, ["user:0"]) for x in hot]
    timed_flush(gets)
    results.append([f.value for f in gets])
    return results


def phase_compaction_service(dev: torch.device, card: str) -> dict:
    """6(b): the keyed service at the headline size with 256 of 10,000
    ensembles active, ``compact=True`` against ``compact=False``: puts,
    a leader-down election, reads, and a damaged replica whose read
    flags it (the compacted exchange path).  Returns the launch counts
    of the compacted arm's run."""
    e, m, s, k = E_FULL, M_FULL, S_FULL, K_FULL
    rng = np.random.default_rng(14)
    sub = np.sort(rng.choice(e, 256, replace=False)).tolist()
    keys = [f"user:{i}" for i in range(48)]
    arms = {}
    for compact in (True, False):
        svc = BatchedEnsembleService(FixedClock(), e, m, s, tick=None,
                                     max_ops_per_tick=k, device=dev,
                                     compact=compact)
        svc.flush()                 # elect all 10,000: full width anyway
        torch.cuda.synchronize()
        svc.payload_bytes = svc.payload_bytes_full_width = 0
        svc._occ_sum, svc._occ_launches = 0.0, 0
        chk = LaunchCheck(svc)
        split = HostSplit(svc)
        reset_counts()                               # this path's run
        ms = []
        results = keyed_rounds(svc, dev, sub, keys, ms)
        counts = read_counts()
        if counts["F1"] != chk.launches:
            raise AssertionError(f"6(b): F1 launched {counts['F1']} times in "
                                 f"{chk.launches} launches")
        arms[compact] = {
            "results": results, "ms": ms, "counts": counts,
            "launches": chk.launches, "sliced": svc.sliced_launches,
            "payload": svc.payload_bytes,
            "full": svc.payload_bytes_full_width,
            "occupancy": svc.grid_occupancy,
            "healed": (svc.corruptions, svc.repairs),
            "split": split.take(), "state": svc.state}
    on, off = arms[True], arms[False]
    if on["results"] != off["results"]:
        raise AssertionError("6(b): compacted and full-width results differ")
    if not (on["sliced"] == on["launches"] == on["counts"]["F1 sliced"]
            and off["sliced"] == off["counts"]["F1 sliced"] == 0):
        raise AssertionError(f"6(b): sliced launches {on['sliced']} of "
                             f"{on['launches']}, counts {on['counts']}; "
                             f"full arm {off['counts']}")
    if not (on["healed"] == off["healed"] and on["healed"][0] > 0
            and on["counts"]["K1"] > 0):
        raise AssertionError(f"6(b): corruption path {on['healed']} vs "
                             f"{off['healed']}, K1 {on['counts']['K1']}")
    # idle rows only ever saw NOOP rounds with every member at the
    # leader's epoch, so the two arms' states agree on every row
    bad = diff_fields(on["state"], off["state"], eng.EngineState._fields)
    if bad:
        raise AssertionError(f"6(b): state planes {bad} differ between "
                             f"the arms")
    for name, arm in (("compact", on), ("full width", off)):
        print(f"6(b) keyed service {e}x{m}x{s} K={k}, 256 active, {name} "
              f"[{card}]: median flush {statistics.median(arm['ms']):.3f} "
              f"ms over {len(arm['ms'])} flushes; payload {arm['payload']} "
              f"B vs full width {arm['full']} B; grid occupancy "
              f"{arm['occupancy']:.6f}; launches {arm['counts']} "
              f"(service launches {arm['launches']}, sliced "
              f"{arm['sliced']}); corruptions/repairs {arm['healed']}")
        print(f"6(b) {name} [{card}]: flush ms "
              f"{[round(x, 3) for x in arm['ms']]}; host ms per flush: "
              f"{split_line(arm['split'], len(arm['ms']))}")
    return on["counts"]


class HostSplit:
    """Host time of a service's launch path by stage, from wrappers around
    its methods and host passes: the enqueue half (plane slicing, uploads,
    step, pack of the result, the copy's start), the C++ pack of the op
    planes, the wait for the packed result, the unpack with the leader /
    lease mirrors (and any exchange), the C++ mirror scatter, the WAL
    barrier (the records' encode, append and fsync), and the fan-out to
    the futures.  What a flush spends outside these is the
    queue walk (with the [K, E] plane build on the oracle arm, whose
    mirror writes sit inside the fan-out).  It also counts the settled
    launches that carried ops."""

    STAGES = ("enqueue", "pack", "wait", "unpack", "mirrors", "wal",
              "fanout")

    def __init__(self, svc: BatchedEnsembleService) -> None:
        self.ms = dict.fromkeys(self.STAGES + ("resolve", "settle"), 0.0)
        self.op_settles = 0
        for obj, name, key in ((svc, "_launch_enqueue", "enqueue"),
                               (svc, "_fetch_packed", "wait"),
                               (svc, "_launch_resolve", "resolve"),
                               (svc, "_settle_launch", "settle"),
                               (svc._native_enqueue, "pack", "pack"),
                               (svc._native_resolve, "scatter_mirrors",
                                "mirrors"),
                               (svc, "_log_wal", "wal"),
                               (svc, "_log_execute_wal", "wal")):
            if obj is not None:
                setattr(obj, name, self._timed(getattr(obj, name), key))
        settle = svc._settle_launch

        def counted(fl):
            self.op_settles += bool(fl.taken)
            return settle(fl)
        svc._settle_launch = counted

    def _timed(self, fn, key):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.ms[key] += (time.perf_counter() - t0) * 1e3
        return run

    def take(self) -> dict:
        """The stages' ms since the last take, then zero them."""
        ms = self.ms
        out = {"enqueue": ms["enqueue"], "pack": ms["pack"],
               "wait": ms["wait"], "unpack": ms["resolve"] - ms["wait"],
               "mirrors": ms["mirrors"], "wal": ms["wal"],
               "fanout": max(ms["settle"] - ms["resolve"] - ms["mirrors"]
                             - ms["wal"], 0.0)}
        for key in ms:
            ms[key] = 0.0
        return out


def split_line(split: dict, n: int) -> str:
    return ", ".join(f"{k} {v / n:.3f}" for k, v in split.items())


def execute_batches(n: int) -> list:
    """The 6(c) stream: ``n + 1`` full-width K = 64 batches (60 % puts,
    40 % gets) over fixed slots; the first is the warm-up batch."""
    e, s, k = E_FULL, S_FULL, K_FULL
    rng = np.random.default_rng(16)
    rows = np.arange(k)[:, None]
    slots = ((rows + rng.integers(0, s, (1, e))) % s).astype(np.int32)
    batches = []
    for _ in range(n + 1):
        kind = np.where(rng.random((k, e)) < 0.6, eng.OP_PUT,
                        eng.OP_GET).astype(np.int32)
        vals = rng.integers(1, 2 ** 31 - 1, (k, e)).astype(np.int32)
        batches.append((kind, slots, vals))
    return batches


def phase_pipeline(dev: torch.device, card: str,
                   profile: Optional[str] = None) -> dict:
    """6(c): a stream of K = 64 flushes at the headline size through
    ``execute`` at depth 1 and ``execute_async`` at depth 2, each run
    twice in the order 1, 2, 2, 1: equal results (first runs) and final
    state, the wall and host split per flush of every run, and the
    overlap — at depth 2 the settle of launch N starts while launch N + 1
    still runs on the card.  Returns the first depth-2 run's counts."""
    e, m, s, k = E_FULL, M_FULL, S_FULL, K_FULL
    n = 12
    batches = execute_batches(n)
    stream = torch.cuda.current_stream(dev)
    svcs, busy, splits = {}, {}, {}
    for depth in (1, 2):
        svc = svcs[depth] = BatchedEnsembleService(
            FixedClock(), e, m, s, tick=None, max_ops_per_tick=k, device=dev,
            pipeline_depth=depth)
        # elections, and every upload slot's pinned buffers, before the
        # runs: set-up, not flush time (the same count at both depths)
        for _ in range(4):
            svc.execute(*batches[0])
        torch.cuda.synchronize()
        busy[depth] = []
        fetch = svc._fetch_packed

        def watched(fl, fetch=fetch, out=busy[depth]):
            got = fetch(fl)
            out.append(not stream.query())  # a later launch still runs
            return got
        svc._fetch_packed = watched
        splits[depth] = HostSplit(svc)

    def run(depth):
        svc = svcs[depth]
        if depth == 1:
            return [svc.execute(*b) for b in batches[1:]]
        futs = [svc.execute_async(*b) for b in batches[1:]]
        svc.flush()
        return [f.value for f in futs]
    runs, outs, counts = [], {}, {}
    for depth in (1, 2, 2, 1):
        busy[depth].clear()
        splits[depth].take()
        reset_counts()                                # this path's run
        t0 = time.perf_counter()
        out = run(depth)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if depth not in outs:
            outs[depth], counts[depth] = out, read_counts()
        runs.append((depth, wall, splits[depth].take(), sum(busy[depth][:-1]),
                     len(busy[depth])))
    for i, (a, b) in enumerate(zip(outs[1], outs[2])):
        if not all(np.array_equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"6(c): flush {i} results differ between "
                                 f"depth 1 and depth 2")
    shares = {}
    if profile:
        from torch.profiler import ProfilerActivity, profile as tprofile
        for depth in (1, 2):
            with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                run(depth)
                torch.cuda.synchronize()
                pwall = time.perf_counter() - t1
            dev_us = sum(ev.self_device_time_total
                         for ev in prof.key_averages()
                         if ev.device_type == torch.autograd.DeviceType.CUDA)
            shares[depth] = (dev_us / n, dev_us / (pwall * 1e6))
    bad = diff_fields(svcs[1].state, svcs[2].state, eng.EngineState._fields)
    if bad:
        raise AssertionError(f"6(c): final state planes {bad} differ")
    for depth, wall, split, overlapped, settles in runs:
        if overlapped < (n - 1) // 2 if depth == 2 else overlapped:
            raise AssertionError(f"6(c): depth {depth}: the card was busy at "
                                 f"{overlapped} of {settles - 1} settles")
        print(f"6(c) pipeline depth {depth} [{card}]: {n} flushes of K={k} x "
              f"{e} in {wall * 1e3:.3f} ms, {wall / n * 1e3:.3f} ms per "
              f"flush, {n * k * e / wall:.1f} ops/s; card busy at "
              f"{overlapped} of {settles - 1} settles; host ms per flush: "
              f"{split_line(split, n)}")
    for depth, (dev_us, share) in shares.items():
        print(f"6(c) pipeline depth {depth} [{card}]: device kernel time "
              f"{dev_us:.1f} us per flush, busy share {share:.3f} "
              f"(profiled)")
    print(f"6(c) launches [{card}]: depth 1 {counts[1]}, depth 2 "
          f"{counts[2]}")
    device_resident_stream(dev, card, batches, outs[1])
    return counts[2]


OP_PLANES = ("kind", "slot", "val", "exp_e", "exp_s")


def device_resident_stream(dev: torch.device, card: str, batches: list,
                           want: list) -> None:
    """6(c), device-resident: the same stream as CUDA int32 planes
    through ``execute`` at depth 1 on a service warmed like the
    depth-1 one: results bit-equal to the host-array run, no op-plane
    byte staged for the device, and ``k * E`` ops served per call."""
    e, m, s, k = E_FULL, M_FULL, S_FULL, K_FULL
    svc = BatchedEnsembleService(FixedClock(), e, m, s, tick=None,
                                 max_ops_per_tick=k, device=dev)
    for _ in range(4):
        svc.execute(*batches[0])
    staged = {"op planes": 0, "other": 0}
    buffer = svc._uploads.buffer

    def counted(name, shape, dtype):
        t = buffer(name, shape, dtype)
        staged["op planes" if name in OP_PLANES else "other"] += \
            t.numel() * t.element_size()
        return t
    svc._uploads.buffer = counted
    planes = [tuple(torch.from_numpy(x).to(dev) for x in b)
              for b in batches[1:]]
    torch.cuda.synchronize()
    served = svc.ops_served
    t0 = time.perf_counter()
    outs = [svc.execute(*p) for p in planes]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = len(planes)
    same = all(np.array_equal(x, y) for a, b in zip(outs, want)
               for x, y in zip(a, b))
    if not same or staged["op planes"] or \
            svc.ops_served - served != n * k * e:
        raise AssertionError(f"6(c) device-resident: results equal {same}, "
                             f"op-plane bytes staged {staged['op planes']}, "
                             f"served {svc.ops_served - served}")
    print(f"6(c) device-resident stream [{card}]: {n} flushes, "
          f"{wall / n * 1e3:.3f} ms per flush, results bit-equal to the "
          f"host-array run; H2D op-plane bytes 0 (other inputs "
          f"{staged['other'] / n:.0f} B per flush)")
    del svc, planes


# ---------------------------------------------------------------------------
# Phase 7: the host passes and the two host arms

HOST_SRC = "riak_ensemble_tpu_torch/csrc/host/"
REF = "riak_ensemble_tpu/parallel/batched_host.py:"
#: (pass, source, the reference's call site)
HOST_PASSES = (("pack", HOST_SRC + "enqueuekernel.cc", REF + "5346"),
               ("gather", HOST_SRC + "enqueuekernel.cc", REF + "6184"),
               ("unpack", HOST_SRC + "resolvekernel.cc", REF + "3728"),
               ("scatter_mirrors", HOST_SRC + "resolvekernel.cc",
                REF + "6527"))


def copied(args) -> list:
    return [np.array(a, copy=True) if isinstance(a, np.ndarray) else a
            for a in args]


class PassRecorder:
    """Counts the calls of ``svc``'s four host passes and, while armed,
    keeps copies of every call's arguments (taken before the call: the
    mirror scatter writes its slabs in place).  The unpack's arguments
    are taken from every op-carrying launch's packed result, since the
    service unpacks a full-width payload with numpy."""

    def __init__(self, svc: BatchedEnsembleService) -> None:
        self.counts = {name: 0 for name, _, _ in HOST_PASSES}
        self.calls = {name: [] for name, _, _ in HOST_PASSES}
        self.armed = False
        for obj, names in ((svc._native_enqueue, ("pack", "gather")),
                           (svc._native_resolve,
                            ("unpack", "scatter_mirrors"))):
            for name in names:
                setattr(obj, name, self._wrap(getattr(obj, name), name))
        fetch = svc._fetch_packed

        def fetched(fl):
            flat = fetch(fl)
            if self.armed and fl.k:
                self.calls["unpack"].append(copied(
                    [flat, svc.n_ens, svc.n_peers, fl.k, fl.want_vsn,
                     fl.active, fl.a_width, fl.sliced]))
            return flat
        svc._fetch_packed = fetched

    def _wrap(self, fn, name):
        def run(*args):
            self.counts[name] += 1
            if self.armed and name != "unpack":
                self.calls[name].append(copied(args))
            return fn(*args)
        return run


def host_ms(fn, reps: int = 7) -> float:
    """Median host ms of one call of ``fn()`` (a host pass: nothing of it
    runs on the card), over ``reps`` calls after one warm-up."""
    fn()
    per = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        per.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(per)


def hold_pass(name: str, args: list) -> tuple:
    """Run one recorded call through the C++ pass and its plain version
    on copies of the same inputs; raise unless every output is equal
    byte for byte.  Returns (C++ ms, plain ms) per call."""
    nat = (enqueue_native.get() if name in ("pack", "gather")
           else resolve_native.get())
    if name in ("pack", "gather"):
        plain = getattr(enqueue_native, name + "_plain")
    elif name == "unpack":
        def plain(flat, e, m, k, want_vsn, active, a_width, sliced):
            return resolve_native.unpack_results(
                flat, e, m, k, want_vsn, active=active, a_width=a_width,
                sliced=sliced)
    else:
        plain = resolve_native.scatter_mirrors_plain
    n_in = {"pack": 10, "scatter_mirrors": 13}.get(name, len(args))

    def run(fn):
        """Outputs of ``fn`` on fresh copies of the written arguments."""
        outs = [np.array(a, copy=True) for a in args[n_in:]]
        ret = fn(*args[:n_in], *outs)
        return outs if ret is None else list(ret)
    got, want = run(getattr(nat, name)), run(plain)
    if len(got) != len(want) or not all(
            (a is None and b is None) or (
                a is not None and b is not None and a.dtype == b.dtype
                and np.array_equal(a, b)) for a, b in zip(got, want)):
        raise AssertionError(f"7(a): the C++ {name} differs from its plain "
                             f"version")
    if n_in < len(args):          # the pass writes into its arguments
        fresh = [[np.array(a, copy=True) for a in args[n_in:]]
                 for _ in range(16)]

        def timed(fn):
            pool = iter(fresh * 2)
            return host_ms(lambda: fn(*args[:n_in], *next(pool)))
        return timed(getattr(nat, name)), timed(plain)
    return (host_ms(lambda: getattr(nat, name)(*args)),
            host_ms(lambda: plain(*args)))


def rmw_cas_flush(svc: BatchedEnsembleService, rec: PassRecorder,
                  sub: list) -> str:
    """Phase 5's RMW traffic in one recorded flush: ``kmodify_many`` rows
    (8 keys four times, rmw:add) on ``sub[64:]`` beside the CAS halves of
    host kmodify increments (4 of one key) on ``sub[:64]``, whose reads
    and first CAS round took the flush call before: its first launch
    carries both, its second the CAS halves that read in the first.
    Then every op is driven to its ack.  Returns what the first launch
    carried."""
    storm = [svc.kmodify(x, "hot", lambda vsn, cur: cur + 1, 0, retries=16)
             for x in sub[:64] for _ in range(4)]
    svc.flush()                                  # the storm's reads
    keys = [f"ctr:{i}" for i in range(8)]
    many = [svc.kmodify_many(x, keys * 4, funref.ref("rmw:add", 3))
            for x in sub[64:]]
    rec.armed = True
    svc.flush()
    rec.armed = False
    drive(svc, storm + many, 32)
    if not all(r[0] == "ok" for f in many for r in f.value) or \
            not all(f.value[0] == "ok" for f in storm):
        raise AssertionError("7(a) RMW + CAS: an op did not commit")
    kinds = rec.calls["scatter_mirrors"][0][2]
    if not ((kinds == eng.OP_RMW).any() and (kinds == eng.OP_CAS).any()):
        raise AssertionError("7(a) RMW + CAS: the recorded flush lacks RMW "
                             "or CAS rows")
    return (f"{int((kinds == eng.OP_RMW).sum())} RMW and "
            f"{int((kinds == eng.OP_CAS).sum())} CAS rows")


def phase_host_passes(dev: torch.device, card: str) -> dict:
    """7(a): every host pass's inputs recorded on three flushes at the
    headline and replayed through the C++ pass and its plain version:
    equal bytes, and each timed per call.  Two are one mixed keyed flush
    of the phase-4 pattern (256 of 10,000 ensembles, 24 puts then 24
    reads of the same keys each) with compaction (a sliced A = 256
    payload) and without (a full-width one); the third carries phase
    5's RMW traffic (:func:`rmw_cas_flush`, a sliced A = 512 payload)."""
    e, m, s, k = E_FULL, M_FULL, S_FULL, K_FULL
    rng = np.random.default_rng(17)
    sub = np.sort(rng.choice(e, 256, replace=False)).tolist()
    sub_rmw = rng.choice(e, 320, replace=False).tolist()
    keys = [f"user:{i}" for i in range(24)]
    out = {name: {"ms": {}, "plain_ms": {}} for name, _, _ in HOST_PASSES}
    for label, compact in (("sliced A=256", True), ("full width", False),
                           ("RMW + CAS, sliced A=512", True)):
        svc = BatchedEnsembleService(FixedClock(), e, m, s, tick=None,
                                     max_ops_per_tick=k, device=dev,
                                     compact=compact)
        svc.flush()
        rec = PassRecorder(svc)
        if label.startswith("RMW"):
            ops = rmw_cas_flush(svc, rec, sub_rmw)
        else:
            puts = [svc.kput_many(x, keys,
                                  [f"p{x}:{i}" for i in range(len(keys))])
                    for x in sub]
            gets = [svc.kget_many(x, keys, want_vsn=True) for x in sub]
            rec.armed = True
            svc.flush()
            rec.armed = False
            torch.cuda.synchronize()
            if not all(f.done for f in puts + gets) or any(
                    r[0] != "ok" for f in gets for r in f.value):
                raise AssertionError(f"7(a) {label}: the mixed flush did "
                                     f"not serve its ops")
            ops = f"{len(sub)} x {2 * len(keys)} ops"
        # the flush's first launch (a kmodify chain launches again)
        for name, _, _ in HOST_PASSES:
            if len(rec.calls[name]) != 1 + label.startswith("RMW"):
                raise AssertionError(f"7(a) {label}: {name} ran "
                                     f"{len(rec.calls[name])} times")
        unpack = rec.calls["unpack"][0]
        if unpack[7] != compact or (unpack[5] is None) == compact:
            raise AssertionError(f"7(a) {label}: the payload's layout is "
                                 f"active {unpack[5] is not None}, sliced "
                                 f"{unpack[7]}")
        for name, _, _ in HOST_PASSES:
            ms, plain_ms = hold_pass(name, rec.calls[name][0])
            out[name]["ms"][label] = ms
            out[name]["plain_ms"][label] = plain_ms
            print(f"7(a) host pass {name} == plain, {label} [{card}]: "
                  f"{ms:.6f} ms per call, plain {plain_ms:.6f} ms "
                  f"({ops}, K={k})")
        del svc, rec
        torch.cuda.empty_cache()
    return out


class GcWatch:
    """Python's cyclic garbage collections while a window runs: count
    and pause ms per generation (a full, generation-2 collection walks
    every tracked object the process holds)."""

    def __init__(self) -> None:
        self.n = [0, 0, 0]
        self.ms = [0.0, 0.0, 0.0]
        self._t0 = 0.0

    def _cb(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            g = info["generation"]
            self.n[g] += 1
            self.ms[g] += (time.perf_counter() - self._t0) * 1e3

    def __enter__(self) -> "GcWatch":
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self._cb)

    def line(self) -> str:
        return ", ".join(f"gen{g} {self.n[g]} x {self.ms[g]:.1f} ms"
                         for g in range(3))


def mirrors_of(svc: BatchedEnsembleService) -> dict:
    return {name: getattr(svc, name).copy() for name in (
        "_slot_vsn_np", "_slot_vsn_ok", "_inline_value_np",
        "_inline_value_ok", "_inline_np", "leader_np", "lease_until")}


def phase_host_arms(dev: torch.device, card: str) -> dict:
    """7(b): the phase-4 keyed pattern and the 6(c) execute stream at
    depth 1 and 2, on the default (native) host arm and on
    ``native_enqueue=False, native_resolve=False``: equal futures, mirror
    slabs, engine state and exchange counters; one completion-slab wake
    per settled flush that carried ops; the median flush and the host
    split per arm.  Returns the host passes' call counts on the default
    arm's keyed runs."""
    e, m, s, k = E_FULL, M_FULL, S_FULL, K_FULL
    rng = np.random.default_rng(18)
    sub = np.sort(rng.choice(e, 256, replace=False)).tolist()
    keys = [f"user:{i}" for i in range(48)]
    n = 8
    batches = execute_batches(n)
    calls = {name: 0 for name, _, _ in HOST_PASSES}
    arms = {"native": {}, "oracle": {"native_enqueue": False,
                                     "native_resolve": False}}
    for stream in ("keyed", "execute"):
        for depth in (1, 2):
            runs = {}
            for arm, kw in arms.items():
                svc = BatchedEnsembleService(
                    FixedClock(), e, m, s, tick=None, max_ops_per_tick=k,
                    device=dev, pipeline_depth=depth, **kw)
                if stream == "keyed":
                    svc.flush()                  # elect all 10,000
                else:
                    for _ in range(depth + 2):   # elections, pinned slots
                        svc.execute(*batches[0])
                torch.cuda.synchronize()
                rec = PassRecorder(svc) if arm == "native" else None
                split = HostSplit(svc)
                wakes0, ms = svc.completion_wakes, []
                with GcWatch() as gcw:
                    if stream == "keyed":
                        results = keyed_rounds(svc, dev, sub, keys, ms)
                    else:
                        t0 = time.perf_counter()
                        if depth == 1:
                            results = [svc.execute(*b)
                                       for b in batches[1:]]
                        else:
                            futs = [svc.execute_async(*b)
                                    for b in batches[1:]]
                            svc.flush()
                            results = [f.value for f in futs]
                        torch.cuda.synchronize()
                        ms = [(time.perf_counter() - t0) * 1e3]
                wakes = svc.completion_wakes - wakes0
                want = split.op_settles if arm == "native" else 0
                if wakes != want:
                    raise AssertionError(
                        f"7(b) {stream} depth {depth} {arm}: {wakes} "
                        f"completion wakes for {split.op_settles} settled "
                        f"flushes with ops")
                if rec is not None and stream == "keyed":
                    for name in calls:
                        calls[name] += rec.counts[name]
                runs[arm] = {
                    "results": results, "ms": ms, "split": split.take(),
                    "gc": gcw.line(),
                    "mirrors": mirrors_of(svc), "state": svc.state,
                    "healed": (svc.corruptions, svc.repairs),
                    "counters": (svc.native_enqueue_flushes,
                                 svc.fallback_enqueue_flushes,
                                 svc.native_resolve_flushes,
                                 svc.fallback_resolve_flushes)}
                del svc, rec, split
            a, b = runs["native"], runs["oracle"]
            same = (a["results"] == b["results"] if stream == "keyed"
                    else all(np.array_equal(x, y)
                             for ra, rb in zip(a["results"], b["results"])
                             for x, y in zip(ra, rb)))
            bad = [f for f in a["mirrors"]
                   if not np.array_equal(a["mirrors"][f], b["mirrors"][f])]
            bad += diff_fields(a["state"], b["state"],
                               eng.EngineState._fields)
            if not same or bad or a["healed"] != b["healed"]:
                raise AssertionError(
                    f"7(b) {stream} depth {depth}: the arms differ (results "
                    f"equal {same}, planes {bad}, exchange {a['healed']} vs "
                    f"{b['healed']})")
            for arm, r in runs.items():
                n_fl = len(r["ms"]) if stream == "keyed" else n
                per = (f"median flush {statistics.median(r['ms']):.3f} ms"
                       if stream == "keyed" else
                       f"wall per flush {r['ms'][0] / n:.3f} ms")
                rest = (sum(r["ms"]) - sum(r["split"].values())) / n_fl
                print(f"7(b) {stream} depth {depth} {arm} arm [{card}]: "
                      f"{per} over {n_fl} flushes "
                      f"{[round(x, 3) for x in r['ms']]}; host ms per "
                      f"flush: {split_line(r['split'], n_fl)}, rest "
                      f"{rest:.3f}; garbage collections {r['gc']}; counters "
                      f"(native/fallback enqueue, native/fallback resolve) "
                      f"{r['counters']}; exchange {r['healed']}")
            del runs, a, b
            torch.cuda.empty_cache()
    if not all(calls.values()):
        raise AssertionError(f"7(b): a host pass never ran on the default "
                             f"arm: {calls}")
    return calls


# ---------------------------------------------------------------------------
# Phase 8: durable acks (the WAL before the ack, checkpoints, restore)

class WalMeter:
    """Records, bytes and fsyncs of a service's WAL: wrappers on its
    ``log`` / ``log_arena`` and its store's ``sync``.  Bytes are the
    protocol-4 pickles of each record's key and value (the store adds
    its frame); records logged through ``log`` are kept and pickled only
    in :meth:`take`, outside any timed window."""

    def __init__(self, svc: BatchedEnsembleService) -> None:
        self.records = self.bytes = self.fsyncs = self.appends = 0
        self._kept = []
        w = svc._wal
        log, arena, sync = w.log, w.log_arena, w._store.sync

        def log_(recs):
            self.appends += 1
            self.records += len(recs)
            self._kept.append(recs)
            return log(recs)

        def arena_(a, idx, extra=()):
            self.appends += 1
            self.records += len(idx)
            self.bytes += int(idx[:, 1].sum() + idx[:, 3].sum())
            return arena(a, idx, extra)

        def sync_():
            self.fsyncs += 1
            return sync()
        w.log, w.log_arena, w._store.sync = log_, arena_, sync_

    def take(self) -> tuple:
        """(records, bytes, fsyncs, appends) since the last take, then
        zero them; an append is one flush's durability barrier."""
        for recs in self._kept:
            self.bytes += sum(len(pickle.dumps(k, protocol=4))
                              + len(pickle.dumps(v, protocol=4))
                              for k, v in recs)
        out = (self.records, self.bytes, self.fsyncs, self.appends)
        self.records = self.bytes = self.fsyncs = self.appends = 0
        self._kept = []
        return out


def durable_service(dev, data: str, depth: int = 1,
                    **kw) -> BatchedEnsembleService:
    return BatchedEnsembleService(
        FixedClock(), E_FULL, M_FULL, S_FULL, tick=None,
        max_ops_per_tick=K_FULL, device=dev, pipeline_depth=depth,
        data_dir=data, wal_sync="fsync", **kw)


def restore_service(dev, data: str) -> tuple:
    """The service restored from ``data`` on the card, and the ms it
    took (the replay's device work included)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svc = BatchedEnsembleService.restore(
        FixedClock(), data, tick=None, max_ops_per_tick=K_FULL, device=dev,
        data_dir=data, wal_sync="fsync")
    torch.cuda.synchronize()
    return svc, (time.perf_counter() - t0) * 1e3


def read_back(svc: BatchedEnsembleService, sub: list, keys: list,
              want: dict, label: str) -> None:
    """kget_many of ``keys`` on ``sub``; raise unless each reads ``want``
    (ensemble -> values in key order)."""
    svc.runtime.now += 1.0          # leases lapse: the reads go round
    futs = [svc.kget_many(x, keys) for x in sub]
    drive(svc, futs, 8)
    bad = [x for x, f in zip(sub, futs)
           if f.value != [("ok", v) for v in want[x]]]
    if bad:
        raise AssertionError(f"{label}: acknowledged puts of {len(bad)} "
                             f"ensembles did not read back (first "
                             f"{bad[0]})")


def wal_flush_capture(svc: BatchedEnsembleService, sub: list,
                      keys: list, tag: str) -> tuple:
    """8(c): one keyed put flush on ``sub`` whose WAL records are also
    taken through the Python walk.  Returns (the Python walk's records,
    the C++ pass's arena and index): the service's own WAL gets its
    records as usual."""
    got = {}
    real_log_wal = svc._log_wal
    real_wal = svc._wal

    class Recorder:
        def log(self, recs):
            got["recs"] = list(recs)

        def log_arena(self, arena, idx, extra=()):
            got["arena"] = (np.array(arena, copy=True), idx.copy())

    def capture(taken, planes):
        if "arena" not in got and planes[0] is not None:
            svc._wal = Recorder()
            nat = svc._native_resolve
            try:
                svc._native_resolve = None
                real_log_wal(taken, planes)       # the Python walk
                svc._native_resolve = nat
                real_log_wal(taken, planes)       # the C++ encode
            finally:
                svc._native_resolve = nat
                svc._wal = real_wal
        return real_log_wal(taken, planes)
    svc._log_wal = capture
    futs = [svc.kput_many(x, keys, [f"{tag}:{x}:{i}".encode()
                                    for i in range(len(keys))])
            for x in sub]
    drive(svc, futs, 8)
    svc._log_wal = real_log_wal
    if not all(r[0] == "ok" for f in futs for r in f.value):
        raise AssertionError("8(c): the captured put flush did not commit")
    if "arena" not in got or "recs" not in got:
        raise AssertionError("8(c): the flush did not take the C++ encode")
    return got["recs"], got["arena"]


def hold_wal_encode(recs: list, arena: np.ndarray, idx: np.ndarray,
                    root: str, card: str) -> dict:
    """8(c): the C++ pass's arena against the Python encoder: every
    record's bytes equal ``pickle.dumps(..., protocol=4)`` of the Python
    walk's record, and the two stores (``log`` of the records,
    ``log_arena`` of the arena) hold equal contents in byte-identical
    files.  Returns the two appends' ms."""
    if len(recs) != len(idx):
        raise AssertionError(f"8(c): {len(idx)} arena records against "
                             f"{len(recs)} from the Python walk")
    for i, (key, value) in enumerate(recs):
        ko, kl, vo, vl = idx[i].tolist()
        if (bytes(arena[ko:ko + kl]) != pickle.dumps(key, protocol=4)
                or bytes(arena[vo:vo + vl])
                != pickle.dumps(value, protocol=4)):
            raise AssertionError(f"8(c): arena record {i} differs from the "
                                 f"protocol-4 pickles of {key!r}")
    ms = {}
    stores = {}
    for name in ("python", "arena"):
        w = ServiceWAL(os.path.join(root, name), "fsync")
        t0 = time.perf_counter()
        if name == "python":
            w.log(recs)
        else:
            w.log_arena(arena, idx)
        ms[name] = (time.perf_counter() - t0) * 1e3
        stores[name] = w.records()
        w.close()
    files = [{f: open(os.path.join(root, n, f), "rb").read()
              for f in sorted(os.listdir(os.path.join(root, n)))}
             for n in ("python", "arena")]
    if stores["python"] != stores["arena"] or files[0] != files[1]:
        raise AssertionError("8(c): the arena's store differs from the "
                             "Python encoder's")
    print(f"8(c) WAL encode [{card}]: {len(recs)} records, arena "
          f"{arena.nbytes} B, byte-equal to the protocol-4 pickles; append "
          f"+ fsync: log_arena {ms['arena']:.3f} ms, Python log "
          f"{ms['python']:.3f} ms; stores equal, files byte-identical")
    return ms


def phase_durable(dev: torch.device, card: str) -> dict:
    """Phase 8 at the headline shape, default native arm, each data dir
    a fresh ``tempfile.mkdtemp()`` with ``wal_sync="fsync"``: (a) the
    6(b) keyed pattern with bytes payloads at depth 1 and 2 (the wal
    stage in the host split; records, bytes and fsyncs per flush), each
    service then dropped without a save and restored on the card (every
    acknowledged put reads back; a new write commits and reads back);
    (b) ``save`` then ``restore`` (every plane ``torch.equal``); (c) one
    keyed flush's records through the C++ encode + ``log_arena`` and
    through the Python walk + ``log``; (d) the 6(c) execute stream with a
    data dir (WAL ms and records per flush), 2 flushes at depth 1 and 2
    at depth 2; (e) a launch failure injected through ``engine=``.
    Returns the F1 counts of (a) and (d)."""
    e = E_FULL
    rng = np.random.default_rng(19)
    sub = np.sort(rng.choice(e, 256, replace=False)).tolist()
    keys = [f"user:{i}" for i in range(48)]
    counts = {}
    restored = None
    for depth in (1, 2):
        data = tempfile.mkdtemp(prefix="retpu_durable_")
        svc = durable_service(dev, data, depth)
        svc.flush()                                     # elect all
        torch.cuda.synchronize()
        chk = LaunchCheck(svc)
        split = HostSplit(svc)
        meter = WalMeter(svc)
        meter.take()
        reset_counts()                                  # this path's run
        ms = []
        keyed_rounds(svc, dev, sub, keys, ms, enc=str.encode)
        counts[f"phase8a durable keyed depth {depth}"] = c = read_counts()
        if c["F1"] != chk.launches:
            raise AssertionError(f"8(a): F1 launched {c['F1']} times in "
                                 f"{chk.launches} launches")
        recs, nbytes, fsyncs, put_flushes = meter.take()
        sp = split.take()
        n = len(ms)
        print(f"8(a) durable keyed depth {depth} [{card}]: median flush "
              f"{statistics.median(ms):.3f} ms over {n} flushes "
              f"{[round(x, 3) for x in ms]}; host ms per flush: "
              f"{split_line(sp, n)}; WAL {recs} records, {nbytes} B, "
              f"{fsyncs} fsyncs in {n} flushes ({recs / put_flushes:.1f} "
              f"records, {nbytes / put_flushes:.1f} B and "
              f"{sp['wal'] / put_flushes:.3f} WAL ms per put flush, "
              f"{fsyncs / n:.3f} fsyncs per flush); launches {c}")
        want = {x: [f"v2:{x}:{i}".encode() for i in range(len(keys))]
                for x in sub}
        svc._wal.close()                       # dropped without a save
        del svc, chk, split, meter
        torch.cuda.empty_cache()
        svc, r_ms = restore_service(dev, data)
        read_back(svc, sub, keys, want, f"8(a) depth {depth} restore")
        f = svc.kput_many(sub[0], ["after"], [b"restored"])
        drive(svc, [f], 8)
        read_back(svc, [sub[0]], ["after"], {sub[0]: [b"restored"]},
                  f"8(a) depth {depth} post-restore write")
        print(f"8(a) restore depth {depth} [{card}]: {r_ms:.3f} ms from "
              f"META + WAL generation 0 ({len(sub) * len(keys)} acked "
              f"keys read back, a new write served)")
        if restored is not None:
            restored._wal.close()
        restored = svc
    svc = restored
    # (c) one keyed put flush through both encoders
    recs, (arena, idx) = wal_flush_capture(svc, sub, keys, "c")
    enc_root = tempfile.mkdtemp(prefix="retpu_walenc_")
    enc_ms = hold_wal_encode(recs, arena, idx, enc_root, card)
    # (b) save, then restore: every plane equal
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svc.save()
    torch.cuda.synchronize()
    save_ms = (time.perf_counter() - t0) * 1e3
    saved = [t.clone() for t in svc.state]
    nbytes = sum(t.numel() * t.element_size() for t in saved)
    svc._wal.close()
    data = svc.data_dir
    del svc, restored
    torch.cuda.empty_cache()
    svc, r_ms = restore_service(dev, data)
    bad = [f for f, a, b in zip(eng.EngineState._fields, saved, svc.state)
           if not torch.equal(a, b)]
    if bad:
        raise AssertionError(f"8(b): restored planes {bad} differ from "
                             f"the saved ones")
    print(f"8(b) save / restore [{card}]: save {save_ms:.3f} ms, restore "
          f"{r_ms:.3f} ms, {nbytes} B of engine state, every plane "
          f"torch.equal")
    svc._wal.close()
    del svc, saved
    torch.cuda.empty_cache()
    # (d) full-width execute with a data dir
    batches = execute_batches(2)
    for depth in (1, 2):
        data = tempfile.mkdtemp(prefix="retpu_durable_x_")
        svc = durable_service(dev, data, depth)
        for _ in range(depth + 2):               # elections, pinned slots
            svc.execute(*batches[0])
        torch.cuda.synchronize()
        split = HostSplit(svc)
        meter = WalMeter(svc)
        meter.take()
        reset_counts()
        t0 = time.perf_counter()
        if depth == 1:
            outs = [svc.execute(*b) for b in batches[1:]]
        else:
            futs = [svc.execute_async(*b) for b in batches[1:]]
            svc.flush()
            outs = [f.value for f in futs]
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts[f"phase8d durable execute depth {depth}"] = read_counts()
        sp = split.take()
        recs, nbytes, fsyncs, _ = meter.take()
        want = sum(int(((b[0] == eng.OP_PUT) & c[0]).sum())
                   for b, c in zip(batches[1:], outs))
        if recs != want or not all(isinstance(o, tuple) for o in outs):
            raise AssertionError(f"8(d): {recs} WAL records for {want} "
                                 f"committed puts")
        nb = len(batches) - 1
        print(f"8(d) durable execute depth {depth} [{card}]: {nb} flushes "
              f"of K={K_FULL} x {e} in {wall:.3f} ms, "
              f"{wall / nb:.3f} ms per flush; WAL {sp['wal'] / nb:.3f} ms, "
              f"{recs / nb:.1f} records, {nbytes / nb:.1f} B and "
              f"{fsyncs / nb:.3f} fsyncs per flush; host ms per flush: "
              f"{split_line(sp, nb)}")
        svc._wal.close()
        del svc, split, meter
        torch.cuda.empty_cache()
    # (e) a launch failure on the card, injected through engine=
    phase_launch_failure(dev, card)
    return {"counts": counts, "encode_ms": enc_ms}


class _FailingEngine(_LocalEngine):
    """Steps the card (F1 updates the state in place), then raises once
    when armed."""

    armed = False

    def full_step(self, *a, **kw):
        out = _LocalEngine.full_step(*a, **kw)
        if self.armed:
            self.armed = False
            raise RuntimeError("injected launch failure")
        return out


def phase_launch_failure(dev: torch.device, card: str) -> None:
    """8(e): a launch that fails on CUDA: its ops fail, no snapshot was
    taken (the donated contract: the stepped state stands), and the next
    flush serves."""
    eng_ = _FailingEngine()
    svc = BatchedEnsembleService(FixedClock(), E_FULL, M_FULL, S_FULL,
                                 tick=None, max_ops_per_tick=K_FULL,
                                 device=dev, engine=eng_)
    svc.flush()
    f = svc.kput_many(7, ["a", "b"], [b"1", b"2"])
    drive(svc, [f], 4)
    eng_.armed = True
    g = svc.kput_many(7, ["a", "c"], [b"3", b"4"])
    slot_c = svc.key_slot[7]["c"]
    try:
        svc.flush()
    except RuntimeError as exc:
        if "injected" not in str(exc):
            raise
    else:
        raise AssertionError("8(e): the injected failure did not reach "
                             "the flush caller")
    torch.cuda.synchronize()
    # the failed launch's write of "c" stands on the leader's replica
    stepped = int(svc.state.obj_seq[7, int(svc.leader_np[7]), slot_c])
    if g.value != ["failed", "failed"] or not svc._donate or not stepped:
        raise AssertionError(f"8(e): futures {g.value}, donate "
                             f"{svc._donate}, seq of the failed write "
                             f"{stepped} (the step must stand)")
    h = svc.kput_many(7, ["a", "c"], [b"5", b"6"])
    drive(svc, [h], 4)
    read_back(svc, [7], ["a", "b", "c"], {7: [b"5", b"2", b"6"]},
              "8(e) after the failure")
    print(f"8(e) launch failure on CUDA [{card}]: ops failed, no rollback "
          f"(the failed write stands at seq {stepped}, stepped in place), "
          f"next flush served")


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
        committed, _, _, _ = svc.execute(kind, slots, vals)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    # device rows only: the aten rows repeat their kernels' time
    kernels = [ev for ev in events
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(ev.self_device_time_total for ev in kernels)
    n_kern = sum(ev.count for ev in kernels)
    f1 = [ev for ev in kernels if "engine_step_kernel" in ev.key]
    f1_n = sum(ev.count for ev in f1)
    f1_us = sum(ev.self_device_time_total for ev in f1) / max(f1_n, 1)
    table = events.table(sort_by="self_device_time_total", row_limit=25)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"[{card}] one execute() flush, wall {wall_us:.1f} us, "
                f"device kernel time {dev_us:.1f} us\n{table}\n")
    _, _, bound_ms = bound(*f1_work(svc.state, svc.up, committed))
    print(f"profile [{card}]: flush wall {wall_us:.1f} us (profiled), "
          f"device kernel time {dev_us:.1f} us (busy "
          f"{dev_us / wall_us:.3f}), {n_kern} kernels; F1 {f1_n} "
          f"launches, {f1_us:.3f} us device time each against its bound "
          f"{bound_ms * 1e3:.3f} us for this flush "
          f"({bound_ms * 1e3 / f1_us:.3f} of it)")
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
          f"({', '.join(f'{n} {v:.3f} s' for n, v in secs.items())})")
    for name, text in build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    k1 = phase_k1(dev)
    reset_counts()
    k2 = phase_k2(dev, profile)
    k2_launches = read_counts()["K2"]
    phase_engine(dev)
    f1 = phase_f1(dev, card)
    reset_counts()
    k1_exchange = phase_exchange(dev, card)
    f1_sliced = phase_f1_sliced(dev, card)
    by_path = {"phase4 keyed service": phase_service(dev, card, profile),
               "phase5 rmw + fast reads": phase_rmw(dev, card),
               "phase6b compacted keyed service":
                   phase_compaction_service(dev, card),
               "phase6c pipeline depth 2": phase_pipeline(dev, card,
                                                          profile)}
    host = phase_host_passes(dev, card)
    host_calls = phase_host_arms(dev, card)
    durable = phase_durable(dev, card)
    by_path.update(durable["counts"])
    f1_by_path = {p: c["F1"] for p, c in by_path.items()}
    sliced_by_path = {p: c["F1 sliced"] for p, c in by_path.items()}
    if not (all(f1_by_path.values()) and k1_exchange and k2_launches
            and sliced_by_path["phase6b compacted keyed service"]):
        raise AssertionError(f"a kernel did not launch on its path: F1 "
                             f"{f1_by_path} (sliced {sliced_by_path}), K1 "
                             f"{k1_exchange}, K2 {k2_launches}")
    kernels = [{
        "name": "F1 engine_step", "route": "cuda",
        "source": "riak_ensemble_tpu_torch/csrc/engine_step.cu",
        "replaces": "riak_ensemble_tpu/ops/pallas_quorum.py:172",
        "fuses": "riak_ensemble_tpu/ops/engine.py:1386",
        "launches": sum(f1_by_path.values()),
        "launches_by_path": f1_by_path,
        "sliced_launches": sum(sliced_by_path.values()),
        "sliced_launches_by_path": sliced_by_path,
        "max_abs_err": f1["max_abs_err"], "ms": f1["ms"],
        "plain_ms": f1["plain_ms"], "bound_ms": f1["bound_ms"],
        "bound_by": f1["bound_by"], "library_ms": None,
        "device_us": f1["device_us"], "sliced": f1_sliced}, {
        "name": "K1 quorum_met_e", "route": "cuda",
        "source": "riak_ensemble_tpu_torch/csrc/quorum.cu",
        "replaces": "riak_ensemble_tpu/ops/pallas_quorum.py:172",
        "launches": k1_exchange + sum(c["K1"] for c in by_path.values()),
        "launches_by_path": {"phase3c exchange": k1_exchange,
                             **{p: c["K1"] for p, c in by_path.items()}},
        "compacted_exchange_launches":
            by_path["phase6b compacted keyed service"]["K1"],
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": None,
        "device_us": k1["device_us"]}, {
        "name": "K2 quorum_met_s", "route": "cuda",
        "source": "riak_ensemble_tpu_torch/csrc/quorum.cu",
        "replaces": "riak_ensemble_tpu/ops/pallas_quorum.py:83",
        "launches": k2_launches,
        "main_path_launches": sum(c["K2"] for c in by_path.values()),
        "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
        "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"], "library_ms": None}]
    host_line = [{"name": name, "route": "host c++", "source": src,
                  "replaces": ref, "calls": host_calls[name],
                  "max_abs_err": 0, **host[name]}
                 for name, src, ref in HOST_PASSES]
    print(card)
    print(json.dumps({"kernels": kernels, "host": host_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
