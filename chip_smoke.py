"""Chip smoke test of riak_ensemble_tpu_torch on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit (``nvcc``)::

    python3 chip_smoke.py [--profile PATH]

Phases (each raises on failure, so any failure exits non-zero):

1. build every CUDA kernel of the package from ``csrc/`` with nvcc and,
   at the same time, the service's host passes and the wire codec (a
   CPython extension; ``csrc/host/*.cc``) with g++;
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
   and upper nodes, damage aimed at a bucket then repeated writes into
   it, a corrupt node that no op writes under, M = 32 and M = 7 x S =
   1,024 (208 KB staged); time F1 (device time from CUDA events behind a
   stream sleep) and its plain version, with its occupancy (registers,
   shared memory, resident blocks per SM), its host time per call, and
   its bounds (bytes, the reference arithmetic's operations, the
   design's);
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
   electing rows and row E - 1 active before the pads), A = 1 with K = 1,
   and at the edge shapes of 3b, timed at A = 256 (K = 64 and K = 1) and
   2,048 as 3b times full width, with the wrapper's per-call overhead
   (ms per call back to back minus device time); (b) the keyed service at
   the headline size with 256 of 10,000 ensembles active, compacted
   against ``compact=False`` (equal results; payload bytes, sliced and F1
   launches, median flush time per arm); (c) a stream of K = 64 flushes
   through ``execute_async`` at depth 2 against ``execute`` at depth 1
   (equal results and final state; wall per flush; launch N + 1
   enqueued before the host's settle of launch N begins, and how often
   the card still runs it then);
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
   staged for the device;
9. the control plane at the headline shape: (a) after an election of
   every row, a one-member shrink proposed on a seeded 1,000 rows, then
   the collapse step, each ``reconfig_step`` (K1 for both gates, twice
   per step) bit-equal to ``reconfig_step_plain`` on every state plane
   and on ``installed`` / ``collapsed``, K1's device time per launch on
   this path, and the service's ``update_members`` (a shrink, a change
   left joint whose flush runs F1 with two views and fails its writes,
   the retry that collapses it) with its wall ms per call; (b) the timer
   (``tick=0.005``, K = 64) on the port's simulator ``Runtime``: bursts
   of ``kput_many`` / ``kupdate_many`` / ``kdelete_many`` on 256 rows
   flush on the next runtime turn, a trickle waits for the tick, leader
   kills and ``update_members`` churn between flushes, watchers see every
   leader change, every acknowledged write reads back; (c) dynamic rows
   with a data dir and ``wal_sync="fsync"``: create every row, destroy
   half, recreate a quarter, keyed writes between, ops on destroyed rows
   fail, a restore without a save brings back the names, membership
   rows and acknowledged writes, and one with the wrong ``dynamic``
   flag raises (mem records and fsyncs per call, ms per create, destroy
   and restore);
10. the front end at the headline shape, obs on: (a) the C++ wire codec
   (``csrc/host/wirecodec.cc``) against ``encode_py`` / ``decode_py`` byte
   for byte on a seeded corpus (every record type, nesting one under the
   depth limit, a raw frame), and encode / decode of 12,288-key frames
   timed C++ against Python; (b) ``svcnode.serve()`` in process on
   loopback (``tick=0.005``, a fresh data dir, ``wal_sync="fsync"``,
   warmed) with one ``ServiceClient``: 2,000 serial ``kput`` each followed
   by its ``kget``, 6(b)'s keyed pattern through the slab verbs with 256
   batches in flight, every acknowledged write read back over the wire
   with one request per ensemble all in flight at once (~2,000), F1
   counted on this path, and ``stats()``, ``health()``,
   ``health(ens)``, ``latency_breakdown()`` and the parsed Prometheus
   scrape printed; (c) 6(b)'s keyed pattern on a service with obs on
   and one under ``RETPU_OBS=0``, passes interleaved on, off, off, on
   three times with the collector off in the timed window: the median
   flush and the host split per flush of each, and the collection after
   each pass; (d)
   ``python -m riak_ensemble_tpu_torch.svcnode --dynamic --data-dir D``
   as a process on the card: 64 names and 4,096 keys written, SIGKILL,
   a restart on ``D``, every name and acknowledged write read back;
11. wide rounds and sharded host passes: (a) F1's wide mode against
   ``full_step_wide_plain`` / ``full_step_wide_sliced_plain`` (and
   ``kv_step_scan_wide`` against its plain twin) bit for bit on every
   state plane, ``won`` and every result lane, at the headline shape with
   distinct slots (G = 1) and duplicate chains (G = 2), sliced at A = 256
   and 2,048, and at 3b's edge shapes (M = 3 / 7 / 32, S = 16 / 33 /
   1,024, joint views) over damaged stores, and with a group's lanes aimed
   under one corrupt level-0 node; timed as 3b times F1, beside scalar F1
   on the same ops in (group, lane) order, with its occupancy and bound,
   and with one live lane a row; (b) the headline service with ``wide=True`` on the card
   against one on the CPU: ``execute()`` of distinct-slot planes, every
   acknowledged put read back, then 6(b)'s keyed pattern; wide launches
   run and F1 launches once per launch; (c) 6(b)'s keyed pattern and a
   full-width ``execute`` stream at ``resolve_shards=4`` against 1: equal
   results, mirror slabs and state, and the host split of each arm.

12. a three-host replication group at bench.py's headline lane (10,000
   ensembles x 128 slots, K = 64): the leader in this process on the
   card, two replica processes of ``python -m
   riak_ensemble_tpu_torch.parallel.repgroup`` on the same card, each
   host with its own data dir at ``wal_sync="fsync"``.  Stage A runs
   6(b)'s keyed pattern with bytes payloads (256 rows, 48 keys, three
   put / get rounds, every active row's leader taken down after the
   first, so the replicas re-execute the election's full-plane entry
   through F1) and a ``kmodify_many`` burst (the merge lane), and the
   same ops on an in-process CPU group: equal futures and leader lanes.
   Then kill -9 a replica (commits go on at 2 of 3), restart it
   (catch-up by tree patch or install), kill both (nothing acks),
   restart them, stop the leader and promote a replica that a
   ``GroupClient`` follows, reading back every acknowledged put.  After
   each stage every replica's lane (pulled over its replication port)
   equals the leader's; F1 launches on every host (the replicas report
   theirs through ``stats``).  It prints the group's keyed flush median
   beside the one-host lane's (stage A's ops without replication), bytes per entry against the full-plane
   equivalent, ship build / encode / ack ms, the replica's apply ms per
   batch, catch-up ms and bytes, and the ms from promotion to the first
   ack.
13. riak_ensemble's own consensus plane and the device Merkle tree:
   (a) ``ops/hash.py``'s tree on the card at the reference synctree's
   design scale (16^5 = 1,048,576 segments, width 16, 4 lanes): ``build``,
   ``update`` of 4,096 ids with duplicates, ``verify`` with a node
   corrupted at three levels, ``diff_levels`` and ``exchange_cost``
   against a tree with 1,000 differing segments, each bit-equal to the
   same call on CPU tensors and timed; then ``synctree/remote_sync.py``'s
   ``sync_diff`` against that tree on the card in another process, which
   must find the CPU diff's segments inside the O(width x height x diffs)
   traffic bound; (b) ``testing.ManagedCluster`` at a Riak KV strong
   consistency deployment's size: 5 nodes, the root ensemble on all 5,
   64 ensembles (one per partition of the default 64-partition ring) x
   5 peers (n_val 5) on 5 distinct nodes, 100 keys each through
   ``kput_once`` / ``kover`` / ``kget`` / ``kupdate`` / ``kmodify`` /
   ``kdelete``, a leader suspended and re-elected, a leader's synctree
   corrupted and healed by exchange, and every acknowledged put read
   back; it prints the wall seconds to elect, the wall µs per op (p50,
   p99) and the simulated seconds, and asserts that the lease clock is
   the host library's native one.
14. the scale plane under consensus management: (a) two svcnodes'
   services at the headline shape, ``dynamic=True``, each with a data dir
   at ``wal_sync="fsync"`` and a ``service_manager.ServiceReconciler``,
   over a ``ManagedCluster`` of 3 nodes with the root ensemble on all 3:
   ``svc@node0`` registers in ``service_directory``, 1,000 tenants (cut
   from 10,000, one a row, because each root mutation rewrites the
   gossiped cluster state in Python) are created through the root and
   adopted, 64 keys a tenant written with ``kput_many``; ``svc@node1``
   registers and the tenants rebalance by gossip alone (exports gathered
   on the card, ``destroy_ensemble``, ``install_objs`` on the new owner);
   every key reads back on its owner with its (epoch, seq), a CAS token
   minted before the move succeeds on every moved tenant and a stale one
   fails; ``set_tenant_view`` on 8 tenants reaches ``member_np``
   (``update_members``, K1) and their keys read back; 8 tenants retire
   and run nowhere; any ``svc_reconcile_error`` /
   ``svc_reconcile_tenant_error`` event fails it; it prints each step's
   wall time, export and ``install_objs`` ms per tenant (median, p99) and
   the view change's ms; (b) the port's ``ServiceReadWorkload`` under its
   nemesis (lease expiry, leader step-down and re-election, clock jumps
   into the margin) on a headline-shape service, 400 rounds over one key
   an ensemble, checked by the port's ``KeyModel``, at depth 1, depth 2
   and a skewed margin: no violation, fast-read hits above 0; (c) three
   ``python -m riak_ensemble_tpu_torch.netnode`` processes on loopback:
   enable, join, an ensemble with its leader hint on node1, 32 writes,
   kill -9 of node1, 32 overwrites through the survivors, node1 restarted
   on its port once it binds again (at most 10 s), every acknowledged
   write read back (a timed-out op is retried, never counted as
   acknowledged).
15. the mesh (``parallel/mesh.py``, ``parallel/distributed.py``) on every
   card ``torch.cuda.device_count()`` reports — on one card every shard
   sits on it; it prints the card count and each shard's device: (a) the
   reference's ``test_multiprocess.py`` scenario (elections, K/V, a
   failover, a joint-consensus shrink, reads) through ``ShardedEngine``
   at (4, 1), the headline shape, and at (2, 2) with M = 6 (the 5 peers
   and one absent from every view), every result and state plane (tree
   hashes included) bit-equal to the unsharded engine on card 0; F1 and K1
   launches per shard and F1's device ms per shard (CUDA events); (b) a
   ``BatchedEnsembleService`` over ``mesh_engine`` at (4, 1) against one
   over the single engine at the same full launch grid (no sliced step,
   so leases renew on the same rows), data dirs at ``wal_sync="fsync"``,
   one seeded
   keyed stream (puts, CAS hit and miss, RMW, deletes, gets) on every row
   and then on 256 rows (the shard-wise compaction): futures, state,
   mirrors and WAL bytes equal, every acknowledged write read back, the
   flush median of each arm and the packed bytes shard-wise against full
   width; (c) ``save`` from the mesh service, ``restore`` onto the single
   engine, and back onto the mesh, bit-equal; (d) ``python -m
   riak_ensemble_tpu_torch.svcnode --mesh-devices N`` (one card: N = 4
   shards of ``--device cuda:0``) serving a ``ServiceClient``, every
   acknowledged write read back; (e) two processes of this script under
   ``distributed.initialize`` forming one global (4, 1) mesh, two shards
   each, running (a)'s scenario, each checking its own shards against an
   unsharded run.
16. the nemesis on the card: phase 12's group (the leader here, two
   replica processes on the same card, a data dir each at ``wal_sync=
   "fsync"``) after ``warmup()``, ``takeover()`` and a warm keyed round,
   every op of the phase filed with its key's ``KeyModel``: (a) a replica
   SIGSTOPped while 6(b)'s keyed pattern (256 rows x 48 keys) runs, every
   write committing at 2 of 3 inside the ack deadline; after SIGCONT its
   re-sync (a tree patch, an install, or its own socket backlog) and its
   lane equal to the leader's; then kill -9 of the other replica and every
   key read back by quorum rounds at 2 of 3; (b) the return direction of
   every link blackholed in this process (``faults.FaultPlan().drop(link.
   label, faults.LOCAL)``): the leader acks nothing and ``health()
   ["injected"]`` names the plan, a replica promotes itself with the other
   as its peer and commits through a ``ServiceClient``, every key reads
   back through it, and after ``plan.heal()`` the old leader sees that it
   is deposed; (c) ``tools.trace_export`` over (a)'s flush ids, the leader's
   span store and the fleet timelines with the replicas' spans, every
   exported span equal to its record.  Before each stage
   ``utils.trace.dump_ensemble`` / ``peer_info`` of a ``testing.Cluster``
   bring-up are held against the cluster and the first run's.  It prints
   the ms from the SIGSTOP to the first 2-of-3 commit, the re-sync's ms and
   bytes, the ms from the blackhole to the new leader's first ack, the
   deposed leader's acks (0), F1 launches per host, and the export's events
   and ms.

Phases 4-10 run the service's default (native) host arm.

``--f1`` runs the build and F1's phases 3b and 6(a) alone, ``--wide``
the build and phase 11(a), ``--repgroup`` the build and phase 12,
``--scalar`` the build and phase 13, ``--tenants`` the build and phase
14, ``--mesh`` the build and phase 15, ``--nemesis`` the build and phase
16 (no result line); ``--ab DIR``
times F1 at the headline shape (full width and four sliced shapes),
phase 6(c) and F1's wide mode at 11(a)'s four timed shapes in the tree
DIR and in this one, on one card, in turns (DIR, this, this, DIR), each
turn a process of its own running this file's timing code on its tree's
package.

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
import inspect
import json
import os
import pickle
import shutil
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
from riak_ensemble_tpu_torch.ops import hash as hashk
from riak_ensemble_tpu_torch.ops.quorum import REQUIRED_MODES
from riak_ensemble_tpu_torch.parallel import distributed
from riak_ensemble_tpu_torch.parallel import enqueue_native, resolve_native
from riak_ensemble_tpu_torch.parallel.batched_host import (
    BatchedEnsembleService, WallRuntime, _LocalEngine)
from riak_ensemble_tpu_torch.parallel.mesh import (
    Sharded, ShardedEngine, make_mesh, mesh_engine)
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


def device_us_per_launch(fn, name: str, n: int = 50,
                         per_call: int = 1) -> float:
    """Device time per launch of the kernel whose name contains
    ``name``, from torch.profiler over ``n`` back-to-back calls that
    each launch it ``per_call`` times (averaged over the launches the
    trace holds: it may drop one of a window).  A window whose trace
    dropped more is traced again, up to three windows in all."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages() if name in ev.key]
        count = sum(ev.count for ev in evs)
        if n * per_call - 2 <= count <= n * per_call:
            return sum(ev.self_device_time_total for ev in evs) / count
        print(f"profiler saw {count} of {n * per_call} launches of {name}; "
              f"tracing again")
    raise AssertionError(f"profiler saw {count} of {n * per_call} "
                         f"launches of {name}")


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

#: (name, E, M, S, K, views, steps, elect every step[, stream pattern])
#: — the patterns are :func:`f1_stream`'s
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
    ("targeted damage, then repeated writes to one bucket", 2048, 5, 128,
     64, None, 3, True, "bucket"),
    ("a corrupt node that is never written", 2048, 5, 128, 64, None, 3,
     True, "avoid"),
    ("M=32 S=128 (32 replicas staged)", 512, 32, 128, 16, None, 3, True),
    ("M=7 S=1024 (208 KB staged, near the cap)", 256, 7, 1024, 16, None, 2,
     True),
]


def f1_stream(rng: np.random.Generator, leader: np.ndarray, e: int, m: int,
              s: int, k: int, pattern: str = "mixed",
              bucket: Optional[np.ndarray] = None):
    """One step's full_step inputs: elections with bogus candidates, down
    leaders and down peers, every op kind and RMW code (and one unknown
    code), operands at the int32 edges, invalid slots and tombstones;
    one column in seven runs put/RMW-add at INT32_MAX and put/RMW-sub at
    INT32_MIN on one slot, so the wraparound is certain to run.
    ``pattern="bucket"``: every op a read, put, CAS or RMW inside row r's
    16-slot bucket starting at ``bucket[r]``; ``"avoid"``: no op reaches
    slots 0-15, so a node over them is never written."""
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
    if pattern == "bucket":
        slot = np.minimum(bucket[None, :] + rng.integers(0, 16, (k, e)),
                          s - 1).astype(np.int32)
        kind = rng.choice([eng.OP_GET, eng.OP_PUT, eng.OP_PUT, eng.OP_CAS,
                           eng.OP_RMW], (k, e)).astype(np.int32)
    elif pattern == "avoid":
        slot = np.where((slot >= 0) & (slot < 16), slot + 16,
                        slot).astype(np.int32)
    return elect, cand, kind, slot, val, lease, up, exp_e, exp_s


def damage(rng: np.random.Generator, states, n: int,
           bucket: Optional[np.ndarray] = None, node0: bool = False) -> None:
    """The same out-of-band damage on every state: object values, leaf
    lanes and upper-node lanes of random replicas.  With ``bucket``
    (row r's 16-slot bucket starts at ``bucket[r]``) the objects and
    leaves hit lie in the row's bucket and the nodes hit are its
    level-0 node; with ``node0`` the level-0 node over slots 0-15 of
    ``n`` rows is hit too."""
    st = states[0]
    e, m, s = st.obj_val.shape
    u = st.tree_node.shape[2]
    picks = [(rng.integers(0, e, n), rng.integers(0, m, n),
              rng.integers(0, s, n)) for _ in range(2)]
    nodes = (rng.integers(0, e, n), rng.integers(0, m, n),
             rng.integers(0, u, n))
    if bucket is not None:
        for rows, reps, slots in picks:
            slots[:] = np.minimum(bucket[rows] + rng.integers(0, 16, n),
                                  s - 1)
        nodes[2][:] = bucket[nodes[0]] // 16
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
        if node0:
            st.tree_node[ix(nodes[0]), ix(nodes[1]), 0, 1] ^= 0x40


def diff_fields(a, b, fields) -> list:
    """Fields whose planes differ (compared on the host, bit for bit)."""
    return [f for f in fields
            if not torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())]


def copy_state(st):
    return eng.EngineState(*(t.clone() for t in st))


def f1_case(dev, name, e, m, s, k, views, steps, elect_every, seed,
            pattern="mixed"):
    """Run one case's steps through F1 and through the plain version
    from the same state; raise on any difference.  Returns counts of
    what the stream exercised."""
    rng = np.random.default_rng(seed)
    st_f1 = eng.init_state(e, m, s, views=views, device=dev)
    st_pl = copy_state(st_f1)
    stats = {"won": 0, "commits": 0, "corrupt": 0, "get_ok": 0}
    bucket = 16 * rng.integers(0, -(-s // 16), e)
    for step in range(steps):
        if step:
            damage(rng, (st_f1, st_pl), max(e // 40, 4),
                   bucket=bucket if pattern == "bucket" else None,
                   node0=pattern == "avoid")
        leader = st_pl.leader.cpu().numpy()
        planes = [torch.from_numpy(p).to(dev)
                  for p in f1_stream(rng, leader, e, m, s, k, pattern,
                                     bucket)]
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


def bound(nbytes: int, ops: int) -> tuple:
    """(bytes ms, int32 ops ms, bound ms) at the card's published peaks."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return bytes_ms, ops_ms, max(bytes_ms, ops_ms)


def gated_us(fn, n: int = 20, reps: int = 3) -> float:
    """Device µs per call of ``fn`` (one kernel launch each): CUDA events
    around ``n`` calls queued behind a 50 ms stream sleep, so the host's
    enqueue time stays out of the window; the median of ``reps``."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(0.05 * 1.98e9))
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) * 1e3 / n)
    return statistics.median(per)


def host_us(fn, n: int = 20, reps: int = 5) -> float:
    """Host µs per call of ``fn`` (the enqueue, without a synchronise):
    the median over ``reps`` windows of ``n`` calls."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        per.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per)


def launch_timings(fn) -> dict:
    """One launch per call of ``fn``: ms per call back to back, device µs
    per launch (gated events), host µs per call, and the per-call
    overhead (ms per call minus the device time)."""
    ms = cuda_ms(fn, iters=10)
    dev_us = gated_us(fn)
    return {"ms": ms, "device_us": dev_us, "host_us": host_us(fn),
            "overhead_ms": ms - dev_us / 1e3}


def f1_occupancy(label: str, e: int, m: int, s: int, v: int, k: int,
                 a: int) -> dict:
    """Print and return how an F1 launch at these dims runs."""
    occ = cuda_engine.occupancy(e, m, s, v, k, a)
    print(f"F1 occupancy {label}: {occ['regs_per_thread']} registers per "
          f"thread, {occ['static_smem']} B static + {occ['dynamic_smem']} B "
          f"dynamic shared memory, {occ['spill_bytes']} B spilled, "
          f"{occ['warps_per_block']} warps per block, "
          f"{occ['blocks_per_sm']} resident blocks per SM of {occ['sms']} "
          f"SMs")
    return occ


def f1_bounds(pre, post, up: np.ndarray, kind: np.ndarray,
              slot: np.ndarray, committed: np.ndarray,
              rows: Optional[np.ndarray] = None,
              groups: Optional[int] = None) -> dict:
    """F1's bound for one launch with election planes that took ``pre`` to
    ``post`` on these inputs (``kind`` / ``slot`` / ``committed``
    ``[K, A]``; sliced: column i steps ``rows[i]``, the rest are pads; a
    wide launch hands in its flat rounds, ``cuda_engine.flat_rounds``, and
    its ``groups``).
    The bytes it must move (``cuda_engine.design_bytes``: the heard
    replicas of the staged rows read, the replicas that changed written),
    the design's hashing (``cuda_engine.design_work``), and the counts of
    PR 3-8's bound (``cuda_engine.step_work``: every plane read and
    written once, a path verify per replica and round).  ``bound_ms`` is
    the larger of the bytes and the design's ops."""
    e, m, s = pre.obj_val.shape
    v = pre.view_mask.shape[1]
    k, a = kind.shape
    rows = np.arange(e) if rows is None else np.asarray(rows)
    n = len(rows)

    def changed(*fields):
        out = torch.zeros(pre.epoch.shape, dtype=torch.bool,
                          device=pre.epoch.device)
        for f in fields:
            x, y = getattr(pre, f), getattr(post, f)
            out |= (x != y).reshape(e, -1).any(1)[:, None] if x.dim() == 1 \
                else (x != y).reshape(e, m, -1).any(2)
        return out.cpu().numpy()[rows]
    wrote = changed("obj_epoch", "obj_seq", "obj_val", "tree_leaf",
                    "tree_node")
    ballot = changed("epoch", "fact_seq", "leader", "obj_seq_ctr").any(1)
    heard = (up & pre.view_mask.any(1).cpu().numpy())[rows]
    live = (kind >= 1) & (kind <= 4) & (slot >= 0) & (slot < s)
    staged = live[:, :n].any(0) if k else np.zeros(n, bool)
    moved = cuda_engine.design_bytes(heard, staged, wrote, ballot, s, v, k, a,
                                     groups)
    cols = np.zeros((a, m), bool)
    cols[:n] = heard
    work = cuda_engine.design_work(cols, kind, slot, committed, s)
    writers = int((committed[:, :n] * heard.sum(1)[None, :]).sum())
    old_bytes, ref_ops = cuda_engine.step_work(n, m, s, v, k, a, writers)
    bytes_ms, design_ms, bound_ms = bound(moved["bytes"], work["ops"])
    return {"bytes": moved["bytes"], "bytes_read": sum(moved["read"].values()),
            "bytes_written": sum(moved["written"].values()),
            "bytes_ms": bytes_ms, "design_ops": work["ops"],
            "design_ops_ms": design_ms, "ref_ops": ref_ops,
            "ref_ops_ms": bound(0, ref_ops)[1], "old_bytes": old_bytes,
            "old_bytes_ms": bound(old_bytes, 0)[0],
            "heard_staged": int((heard & staged[:, None]).sum()),
            "replicas_written": int(wrote.sum()),
            "design_work": work, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= design_ms else "operations"}


def bound_text(b: dict) -> str:
    return (f"bound {b['bound_ms']:.6f} ms = max(bytes {b['bytes']} B "
            f"({b['bytes_read']} read: {b['heard_staged']} heard replicas "
            f"of staged rows; {b['bytes_written']} written: "
            f"{b['replicas_written']} replicas changed) -> "
            f"{b['bytes_ms']:.6f} ms, design int32 ops {b['design_ops']} -> "
            f"{b['design_ops_ms']:.6f} ms); PR 3-8's counts: bytes "
            f"{b['old_bytes']} -> {b['old_bytes_ms']:.6f} ms, the reference "
            f"arithmetic's {b['ref_ops']} ops -> {b['ref_ops_ms']:.6f} ms")


def time_full(dev: torch.device, card: str, detail: bool = True) -> dict:
    """F1 at the headline shape, full width, on phase 3b's stream (about
    half the rows elect in every launch): :func:`launch_timings`; with
    ``detail`` also the plain version, the occupancy and the bound of one
    launch as timed."""
    e, m, s, k = E_FULL, M_FULL, S_FULL, K_FULL
    rng = np.random.default_rng(99)
    st = eng.init_state(e, m, s, device=dev)
    planes = [torch.from_numpy(p).to(dev) for p in f1_stream(
        rng, np.full(e, -1, np.int32), e, m, s, k)]
    args = planes[:7]
    kw = {"exp_epoch": planes[7], "exp_seq": planes[8]}
    st, _, _ = eng.full_step(st, *args, **kw)    # elect, fill the store
    torch.cuda.synchronize()
    out = {"max_abs_err": 0}
    if detail:
        pre = copy_state(st)
        st, _, res = eng.full_step(st, *args, **kw)
        torch.cuda.synchronize()
        b = f1_bounds(pre, st, planes[6].cpu().numpy(),
                      planes[2].cpu().numpy(), planes[3].cpu().numpy(),
                      res.committed.cpu().numpy())
        del pre
        out.update(bound_ms=b["bound_ms"], bound_by=b["bound_by"])

    def step():
        eng.full_step(st, *args, **kw)
    out.update(launch_timings(step))
    if not detail:
        return out
    st_pl = copy_state(st)
    out["plain_ms"] = cuda_ms(lambda: eng.full_step_plain(st_pl, *args, **kw),
                              iters=1, reps=3)
    out["occupancy"] = f1_occupancy(f"full width {e}x{m}x{s} K={k}", e, m,
                                    s, 2, k, e)
    print(f"F1 at {e}x{m}x{s} K={k} [{card}]: full_step {out['ms']:.6f} ms "
          f"per call back to back, {out['device_us']:.3f} us device time "
          f"per launch (gated events); host {out['host_us']:.3f} us per "
          f"call; plain {out['plain_ms']:.3f} ms; {bound_text(b)}")
    return out


def phase_f1(dev: torch.device, card: str):
    for i, case in enumerate(F1_CASES):
        name, e, m, s, k, views, steps, every = case[:8]
        t0 = time.perf_counter()
        stats = f1_case(dev, name, e, m, s, k, views, steps, every, 100 + i,
                        *case[8:])
        print(f"F1 == plain  {name}: E={e} M={m} S={s} K={k}, {steps} "
              f"steps, {stats} ({time.perf_counter() - t0:.1f} s)")
        if k and not (stats["commits"] and stats["corrupt"]):
            raise AssertionError(f"F1 case {name} exercised no commits or "
                                 f"no integrity flags: {stats}")
    return time_full(dev, card)


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
    cuda_engine.engine_step_wide_launches = 0
    cuda_quorum.quorum_launches = 0
    cuda_quorum.quorum_s_launches = 0


def read_counts() -> dict:
    return {"F1": cuda_engine.engine_step_launches,
            "F1 sliced": cuda_engine.engine_step_sliced_launches,
            # (an older tree's package, under --ab, has no wide count)
            "F1 wide": getattr(cuda_engine, "engine_step_wide_launches", 0),
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
    ("A=1, K=1 (a lone row, no pads)", E_FULL, M_FULL, S_FULL, 1, None, 3, 1,
     1, True),
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


def time_sliced(dev, card: str, n_real: int, bucket: int,
                k: int = K_FULL, puts: bool = False,
                detail: bool = True) -> dict:
    """Sliced F1 at the headline shape with ``n_real`` active rows in an
    A = ``bucket`` grid and ``k`` rounds, every real row electing
    (``puts``: every real round a put at a valid slot, as a serial
    ``kput`` sends): :func:`launch_timings`; with ``detail`` also the
    plain version, the occupancy and the bound of one launch as timed."""
    e, m, s = E_FULL, M_FULL, S_FULL
    rng = np.random.default_rng(98 + bucket)
    st = eng.init_state(e, m, s, device=dev)
    active, planes = sliced_inputs(rng, np.full(e, -1, np.int32), e, m, s,
                                   k, n_real, bucket, n_real > 1,
                                   elect_all=True)
    if puts:
        planes[2][:, :n_real] = eng.OP_PUT
        planes[3][:, :n_real] = rng.integers(0, s, (k, n_real))
    t = [torch.from_numpy(p).to(dev) for p in planes]
    args, kw = t[:7], {"exp_epoch": t[7], "exp_seq": t[8]}
    st, _, _ = eng.full_step_sliced(st, active, *args, **kw)  # elect, fill
    torch.cuda.synchronize()
    out = {"rows": n_real, "k": k, "max_abs_err": 0, "library_ms": None}
    if detail:
        pre = copy_state(st)
        st, _, res = eng.full_step_sliced(st, active, *args, **kw)
        torch.cuda.synchronize()
        b = f1_bounds(pre, st, planes[6], planes[2], planes[3],
                      res.committed.cpu().numpy(), rows=active[:n_real])
        del pre
        out.update(bound_ms=b["bound_ms"], bound_by=b["bound_by"])

    def step():
        eng.full_step_sliced(st, active, *args, **kw)
    out.update(launch_timings(step))
    if not detail:
        return out
    st_pl = copy_state(st)
    out["plain_ms"] = cuda_ms(lambda: eng.full_step_sliced_plain(
        st_pl, active, *args, **kw), iters=1, reps=3)
    label = (f"sliced A={bucket} ({n_real} rows) K={k}"
             + (" puts" if puts else ""))
    out["occupancy"] = f1_occupancy(label, e, m, s, 2, k, bucket)
    print(f"F1 {label} at {e}x{m}x{s} [{card}]: full_step_sliced "
          f"{out['ms']:.6f} ms per call back to back, "
          f"{out['device_us']:.3f} us device time per launch (gated "
          f"events); host {out['host_us']:.3f} us per call; per-call "
          f"overhead {out['overhead_ms']:.6f} ms; plain "
          f"{out['plain_ms']:.3f} ms; {bound_text(b)}")
    return out


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
    return {"A=256": time_sliced(dev, card, 250, 256),
            "A=256 K=1": time_sliced(dev, card, 250, 256, k=1),
            "A=2048": time_sliced(dev, card, 2000, 2048),
            "A=8 K=1 put": time_sliced(dev, card, 1, 8, k=1, puts=True)}


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
                   profile: Optional[str] = None) -> tuple:
    """6(c): a stream of K = 64 flushes at the headline size through
    ``execute`` at depth 1 and ``execute_async`` at depth 2, each run
    twice in the order 1, 2, 2, 1: equal results (first runs) and final
    state, the wall and host split per flush of every run, and the
    overlap — at depth 2 launch N + 1 is enqueued before the settle of
    launch N begins (at depth 1 never), and how often the card still
    runs it then.  Returns the first depth-2 run's counts, and
    the ms per flush and host split of every run by depth and of the
    device-resident stream."""
    e, m, s, k = E_FULL, M_FULL, S_FULL, K_FULL
    n = 12
    batches = execute_batches(n)
    stream = torch.cuda.current_stream(dev)
    svcs, busy, ahead, launched, splits = {}, {}, {}, {}, {}
    for depth in (1, 2):
        svc = svcs[depth] = BatchedEnsembleService(
            FixedClock(), e, m, s, tick=None, max_ops_per_tick=k, device=dev,
            pipeline_depth=depth)
        # elections, and every upload slot's pinned buffers, before the
        # runs: set-up, not flush time (the same count at both depths)
        for _ in range(4):
            svc.execute(*batches[0])
        torch.cuda.synchronize()
        busy[depth], ahead[depth], launched[depth] = [], [], [0]
        fetch, enqueue = svc._fetch_packed, svc._launch_enqueue

        def watched(fl, fetch=fetch, out=busy[depth], seen=ahead[depth],
                    n_launched=launched[depth]):
            # a later launch was enqueued before this settle began
            seen.append(n_launched[0] > len(seen) + 1)
            got = fetch(fl)
            out.append(not stream.query())  # a later launch still runs
            return got

        def counted(*args, enqueue=enqueue, n_launched=launched[depth],
                    **kwargs):
            n_launched[0] += 1
            return enqueue(*args, **kwargs)
        svc._fetch_packed = watched
        svc._launch_enqueue = counted
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
        ahead[depth].clear()
        launched[depth][0] = 0
        splits[depth].take()
        reset_counts()                                # this path's run
        t0 = time.perf_counter()
        out = run(depth)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if depth not in outs:
            outs[depth], counts[depth] = out, read_counts()
        runs.append((depth, wall, splits[depth].take(), sum(busy[depth][:-1]),
                     len(busy[depth]), sum(ahead[depth])))
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
    for depth, wall, split, overlapped, settles, early in runs:
        if early != (settles - 1 if depth == 2 else 0):
            raise AssertionError(f"6(c): depth {depth}: the next launch was "
                                 f"enqueued before {early} of {settles} "
                                 f"settles")
        print(f"6(c) pipeline depth {depth} [{card}]: {n} flushes of K={k} x "
              f"{e} in {wall * 1e3:.3f} ms, {wall / n * 1e3:.3f} ms per "
              f"flush, {n * k * e / wall:.1f} ops/s; the next launch "
              f"enqueued before {early} of {settles} settles, the card still "
              f"busy at {overlapped} of {settles - 1}; host ms per flush: "
              f"{split_line(split, n)}")
    for depth, (dev_us, share) in shares.items():
        print(f"6(c) pipeline depth {depth} [{card}]: device kernel time "
              f"{dev_us:.1f} us per flush, busy share {share:.3f} "
              f"(profiled)")
    print(f"6(c) launches [{card}]: depth 1 {counts[1]}, depth 2 "
          f"{counts[2]}")
    summary = {f"depth {d}": {"ms_per_flush": [w / n * 1e3 for d2, w, *_
                                               in runs if d2 == d],
                              "busy_at_settle": [r[3] for r in runs
                                                 if r[0] == d],
                              "split": [{key: x / n for key, x in sp.items()}
                                        for d2, _, sp, *_ in runs
                                        if d2 == d]}
               for d in (1, 2)}
    summary["device-resident"] = device_resident_stream(dev, card, batches,
                                                        outs[1])
    return counts[2], summary


OP_PLANES = ("kind", "slot", "val", "exp_e", "exp_s")


def device_resident_stream(dev: torch.device, card: str, batches: list,
                           want: list) -> float:
    """6(c), device-resident: the same stream as CUDA int32 planes
    through ``execute`` at depth 1 on a service warmed like the
    depth-1 one: results bit-equal to the host-array run, no op-plane
    byte staged for the device, and ``k * E`` ops served per call.
    Returns the ms per flush."""
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
    return wall / n * 1e3


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

    def capture(taken, planes, rec=None):
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
        return real_log_wal(taken, planes, rec=rec)
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


# ---------------------------------------------------------------------------
# Phase 9: the control plane (reconfig launches, the timer, dynamic rows)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def reconfig_case(dev, label: str, st, prop, nv, up):
    """One ``reconfig_step`` (K1 for both gates, the state stepped in
    place on the card) against ``reconfig_step_plain`` on a copy: every
    state plane and ``installed`` / ``collapsed`` bit-equal.  Returns
    the stepped state, the two vectors and K1's launches in the step."""
    want = eng.reconfig_step_plain(copy_state(st), prop, nv, up)
    before = cuda_quorum.quorum_launches
    st, inst, coll = eng.reconfig_step(st, prop, nv, up)
    sync(dev)
    k1 = cuda_quorum.quorum_launches - before
    bad = diff_fields(want[0], st, eng.EngineState._fields)
    if bad or not torch.equal(want[1].cpu(), inst.cpu()) \
            or not torch.equal(want[2].cpu(), coll.cpu()):
        raise AssertionError(f"9(a) {label}: reconfig_step differs from "
                             f"reconfig_step_plain on {bad} / installed / "
                             f"collapsed")
    return st, inst, coll, k1


def phase_reconfig(dev: torch.device, card: str, e: int = E_FULL,
                   m: int = M_FULL, s: int = S_FULL, k: int = K_FULL,
                   n_prop: int = 1000) -> tuple:
    """9(a): after an election of every row, a one-member shrink proposed
    on a seeded ``n_prop`` rows (a seeded 5 % of rows with a majority of
    peers down, whose gate must refuse), then the collapse step, each
    ``reconfig_step`` bit-equal to ``reconfig_step_plain``; K1 launches
    per step, its device time per launch on this path, and the step's
    time.  Then the service: ``update_members`` on ``n_prop`` rows, a
    change left joint (its new view lacks a quorum) whose flush runs F1
    with two views and fails its writes, and the retry that collapses
    it; wall ms per call."""
    rng = np.random.default_rng(29)
    st = eng.init_state(e, m, s, device=dev)
    ones = torch.ones((e,), dtype=torch.bool, device=dev)
    zeros = torch.zeros((e,), dtype=torch.bool, device=dev)
    st, won = eng.elect_step(st, ones, torch.zeros((e,), dtype=torch.int32,
                                                   device=dev),
                             torch.ones((e, m), dtype=torch.bool,
                                        device=dev))
    up_np = np.ones((e, m), bool)
    lost = rng.choice(e, e // 20, replace=False)
    up_np[lost, 1:m // 2 + 2] = False          # a majority of peers down
    prop_np = np.zeros((e,), bool)
    prop_np[rng.choice(e, n_prop, replace=False)] = True
    nv_np = np.ones((e, m), bool)
    nv_np[np.arange(e), rng.integers(0, m, e)] = False
    up, prop, nv = (torch.from_numpy(x).to(dev)
                    for x in (up_np, prop_np, nv_np))
    st, inst, coll, k1_a = reconfig_case(dev, "propose", st, prop, nv, up)
    st, inst2, coll2, k1_b = reconfig_case(dev, "collapse", st, zeros, nv,
                                           up)
    n_inst, n_coll = int(inst.sum()), int(coll2.sum())
    want_inst = int((prop_np & np.isin(np.arange(e), lost,
                                       invert=True)).sum())
    if n_inst != want_inst or n_coll != n_inst or coll.any() \
            or inst2.any():
        raise AssertionError(f"9(a): installed {n_inst} (want "
                             f"{want_inst}), collapsed {n_coll}")
    if dev.type == "cuda" and (k1_a, k1_b) != (2, 2):
        raise AssertionError(f"9(a): K1 launched {k1_a} / {k1_b} times "
                             f"per reconfig_step, want 2")
    step_ms = plain_ms = k1_us = None
    if dev.type == "cuda":
        step_ms = cuda_ms(lambda: eng.reconfig_step(st, zeros, nv, up),
                          iters=50)
        plain_ms = cuda_ms(
            lambda: eng.reconfig_step_plain(st, zeros, nv, up), iters=20)
        k1_us = device_us_per_launch(
            lambda: eng.reconfig_step(st, zeros, nv, up),
            "quorum_met_kernel", n=25, per_call=2)
    print(f"9(a) reconfig_step at [{e}, {m}] x {s}, V=2 [{card}]: "
          f"{n_inst} of {n_prop} proposals installed ({len(lost)} rows "
          f"without a majority up), {n_coll} collapsed; bit-equal to "
          f"reconfig_step_plain on every plane; K1 {k1_a} + {k1_b} "
          f"launches (one per gate); step {step_ms} ms, plain "
          f"{plain_ms} ms; K1 {k1_us} us device time per launch")
    del st, want_inst
    # the service: update_members on the card
    svc = BatchedEnsembleService(WallRuntime(), e, m, s, tick=None,
                                 max_ops_per_tick=k, device=dev)
    sync(dev)
    reset_counts()                             # this path's run
    svc.flush()                                # elect every row
    sel = prop_np
    view = svc.member_np.copy()
    view[np.arange(e), rng.integers(0, m, e)] = False
    calls = []

    def members(label, sel_, view_, want_changed, want_k1):
        k1 = cuda_quorum.quorum_launches
        t0 = time.perf_counter()
        changed = svc.update_members(sel_, view_)
        sync(dev)
        calls.append((label, (time.perf_counter() - t0) * 1e3))
        k1 = cuda_quorum.quorum_launches - k1
        if int(changed.sum()) != want_changed or (
                dev.type == "cuda" and k1 != want_k1):
            raise AssertionError(f"9(a) {label}: {int(changed.sum())} "
                                 f"rows changed (want {want_changed}), K1 "
                                 f"{k1} (want {want_k1})")
    members("shrink", sel, view, n_prop, 4)
    # a change left joint: on rows outside the shrink, peers 1 and 2 go
    # down and the new view {0, 1, 2} lacks a quorum, so the install
    # lands and the collapse cannot
    joint = np.sort(rng.choice(np.flatnonzero(~sel), 100, replace=False))
    for r in joint:
        for p in (1, 2):
            svc.set_peer_up(int(r), p, False)
    jsel = np.zeros((e,), bool)
    jsel[joint] = True
    jview = np.zeros((e, m), bool)
    jview[:, :3] = True
    members("joint install", jsel, jview, 0, 4)
    if not svc._pending_mask[joint].all():
        raise AssertionError("9(a): the joint installs did not land")
    futs = [svc.kput_many(int(r), ["j"], [b"joint"]) for r in joint]
    shrunk = np.flatnonzero(sel)[:100]
    futs_ok = [svc.kput_many(int(r), ["s"], [b"shrunk"]) for r in shrunk]
    drive(svc, futs + futs_ok, 8)
    if any(f.value != ["failed"] for f in futs) or \
            any(f.value[0][0] != "ok" for f in futs_ok):
        raise AssertionError("9(a): writes under the joint views / the "
                             "shrunk views did not fail / commit")
    for r in joint:
        for p in (1, 2):
            svc.set_peer_up(int(r), p, True)
    members("retry (collapse)", np.zeros((e,), bool), jview, 100, 2)
    futs = [svc.kput_many(int(r), ["j"], [b"joint"]) for r in joint]
    drive(svc, futs, 8)
    if any(f.value[0][0] != "ok" for f in futs) or \
            not (svc.member_np[joint] == jview[joint]).all():
        raise AssertionError("9(a): the collapsed rows do not serve")
    counts = read_counts()
    print(f"9(a) update_members at {e} x {m} x {s} [{card}]: wall ms per "
          f"call {[(lab, round(ms, 3)) for lab, ms in calls]}; 100 writes "
          f"under joint views failed, then committed after the collapse; "
          f"launches {counts}")
    return counts, {"step_ms": step_ms, "plain_ms": plain_ms,
                    "device_us": k1_us, "per_step": k1_a,
                    "update_members_ms": {lab: ms for lab, ms in calls}}


class TimedService(BatchedEnsembleService):
    """The service with each top-level flush labelled by its cause:
    "tick" (the timer) or "burst" (the burst trigger's kick); the wall
    time of each flush that settled a launch is kept by cause, the rest
    (idle ticks) are counted."""

    def __init__(self, *a, **kw) -> None:
        self.cause = None
        self.ms = {"tick": [], "burst": []}
        self.idle = 0
        self._depth = 0
        super().__init__(*a, **kw)

    def _on_tick(self) -> None:
        self.cause = "tick"
        try:
            super()._on_tick()
        finally:
            self.cause = None

    def flush(self) -> int:
        if self._depth:
            return super().flush()
        cause = self.cause or "burst"
        self.cause = cause
        self._depth += 1
        settled = self.flushes
        t0 = time.perf_counter()
        try:
            return super().flush()
        finally:
            sync(self.device)
            if self.flushes > settled:
                self.ms[cause].append((time.perf_counter() - t0) * 1e3)
            else:
                self.idle += 1
            self._depth -= 1
            if cause == "burst":
                self.cause = None


def phase_timer(dev: torch.device, card: str, e: int = E_FULL,
                m: int = M_FULL, s: int = S_FULL, k: int = K_FULL,
                n_rows: int = 256, rounds: int = 8) -> dict:
    """9(b): the timer on the simulator runtime (``tick=0.005``,
    ``max_ops_per_tick=k``).  Each round: bursts of ``kput_many`` /
    ``kupdate_many`` / ``kdelete_many`` of ``k`` keys on 32 of the
    ``n_rows`` rows (each reaches ``k`` rounds: it must flush on the
    next runtime turn, by the burst trigger), single puts on 16 rows (a
    trickle: it must wait for the tick), leader kills through
    ``set_peer_up`` and ``update_members`` churn between flushes.
    Watchers on every row must see every leader change, and every
    acknowledged write reads back once the service is quiesced."""
    from riak_ensemble_tpu_torch.runtime import Runtime
    from riak_ensemble_tpu_torch.types import NOTFOUND
    rng = np.random.default_rng(31)
    rt = Runtime(seed=31)
    svc = TimedService(rt, e, m, s, tick=0.005, max_ops_per_tick=k,
                       device=dev)
    rows = np.sort(rng.choice(e, n_rows, replace=False)).tolist()
    events = {r: [] for r in rows}
    for r in rows:
        svc.watch_leader(r, lambda en, o, n: events[en].append((o, n)))
    want = {}                       # (row, key) -> acked value
    late = []                       # futures whose cause is wrong
    sync(dev)
    reset_counts()                             # this path's run
    rt.run_for(0.006)                          # a tick elects every row
    keys = [f"b{i}" for i in range(k)]
    down = {}
    for rnd in range(rounds):
        t_sub = rt.now
        burst_rows = rng.choice(rows, 32, replace=False).tolist()
        for i, r in enumerate(burst_rows):
            kind = (rnd + i) % 3
            vals = [b"r%d:%d" % (rnd, j) for j in range(k)]
            if kind == 0:
                f = svc.kput_many(r, keys, vals)
            elif kind == 1:
                f = svc.kupdate_many(r, keys, [(0, 0)] * k, vals)
            else:
                f = svc.kdelete_many(r, keys)
            # a delete of keys the row no longer holds resolves at once,
            # with no device round
            served = not f.done

            def on_burst(res, r=r, kind=kind, vals=vals, served=served):
                if served and (svc.cause != "burst" or rt.now != t_sub):
                    late.append(("burst", r, svc.cause, rt.now))
                for key, v, x in zip(keys, vals, res):
                    if isinstance(x, tuple) and x[0] == "ok":
                        want[r, key] = NOTFOUND if kind == 2 else v
            f.add_waiter(on_burst)
        rt.run_for(0.0005)                    # the next turns: the kick
        trickle = [r for r in rng.choice(rows, 16, replace=False).tolist()
                   if r not in burst_rows]
        for r in trickle:
            v = b"t%d" % rnd

            def on_trickle(res, r=r, v=v):
                if svc.cause != "tick":
                    late.append(("trickle", r, svc.cause, rt.now))
                if isinstance(res, tuple) and res[0] == "ok":
                    want[r, "t"] = v
            svc.kput(r, "t", v).add_waiter(on_trickle)
        # the nemesis, between flushes
        for r in rng.choice(rows, 4, replace=False).tolist():
            if r in down:
                svc.set_peer_up(r, down.pop(r), True)
            elif svc.leader_np[r] >= 0:
                down[r] = int(svc.leader_np[r])
                svc.set_peer_up(r, down[r], False)
        csel = np.zeros((e,), bool)
        csel[rng.choice(rows, 8, replace=False)] = True
        view = svc.member_np.copy()
        for r in np.flatnonzero(csel):
            if view[r].all():
                view[r, int(rng.integers(m))] = False
            else:
                view[r] = True
        svc.update_members(csel, view)
        rt.run_for(0.012)                     # ticks
    for r, p in list(down.items()):
        svc.set_peer_up(r, p, True)
    rt.run_for(0.05)                          # quiesce
    if svc._active or svc._inflight:
        raise AssertionError("9(b): the timer left work queued")
    reads = {r: svc.kget_many(r, keys + ["t"]) for r in rows}
    rt.run_for(0.02)
    bad = 0
    for r, f in reads.items():
        if not f.done:
            raise AssertionError("9(b): a read-back never resolved")
        for key, x in zip(keys + ["t"], f.value):
            exp = want.get((r, key), NOTFOUND)
            if x != ("ok", exp):
                bad += 1
    counts = read_counts()
    n_events = sum(len(v) for v in events.values())
    for r, ev in events.items():
        chain = all(ev[i][0] == ev[i - 1][1] for i in range(1, len(ev)))
        if not chain or ev[-1][1] != int(svc.leader_np[r]):
            raise AssertionError(f"9(b): watcher of row {r} missed a "
                                 f"leader change: {ev}")
    if bad or late:
        raise AssertionError(f"9(b): {bad} acknowledged writes did not "
                             f"read back; wrong flush cause {late[:4]}")
    svc.stop()
    nb, nt = len(svc.ms["burst"]), len(svc.ms["tick"])
    med = {c: statistics.median(v) if v else None
           for c, v in svc.ms.items()}
    print(f"9(b) timer at {e} x {m} x {s}, tick 0.005, K {k} [{card}]: "
          f"{nb} burst flushes (median {med['burst']} ms wall), {nt} tick "
          f"flushes with a launch (median {med['tick']} ms wall), "
          f"{svc.idle} idle flushes; {len(want)} acked "
          f"writes read back; {n_events} watcher events on {n_rows} rows, "
          f"every leader change seen; launches {counts}")
    return counts, {"burst_flushes": nb, "tick_flushes": nt,
                    "idle_flushes": svc.idle,
                    "burst_ms": med["burst"], "tick_ms": med["tick"],
                    "watcher_events": n_events}


def phase_dynamic(dev: torch.device, card: str, e: int = E_FULL,
                  m: int = M_FULL, s: int = S_FULL,
                  k: int = K_FULL) -> tuple:
    """9(c): ``dynamic=True`` at ``e`` rows with a fresh data dir and
    ``wal_sync="fsync"``: create every row, keyed writes, destroy half,
    ops on destroyed rows fail, recreate a quarter, keyed writes; drop
    the service without a save, restore on the card (names, membership
    rows and every acknowledged write come back); a restore with the
    wrong ``dynamic`` flag raises.  mem records and fsyncs per call, ms
    per create, destroy and restore."""
    import shutil
    rng = np.random.default_rng(37)
    data = tempfile.mkdtemp(prefix="retpu_dynamic_")
    svc = BatchedEnsembleService(WallRuntime(), e, m, s, tick=None,
                                 max_ops_per_tick=k, device=dev,
                                 dynamic=True, data_dir=data,
                                 wal_sync="fsync")
    meter = WalMeter(svc)
    sync(dev)
    reset_counts()                             # this path's run
    per = {}

    def timed(label, fn, items):
        meter.take()
        t0 = time.perf_counter()
        out = [fn(x) for x in items]
        sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        recs, _b, fsyncs, _a = meter.take()
        per[label] = (len(items), ms / len(items), recs / len(items),
                      fsyncs / len(items))
        return out
    rows = timed("create", svc.create_ensemble, [f"t{i}" for i in range(e)])
    if sorted(rows) != list(range(e)):
        raise AssertionError("9(c): creates did not take every row")
    keys = [f"k{i}" for i in range(16)]
    want = {}

    def write(sub, tag):
        futs = {r: svc.kput_many(r, keys, [b"%s:%d:%d" % (tag, r, i)
                                           for i in range(len(keys))])
                for r in sub}
        drive(svc, list(futs.values()), 8)
        for r, f in futs.items():
            if any(x[0] != "ok" for x in f.value):
                raise AssertionError(f"9(c): a write on row {r} failed")
            want[r] = [b"%s:%d:%d" % (tag, r, i) for i in range(len(keys))]
    write(sorted(rng.choice(e, 256, replace=False).tolist()), b"a")
    gone = [f"t{i}" for i in range(0, e, 2)]
    dead_rows = [svc.resolve_ensemble(n) for n in gone]
    timed("destroy", svc.destroy_ensemble, gone)
    for r in dead_rows:
        want.pop(r, None)
    probes = [svc.kget(r, "k0") for r in dead_rows[:64]] + \
        [svc.kput_many(r, ["x"], [b"x"]) for r in dead_rows[:64]]
    if any(not f.done or f.value not in ("failed", ["failed"])
           for f in probes):
        raise AssertionError("9(c): an op on a destroyed row did not fail")
    new = timed("recreate", svc.create_ensemble,
                [f"u{i}" for i in range(e // 4)])
    if None in new or not set(new) <= set(dead_rows):
        raise AssertionError("9(c): recreates did not recycle free rows")
    live = np.flatnonzero(svc._live)
    write(sorted(rng.choice(live, min(256, live.size),
                            replace=False).tolist()), b"b")
    counts = read_counts()
    names = dict(svc._ens_names)
    member = svc.member_np.copy()
    svc._wal.close()                           # dropped without a save
    del svc, meter
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    try:
        BatchedEnsembleService.restore(WallRuntime(), data, tick=None,
                                       device=dev, dynamic=False)
    except ValueError:
        pass
    else:
        raise AssertionError("9(c): a restore with dynamic=False did not "
                             "raise")
    sync(dev)
    t0 = time.perf_counter()
    back = BatchedEnsembleService.restore(
        WallRuntime(), data, tick=None, max_ops_per_tick=k, device=dev,
        data_dir=data, wal_sync="fsync")
    sync(dev)
    restore_ms = (time.perf_counter() - t0) * 1e3
    if back._ens_names != names or not (back.member_np == member).all() \
            or not back.dynamic:
        raise AssertionError("9(c): the restore lost names or membership")
    futs = {r: back.kget_many(r, keys) for r in want}
    drive(back, list(futs.values()), 8)
    bad = [r for r, f in futs.items()
           if f.value != [("ok", v) for v in want[r]]]
    if bad:
        raise AssertionError(f"9(c): acknowledged writes of {len(bad)} rows "
                             f"did not come back (first {bad[0]})")
    back._wal.close()
    shutil.rmtree(data, ignore_errors=True)
    print(f"9(c) dynamic rows at {e} x {m} x {s}, fsync [{card}]: "
          + "; ".join(f"{lab} x{n}: {ms:.3f} ms, {r:.2f} WAL records, "
                      f"{f:.2f} fsyncs per call"
                      for lab, (n, ms, r, f) in per.items())
          + f"; restore {restore_ms:.3f} ms ({len(names)} names, "
          f"{sum(len(v) for v in want.values())} acked writes back; "
          f"dynamic=False refused); launches {counts}")
    return counts, {lab: ms for lab, (n, ms, r, f) in per.items()} | {
        "restore_ms": restore_ms}


def phase_control_plane(dev: torch.device, card: str) -> tuple:
    """Phase 9: (a) reconfig, (b) the timer, (c) dynamic rows, each path
    read with its counts set to 0 just before it."""
    counts = {}
    c, rec = phase_reconfig(dev, card)
    counts["phase9a reconfig"] = c
    c, tim = phase_timer(dev, card)
    counts["phase9b timer"] = c
    c, dyn = phase_dynamic(dev, card)
    counts["phase9c dynamic rows"] = c
    return counts, {"reconfig": rec, "timer": tim, "dynamic": dyn}


# -- phase 10: the front end ---------------------------------------------------

WIRE_SRC = "riak_ensemble_tpu_torch/csrc/host/wirecodec.cc"
#: 10(b)'s serial client: this many kput, each followed by its kget
SERIAL_OPS = 2000


class CodecCount:
    """Counts the C++ codec's encode / decode calls (the service path's
    frames) while ``armed``; forwards everything else."""

    def __init__(self, mod) -> None:
        self.mod = mod
        self.armed = False
        self.calls = 0

    def encode(self, v):
        self.calls += self.armed
        return self.mod.encode(v)

    def decode(self, b):
        self.calls += self.armed
        return self.mod.decode(b)


def wire_corpus(rng: np.random.Generator) -> list:
    """Every record type, big ints, nesting one under the depth limit and
    seeded random structures."""
    from riak_ensemble_tpu_torch.state import ClusterState
    from riak_ensemble_tpu_torch.types import (NOTFOUND, EnsembleInfo, Fact,
                                               Obj, PeerId)
    deep = None
    for _ in range(31):
        deep = [deep]
    p = PeerId(1, "n1")
    out = [None, True, -(2 ** 90), 2 ** 63, -1, 0.25, "ünï", b"\x00\xff",
           NOTFOUND, deep, p, Obj(3, 7, ("k", 2), NOTFOUND),
           Fact(2, 5, p, ((p, PeerId(2, "n2")),), (1, 0), None, (0, 0),
                ((2, 1), ((p,),))),
           EnsembleInfo((1, 2), None, ((p,),), None),
           ClusterState(("c", 1.5), True, (1, 0), frozenset({"n1"}),
                        {"root": EnsembleInfo((0, 1), p, ((p,),), (1, 1))},
                        {"root": ((1, 1), ((p,),))})]

    def gen(depth=0):
        c = int(rng.integers(10 if depth < 5 else 6))
        if c < 2:
            return int(rng.integers(-2 ** 40, 2 ** 40)) << int(
                rng.integers(40))
        if c == 2:
            return float(rng.normal())
        if c == 3:
            return bytes(rng.integers(0, 256, int(rng.integers(0, 16)),
                                      dtype=np.uint8))
        if c == 4:
            return "".join(chr(int(rng.integers(32, 900)))
                           for _ in range(int(rng.integers(0, 8))))
        if c == 5:
            return Obj(int(rng.integers(9)), int(rng.integers(9)), "k",
                       NOTFOUND)
        n = int(rng.integers(0, 4))
        if c == 6:
            return tuple(gen(depth + 1) for _ in range(n))
        if c == 7:
            return [gen(depth + 1) for _ in range(n)]
        if c == 8:
            return {int(rng.integers(100)): gen(depth + 1)
                    for _ in range(n)}
        return frozenset(int(rng.integers(1000)) for _ in range(n))
    return out + [gen() for _ in range(2000)]


def phase_wire(card: str) -> dict:
    """10(a): the C++ codec against ``encode_py`` / ``decode_py`` byte for
    byte on the seeded corpus and on raw frames, then encode and decode
    of one 12,288-key frame each way, C++ against Python."""
    from riak_ensemble_tpu_torch import wire
    mod = wire._native_codec()
    if mod is None or not mod.__file__.startswith(build.BUILD_DIR):
        raise AssertionError(f"10(a): the codec is not the port's build: "
                             f"{mod}")
    corpus = wire_corpus(np.random.default_rng(10))
    for v in corpus:
        b = wire.encode_py(v)
        if mod.encode(v) != b:
            raise AssertionError(f"10(a): C++ encode differs for {v!r:.80}")
        if wire.encode_py(mod.decode(b)) != wire.encode_py(
                wire.decode_py(b)):
            raise AssertionError(f"10(a): C++ decode differs for {v!r:.80}")
    n = K_FULL * 192                     # 12,288 keys
    keys = [f"user:{i}" for i in range(n)]
    vals = [b"v%08d" % i for i in range(n)]
    lens = np.fromiter(map(len, keys), np.int32, n)
    vlens = np.fromiter(map(len, vals), np.int32, n)
    slab = b"".join(bytes(x) for x in wire.encode_parts(
        (1, "kput_slab", 7, wire.Raw(lens),
         wire.Raw("".join(keys).encode()), wire.Raw(vlens),
         wire.Raw(b"".join(vals)))))
    for dec in (mod.decode, wire.decode_py):
        got = dec(slab)
        if got[:3] != (1, "kput_slab", 7) or bytes(got[6]) != \
                b"".join(vals):
            raise AssertionError("10(a): the raw frame does not decode")
    frames = {"kput_many list frame": (1, "kput_many", 7, keys, vals),
              "kget_many result list": (1, [("ok", v, (3, i))
                                            for i, v in enumerate(vals)])}
    ms, plain_ms = {}, {}
    for label, v in frames.items():
        b = wire.encode_py(v)
        if mod.encode(v) != b or mod.decode(b) != wire.decode_py(b):
            raise AssertionError(f"10(a): {label} differs")
        ms[f"encode {label}"] = host_ms(lambda v=v: mod.encode(v))
        plain_ms[f"encode {label}"] = host_ms(lambda v=v: wire.encode_py(v))
        ms[f"decode {label}"] = host_ms(lambda b=b: mod.decode(b))
        plain_ms[f"decode {label}"] = host_ms(lambda b=b: wire.decode_py(b))
    ms["decode kput_slab raw frame"] = host_ms(lambda: mod.decode(slab))
    plain_ms["decode kput_slab raw frame"] = host_ms(
        lambda: wire.decode_py(slab))
    for label in ms:
        print(f"10(a) wire codec == encode_py / decode_py, {label} "
              f"({n} keys) [{card}]: C++ {ms[label]:.6f} ms, Python "
              f"{plain_ms[label]:.6f} ms")
    print(f"10(a) wire codec: {len(corpus)} corpus values and 1 raw frame "
          f"byte-equal through C++ and Python")
    return {"ms": ms, "plain_ms": plain_ms}


def pctl(xs: list, q: float) -> float:
    return float(np.percentile(np.asarray(xs), q))


def parse_prometheus(text: str) -> dict:
    """name{labels} -> value of every sample line; raises on a malformed
    line (the scrape must parse)."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        if not name:
            raise AssertionError(f"10(b): unparsable scrape line {line!r}")
        out[name] = float(value)
    return out


class LaunchShapes:
    """F1's launches on a path by shape (K, A, sliced): how many, the
    real rows of each, and a copy of the first launch's inputs of each
    shape, to time F1 at the shapes the path runs.  It wraps the wrapper
    ``cuda_engine.engine_step`` (which the engine calls by attribute) and
    calls through, so the launch counts are untouched."""

    def __init__(self) -> None:
        self.count: dict = {}
        self.rows: dict = {}
        self.sample: dict = {}
        self.fn = cuda_engine.engine_step
        self.sig = inspect.signature(self.fn)
        cuda_engine.engine_step = self._record

    def _record(self, state, *args, **kwargs):
        got = self.sig.bind(state, *args, **kwargs).arguments
        idx = got.get("active_idx")
        k, a = got["kind"].shape
        key = (k, a, idx is not None)
        self.count[key] = self.count.get(key, 0) + 1
        self.rows.setdefault(key, []).append(
            a if idx is None else int((idx < state.epoch.shape[0]).sum()))
        if key not in self.sample:
            self.sample[key] = {
                n: v.clone() if isinstance(v, torch.Tensor)
                else v.copy() if isinstance(v, np.ndarray) else v
                for n, v in got.items() if n != "state"}
        return self.fn(state, *args, **kwargs)

    def close(self) -> None:
        cuda_engine.engine_step = self.fn

    def top(self, n: int) -> list:
        return sorted(self.count, key=lambda key: -self.count[key])[:n]

    def time_top(self, state, card: str, label: str, n: int = 3) -> dict:
        """F1 at the path's ``n`` most launched shapes, each on a copy of
        ``state`` with its first launch's inputs: :func:`launch_timings`,
        and the launches and real rows of the shape on the path."""
        out = {}
        for key in self.top(n):
            k, a, sliced = key
            st = copy_state(state)
            args = self.sample[key]
            t = launch_timings(lambda: self.fn(st, **args))
            rows = self.rows[key]
            name = f"K={k} A={a}" + (" sliced" if sliced else "")
            out[name] = {"launches": self.count[key],
                         "rows_median": statistics.median(rows), **t}
            print(f"{label} F1 at its shape {name} [{card}]: "
                  f"{self.count[key]} launches, real rows median "
                  f"{statistics.median(rows)} (min {min(rows)}, max "
                  f"{max(rows)}); {t['device_us']:.3f} us device time per "
                  f"launch (gated events), {t['ms']:.6f} ms per call back "
                  f"to back, host {t['host_us']:.3f} us per call")
            del st
        return out


async def front_end_session(dev, card: str, data: str) -> dict:
    """10(b): ``serve()`` in process on loopback, one ServiceClient: the
    serial ops, the batched keyed pattern with up to 256 batches in
    flight, the read-back, the read-outs; returns the numbers and the
    kernels' counts of this path."""
    import asyncio

    from riak_ensemble_tpu_torch import svcnode, wire
    server = await svcnode.serve(E_FULL, M_FULL, S_FULL, tick=0.005,
                                 data_dir=data, device=dev, warm=True,
                                 max_ops_per_tick=K_FULL,
                                 wal_sync="fsync")
    svc = server.svc
    codec = CodecCount(wire._native_codec())
    wire._NATIVE = codec
    c = svcnode.ServiceClient(server.host, server.port)
    await c.connect()
    rng = np.random.default_rng(20)
    torch.cuda.synchronize()
    reset_counts()                                 # the main path's run
    shapes = LaunchShapes()
    codec.armed = True
    acked = {}
    serial = {"kput": [], "kget": []}
    ens = rng.integers(0, E_FULL, SERIAL_OPS).tolist()
    for i, x in enumerate(ens):
        t0 = time.perf_counter()
        r = await c.kput(x, f"s{i}", b"serial:%d" % i, timeout=60.0)
        serial["kput"].append((time.perf_counter() - t0) * 1e3)
        if r[0] != "ok":
            raise AssertionError(f"10(b): serial kput {i} answered {r}")
        acked[(x, f"s{i}")] = b"serial:%d" % i
        t0 = time.perf_counter()
        r = await c.kget(x, f"s{i}", timeout=60.0)
        serial["kget"].append((time.perf_counter() - t0) * 1e3)
        if r != ("ok", b"serial:%d" % i):
            raise AssertionError(f"10(b): serial kget {i} answered {r}")
    sub = np.sort(rng.choice(E_FULL, 256, replace=False)).tolist()
    keys = [f"user:{i}" for i in range(48)]
    batch_ms, acked_ops, t_batched = [], 0, 0.0

    async def timed(coro):
        t0 = time.perf_counter()
        out = await coro
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        return out
    for rnd in range(3):
        vals = {x: [b"b%d:%d:%d" % (rnd, x, i) for i in range(len(keys))]
                for x in sub}
        t0 = time.perf_counter()
        res = await asyncio.gather(*[timed(c.kput_many(x, keys, vals[x],
                                                       timeout=120.0))
                                     for x in sub])
        t_batched += time.perf_counter() - t0
        for x, rr in zip(sub, res):
            for key, v, r in zip(keys, vals[x], rr):
                if r[0] == "ok":
                    acked[(x, key)] = v
                    acked_ops += 1
        t0 = time.perf_counter()
        got = await asyncio.gather(*[timed(c.kget_many(x, keys,
                                                       timeout=120.0))
                                     for x in sub])
        t_batched += time.perf_counter() - t0
        acked_ops += sum(len(g) for g in got)
        for x, g in zip(sub, got):
            if g != [("ok", v) for v in vals[x]]:
                raise AssertionError(f"10(b) round {rnd}: acknowledged "
                                     f"puts of ensemble {x} did not read "
                                     f"back")
    # every acknowledged write, serial ones included, over the wire: one
    # request per ensemble, all in flight at once on the one connection
    # (~2,000, past the server's per-connection budget of 1,024)
    by_ens = {}
    for (x, key), v in acked.items():
        by_ens.setdefault(x, []).append((key, v))
    items = list(by_ens.items())
    t0 = time.perf_counter()
    got = await asyncio.gather(*[c.kget_many(x, [k for k, _ in kv],
                                             timeout=120.0)
                                 for x, kv in items])
    readback_s = time.perf_counter() - t0
    for (x, kv), g in zip(items, got):
        if g != [("ok", v) for _, v in kv]:
            raise AssertionError(f"10(b): acknowledged writes of "
                                 f"ensemble {x} did not read back")
    torch.cuda.synchronize()
    codec.armed = False
    counts = read_counts()
    shapes.close()
    state = copy_state(svc.state)
    stats = await c.stats()
    health = await c.health()
    health0 = await c.health(int(sub[0]))
    scrape = await c.metrics("prometheus")
    samples = parse_prometheus(scrape)
    lb = svc.latency_breakdown()
    await c.close()
    await server.stop()
    wire._NATIVE = codec.mod
    for label, v in (("stats()", stats), ("health()", health),
                     (f"health({sub[0]})", health0),
                     ("latency_breakdown()", lb)):
        print(f"10(b) {label} [{card}]: {json.dumps(v, default=str)}")
    print(f"10(b) ('metrics', 'prometheus') [{card}]: {len(samples)} "
          f"samples parsed")
    print(f"10(b) F1 launches by (K, A, sliced) [{card}]: "
          + ", ".join(f"{key}: {shapes.count[key]}"
                      for key in shapes.top(len(shapes.count))))
    f1_shapes = shapes.time_top(state, card, "10(b)")
    del state
    print(scrape)
    if not (samples.get("retpu_flushes_total", 0) >= 1
            and stats["obs_enabled"] and health["storage"]["degraded"]
            is False and samples.get(
                'retpu_op_latency_ms_count{kind="put"}', 0) > 0):
        raise AssertionError("10(b): the read-outs miss the session")
    out = {
        "serial_ops": len(serial["kput"]) * 2,
        "serial_kput_ms_p50": pctl(serial["kput"], 50),
        "serial_kput_ms_p99": pctl(serial["kput"], 99),
        "serial_kget_ms_p50": pctl(serial["kget"], 50),
        "serial_kget_ms_p99": pctl(serial["kget"], 99),
        "batched_acked_ops": acked_ops,
        "batched_ops_per_s": acked_ops / t_batched,
        "batch_ms_p50": pctl(batch_ms, 50),
        "batch_ms_p99": pctl(batch_ms, 99),
        "acked_writes_read_back": len(acked),
        "readback_requests_in_flight": len(items),
        "readback_s": readback_s,
        "codec_calls": codec.calls,
        "flushes": stats["flushes"],
        "compile_events": {k: v for k, v in samples.items()
                           if k.startswith("retpu_compile_events_total")},
        "flush_total_ms_p50": lb.get("total", {}).get("p50_ms"),
        "flush_total_ms_p99": lb.get("total", {}).get("p99_ms"),
        "f1_shapes": f1_shapes,
    }
    print(f"10(b) svcnode on loopback {E_FULL}x{M_FULL}x{S_FULL} K={K_FULL} "
          f"[{card}]: serial kput p50 {out['serial_kput_ms_p50']:.3f} / p99 "
          f"{out['serial_kput_ms_p99']:.3f} ms, kget p50 "
          f"{out['serial_kget_ms_p50']:.3f} / p99 "
          f"{out['serial_kget_ms_p99']:.3f} ms ({out['serial_ops']} ops); "
          f"batched {acked_ops} acked ops at "
          f"{out['batched_ops_per_s']:.1f} ops/s, per batch p50 "
          f"{out['batch_ms_p50']:.3f} / p99 {out['batch_ms_p99']:.3f} ms; "
          f"{len(acked)} acknowledged writes read back ({len(items)} "
          f"requests in flight at once, {readback_s:.3f} s); launches "
          f"{counts}; "
          f"codec calls {codec.calls}")
    return {"counts": counts, **out}


def obs_cost(dev, card: str) -> dict:
    """10(c): 6(b)'s keyed pattern in process on two services at the
    headline size, one built with obs on and one under ``RETPU_OBS=0``,
    their passes interleaved on, off, off, on (three times).  Each
    pass starts after a full collection and runs with the collector off,
    so no collection lands in the timed window; the collection after the
    pass is timed on its own, with the objects the pass left behind.
    Both arms must give equal results.  Returns per arm the median and
    mean flush ms, the host split per flush (6(b)'s stages and the rest)
    and the collection's ms and objects per pass."""
    rng = np.random.default_rng(14)
    sub = np.sort(rng.choice(E_FULL, 256, replace=False)).tolist()
    keys = [f"user:{i}" for i in range(48)]
    arms, passes = ("on", "off"), 3
    svcs, splits = {}, {}
    saved = os.environ.get("RETPU_OBS")
    try:
        for arm in arms:
            if arm == "off":
                os.environ["RETPU_OBS"] = "0"
            else:
                os.environ.pop("RETPU_OBS", None)
            svc = BatchedEnsembleService(FixedClock(), E_FULL, M_FULL,
                                         S_FULL, tick=None,
                                         max_ops_per_tick=K_FULL, device=dev)
            if svc._obs != (arm == "on"):
                raise AssertionError("10(c): RETPU_OBS did not take")
            svc.flush()
            torch.cuda.synchronize()
            svcs[arm], splits[arm] = svc, HostSplit(svc)
    finally:
        if saved is None:
            os.environ.pop("RETPU_OBS", None)
        else:
            os.environ["RETPU_OBS"] = saved
    ms = {a: [] for a in arms}
    results = {a: [] for a in arms}
    stage = {a: dict.fromkeys(HostSplit.STAGES, 0.0) for a in arms}
    gc_ms = {a: [] for a in arms}
    gc_objects = {a: [] for a in arms}
    for arm in ("on", "off", "off", "on") * passes:
        svc = svcs[arm]
        gc.collect()
        n0 = len(gc.get_objects())
        splits[arm].take()
        gc.disable()
        try:
            results[arm].append(keyed_rounds(svc, dev, sub, keys, ms[arm]))
            for key, v in splits[arm].take().items():
                stage[arm][key] += v
            gc_objects[arm].append(len(gc.get_objects()) - n0)
        finally:
            gc.enable()
        t0 = time.perf_counter()
        gc.collect()
        gc_ms[arm].append((time.perf_counter() - t0) * 1e3)
        for x in sub:               # every peer up again for the next pass
            for p in range(M_FULL):
                svc.set_peer_up(x, p, True)
    if results["on"] != results["off"]:
        raise AssertionError("10(c): obs on and off gave different results")
    del svcs, splits
    torch.cuda.empty_cache()
    out = {}
    for arm in arms:
        n = len(ms[arm])
        split = {k: v / n for k, v in stage[arm].items()}
        split["rest"] = max(sum(ms[arm]) / n - sum(split.values()), 0.0)
        out[arm] = {"flushes": n, "median_ms": statistics.median(ms[arm]),
                    "mean_ms": statistics.fmean(ms[arm]),
                    "split_ms_per_flush": split,
                    "gc_ms_per_pass": statistics.median(gc_ms[arm]),
                    "gc_objects_per_pass":
                        statistics.median(gc_objects[arm])}
        print(f"10(c) obs {arm} [{card}]: flush ms "
              f"{[round(x, 3) for x in ms[arm]]}")
    on, off = out["on"], out["off"]
    print(f"10(c) cost of obs, 6(b)'s keyed pattern, {passes * 2} passes "
          f"an arm interleaved, collector off in the timed window "
          f"[{card}]: median flush {on['median_ms']:.3f} ms obs on, "
          f"{off['median_ms']:.3f} ms RETPU_OBS=0; mean "
          f"{on['mean_ms']:.3f} / {off['mean_ms']:.3f} ms "
          f"({on['flushes']} / {off['flushes']} flushes); host ms per "
          f"flush on / off / on - off: " + ", ".join(
              f"{k} {on['split_ms_per_flush'][k]:.3f} / "
              f"{off['split_ms_per_flush'][k]:.3f} / "
              f"{on['split_ms_per_flush'][k] - off['split_ms_per_flush'][k]:+.3f}"
              for k in on["split_ms_per_flush"])
          + f"; collection after a pass {on['gc_ms_per_pass']:.3f} / "
          f"{off['gc_ms_per_pass']:.3f} ms for {on['gc_objects_per_pass']} "
          f"/ {off['gc_objects_per_pass']} objects left")
    return out


def svcnode_process(data: str, dynamic: bool = True):
    """``python -m riak_ensemble_tpu_torch.svcnode`` on the card, at the
    headline shape, on ``data``; returns (process, host, port)."""
    cmd = [sys.executable, "-m", "riak_ensemble_tpu_torch.svcnode",
           "--port", "0", "--n-ens", str(E_FULL), "--n-peers", str(M_FULL),
           "--n-slots", str(S_FULL), "--data-dir", data]
    if dynamic:
        cmd.append("--dynamic")
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    p = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
    line = p.stdout.readline()
    if "svcnode serving" not in line:
        p.kill()
        raise AssertionError(f"10(d): svcnode did not start: {line!r} "
                             f"{p.stderr.read()[-3000:]}")
    host, port = line.rsplit(" ", 1)[1].strip().rsplit(":", 1)
    return p, host, int(port)


def crash_restart(card: str, data: str) -> dict:
    """10(d): a svcnode process with a fresh data dir, 64 named
    ensembles and 4,096 keys written, SIGKILL, a restart on the same dir:
    every acknowledged write and the name directory read back."""
    import asyncio
    import signal

    from riak_ensemble_tpu_torch import svcnode
    t0 = time.perf_counter()
    p, host, port = svcnode_process(data)
    boot_s = time.perf_counter() - t0
    acked, rows = {}, {}
    try:
        async def write():
            c = svcnode.ServiceClient(host, port)
            await c.connect()
            for i in range(64):
                r = await c.create_ensemble(f"tenant{i}")
                if r[0] != "ok":
                    raise AssertionError(f"10(d): create answered {r}")
                rows[f"tenant{i}"] = r[1]
            res = await asyncio.gather(*[
                c.kput_many(row, [f"k{j}" for j in range(64)],
                            [b"%s:%d" % (name.encode(), j)
                             for j in range(64)], timeout=120.0)
                for name, row in rows.items()])
            for (name, row), rr in zip(rows.items(), res):
                for j, r in enumerate(rr):
                    if r[0] == "ok":
                        acked[(row, f"k{j}")] = b"%s:%d" % (name.encode(),
                                                            j)
            await c.close()
        asyncio.run(write())
    finally:
        p.send_signal(signal.SIGKILL)
        p.wait(60)
    if len(acked) != 4096:
        raise AssertionError(f"10(d): {len(acked)} of 4096 writes acked")
    t0 = time.perf_counter()
    p, host, port = svcnode_process(data, dynamic=False)
    restart_s = time.perf_counter() - t0
    try:
        async def read():
            c = svcnode.ServiceClient(host, port)
            await c.connect()
            for name, row in rows.items():
                if await c.resolve_ensemble(name) != ("ok", row):
                    raise AssertionError(f"10(d): {name} lost its row")
            got = await asyncio.gather(*[
                c.kget_many(row, [f"k{j}" for j in range(64)],
                            timeout=120.0) for row in rows.values()])
            for row, g in zip(rows.values(), got):
                if g != [("ok", acked[(row, f"k{j}")]) for j in range(64)]:
                    raise AssertionError(f"10(d): acknowledged writes of "
                                         f"row {row} did not read back")
            await c.close()
        asyncio.run(read())
    finally:
        p.send_signal(signal.SIGKILL)
        p.wait(60)
    print(f"10(d) svcnode process SIGKILL + restart [{card}]: boot "
          f"{boot_s:.3f} s, restart (restore from the data dir) "
          f"{restart_s:.3f} s; 64 names and 4096 acknowledged writes read "
          f"back")
    return {"boot_s": boot_s, "restart_s": restart_s, "acked": len(acked)}


def phase_front_end(dev: torch.device, card: str) -> tuple:
    """Phase 10: (a) the wire codec, (b) svcnode on loopback (the counted
    path), (c) the cost of obs, (d) a svcnode process killed and
    restarted."""
    import asyncio
    codec = phase_wire(card)
    data = tempfile.mkdtemp(prefix="retpu_p10_")
    sess = asyncio.run(front_end_session(dev, card, data))
    shutil.rmtree(data, ignore_errors=True)
    cost = obs_cost(dev, card)
    data = tempfile.mkdtemp(prefix="retpu_p10d_")
    crash = crash_restart(card, data)
    shutil.rmtree(data, ignore_errors=True)
    return sess.pop("counts"), codec, {"svcnode": sess, "obs_cost": cost,
                                       "crash_restart": crash}


# ---------------------------------------------------------------------------
# Phase 11: wide rounds (F1's wide mode) and the sharded host passes

#: (name, E, M, S, K, views, steps, chains, sliced (rows, bucket) or None,
#: aimed): ``chains`` False gives distinct slots per column (G = 1), True
#: every slot twice (G = 2); ``aimed`` puts a group's first lanes on slots
#: 0-15 and damages their level-0 node on a quarter of the rows, so that
#: several lanes of one group cross one corrupt internal node
WIDE_CASES = [
    ("headline, distinct slots (G=1)", E_FULL, M_FULL, S_FULL, K_FULL, None,
     2, False, None, False),
    ("headline, duplicate chains (G=2)", E_FULL, M_FULL, S_FULL, K_FULL,
     None, 2, True, None, False),
    ("M=3", 2048, 3, 128, 16, None, 2, True, None, False),
    ("M=7 S=33 (unaligned object rows, short level)", 2048, 7, 33, 16, None,
     2, True, None, False),
    ("M=32 S=16 (one level, 8 warps)", 512, 32, 16, 16, None, 2, True, None,
     False),
    ("M=7 S=1024 (208 KB staged)", 256, 7, 1024, 32, None, 2, True, None,
     False),
    ("joint views", 2048, 5, 128, 16, [[0, 1, 2], [1, 2, 3, 4]], 2, False,
     None, False),
    ("sliced A=256, chains", E_FULL, M_FULL, S_FULL, K_FULL, None, 2, True,
     (250, 256), False),
    ("sliced A=2048, distinct", E_FULL, M_FULL, S_FULL, K_FULL, None, 2,
     False, (2000, 2048), False),
    ("sliced M=7 S=1024 A=64, chains", 256, 7, 1024, 32, None, 2, True,
     (60, 64), False),
    ("shared corrupt node, lanes aimed under it (G=2)", 2048, M_FULL, S_FULL,
     32, None, 3, True, None, True),
]


def wide_slots(rng: np.random.Generator, k: int, a: int, s: int,
               chains: bool, aimed: bool = False) -> np.ndarray:
    """``[K, A]`` slots that schedule to one group (distinct in every
    column) or, with ``chains``, to two (each of K/2 distinct slots twice,
    the second time in a later, shuffled row), with a few invalid slots
    (below 0, and past S distinct by row: the scheduler chains every slot
    from 0 up).  ``aimed``: slots 0-15 (one level-0 node) come first."""
    n = k // 2 if chains else k
    keys = rng.random((s, a)) - aimed * (np.arange(s) < 16)[:, None]
    first = np.argsort(keys, axis=0)[:n]                     # [n, A] distinct
    if chains:
        again = first[np.argsort(rng.random((n, a)), axis=0),
                      np.arange(a)[None, :]]
        slot = np.concatenate([first, again])
    else:
        slot = first
    bad = rng.random((k, a))
    past = s + np.arange(k)[:, None]          # past S, distinct by row
    slot = np.where(bad < 0.03, -1, np.where(bad > 0.98, past, slot))
    return slot.astype(np.int32)


def wide_plan(kind, slot, val, lease, exp_e, exp_s, chains: bool):
    # imported here: ``--ab`` loads this file over an older tree's package
    from riak_ensemble_tpu_torch.ops import schedule
    plan = schedule.schedule_wide(kind, slot, val, lease, exp_e, exp_s)
    want = 2 if chains else 1
    if plan.kind.shape[0] != want:
        raise AssertionError(f"the wide plan has {plan.kind.shape[0]} "
                             f"groups, want {want}")
    return plan


def wide_ops(plan, dev) -> list:
    return [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (
        plan.kind, plan.slot, plan.val, plan.lease_ok, plan.exp_epoch,
        plan.exp_seq)]


def wide_case(dev, name, e, m, s, k, views, steps, chains, sliced, aimed,
              seed):
    """One case's steps through F1's wide mode and through the plain wide
    step from the same state, bit for bit on every state plane, ``won``
    and every result lane (NOOP and pad lanes included).  The second step
    of a full-width case runs ``kv_step_scan_wide`` (no election).
    ``aimed``: see :data:`WIDE_CASES`; ``shared`` then counts the (group,
    row) pairs in which two or more live lanes crossed a corrupt level-0
    node of one heard replica."""
    rng = np.random.default_rng(seed)
    st_f1 = eng.init_state(e, m, s, views=views, device=dev)
    st_pl = copy_state(st_f1)
    stats = {"won": 0, "commits": 0, "corrupt": 0, "lanes": 0, "shared": 0}
    for step in range(steps):
        if step:
            damage(rng, (st_f1, st_pl), e // 4 if aimed else max(e // 40, 4),
                   node0=aimed)
        leader = st_pl.leader.cpu().numpy()
        if sliced is None:
            active = None
            elect, cand, kind, slot, val, lease, up, exp_e, exp_s = \
                f1_stream(rng, leader, e, m, s, k)
            slot = wide_slots(rng, k, e, s, chains, aimed)
        else:
            active, planes = sliced_inputs(rng, leader, e, m, s, k,
                                           sliced[0], sliced[1], True,
                                           elect_all=step == 0)
            elect, cand, kind, slot, val, lease, up, exp_e, exp_s = planes
            slot = wide_slots(rng, k, sliced[1], s, chains)
        plan = wide_plan(kind, slot, val, lease, exp_e, exp_s, chains)
        ops = wide_ops(plan, dev)
        el, cd, upd = (torch.from_numpy(x).to(dev) for x in (elect, cand, up))
        if aimed:
            stats["shared"] += shared_corrupt_lanes(st_pl, plan, up)
        before = cuda_engine.engine_step_wide_launches
        if active is not None:
            args = (el, cd, *ops[:4], upd)
            st_f1, won_f, res_f = eng.full_step_wide_sliced(
                st_f1, active, *args, ops[4], ops[5])
            st_pl, won_p, res_p = eng.full_step_wide_sliced_plain(
                st_pl, active, *args, ops[4], ops[5])
        elif step == 1:
            st_f1, res_f = eng.kv_step_scan_wide(st_f1, *ops[:4], upd,
                                                 ops[4], ops[5])
            st_pl, res_p = eng.kv_step_scan_wide_plain(st_pl, *ops[:4], upd,
                                                       ops[4], ops[5])
            won_f = won_p = torch.zeros(0)
        else:
            args = (el, cd, *ops[:4], upd)
            st_f1, won_f, res_f = eng.full_step_wide(st_f1, *args, ops[4],
                                                     ops[5])
            st_pl, won_p, res_p = eng.full_step_wide_plain(st_pl, *args,
                                                           ops[4], ops[5])
        torch.cuda.synchronize()
        want = before + (ops[0].shape[2] > 1)
        if cuda_engine.engine_step_wide_launches != want:
            raise AssertionError(f"F1 wide {name}: wide launches "
                                 f"{cuda_engine.engine_step_wide_launches}"
                                 f", want {want}")
        if not torch.equal(won_f.cpu(), won_p.cpu()):
            raise AssertionError(f"F1 wide {name}, step {step}: won differs")
        bad = (diff_fields(st_f1, st_pl, eng.EngineState._fields)
               + diff_fields(res_f, res_p, eng.KvResult._fields))
        if bad:
            raise AssertionError(f"F1 wide {name}, step {step}: {bad} differ "
                                 f"from the plain wide step")
        stats["won"] += int(won_p.sum())
        stats["commits"] += int(res_p.committed.sum())
        stats["corrupt"] += int(res_p.tree_corrupt.sum())
        stats["lanes"] = list(plan.kind.shape)
    return stats


def shared_corrupt_lanes(st, plan, up: np.ndarray) -> int:
    """Of a full-width wide plan about to run on ``st``: the (group, row)
    pairs with two or more live lanes under a level-0 node that is corrupt
    (differs from the fold of its stored leaves) on a heard replica."""
    leaves = st.tree_leaf[:, :, :16].cpu()
    bad = (hashk.fold(leaves.reshape(leaves.shape[:2] + (1, 16, 4)))[
        :, :, 0] != st.tree_node[:, :, 0].cpu()).any(-1).numpy()
    heard = up & st.view_mask.any(1).cpu().numpy()
    s = st.obj_val.shape[2]
    live = ((plan.kind >= 1) & (plan.kind <= 4) & (plan.slot >= 0)
            & (plan.slot < min(s, 16)))
    crossed = (bad & heard).any(1)[None, :] & (live.sum(2) >= 2)
    return int(crossed.sum())


def time_wide(dev, card: str, chains: bool, sliced=None,
              detail: bool = True) -> dict:
    """F1's wide mode at the headline shape on a filled store (G = 1, or
    G = 2 with ``chains``; ``sliced`` (rows, bucket) for the sliced form):
    :func:`launch_timings`, scalar F1 on the same ops in (group, lane)
    order (``schedule.flat_order``), the plain wide step, the occupancy
    and the bound of one launch as timed."""
    e, m, s, k = E_FULL, M_FULL, S_FULL, K_FULL
    rng = np.random.default_rng(97 + chains + (0 if sliced is None
                                               else sliced[1]))
    st = eng.init_state(e, m, s, device=dev)
    if sliced is None:
        active, rows = None, None
        planes = list(f1_stream(rng, np.full(e, -1, np.int32), e, m, s, k))
        a = e
    else:
        active, planes = sliced_inputs(rng, np.full(e, -1, np.int32), e, m,
                                       s, k, sliced[0], sliced[1], True,
                                       elect_all=True)
        rows, a = active[:sliced[0]], sliced[1]
    planes[3] = wide_slots(rng, k, a, s, chains)
    elect, cand, kind, slot, val, lease, up, exp_e, exp_s = planes
    plan = wide_plan(kind, slot, val, lease, exp_e, exp_s, chains)
    g, _, w = plan.kind.shape
    ops = wide_ops(plan, dev)
    el, cd, upd = (torch.from_numpy(x).to(dev) for x in (elect, cand, up))
    args = (el, cd, *ops[:4], upd)

    def wide(state, ops=ops):
        head = (el, cd, *ops[:4], upd)
        if active is None:
            return eng.full_step_wide(state, *head, ops[4], ops[5])
        return eng.full_step_wide_sliced(state, active, *head, ops[4],
                                         ops[5])
    st, _, _ = wide(st)                     # elect, fill the store
    torch.cuda.synchronize()
    pre = copy_state(st)
    st, _, res = wide(st)
    torch.cuda.synchronize()
    flat = cuda_engine.flat_rounds
    b = f1_bounds(pre, st, up, flat(plan.kind), flat(plan.slot),
                  flat(res.committed.cpu().numpy()), rows=rows, groups=g)
    out = {"g": g, "w": w, "rows": a if rows is None else len(rows),
           "max_abs_err": 0, "library_ms": None, "bound_ms": b["bound_ms"],
           "bound_by": b["bound_by"]}
    out.update(launch_timings(lambda: wide(st)))
    if detail:
        # the launch's part that does not grow with the lanes: the same
        # rows staged, verified, refolded and written back, with one live
        # lane each (lane 0 of group 0; every other lane NOOP)
        one = plan.kind.copy()
        one[1:] = eng.OP_NOOP
        one[0, :, 1:] = eng.OP_NOOP
        ops_one = [torch.from_numpy(one).to(dev)] + ops[1:]
        out["one_lane_us"] = gated_us(lambda: wide(st, ops_one))
    # scalar F1 on the same ops in (group, lane) order
    from riak_ensemble_tpu_torch.ops import schedule
    order, ee = schedule.flat_order(plan)
    sc = [torch.from_numpy(np.ascontiguousarray(p[order, ee])).to(dev)
          for p in (kind, slot, val, lease, exp_e, exp_s)]
    st_sc = copy_state(pre)

    def scalar(sc=sc):
        if active is None:
            eng.full_step(st_sc, el, cd, *sc[:4], upd, exp_epoch=sc[4],
                          exp_seq=sc[5])
        else:
            eng.full_step_sliced(st_sc, active, el, cd, *sc[:4], upd,
                                 exp_epoch=sc[4], exp_seq=sc[5])
    out["scalar"] = launch_timings(scalar)
    if detail:
        # scalar F1 on the one-lane plan's flat rounds: the one live
        # round of each row, then NOOP rounds
        sc_one = [torch.from_numpy(np.ascontiguousarray(flat(x))).to(dev)
                  for x in (one, plan.slot, plan.val, plan.lease_ok,
                            plan.exp_epoch, plan.exp_seq)]
        out["scalar_one_round_us"] = gated_us(lambda: scalar(sc_one))
        print(f"F1 wide G={g} A={a} with one live lane a row [{card}]: "
              f"{out['one_lane_us']:.3f} us device time per launch; scalar "
              f"F1 with its one live round {out['scalar_one_round_us']:.3f} "
              f"us")
    label = (f"wide G={g} W={w}" + ("" if active is None
                                    else f" sliced A={a} ({len(rows)} rows)"))
    out["occupancy"] = occ = cuda_engine.occupancy(e, m, s, 2, g, a, w)
    print(f"F1 occupancy {label}: {occ['regs_per_thread']} registers per "
          f"thread, {occ['dynamic_smem']} B dynamic shared memory, "
          f"{occ['spill_bytes']} B spilled, {occ['warps_per_block']} warps "
          f"per block, {occ['blocks_per_sm']} resident blocks per SM")
    plain_text = ""
    if detail:
        st_pl = copy_state(pre)
        if active is None:
            plain = lambda: eng.full_step_wide_plain(    # noqa: E731
                st_pl, *args, ops[4], ops[5])
        else:
            plain = lambda: eng.full_step_wide_sliced_plain(    # noqa: E731
                st_pl, active, *args, ops[4], ops[5])
        out["plain_ms"] = cuda_ms(plain, iters=1, reps=3)
        plain_text = f"; plain wide {out['plain_ms']:.3f} ms"
        del st_pl
    print(f"F1 {label} at {e}x{m}x{s} K={k} [{card}]: {out['ms']:.6f} ms per "
          f"call back to back, {out['device_us']:.3f} us device time per "
          f"launch (gated events), host {out['host_us']:.3f} us per call; "
          f"scalar F1 on the same ops in (group, lane) order "
          f"{out['scalar']['device_us']:.3f} us per launch{plain_text}; "
          f"{bound_text(b)}; share of the bound "
          f"{b['bound_ms'] * 1e3 / out['device_us'] * 100:.2f} %")
    del pre, st_sc
    return out


#: 11(a)'s timed shapes: (label, chains, sliced (rows, bucket) or None)
WIDE_TIMED = (("G=1", False, None), ("G=2", True, None),
              ("sliced A=256 G=2", True, (250, 256)),
              ("sliced A=2048 G=1", False, (2000, 2048)))


def phase_f1_wide(dev: torch.device, card: str) -> dict:
    """11(a): F1's wide mode against the plain wide steps, then timed."""
    total = {"commits": 0, "corrupt": 0, "won": 0}
    for i, case in enumerate(WIDE_CASES):
        name, e, m, s, k, views, steps, chains, sliced, aimed = case
        t0 = time.perf_counter()
        stats = wide_case(dev, name, e, m, s, k, views, steps, chains,
                          sliced, aimed, 300 + i)
        # the launch shape the occupancy query gave this case's grid
        occ = cuda_engine.occupancy(e, m, s, 2, 1,
                                    e if sliced is None else sliced[1], 2)
        print(f"F1 wide == plain  {name}: E={e} M={m} S={s} K={k}, {steps} "
              f"steps, {stats}, {occ['warps_per_block']} warps per block "
              f"({time.perf_counter() - t0:.1f} s)")
        if not stats["commits"]:
            raise AssertionError(f"F1 wide case {name} committed nothing")
        if aimed and not stats["shared"]:
            raise AssertionError(f"F1 wide case {name}: no two lanes of a "
                                 f"group crossed one corrupt node")
        for key in total:
            total[key] += stats[key]
    if not all(total.values()):
        raise AssertionError(f"the wide cases raised no integrity flag or "
                             f"won no election: {total}")
    return {label: time_wide(dev, card, chains, sliced)
            for label, chains, sliced in WIDE_TIMED}


def acked_puts(kind, slot, val, committed, want: np.ndarray) -> None:
    """Fold one execute()'s committed puts into ``want [S, E]`` (the last
    value per slot; 0 = none).  A wide launch runs a column's ops in
    (group, lane) order, which keeps per-slot order."""
    for j in range(kind.shape[0]):
        hit = (kind[j] == eng.OP_PUT) & committed[j]
        cols = np.nonzero(hit)[0]
        want[slot[j, cols], cols] = val[j, cols]


def wide_execute_run(dev, batches: list) -> dict:
    """``execute()`` of distinct-slot planes on a ``wide=True`` service on
    ``dev``, then every slot read back; the results, the state, counters."""
    e, m, s, k = E_FULL, M_FULL, S_FULL, K_FULL
    svc = BatchedEnsembleService(FixedClock(), e, m, s, tick=None,
                                 max_ops_per_tick=k, device=dev, wide=True)
    chk = LaunchCheck(svc) if dev.type == "cuda" else None
    outs, ms = [], []
    want = np.zeros((s, e), np.int32)
    for kind, slot, val in batches:
        t0 = time.perf_counter()
        out = svc.execute(kind, slot, val)
        ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
        acked_puts(kind, slot, val, out[0], want)
    slot0 = batches[0][1]
    get = np.full((k, e), eng.OP_GET, np.int32)
    _, get_ok, found, value = svc.execute(get, slot0, np.zeros_like(get))
    seen = want[slot0, np.arange(e)[None, :]]
    if not (get_ok.all() and np.array_equal(np.where(found, value, 0), seen)
            and found[seen != 0].all()):
        raise AssertionError("11(b) execute: acknowledged puts did not read "
                             "back")
    outs.append((get_ok, found, value))
    return {"outs": outs, "state": svc.state, "ms": ms,
            "wide": svc.wide_launches, "launches": chk.launches if chk
            else None, "acked": int((want != 0).sum())}


def phase_wide_service(dev: torch.device, card: str) -> dict:
    """11(b): the headline service with ``wide=True`` on the card against a
    CPU service with ``wide=True`` on the same stream: ``execute()`` of
    distinct-slot planes, then 6(b)'s keyed pattern.  Every acknowledged
    put reads back, F1 launches once per launch, and wide launches run.
    Returns the card runs' launch counts."""
    e, m, s, k = E_FULL, M_FULL, S_FULL, K_FULL
    cpu = torch.device("cpu")
    batches = execute_batches(2)[1:]
    reset_counts()                               # this path's run
    got = wide_execute_run(dev, batches)
    counts = read_counts()
    ref = wide_execute_run(cpu, batches)
    for i, (a, b) in enumerate(zip(got["outs"], ref["outs"])):
        if not all(np.array_equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"11(b) execute {i}: the card's wide "
                                 f"service differs from the CPU's")
    bad = diff_fields(got["state"], ref["state"], eng.EngineState._fields)
    if bad or not (got["wide"] == ref["wide"] > 0
                   and counts["F1"] == got["launches"]
                   and counts["F1 wide"] == got["wide"]):
        raise AssertionError(f"11(b) execute: state {bad}, wide launches "
                             f"{got['wide']} / {ref['wide']}, counts {counts}"
                             f", launches {got['launches']}")
    print(f"11(b) wide execute {e}x{m}x{s} K={k} [{card}]: {got['wide']} wide "
          f"launches of {got['launches']}, {got['acked']} acknowledged puts "
          f"read back, equal to the CPU service; ms per execute "
          f"{[round(x, 3) for x in got['ms']]}; launches {counts}")
    del got, ref
    rng = np.random.default_rng(14)
    sub = np.sort(rng.choice(e, 256, replace=False)).tolist()
    keys = [f"user:{i}" for i in range(48)]
    arms = {}
    for d in (dev, cpu):
        svc = BatchedEnsembleService(FixedClock(), e, m, s, tick=None,
                                     max_ops_per_tick=k, device=d, wide=True)
        svc.flush()
        chk = LaunchCheck(svc) if d.type == "cuda" else None
        if d.type == "cuda":
            split, plan_ms = HostSplit(svc), time_wide_plan(svc)
            reset_counts()
        ms = []
        results = keyed_rounds(svc, d, sub, keys, ms)
        if d.type == "cuda":
            keyed_split = split.take()
            keyed = read_counts()
            if keyed["F1"] != chk.launches or not keyed["F1 wide"]:
                raise AssertionError(f"11(b) keyed: counts {keyed} in "
                                     f"{chk.launches} launches")
            counts = {n: counts[n] + keyed[n] for n in counts}
        arms[d.type] = (results, svc.state, svc.wide_launches, ms,
                        svc.corruptions)
    (r1, s1, w1, ms1, c1), (r2, s2, w2, _, c2) = arms["cuda"], arms["cpu"]
    bad = diff_fields(s1, s2, eng.EngineState._fields)
    if r1 != r2 or bad or not (w1 == w2 > 0) or c1 != c2:
        raise AssertionError(f"11(b) keyed: results equal {r1 == r2}, state "
                             f"{bad}, wide launches {w1} / {w2}, "
                             f"corruptions {c1} / {c2}")
    print(f"11(b) wide keyed service, 6(b)'s pattern [{card}]: {w1} wide "
          f"launches, every acknowledged put read back, equal to the CPU "
          f"service; median flush {statistics.median(ms1):.3f} ms over "
          f"{len(ms1)} flushes; host ms per flush: "
          f"{split_line(keyed_split, len(ms1))} (the wide plan "
          f"{plan_ms[0] / len(ms1):.3f} of the enqueue); launches {counts}")
    return counts


def time_wide_plan(svc: BatchedEnsembleService) -> list:
    """Wrap the service's wide scheduling: ``[ms]`` summed over its
    calls (a part of HostSplit's enqueue stage)."""
    total = [0.0]
    run = svc._wide_plan

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return run(*args, **kwargs)
        finally:
            total[0] += (time.perf_counter() - t0) * 1e3
    svc._wide_plan = timed
    return total


class ShardWall:
    """Wall ms of each sharded pass of a service (``_shard_map`` calls by
    the chunk function's name: ``pack_chunk``, ``gather``, ``scatter``)."""

    def __init__(self, svc: BatchedEnsembleService) -> None:
        self.ms: dict = {}
        run = svc._shard_map

        def timed(fn, bounds):
            t0 = time.perf_counter()
            try:
                return run(fn, bounds)
            finally:
                key = fn.__name__
                self.ms[key] = self.ms.get(key, 0.0) + (
                    time.perf_counter() - t0) * 1e3
        svc._shard_map = timed


def phase_sharded(dev: torch.device, card: str) -> None:
    """11(c): 6(b)'s keyed pattern and a full-width ``execute`` stream at
    ``resolve_shards=4`` against 1 on the card: equal results, mirrors and
    state; the host split of each arm (and the wall of each sharded
    pass)."""
    e, m, s, k = E_FULL, M_FULL, S_FULL, K_FULL
    rng = np.random.default_rng(14)
    sub = np.sort(rng.choice(e, 256, replace=False)).tolist()
    keys = [f"user:{i}" for i in range(48)]
    batches = execute_batches(3)
    arms = {}
    for shards in (1, 4):
        svc = BatchedEnsembleService(FixedClock(), e, m, s, tick=None,
                                     max_ops_per_tick=k, device=dev,
                                     resolve_shards=shards)
        svc.flush()
        torch.cuda.synchronize()
        split = HostSplit(svc)
        wall = ShardWall(svc)
        ms = []
        results = keyed_rounds(svc, dev, sub, keys, ms)
        keyed_split = split.take()
        outs = [svc.execute(*b) for b in batches]
        arms[shards] = {"results": results, "outs": outs, "ms": ms,
                        "split": keyed_split, "wall": dict(wall.ms),
                        "mirrors": mirrors_of(svc), "state": svc.state,
                        "sharded": svc.sharded_flushes}
        svc.stop()
    one, four = arms[1], arms[4]
    same_outs = all(np.array_equal(x, y) for a, b in zip(one["outs"],
                                                         four["outs"])
                    for x, y in zip(a, b))
    bad = diff_fields(one["state"], four["state"], eng.EngineState._fields)
    mirrors = [n for n in one["mirrors"]
               if not np.array_equal(one["mirrors"][n], four["mirrors"][n])]
    if (one["results"] != four["results"] or not same_outs or bad or mirrors
            or one["sharded"] or not four["sharded"]):
        raise AssertionError(f"11(c): results equal "
                             f"{one['results'] == four['results']}, execute "
                             f"{same_outs}, state {bad}, mirrors {mirrors}, "
                             f"sharded flushes {one['sharded']} / "
                             f"{four['sharded']}")
    for shards, arm in arms.items():
        n = len(arm["ms"])
        print(f"11(c) resolve_shards={shards} keyed, 6(b)'s pattern [{card}]: "
              f"median flush {statistics.median(arm['ms']):.3f} ms over {n} "
              f"flushes; host ms per flush: {split_line(arm['split'], n)}; "
              f"sharded passes' wall ms per flush: "
              f"{split_line(arm['wall'], n) or 'none'}; sharded flushes "
              f"{arm['sharded']}")
    print(f"11(c) [{card}]: resolve_shards=4 equals 1 on every result, "
          f"mirror slab and state plane (keyed pattern and {len(batches)} "
          f"full-width execute launches)")


# ---------------------------------------------------------------------------
# Phase 12: a three-host replication group on the card

#: phase 12's traffic: 6(b)'s keyed pattern (256 of 10,000 rows, 48 keys)
REPG_ROWS = list(range(0, E_FULL, E_FULL // 256))[:256]
REPG_KEYS = [f"user:{i}" for i in range(48)]


class StepClock:
    """A leader runtime whose ``now`` only the script moves: the card
    group and the CPU group see the same lease arithmetic."""

    def __init__(self) -> None:
        self.now = 1000.0

    def schedule(self, delay, fn):
        raise RuntimeError("caller-driven flush only")


def replica_processes(specs: dict) -> dict:
    """``python -m riak_ensemble_tpu_torch.parallel.repgroup`` on the card
    at the headline lane shape (10,000 x 1 x 128, K = 64, WAL fsync), one
    fresh interpreter per ``name: (data dir, log, repl port, client
    port)``, all started together (the kernels are already built); returns
    ``name: (process, repl port, client port)`` once each serves.  Their
    stdout is drained by a thread, their stderr goes to the log."""
    return {name: serving(p, log)
            for name, (p, log) in launch_replicas(specs).items()}


def launch_replicas(specs: dict) -> dict:
    """:func:`replica_processes`' start alone: ``name: (process, log)``,
    not yet serving."""
    root = os.path.dirname(os.path.abspath(__file__))
    started = {}
    for name, (data, log, repl_port, client_port) in specs.items():
        cmd = [sys.executable, "-m",
               "riak_ensemble_tpu_torch.parallel.repgroup",
               "--n-ens", str(E_FULL), "--group-size", "3",
               "--n-slots", str(S_FULL), "--repl-port", str(repl_port),
               "--client-port", str(client_port), "--data-dir", data]
        with open(log, "ab") as err:
            started[name] = (subprocess.Popen(
                cmd, cwd=root, env=dict(os.environ, PYTHONPATH=root),
                stdout=subprocess.PIPE, stderr=err, text=True), log)
    return started


def serving(p, log: str):
    """Wait (at most 300 s) for a replica process's banner; then drain
    its stdout."""
    import select
    import threading
    ready, _w, _x = select.select([p.stdout], [], [], 300.0)
    line = p.stdout.readline() if ready else ""
    if not line.startswith("repgroup replica"):
        p.kill()
        p.wait()
        with open(log, "rb") as f:
            tail = f.read()[-3000:].decode(errors="replace")
        raise AssertionError(f"phase 12: replica did not start: {line!r} "
                             f"{tail}")
    threading.Thread(target=lambda: [None for _ in p.stdout],
                     daemon=True).start()
    parts = dict(kv.split("=") for kv in line.split()[2:])
    return p, int(parts["repl"]), int(parts["client"])


def repl_call(port: int, frame, timeout: float = 120.0):
    """One frame on a fresh connection to a host's replication port."""
    import socket

    from riak_ensemble_tpu_torch.parallel import repgroup
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=timeout) as s:
        s.settimeout(timeout)
        repgroup.send_frame(s, frame)
        return repgroup.recv_frame(s)


def client_stats(port: int) -> dict:
    """A host's ``stats`` over its client port (the svcnode frame)."""
    import socket

    from riak_ensemble_tpu_torch import wire
    from riak_ensemble_tpu_torch.parallel import repgroup
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        s.settimeout(60)
        repgroup.send_frame(s, (1, "stats"))
        return repgroup.recv_frame(s)[1]


def lane_canon(dump) -> tuple:
    """A dumped lane: engine planes verbatim, keyed mirrors in an
    order-insensitive form (their dict order is process history)."""
    fields, host = dump
    (key_slot, slot_handle, values, _nh, leader_b, dyn, _live, _free,
     _names, member_b, inline) = host
    return (fields, [sorted(p, key=repr) for p in key_slot],
            [sorted(p) for p in slot_handle], sorted(values, key=repr),
            leader_b, dyn, member_b, [sorted(x) for x in inline])


def replicas_match(svc, ports, stage: str) -> None:
    """Every replica process at the leader's applied position holds a lane
    bit-equal to the leader's (pulled over its replication port)."""
    from riak_ensemble_tpu_torch.parallel import repgroup
    svc._drain_pending(block_all=True)
    want_pos = (svc.core.applied_ge, svc.core.applied_seq)
    lead = lane_canon(repgroup.dump_state(svc))
    for port in ports:
        deadline = time.monotonic() + 60.0
        while True:
            st = repl_call(port, ("status",))
            if (int(st[3]), int(st[4])) == want_pos:
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"phase 12 {stage}: replica {port} at "
                                     f"{st[3:5]}, leader at {want_pos}")
            time.sleep(0.05)
        r = repl_call(port, ("pull",))
        if r[0] != "state" or lane_canon(r[3]) != lead:
            raise AssertionError(f"phase 12 {stage}: replica {port}'s lane "
                                 f"differs from the leader's")


def settle_flushes(svc, futs, ms: list, sync: bool) -> None:
    """Flush until ``futs`` resolve (at most 16 flushes), each flush's wall
    ms into ``ms``."""
    for _ in range(16):
        if all(f.done for f in futs):
            return
        t0 = time.perf_counter()
        svc.flush()
        if sync:
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    if not all(f.done for f in futs):
        raise AssertionError("phase 12: futures unresolved after 16 flushes")


def group_keyed(svc, rnd: int, ms: list, acked: dict, results: list,
                want_ok: bool = True, sync: bool = True) -> None:
    """One round of the keyed pattern on a group leader: ``kput_many`` of
    the 48 keys on each of the 256 rows (bytes payloads), then
    ``kget_many``; every flush's wall ms into ``ms``; acknowledged puts
    into ``acked``; every future's value into ``results``."""
    def settle(futs):
        settle_flushes(svc, futs, ms, sync)
    puts = [svc.kput_many(x, REPG_KEYS,
                          [b"v%d:%d:%d" % (rnd, x, i)
                           for i in range(len(REPG_KEYS))])
            for x in REPG_ROWS]
    settle(puts)
    results.append([f.value for f in puts])
    for x, f in zip(REPG_ROWS, puts):
        for i, r in enumerate(f.value):
            if r[0] == "ok":
                acked[(x, REPG_KEYS[i])] = b"v%d:%d:%d" % (rnd, x, i)
            elif want_ok:
                raise AssertionError(f"phase 12: put round {rnd} failed: "
                                     f"{r}")
    gets = [svc.kget_many(x, REPG_KEYS) for x in REPG_ROWS]
    settle(gets)
    results.append([f.value for f in gets])
    if want_ok and results[-1] != [[("ok", acked[(x, k)]) for k in REPG_KEYS]
                                   for x in REPG_ROWS]:
        raise AssertionError(f"phase 12: round {rnd}: acknowledged puts did "
                             f"not read back")


def group_stage_a(svc, ms: list, acked: dict, sync: bool) -> list:
    """Stage A, the same on the card group and the CPU group: the
    election-only flush after takeover, three keyed rounds with every
    active row's leader taken down after the first (the next flush
    elects: a full-plane entry the replicas re-execute through F1), then
    a ``kmodify_many`` burst of commutative increments (the merge lane)
    and its read-back."""
    results: list = []
    svc.flush()                                  # elect every row
    for rnd in range(3):
        group_keyed(svc, rnd, ms, acked, results, sync=sync)
        if rnd == 0:
            svc.leader_np[REPG_ROWS] = -1        # leaders down: elections
            svc._slot_vsn_ok[REPG_ROWS] = False
        svc.runtime.now += 0.25
    add = funref.ref("rmw:add", 3)
    burst = [svc.kmodify_many(x, ["ctr"] * 8 + ["c2"] * 8, add, 0)
             for x in REPG_ROWS]
    settle_flushes(svc, burst, ms, sync)
    results.append([f.value for f in burst])
    reads = [svc.kget_many(x, ["ctr", "c2"]) for x in REPG_ROWS]
    settle_flushes(svc, reads, [], sync)
    results.append([f.value for f in reads])
    if results[-1] != [[("ok", 24), ("ok", 24)]] * len(REPG_ROWS):
        raise AssertionError(f"phase 12: the increments read back "
                             f"{results[-1][:2]}")
    return results


def per(g: dict, key: str, n: str) -> float:
    return g[key] * 1e3 / max(g[n], 1)


def phase_repgroup(dev: torch.device, card: str) -> dict:
    """Phase 12: bench.py's headline lane (10,000 ensembles x 128 slots,
    K = 64) as the README's three-host group: the leader in this process
    on the card, two replica processes of the port's ``main`` on the same
    card, each host with its own data dir at ``wal_sync="fsync"``.
    Stage A (keyed rounds, an election, a commutative burst) runs on the
    card group and on an in-process CPU group fed the same ops (futures
    and leader lanes equal); then the faults: kill -9 a replica, restart
    it (catch-up), kill both (no ack), restart, stop the leader and
    promote a replica that a ``GroupClient`` follows.  Every replica's
    lane equals the leader's after each stage, F1 launches on every host,
    and no acknowledged put is lost."""
    import asyncio
    import signal

    from riak_ensemble_tpu_torch import wire
    from riak_ensemble_tpu_torch.parallel import repgroup
    root = tempfile.mkdtemp(prefix="retpu_p12_")
    procs: dict = {}
    t_phase = time.perf_counter()
    try:
        dirs = {n: os.path.join(root, n) for n in ("leader", "r1", "r2")}
        logs = {n: os.path.join(root, f"{n}.log") for n in ("r1", "r2")}
        t0 = time.perf_counter()
        procs.update(replica_processes(
            {n: (dirs[n], logs[n], 0, 0) for n in ("r1", "r2")}))
        boot_s = time.perf_counter() - t0
        repl = {n: procs[n][1] for n in procs}
        cli = {n: procs[n][2] for n in procs}
        svc = repgroup.ReplicatedService(
            StepClock(), E_FULL, 1, S_FULL, group_size=3,
            peers=[("127.0.0.1", repl[n]) for n in ("r1", "r2")],
            ack_timeout=5.0, data_dir=dirs["leader"], device=dev)
        svc.warmup()
        if not svc.takeover(timeout=60.0):
            raise AssertionError("phase 12: takeover found no majority")
        before = {n: client_stats(cli[n])["group"]["kernel_launches"]
                  for n in procs}
        # -- stage A: the counted group path, against a CPU group -------
        ms_group: list = []
        acked: dict = {}
        shipped: list = []
        ship = svc._ship_now

        def recording_ship():
            # every entry as it is coalesced into a frame
            shipped.extend(x.entry for x in svc._ship_buf)
            ship()
        svc._ship_now = recording_ship
        reset_counts()                             # this path's run
        res_card = group_stage_a(svc, ms_group, acked, sync=True)
        counts = read_counts()
        replicas_match(svc, [repl["r1"], repl["r2"]], "stage A")
        after = {n: client_stats(cli[n])["group"]["kernel_launches"]
                 for n in procs}
        replica_f1 = {n: after[n]["F1"] - before[n]["F1"] for n in procs}
        if counts["F1"] == 0 or min(replica_f1.values()) == 0:
            raise AssertionError(f"phase 12: F1 launches leader "
                                 f"{counts['F1']}, replicas {replica_f1}")
        g = dict(svc.stats()["group"])
        svc._ship_now = ship
        by_kind: dict = {}
        for ent in shipped:
            raw = sum(memoryview(x.buf).nbytes for x in ent
                      if isinstance(x, wire.Raw))
            cells = int(ent[3]) if ent[0] != "f" else 0
            kind = ent[0] + ("0" if ent[0] == "d" and not cells else "")
            by_kind.setdefault(kind, []).append(
                (raw, cells,
                 repgroup.full_plane_nbytes(int(ent[2]), E_FULL, True)))
        t_cpu = time.perf_counter()
        cpu_srvs = [repgroup.ReplicaServer(E_FULL, 3, S_FULL, device="cpu")
                    for _ in range(2)]
        cpu = repgroup.ReplicatedService(
            StepClock(), E_FULL, 1, S_FULL, group_size=3,
            peers=[("127.0.0.1", s.repl_port) for s in cpu_srvs],
            ack_timeout=60.0, device="cpu")
        try:
            if not cpu.takeover(timeout=60.0):
                raise AssertionError("phase 12: CPU group takeover failed")
            res_cpu = group_stage_a(cpu, [], {}, sync=False)
            if res_cpu != res_card:
                raise AssertionError("phase 12: the card group's futures "
                                     "differ from the CPU group's")
            cpu._drain_pending(block_all=True)
            if lane_canon(repgroup.dump_state(cpu)) != \
                    lane_canon(repgroup.dump_state(svc)):
                raise AssertionError("phase 12: the card leader's lane "
                                     "differs from the CPU leader's")
        finally:
            cpu.stop()
            for s in cpu_srvs:
                s.stop()
        cpu_s = time.perf_counter() - t_cpu
        # the one-host lane (no replication): stage A's ops, same call
        one = BatchedEnsembleService(StepClock(), E_FULL, 1, S_FULL,
                                     tick=None, device=dev,
                                     data_dir=os.path.join(root, "one"))
        ms_one: list = []
        group_stage_a(one, ms_one, {}, sync=True)
        one.stop()
        one._wal.close()
        dump = repgroup.dump_state(svc)
        snap = len(wire.encode(("install", 0, 0, dump, svc.core.cfg)))
        if snap > repgroup._MAX_FRAME:
            raise AssertionError(f"phase 12: a snapshot of {snap} B exceeds "
                                 f"the {repgroup._MAX_FRAME} B frame")
        entries = g["repl_delta_entries"] + g["repl_full_entries"]
        print(f"12(a) group stage A [{card}]: {len(ms_group)} flushes, "
              f"keyed flush median {statistics.median(ms_group):.3f} ms, "
              f"{sum(ms_group):.3f} ms in all (one-host lane, no "
              f"replication, the same ops: {len(ms_one)} flushes, median "
              f"{statistics.median(ms_one):.3f} ms, {sum(ms_one):.3f} ms in "
              f"all; its lease serves the get rounds without a flush); "
              f"flushes in order {[round(x, 3) for x in ms_group]} / "
              f"{[round(x, 3) for x in ms_one]} ms; "
              f"{entries} entries "
              f"({g['repl_delta_entries']} delta, {g['repl_full_entries']} "
              f"full, {g['repl_merge_cells']} merge cells for "
              f"{g['repl_merge_ops']} ops) in {g['repl_frames']} frames; "
              f"sections {g['repl_bytes_sections'] / max(entries, 1):.1f} "
              f"B/entry against {g['repl_bytes_full_equiv'] / max(entries, 1):.1f}"
              f" B full-plane, {g['repl_bytes_shipped'] / max(g['repl_frames'], 1):.1f}"
              f" B/frame shipped; build {per(g, 'repl_build_s', 'applies'):.3f}"
              f" ms/entry, encode {per(g, 'repl_encode_s', 'repl_frames'):.3f}"
              f" ms/frame, ack {per(g, 'repl_ack_s', 'repl_acked_batches'):.3f}"
              f" ms/batch; F1 launches leader {counts['F1']} (sliced "
              f"{counts['F1 sliced']}), replicas {replica_f1}; replica "
              f"boot {boot_s:.3f} s; CPU group {cpu_s:.3f} s; snapshot "
              f"{snap} B of {repgroup._MAX_FRAME}")
        names = {"d": "delta with writes", "d0": "delta without writes",
                 "m": "merge", "f": "full-plane"}
        print(f"12(a) entry sections [{card}]: " + "; ".join(
            f"{len(v)} {names[k]}: median "
            f"{statistics.median(b for b, _c, _f in v):.0f} B "
            + (f"({statistics.median(b / c for b, c, _f in v):.2f}"
               f" B per ordered cell) " if k == "d" else "")
            + f"against {statistics.median(f for _b, _c, f in v):.0f} B of "
              f"full planes" for k, v in sorted(by_kind.items())))
        rep_apply = {}
        for n in procs:
            rg = client_stats(cli[n])["group"]
            rep_apply[n] = per(rg, "replica_apply_s", "replica_apply_batches")
        # where a write batch's replica apply goes: the replicas' own
        # spans for the delta entries that carried writes, pulled over
        # the fleet sideband (one frame per entry here)
        split: dict = {}
        n_split = 0
        for ent in shipped:
            if ent[0] != "d" or not int(ent[3]) or not ent[-1]:
                continue
            tl = svc.fleet_timeline(int(ent[-1]))
            for role, info in tl.get("roles", {}).items():
                if not str(role).startswith("replica"):
                    continue
                n_split += 1
                for name, _t, dur in info["spans"]:
                    split[name] = split.get(name, 0.0) + dur * 1e3
        print(f"12(a) replica apply [{card}]: "
              + ", ".join(f"{n} {v:.3f} ms/batch" for n, v in
                          rep_apply.items())
              + f"; a write batch's replica spans (mean of {n_split}): "
              + ", ".join(f"{k} {v / max(n_split, 1):.3f} ms"
                          for k, v in split.items()))
        # -- stage B: kill -9 a replica; commits go on at 2 of 3 ---------
        procs["r1"][0].send_signal(signal.SIGKILL)
        procs["r1"][0].wait()
        results: list = []
        group_keyed(svc, 3, [], acked, results)
        g0 = dict(svc.stats()["group"])
        t0 = time.perf_counter()
        procs.update(replica_processes(
            {"r1": (dirs["r1"], logs["r1"], repl["r1"], cli["r1"])}))
        t_up = time.perf_counter()
        while svc.stats()["group"]["peers_synced"] < 2:
            if time.perf_counter() - t0 > 120:
                raise AssertionError("phase 12: restarted replica never "
                                     "caught up")
            svc.heartbeat()
        catch_ms = (time.perf_counter() - t_up) * 1e3
        g1 = dict(svc.stats()["group"])
        tree = g1["tree_resyncs"] - g0["tree_resyncs"]
        how = (f"tree patch, {g1['tree_resync_bytes'] - g0['tree_resync_bytes']}"
               f" B" if tree else f"full install, {snap} B snapshot")
        replicas_match(svc, [repl["r1"], repl["r2"]], "stage B")
        print(f"12(b) replica kill -9 + restart [{card}]: commits at 2 of 3 "
              f"acked; restart to serving {t_up - t0:.3f} s; catch-up "
              f"{catch_ms:.3f} ms by {how}")
        # -- stage C: both replicas down; nothing acks -------------------
        for n in ("r1", "r2"):
            procs[n][0].send_signal(signal.SIGKILL)
            procs[n][0].wait()
        nq = [svc.kput_many(x, [f"nq:{i}" for i in range(4)], [b"x"] * 4)
              for x in REPG_ROWS[:16]]
        for _ in range(8):
            if all(f.done for f in nq):
                break
            svc.flush()
        else:
            raise AssertionError("phase 12: puts without a quorum never "
                                 "resolved")
        if any(r[0] == "ok" for f in nq for r in f.value):
            raise AssertionError("phase 12: a put acked without a quorum")
        procs.update(replica_processes(
            {n: (dirs[n], logs[n], repl[n], cli[n]) for n in ("r1", "r2")}))
        t0 = time.perf_counter()
        while svc.stats()["group"]["peers_synced"] < 2:
            if time.perf_counter() - t0 > 120:
                raise AssertionError("phase 12: restarted replicas never "
                                     "caught up")
            svc.heartbeat()
        replicas_match(svc, [repl["r1"], repl["r2"]], "stage C")
        group_keyed(svc, 4, [], acked, [])
        replicas_match(svc, [repl["r1"], repl["r2"]], "stage C writes")
        print(f"12(c) both replicas down [{card}]: {len(nq)} batches, none "
              f"acked; restarted and re-synced, writes acked again")
        # -- stage D: the leader stops; a replica is promoted ------------
        svc.stop()
        svc._wal.close()
        t0 = time.perf_counter()
        r = repl_call(repl["r1"], ("promote", [("127.0.0.1", repl["r2"])]))
        if r[0] != "ok":
            raise AssertionError(f"phase 12: promotion answered {r}")

        async def follow():
            gc = repgroup.GroupClient([("127.0.0.1", cli[n])
                                       for n in ("r1", "r2")],
                                      discover_timeout=60.0)
            first = await gc.kput(REPG_ROWS[0], "promoted", b"p")
            t_first = time.perf_counter()
            if first[0] != "ok":
                raise AssertionError(f"phase 12: first put after promotion "
                                     f"answered {first}")
            got = await asyncio.gather(*[
                gc.call("kget_many", x, REPG_KEYS, retryable=True)
                for x in REPG_ROWS])
            for x, g in zip(REPG_ROWS, got):
                if g != [("ok", acked[(x, k)]) for k in REPG_KEYS]:
                    raise AssertionError(f"phase 12: row {x}: acknowledged "
                                         f"puts lost across the promotion")
            await gc.close()
            return t_first
        t_first = asyncio.run(follow())
        promo_ms = (t_first - t0) * 1e3
        print(f"12(d) promotion [{card}]: {promo_ms:.3f} ms from the "
              f"promote frame to the first acknowledged put through the "
              f"GroupClient; {len(acked)} acknowledged puts read back; "
              f"phase {time.perf_counter() - t_phase:.3f} s")
        return {"counts": counts, "replica_f1": replica_f1,
                "flush_ms": statistics.median(ms_group),
                "one_host_flush_ms": statistics.median(ms_one),
                "stage_a_ms": sum(ms_group), "one_host_stage_a_ms": sum(ms_one),
                "catch_up_ms": catch_ms, "promotion_ms": promo_ms,
                "replica_apply_ms": rep_apply, "snapshot_bytes": snap,
                "entry_bytes": {names[k]: statistics.median(
                    b for b, _c, _f in v) for k, v in by_kind.items()}}
    finally:
        for p, _r, _c in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# Phase 13: the device Merkle tree and the scalar consensus plane

#: the reference synctree's design scale: 16^5 segments, width 16
TREE_SEGS, TREE_WIDTH = 16 ** 5, 16
#: 13(a): ids in the update batch, segments the remote tree differs in
TREE_K, TREE_DIFFS = 4096, 1000
#: 13(b): Riak KV's strong consistency runs one ensemble per ring
#: partition (64 at the default ring_creation_size), n_val 5
SCALAR_NODES, SCALAR_ENS, SCALAR_PEERS, SCALAR_KEYS = 5, 64, 5, 100

#: the remote tree of 13(a), built on the card in a process of its own
TREE_CHILD = """
import sys, time
import numpy as np
import torch
from riak_ensemble_tpu_torch.ops import hash as hashk
from riak_ensemble_tpu_torch.synctree import remote_sync
segs, width, diffs, seed = (int(a) for a in sys.argv[1:5])
dev = torch.device(sys.argv[5])
idx = torch.arange(segs, dtype=torch.int32, device=dev)
levels = hashk.build(hashk.leaf_hash(idx, idx * 7 + 1), width=width)
rng = np.random.default_rng(seed)
ids = torch.from_numpy(rng.choice(segs, diffs, replace=False))
new = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (diffs, hashk.LANES),
                                    dtype=np.int32))
levels = hashk.update(levels, ids.to(dev), new.to(dev), width=width)
srv = remote_sync.TreeSyncServer(levels)
print(f"port={srv.port}", flush=True)
sys.stdin.read()
"""


def tree_remote(segs: int, diffs: int, seed: int):
    """The remote tree of :data:`TREE_CHILD` on CPU tensors, for the
    CPU diff the streamed exchange is held against."""
    idx = torch.arange(segs, dtype=torch.int32)
    levels = hashk.build(hashk.leaf_hash(idx, idx * 7 + 1), width=TREE_WIDTH)
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.choice(segs, diffs, replace=False))
    new = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31,
                                        (diffs, hashk.LANES),
                                        dtype=np.int32))
    return hashk.update(levels, ids, new, width=TREE_WIDTH)


def same_levels(what: str, got, want) -> None:
    if len(got) != len(want) or not all(
            torch.equal(a.cpu(), b) for a, b in zip(got, want)):
        raise AssertionError(f"phase 13(a): {what} on the card differs "
                             f"from the CPU")


def phase_tree(dev, card: str, segs: int = TREE_SEGS, k: int = TREE_K,
               diffs: int = TREE_DIFFS) -> dict:
    """13(a): ``ops/hash.py``'s tree functions on the card at 16^5
    segments, each bit-equal to the same call on CPU tensors, then the
    streamed exchange (``synctree/remote_sync.py``) against a tree on the
    card in another process."""
    from riak_ensemble_tpu_torch.synctree import remote_sync
    t_phase = time.perf_counter()
    timed = dev.type == "cuda"
    idx = torch.arange(segs, dtype=torch.int32)
    leaves_c = hashk.leaf_hash(idx, idx * 7 + 1)
    leaves = leaves_c.to(dev)
    levels = hashk.build(leaves, width=TREE_WIDTH)
    levels_c = hashk.build(leaves_c, width=TREE_WIDTH)
    same_levels("build", levels, levels_c)
    tree_bytes = sum(lv.numel() * 4 for lv in levels)
    rng = np.random.default_rng(1313)
    ids_np = rng.integers(0, segs, k)
    ids_np[k // 2:k // 2 + k // 8] = ids_np[:k // 8]   # duplicates
    new_np = rng.integers(-2 ** 31, 2 ** 31, (k, hashk.LANES), dtype=np.int32)
    ids_c, new_c = torch.from_numpy(ids_np), torch.from_numpy(new_np)
    ids, new = ids_c.to(dev), new_c.to(dev)
    upd = hashk.update(levels, ids, new, width=TREE_WIDTH)
    upd_c = hashk.update(levels_c, ids_c, new_c, width=TREE_WIDTH)
    same_levels("update", upd, upd_c)
    # last write wins: every segment holds its id's last occurrence
    last = {int(seg): i for i, seg in enumerate(ids_np)}
    if not torch.equal(upd_c[-1][ids_c], new_c[[last[int(seg)]
                                                 for seg in ids_np]]):
        raise AssertionError("phase 13(a): a duplicated segment does not "
                             "hold its last write")
    # corrupt one node at three levels; verify flags each parent check
    bad = list(upd)
    bad_c = list(upd_c)
    marks = {1: 7, 3: 1234, len(upd) - 1: segs // 3}
    for lvl, node in marks.items():
        for arr in (bad, bad_c):
            arr[lvl] = arr[lvl].clone()
            arr[lvl][node, 0] ^= 0x5A5A
    flags = hashk.verify(tuple(bad), width=TREE_WIDTH)
    flags_c = hashk.verify(tuple(bad_c), width=TREE_WIDTH)
    same_levels("verify", flags, flags_c)
    for lvl, node in marks.items():
        # the stored node no longer matches its parent's fold...
        if not bool(flags_c[lvl - 1][node // TREE_WIDTH]):
            raise AssertionError(f"phase 13(a): verify missed level {lvl}")
        # ...and an inner node no longer matches its own children
        if lvl < len(upd) - 1 and not bool(flags_c[lvl][node]):
            raise AssertionError(f"phase 13(a): verify missed level {lvl}")
    if any(bool(f.any()) for f in hashk.verify(upd_c, width=TREE_WIDTH)):
        raise AssertionError("phase 13(a): a clean tree failed verify")
    # a second tree with `diffs` differing segments
    remote_c = tree_remote(segs, diffs, 1314)
    remote = tuple(lv.to(dev) for lv in remote_c)
    masks = hashk.diff_levels(levels, remote)
    masks_c = hashk.diff_levels(levels_c, remote_c)
    same_levels("diff_levels", masks, masks_c)
    cost = hashk.exchange_cost(levels, remote, width=TREE_WIDTH)
    cost_c = hashk.exchange_cost(levels_c, remote_c, width=TREE_WIDTH)
    if not torch.equal(cost.cpu(), cost_c):
        raise AssertionError("phase 13(a): exchange_cost differs")
    want = torch.nonzero(masks_c[-1])[:, 0].tolist()
    if len(want) != diffs:
        raise AssertionError(f"phase 13(a): {len(want)} differing "
                             f"segments, not {diffs}")
    ms = {}
    if timed:
        ms = {"build": cuda_ms(lambda: hashk.build(leaves, TREE_WIDTH), 5),
              "update": cuda_ms(lambda: hashk.update(levels, ids, new,
                                                     TREE_WIDTH), 5),
              "verify": cuda_ms(lambda: hashk.verify(upd, TREE_WIDTH), 5),
              "diff_levels": cuda_ms(lambda: hashk.diff_levels(levels,
                                                               remote), 5),
              "exchange_cost": cuda_ms(lambda: hashk.exchange_cost(
                  levels, remote, TREE_WIDTH), 5)}
    # the streamed exchange between two processes, both trees on `dev`
    root = os.path.dirname(os.path.abspath(__file__))
    child = subprocess.Popen(
        [sys.executable, "-c", TREE_CHILD, str(segs), str(TREE_WIDTH),
         str(diffs), "1314", str(dev)], cwd=root,
        env=dict(os.environ, PYTHONPATH=root), stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = child.stdout.readline()
        if not line.startswith("port="):
            raise AssertionError(f"phase 13(a): tree server did not start: "
                                 f"{child.stderr.read()[-3000:]}")
        port = int(line.split("=")[1])
        sync_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            found, stats = remote_sync.sync_diff(levels, "127.0.0.1", port,
                                                 width=TREE_WIDTH)
            sync_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        child.stdin.close()
        child.wait(timeout=60)
    if sorted(found.tolist()) != want:
        raise AssertionError("phase 13(a): the streamed exchange found "
                             "other segments than the CPU diff")
    height = len(levels)
    node_bytes = hashk.LANES * 4
    limit = (1 + diffs * TREE_WIDTH * height) * node_bytes * 2
    if stats["messages"] > height + 1 or stats["bytes_rx"] > limit or \
            stats["visited"] != cost_c.tolist():
        raise AssertionError(f"phase 13(a): exchange traffic {stats} "
                             f"outside O(width * height * diffs) "
                             f"({limit} B)")
    out = {"segments": segs, "tree_bytes": tree_bytes, "update_k": k,
           "diffs": diffs, "ms": ms, "sync_diff_ms": sync_ms,
           "messages": stats["messages"], "bytes_tx": stats["bytes_tx"],
           "bytes_rx": stats["bytes_rx"], "visited": stats["visited"],
           "bound_bytes_rx": limit}
    print(f"13(a) device tree {segs} segments x {hashk.LANES} lanes, width "
          f"{TREE_WIDTH} ({tree_bytes} B of levels) [{card}]: build, "
          f"update K={k} (duplicates), verify (3 corrupt levels), "
          f"diff_levels, exchange_cost bit-equal to the CPU; ms per call "
          + ", ".join(f"{n} {v:.6f}" for n, v in ms.items()))
    print(f"13(a) sync_diff across processes [{card}]: {len(found)} "
          f"divergent segments = the CPU diff; {stats['messages']} "
          f"messages, {stats['bytes_tx']} B out, {stats['bytes_rx']} B in "
          f"(bound {limit} B; the levels hold {tree_bytes} B), visited "
          f"{stats['visited']}; wall ms per exchange "
          + ", ".join(f"{v:.3f}" for v in sync_ms)
          + f"; phase {time.perf_counter() - t_phase:.3f} s")
    return out


def retried(fn, tries: int = 20):
    """``fn()`` again while it answers a timeout (at most ``tries``
    times): an op racing a leader change may time out without losing an
    acknowledged write."""
    for _ in range(tries - 1):
        r = fn()
        if r != ("error", "timeout"):
            return r
    return fn()


def scalar_op(lat: list, fn):
    t0 = time.perf_counter()
    r = fn()
    lat.append(time.perf_counter() - t0)
    return r


def managed_cluster(nodes: list, seed: int, phase: str):
    """``testing.ManagedCluster`` over ``nodes``, every node joined and
    the root ensemble on all of them, stable."""
    from riak_ensemble_tpu_torch.testing import ManagedCluster
    from riak_ensemble_tpu_torch.types import PeerId

    mc = ManagedCluster(seed=seed, nodes=tuple(nodes))
    rt = mc.runtime
    mc.enable(nodes[0])
    for n in nodes[1:]:
        mc.join(n, nodes[0])
    r = mc.update_members("root", [("add", PeerId("root", n))
                                   for n in nodes[1:]])
    if r != "ok":
        raise AssertionError(f"phase {phase}: root expansion answered {r}")
    if not rt.run_until(lambda: all(
            rt.whereis(("peer", "root", PeerId("root", n))) is not None
            for n in nodes), 60.0, poll=0.1):
        raise AssertionError(f"phase {phase}: root peers never started")
    mc.wait_stable("root")
    return mc


def phase_scalar(card: str, n_ens: int = SCALAR_ENS,
                 n_keys: int = SCALAR_KEYS, seed: int = 13) -> dict:
    """13(b): riak_ensemble's own plane (``testing.ManagedCluster``: a
    manager, routers and storage per node, the root ensemble, gossip) at
    a deployment's size: 5 nodes, ``n_ens`` ensembles of 5 peers on 5
    distinct nodes, ``n_keys`` keys each through every K/V verb, a
    leader suspended and re-elected, a peer's synctree corrupted and
    healed by exchange, then every acknowledged put read back."""
    from riak_ensemble_tpu_torch import funref as fref
    from riak_ensemble_tpu_torch.types import NOTFOUND, PeerId
    from riak_ensemble_tpu_torch.utils import clock

    if clock.load() is None or not clock.is_boottime():
        raise AssertionError("phase 13(b): the native CLOCK_BOOTTIME clock "
                             "of the host library is not in use")
    t_phase = time.perf_counter()
    nodes = [f"node{i}" for i in range(SCALAR_NODES)]
    mc = managed_cluster(nodes, seed, "13(b)")
    rt = mc.runtime
    names = [f"p{e}" for e in range(n_ens)]
    for e, name in enumerate(names):
        mc.create_ensemble(name, [PeerId(j, nodes[(e + j) % SCALAR_NODES])
                                  for j in range(SCALAR_PEERS)])
    for name in names:
        mc.wait_stable(name)
    elect_s = time.perf_counter() - t_phase
    sim_elect = rt.now
    clients = [mc.client(n) for n in nodes]
    lat = []
    acked = {}
    kmod = fref.ref("peer:kmodify")

    def ok(r, what):
        if not (isinstance(r, tuple) and r[0] == "ok"):
            raise AssertionError(f"phase 13(b): {what} answered {r!r}")
        return r[1]

    for e, name in enumerate(names):
        for i in range(n_keys):
            c = clients[(e + i) % SCALAR_NODES]
            key = f"k{i}"
            ok(scalar_op(lat, lambda: c.kput_once(name, key, b"a%d" % i)),
               "kput_once")
            if scalar_op(lat, lambda: c.kput_once(name, key, b"x")) != \
                    ("error", "failed"):
                raise AssertionError("phase 13(b): a second kput_once "
                                     "succeeded")
            ok(scalar_op(lat, lambda: c.kover(name, key, b"b%d" % i)),
               "kover")
            cur = ok(scalar_op(lat, lambda: c.kget(name, key)), "kget")
            ok(scalar_op(lat, lambda: c.kupdate(name, key, cur,
                                                b"c%d" % i)), "kupdate")
            acked[(name, key)] = b"c%d" % i
            if i % 10 == 0:
                ctr = f"n{i}"
                for step in range(1, 3):
                    got = ok(scalar_op(lat, lambda: c._sync(
                        name, ("put", ctr, kmod,
                               [lambda vsn, v: v + 1, 0]), 10.0)),
                        "kmodify")
                    if got.value != step:
                        raise AssertionError(f"phase 13(b): kmodify gave "
                                             f"{got.value}, not {step}")
                acked[(name, ctr)] = 2
                dk = f"d{i}"
                ok(scalar_op(lat, lambda: c.kover(name, dk, b"gone")),
                   "kover")
                ok(scalar_op(lat, lambda: c.kdelete(name, dk)), "kdelete")
                acked[(name, dk)] = NOTFOUND
    n_ops = len(lat)
    # a leader suspended and re-elected
    victim_ens = names[0]
    leader = mc.leader_id(victim_ens)
    mc.suspend_peer(victim_ens, leader)
    t0 = time.perf_counter()
    if not rt.run_until(lambda: mc.leader_id(victim_ens)
                        not in (None, leader), 60.0):
        raise AssertionError("phase 13(b): no re-election")
    mc.wait_stable(victim_ens)
    reelect_ms = (time.perf_counter() - t0) * 1e3
    # the first ops after a failover may time out (a router's stale
    # leader, an ambiguous outcome): a put is acknowledged once it says ok
    ok(retried(lambda: clients[1].kover(victim_ens, "after", b"failover")),
       "kover")
    acked[(victim_ens, "after")] = b"failover"
    mc.resume_peer(victim_ens, leader)
    # one peer's synctree corrupted, healed by exchange
    corrupt_ens = names[1]
    cl = mc.leader_id(corrupt_ens)
    mc.tree_of(corrupt_ens, cl).tree.corrupt("k1")

    def healed():
        r = clients[2].kget(corrupt_ens, "k1", timeout=5.0)
        if r[0] == "ok" and r[1].value is NOTFOUND:
            raise AssertionError("phase 13(b): a corrupted tree let a "
                                 "read return notfound")
        return r[0] == "ok" and r[1].value == acked[(corrupt_ens, "k1")]
    if not rt.run_until(healed, 120.0, poll=0.1):
        raise AssertionError("phase 13(b): the corrupted tree never healed")
    rt.run_for(2.0)
    peers = [p for p in rt.actors.values()
             if type(p).__name__ == "Peer" and p.ensemble == corrupt_ens]
    tops = {mc.tree_of(corrupt_ens, p.id).tree.top_hash for p in peers}
    if len(peers) != SCALAR_PEERS or len(tops) != 1 or not all(
            mc.tree_of(corrupt_ens, p.id).tree.verify() for p in peers):
        raise AssertionError("phase 13(b): the peers' trees did not "
                             "converge after the exchange")
    # every acknowledged put read back
    acked_read = []
    for (name, key), want in acked.items():
        c = clients[len(acked_read) % SCALAR_NODES]
        got = ok(retried(lambda: c.kget(name, key)),
                 f"kget {name}/{key}").value
        acked_read.append(key)
        if not (got is want if want is NOTFOUND else got == want):
            raise AssertionError(f"phase 13(b): {name}/{key} read {got!r}, "
                                 f"acknowledged {want!r}")
    us = sorted(x * 1e6 for x in lat)
    out = {"nodes": SCALAR_NODES, "ensembles": n_ens + 1,
           "peers": SCALAR_PEERS, "keys_per_ensemble": n_keys,
           "ops": n_ops, "acked_read_back": len(acked),
           "elect_wall_s": elect_s, "elect_sim_s": sim_elect,
           "op_us_p50": pctl(us, 50), "op_us_p99": pctl(us, 99),
           "reelect_wall_ms": reelect_ms, "sim_s": rt.now,
           "wall_s": time.perf_counter() - t_phase}
    print(f"13(b) scalar plane, {SCALAR_NODES} nodes, root + {n_ens} "
          f"ensembles x {SCALAR_PEERS} peers, {n_keys} keys each [{card}]: "
          f"elected in {elect_s:.3f} s wall ({sim_elect:.3f} s simulated); "
          f"{n_ops} ops, wall us per op p50 {out['op_us_p50']:.1f} p99 "
          f"{out['op_us_p99']:.1f}; re-election {reelect_ms:.3f} ms wall; "
          f"tree healed; {len(acked)} acknowledged keys read back; "
          f"{rt.now:.3f} s simulated, {out['wall_s']:.3f} s wall")
    return out


def phase_scalar_plane(dev, card: str) -> dict:
    """Phase 13: (a) the device tree and its streamed exchange on the
    card, (b) the scalar consensus plane at a deployment's size."""
    return {"tree": phase_tree(dev, card), "scalar": phase_scalar(card)}


# -- phase 14: the scale plane under consensus management ----------------------

#: 14(a): svcnodes, tenants (cut from 10,000, one a row: each root
#: mutation rewrites the gossiped cluster state in Python), keys written to
#: each, tenants whose view changes and tenants retired
TENANT_NODES, TENANT_T, TENANT_KEYS = 3, 1_000, 64
TENANT_VIEW, TENANT_RETIRE = 8, 8
RECONCILE_ERRORS = ("svc_reconcile_error", "svc_reconcile_tenant_error")
#: 14(b): the read fast path's arms (the cases of
#: tests/test_linearizability.py:172-206): label, seed, pipeline depth,
#: safety margin as a share of the lease; rounds and keys an ensemble (one
#: key, so that reads find the keys written in 10,000 ensembles)
READ_ARMS = (("lease expiry and step-down", 1201, 1, None),
             ("depth 2", 1301, 2, None),
             ("skewed margin", 1401, 1, 0.9))
READ_ROUNDS, READ_KEYS = 400, 1
#: 14(c): keys node0 acknowledges before the kill and again after it
NET_KEYS = 32


class TenantMeter:
    """Keeps every ``svc_*`` event of each service and times the
    reconcilers' exports, the services' ``install_objs`` and
    ``update_members`` (ms per call, the card synchronised)."""

    def __init__(self, dev: torch.device) -> None:
        self.dev = dev
        self.events = {}
        self.ms = {"export": [], "install": [], "update_members": []}

    def _timed(self, label: str, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync(self.dev)
            self.ms[label].append((time.perf_counter() - t0) * 1e3)
            return out
        return timed

    def watch(self, name: str, svc, rec) -> None:
        events = self.events[name] = []
        emit = svc._emit

        def recorded(kind, payload):
            if kind.startswith("svc_"):
                events.append((kind, payload))
            emit(kind, payload)
        svc._emit = recorded
        rec._export = self._timed("export", rec._export)
        svc.install_objs = self._timed("install", svc.install_objs)
        svc.update_members = self._timed("update_members",
                                         svc.update_members)

    def errors(self) -> list:
        return [(n, kind, payload) for n, ev in self.events.items()
                for kind, payload in ev if kind in RECONCILE_ERRORS]

    def kinds(self) -> dict:
        out = {}
        for ev in self.events.values():
            for kind, _p in ev:
                if kind.startswith("svc_tenant"):
                    out[kind] = out.get(kind, 0) + 1
        return out


def spread(xs: list) -> dict:
    return ({"n": len(xs), "median": pctl(xs, 50), "p99": pctl(xs, 99)}
            if xs else {"n": 0})


def phase_tenants(dev: torch.device, card: str, e: int = E_FULL,
                  m: int = M_FULL, s: int = S_FULL, k: int = K_FULL,
                  n_tenants: int = TENANT_T,
                  n_keys: int = TENANT_KEYS) -> tuple:
    """14(a): two svcnodes' services of ``e`` x ``m`` x ``s`` rows,
    ``dynamic=True``, each with a data dir at ``wal_sync="fsync"`` and a
    ``ServiceReconciler``, over a ``ManagedCluster`` of 3 nodes with the
    root ensemble on all 3.  ``svc@node0`` registers, ``n_tenants``
    tenants are created through the root (cut from 10,000: each root
    mutation rewrites the gossiped cluster state in Python) and adopted,
    ``n_keys`` keys a tenant are written with ``kput_many``; then
    ``svc@node1`` registers and the tenants rebalance by gossip alone
    (each runs only on its rendezvous owner, nothing importing); every
    key reads back on its owner with its (epoch, seq), a CAS token minted
    before the move succeeds on every moved tenant; a view change on
    ``TENANT_VIEW`` tenants reaches the device and their keys read back;
    ``TENANT_RETIRE`` tenants retire and run nowhere.  Any reconcile error
    event fails the phase."""
    import shutil

    from riak_ensemble_tpu_torch import service_directory as sd
    from riak_ensemble_tpu_torch import service_manager as sm
    from riak_ensemble_tpu_torch.config import fast_test_config

    t_phase = time.perf_counter()
    nodes = [f"node{i}" for i in range(TENANT_NODES)]
    mc = managed_cluster(nodes, 14, "14(a)")
    rt = mc.runtime
    mgr = mc.mgr(nodes[0])
    meter = TenantMeter(dev)
    svcs, registry, datas, wals, steps = {}, {}, [], [], {}
    t_step = [time.perf_counter()]

    def step(label):
        now = time.perf_counter()
        steps[label] = now - t_step[0]
        t_step[0] = now

    def wait(pred, what, budget=600.0):
        if not rt.run_until(pred, budget, poll=0.05):
            raise AssertionError(f"phase 14(a): {what} never happened "
                                 f"(events {meter.kinds()}, errors "
                                 f"{meter.errors()[:2]})")

    def bring_up(i):
        name = f"svc@{nodes[i]}"
        datas.append(tempfile.mkdtemp(prefix="retpu_tenants_"))
        svc = svcs[name] = BatchedEnsembleService(
            rt, e, m, s, tick=0.005, max_ops_per_tick=k,
            config=fast_test_config(), device=dev, dynamic=True,
            data_dir=datas[-1], wal_sync="fsync")
        rec = registry[name] = sm.ServiceReconciler(
            rt, mc.mgr(nodes[i]), svc, name, registry.get, poll=0.25)
        meter.watch(name, svc, rec)
        wals.append(WalMeter(svc))
        r = sd.register_service(mc.mgr(nodes[i]), rt, name, "127.0.0.1",
                                7000 + i, (e, m, s))
        if r != "ok":
            raise AssertionError(f"phase 14(a): registering {name} "
                                 f"answered {r!r}")
        return svc

    def settle(futs, what):
        wait(lambda: all(f.done for f in futs), what)
        return [f.value for f in futs]

    reset_counts()                             # this path's run
    svc0 = bring_up(0)
    names = [f"tenant{i:05d}" for i in range(n_tenants)]
    for t in names:
        r = sm.create_tenant(mgr, rt, t)
        if r != "ok":
            raise AssertionError(f"phase 14(a): create_tenant({t}) "
                                 f"answered {r!r}")
    step("register + create")
    wait(lambda: all(svc0.resolve_ensemble(t) is not None for t in names),
         "adoption")
    step("adopt")
    keys = [f"k{j}" for j in range(n_keys)]
    acked = {}
    futs = {t: svc0.kput_many(svc0.resolve_ensemble(t), keys,
                              [b"%s/%d" % (t.encode(), j)
                               for j in range(n_keys)]) for t in names}
    for t, res in zip(futs, settle(list(futs.values()), "the writes")):
        for key, r in zip(keys, res):
            if not (isinstance(r, tuple) and r[0] == "ok"):
                raise AssertionError(f"phase 14(a): put {t}/{key} "
                                     f"answered {r!r}")
            acked[(t, key)] = (b"%s/%s" % (t.encode(), key[1:].encode()),
                               tuple(r[1]))
    step("write")
    svc1 = bring_up(1)
    both = sorted(svcs)
    owner = {t: sm.place(t, both) for t in names}
    moved = [t for t in names if owner[t] == "svc@node1"]

    def converged():
        return all(svcs[owner[t]].resolve_ensemble(t) is not None
                   and all(x.resolve_ensemble(t) is None
                           for n, x in svcs.items() if n != owner[t])
                   for t in names) and not any(
                       r._importing for r in registry.values())
    wait(converged, "the rebalance")
    step("join + rebalance")
    if not moved or len(moved) == n_tenants:
        raise AssertionError(f"phase 14(a): {len(moved)} of {n_tenants} "
                             f"tenants moved")

    def read_back(ts, what):
        futs = {t: svcs[owner[t]].kget_many(
            svcs[owner[t]].resolve_ensemble(t), keys, want_vsn=True)
            for t in ts}
        for t, res in zip(futs, settle(list(futs.values()), what)):
            for key, r in zip(keys, res):
                val, vsn = acked[(t, key)]
                if r != ("ok", val, vsn):
                    raise AssertionError(f"phase 14(a): {what}: {t}/{key} "
                                         f"read {r!r}, acknowledged "
                                         f"{(val, vsn)!r}")
    read_back(names, "read back after the move")
    tokens = {t: acked[(t, "k0")][1] for t in moved}
    cas = {t: svcs[owner[t]].kupdate(svcs[owner[t]].resolve_ensemble(t),
                                     "k0", tokens[t], b"cas/" + t.encode())
           for t in moved}
    for t, r in zip(cas, settle(list(cas.values()), "the CAS")):
        if not (isinstance(r, tuple) and r[0] == "ok"
                and tuple(r[1]) > tokens[t]):
            raise AssertionError(f"phase 14(a): a pre-move token on {t} "
                                 f"answered {r!r}")
        acked[(t, "k0")] = (b"cas/" + t.encode(), tuple(r[1]))
    stale_r = settle([svcs[owner[moved[0]]].kupdate(
        svcs[owner[moved[0]]].resolve_ensemble(moved[0]), "k0",
        tokens[moved[0]], b"stale")], "the stale CAS")[0]
    if stale_r != "failed":
        raise AssertionError(f"phase 14(a): a stale token answered "
                             f"{stale_r!r}")
    step("read back + CAS")
    view = [True] * (m - 1) + [False]
    viewed = moved[:TENANT_VIEW // 2] + [t for t in names
                                         if t not in moved][:TENANT_VIEW // 2]
    t0 = time.perf_counter()
    root_ms = []
    for t in viewed:
        t1 = time.perf_counter()
        r = sm.set_tenant_view(mgr, rt, t, view)
        root_ms.append((time.perf_counter() - t1) * 1e3)
        if r != "ok":
            raise AssertionError(f"phase 14(a): set_tenant_view({t}) "
                                 f"answered {r!r}")
    wait(lambda: all(list(svcs[owner[t]].member_np[
        svcs[owner[t]].resolve_ensemble(t)]) == view for t in viewed),
        "the view change")
    view_ms = (time.perf_counter() - t0) * 1e3
    read_back(viewed, "read back after the view change")
    step("view change")
    gone = [t for t in names if t not in viewed][-TENANT_RETIRE:]
    for t in gone:
        r = sm.retire_tenant(mgr, rt, t)
        if r != "ok":
            raise AssertionError(f"phase 14(a): retire_tenant({t}) "
                                 f"answered {r!r}")
    wait(lambda: all(x.resolve_ensemble(t) is None for x in svcs.values()
                     for t in gone), "the retirement")
    if set(sm.tenants(mgr)) & set(gone):
        raise AssertionError("phase 14(a): retired tenants still in the "
                             "registry")
    step("retire")
    counts = read_counts()
    errors = meter.errors()
    if errors:
        raise AssertionError(f"phase 14(a): reconcile errors: {errors[:3]}")
    fsyncs = sum(w.fsyncs for w in wals)
    wal_records = sum(w.records for w in wals)
    for rec in registry.values():
        rec.stop()
    for x in svcs.values():
        x.stop()
        x._wal.close()
    del svcs, svc0, svc1, registry
    for d in datas:
        shutil.rmtree(d, ignore_errors=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = {"tenants": n_tenants, "keys": n_tenants * n_keys,
           "moved": len(moved), "cas_after_move": len(cas),
           "viewed": len(viewed), "retired": len(gone),
           "step_s": steps, "export_ms": spread(meter.ms["export"]),
           "install_ms": spread(meter.ms["install"]),
           "update_members_ms": spread(meter.ms["update_members"]),
           "view_change_ms": view_ms, "set_tenant_view_ms": spread(root_ms),
           "events": meter.kinds(), "wal_records": wal_records,
           "wal_fsyncs": fsyncs, "sim_s": rt.now,
           "wall_s": time.perf_counter() - t_phase}
    print(f"14(a) tenants at {e} x {m} x {s}, K = {k}, 2 svcnodes over "
          f"{TENANT_NODES} nodes, fsync [{card}]: {n_tenants} tenants, "
          f"{n_tenants * n_keys} keys; {len(moved)} moved and read back "
          f"with their versions, {len(cas)} pre-move CAS tokens served; "
          + "; ".join(f"{lab} {sec:.3f} s" for lab, sec in steps.items())
          + "; export ms per tenant median "
          f"{out['export_ms'].get('median', 0):.3f} p99 "
          f"{out['export_ms'].get('p99', 0):.3f}, install_objs median "
          f"{out['install_ms'].get('median', 0):.3f} p99 "
          f"{out['install_ms'].get('p99', 0):.3f}; view change on "
          f"{len(viewed)} tenants {view_ms:.3f} ms (update_members median "
          f"{out['update_members_ms'].get('median', 0):.3f} ms); "
          f"{len(gone)} retired; events {out['events']}; {wal_records} WAL "
          f"records, {fsyncs} fsyncs; "
          f"launches {counts}; {rt.now:.3f} s simulated, "
          f"{out['wall_s']:.3f} s wall")
    return counts, out


def phase_read_nemesis(dev: torch.device, card: str, e: int = E_FULL,
                       m: int = M_FULL, s: int = S_FULL, k: int = K_FULL,
                       rounds: int = READ_ROUNDS) -> tuple:
    """14(b): the port's ``ServiceReadWorkload`` (lease expiry, leader
    step-down and re-election, clock jumps into the safety margin) on a
    service of ``e`` x ``m`` x ``s`` on the card, checked by the port's
    ``KeyModel``, in the three arms of ``READ_ARMS``: no ``Violation``,
    and the fast path serves reads."""
    from riak_ensemble_tpu_torch.config import fast_test_config
    from riak_ensemble_tpu_torch.linearizability import ServiceReadWorkload
    from riak_ensemble_tpu_torch.runtime import Runtime

    reset_counts()                             # this path's run
    out = {}
    for label, seed, depth, margin in READ_ARMS:
        cfg = fast_test_config()
        if margin is not None:
            cfg.read_lease_margin = cfg.lease() * margin
        rt = Runtime(seed=seed)
        svc = BatchedEnsembleService(rt, e, m, s, tick=None,
                                     max_ops_per_tick=k, config=cfg,
                                     pipeline_depth=depth, device=dev)
        t0 = time.perf_counter()
        ServiceReadWorkload(svc, rt, n_keys=READ_KEYS, seed=seed,
                            rounds=rounds).run()
        sync(dev)
        wall = time.perf_counter() - t0
        if svc.read_fastpath_hits <= 0:
            raise AssertionError(f"phase 14(b) {label}: the fast path "
                                 f"served no read")
        out[label] = {"seed": seed, "depth": depth, "margin": margin,
                      "hits": svc.read_fastpath_hits,
                      "misses": svc.read_fastpath_misses,
                      "miss_reasons": dict(svc.read_fastpath_miss_reasons),
                      "flushes": svc.flushes, "wall_s": wall}
        svc.stop()
        del svc
    counts = read_counts()
    print(f"14(b) read fast path under its nemesis at {e} x {m} x {s}, "
          f"{rounds} rounds, {READ_KEYS} key an ensemble [{card}]: "
          + "; ".join(f"{lab}: no violation, {v['hits']} hits, "
                      f"{v['misses']} misses {v['miss_reasons']}, "
                      f"{v['flushes']} flushes, {v['wall_s']:.3f} s"
                      for lab, v in out.items())
          + f"; launches {counts}")
    return counts, out


NET_COMMON = """
import asyncio, os
from riak_ensemble_tpu_torch.types import PeerId

async def until_ok(op, tries=600, pause=0.2):
    # a timed-out or unavailable op is retried, never taken as done
    r = ("error", "not_started")
    for _ in range(tries):
        r = await op()
        if r[0] == "ok":
            return r
        await asyncio.sleep(pause)
    raise AssertionError(r)
"""

NET_NODE0 = NET_COMMON + """
async def all_three_answer(node, limit=180.0):
    # every replica answers the leader's commit: a replica whose tree
    # exchange has not finished does not vote, so a kill before this
    # would leave the ensemble without a quorum
    end = asyncio.get_running_loop().time() + limit
    n = 0
    while asyncio.get_running_loop().time() < end:
        n = await node.runtime.await_future(
            node.manager.count_quorum("kv", timeout=2.0), 4.0)
        if n >= 3:
            return
        await asyncio.sleep(0.3)
    raise AssertionError(n)

async def main(node):
    n_keys = int(os.environ["NET_KEYS"])
    assert (await node.enable()) == "ok"
    for _ in range(600):
        if len(node.members()) >= 3:
            break
        await asyncio.sleep(0.1)
    assert len(node.members()) >= 3, node.members()
    peers = [PeerId(1, "node1"), PeerId(0, "node0"), PeerId(2, "node2")]
    assert (await node.create_ensemble("kv", peers)) == "ok"
    acked = {}
    for i in range(n_keys):
        key, val = f"k{i}", b"v1-%d" % i
        await until_ok(lambda: node.kover("kv", key, val, timeout=3.0))
        acked[key] = val
    await all_three_answer(node)
    print("WROTE", flush=True)
    while not os.path.exists(os.environ["KILLED_MARK"]):
        await asyncio.sleep(0.05)
    for i in range(n_keys):
        key, val = f"k{i}", b"v2-%d" % i
        await until_ok(lambda: node.kover("kv", key, val, timeout=2.0))
        acked[key] = val
    print("SURVIVED", flush=True)
    await all_three_answer(node)
    for key, val in acked.items():
        r = await until_ok(lambda: node.kget("kv", key, timeout=5.0))
        assert r[1].value == val, (key, r)
    print("READ_BACK", len(acked), flush=True)
    await asyncio.sleep(300)
"""

NET_JOINER = """
import asyncio

async def main(node):
    r = None
    for _ in range(600):
        r = await node.join("node0", timeout=10.0)
        if r == "ok":
            break
        await asyncio.sleep(0.3)
    assert r == "ok", r
    print("JOINED", flush=True)
    await asyncio.sleep(600)
"""

NET_IDLE = """
import asyncio

async def main(node):
    print("UP", flush=True)
    await asyncio.sleep(600)
"""


def port_free(port: int, wait: float = 10.0) -> None:
    """Wait (at most ``wait`` s) until ``port`` binds again, as a
    restarted node's listener (``SO_REUSEADDR``) will."""
    import socket
    end = time.monotonic() + wait
    while True:
        sock = socket.socket()
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            sock.bind(("127.0.0.1", port))
            return
        except OSError:
            if time.monotonic() > end:
                raise AssertionError(f"phase 14(c): port {port} stayed "
                                     f"taken for {wait} s")
            time.sleep(0.05)
        finally:
            sock.close()


def phase_netnode(card: str, n_keys: int = NET_KEYS) -> dict:
    """14(c): three ``python -m riak_ensemble_tpu_torch.netnode``
    processes on loopback: enable, join, an ensemble of 3 with its leader
    hint on node1, ``n_keys`` writes, all 3 replicas answering; kill -9 of
    node1, ``n_keys``
    overwrites through the survivors; node1 restarted from its data root
    on its port (once the port binds again, at most 10 s); every
    acknowledged write read back once all 3 replicas answer."""
    import queue
    import socket
    import threading

    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="retpu_netnode_")
    socks = [socket.socket() for _ in range(3)]
    for sock in socks:
        sock.bind(("127.0.0.1", 0))
    ports = [sock.getsockname()[1] for sock in socks]
    for sock in socks:
        sock.close()
    peer_args = []
    for i, p in enumerate(ports):
        peer_args += ["--peer", f"node{i}=127.0.0.1:{p}"]
    scripts = {}
    for name, body in (("node0", NET_NODE0), ("join", NET_JOINER),
                       ("idle", NET_IDLE)):
        scripts[name] = os.path.join(tmp, f"{name}.py")
        with open(scripts[name], "w") as f:
            f.write(body)
    killed = os.path.join(tmp, "killed")
    env = dict(os.environ, PYTHONPATH=root, NET_KEYS=str(n_keys),
               KILLED_MARK=killed)
    procs, lines = [], {}

    def spawn(node, script):
        p = subprocess.Popen(
            [sys.executable, "-m", "riak_ensemble_tpu_torch.netnode",
             "--node", node, *peer_args, "--fast", "--data-root",
             os.path.join(tmp, node), "--script", scripts[script]],
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        procs.append(p)
        q = lines[node] = queue.Queue()
        q.seen = []

        def reader():
            for ln in p.stdout:
                q.seen.append(ln.rstrip())
                q.put(ln.rstrip())
            q.put(None)
        threading.Thread(target=reader, daemon=True).start()
        return p

    def wait_line(node, mark, limit):
        q = lines[node]
        end = time.monotonic() + limit
        while True:
            try:
                ln = q.get(timeout=max(0.0, end - time.monotonic()))
            except queue.Empty:
                ln = None
            if ln is None:
                raise AssertionError(f"phase 14(c): {node} never printed "
                                     f"{mark}: {q.seen[-20:]!r}")
            if ln.startswith(mark):
                return ln

    t0 = time.perf_counter()
    marks = {}
    try:
        spawn("node0", "node0")
        victim = spawn("node1", "join")
        spawn("node2", "join")
        wait_line("node0", "WROTE", 180)
        marks["up_and_written_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        victim.kill()
        victim.wait(timeout=10)
        with open(killed, "w"):
            pass
        wait_line("node0", "SURVIVED", 180)
        marks["failover_and_overwrite_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        port_free(ports[1])
        spawn("node1", "idle")
        wait_line("node1", "UP", 60)
        got = int(wait_line("node0", "READ_BACK", 180).split()[1])
        marks["restart_and_read_back_s"] = time.perf_counter() - t1
    finally:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
    if got != n_keys:
        raise AssertionError(f"phase 14(c): {got} of {n_keys} acknowledged "
                             f"writes read back")
    out = {"nodes": 3, "acked_read_back": got, **marks,
           "wall_s": time.perf_counter() - t0}
    print(f"14(c) netnode processes [{card}]: 3 nodes up, {n_keys} writes "
          f"in {marks['up_and_written_s']:.3f} s; kill -9 of node1, "
          f"{n_keys} overwrites through the survivors in "
          f"{marks['failover_and_overwrite_s']:.3f} s; restart on its port "
          f"and {got} acknowledged writes read back in "
          f"{marks['restart_and_read_back_s']:.3f} s; {out['wall_s']:.3f} s")
    return out


def phase_tenant_plane(dev: torch.device, card: str) -> tuple:
    """Phase 14: (a) tenants moved by gossip alone, (b) the read fast path
    under its nemesis, each path read with its counts set to 0 just
    before it, and (c) the scalar plane as processes."""
    t0 = time.perf_counter()
    counts = {}
    c, tenants = phase_tenants(dev, card)
    counts["phase14 tenants"] = c
    c, reads = phase_read_nemesis(dev, card)
    counts["phase14b read nemesis"] = c
    net = phase_netnode(card)
    wall = time.perf_counter() - t0
    print(f"phase 14 [{card}]: {wall:.3f} s")
    if not (c["F1"] and counts["phase14 tenants"]["F1"]
            and counts["phase14 tenants"]["K1"]):
        raise AssertionError(f"phase 14: a kernel did not launch on its "
                             f"path: {counts}")
    return counts, {"tenants": tenants, "read_nemesis": reads,
                    "netnode": net, "wall_s": wall}


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


#: F1's sliced shapes that ``--ab`` times: (real rows, A, K, puts) — 6(a)'s
#: three, and 10(b)'s serial ``kput`` (one row in the A = 8 bucket, a put)
AB_SLICED = ((250, 256, 64, False), (250, 256, 1, False),
             (2000, 2048, 64, False), (1, 8, 1, True))

#: How ``--ab`` runs one tree: this file, loaded by its path, in a process
#: whose ``riak_ensemble_tpu_torch`` is that tree's (its root is the
#: working directory, first on ``sys.path``)
AB_BOOT = ("import importlib.util, sys\n"
           "spec = importlib.util.spec_from_file_location('chip_smoke', "
           "sys.argv[1])\n"
           "cs = importlib.util.module_from_spec(spec)\n"
           "sys.modules['chip_smoke'] = cs\n"
           "spec.loader.exec_module(cs)\n"
           "sys.exit(cs.ab_run())\n")


# ---------------------------------------------------------------------------
# Phase 15: the mesh

#: (2, 2)'s peer width: the headline's 5 peers and one absent from every
#: view (M must divide by the peer axis)
MESH_M2 = 6
#: the (4, 1) service's compacted run: rows active of E_FULL
MESH_ROWS = 256


def mesh_devices(n: int) -> list:
    """``n`` shard devices over every card: a card each where there are
    ``n`` cards, else round robin (one card: every shard on it)."""
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(n)]


class LocalEngine:
    """The unsharded engine (F1 / K1 on the card) in the mesh's call
    shape."""
    elect_step = staticmethod(eng.elect_step)
    kv_step_scan = staticmethod(eng.kv_step_scan)
    reconfig_step = staticmethod(eng.reconfig_step)


def mesh_scenario(engine, state, e: int, m: int, dev) -> dict:
    """The reference's ``tests/test_multiprocess.py`` CHILD scenario at
    (e, m, S_FULL, K_FULL): every row elects peer 0, K rounds of puts and
    gets, peer 0 goes down and peer 1 is elected, a joint-consensus
    shrink to peers 1-4 proposed then collapsed, K rounds of reads.
    Returns every output (``KvResult`` planes by name) and the final
    state's planes."""
    rng = np.random.default_rng(7)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    k = K_FULL
    kind = rng.choice([eng.OP_PUT, eng.OP_GET], (k, e)).astype(np.int32)
    slot = rng.integers(0, S_FULL, (k, e)).astype(np.int32)
    val = rng.integers(1, 1 << 20, (k, e)).astype(np.int32)
    lease = np.zeros((k, e), bool)
    up0 = np.ones((e, m), bool)
    up1 = up0.copy()
    up1[:, 0] = False
    shrink = np.zeros((e, m), bool)
    shrink[:, 1:M_FULL] = True
    out = {}
    state, out["won0"] = engine.elect_step(state, t(np.ones(e, bool)),
                                           t(np.zeros(e, np.int32)), t(up0))
    state, res = engine.kv_step_scan(state, t(kind), t(slot), t(val),
                                     t(lease), t(up0))
    out.update({f"kv1.{f}": getattr(res, f) for f in res._fields})
    state, out["won1"] = engine.elect_step(state, t(np.ones(e, bool)),
                                           t(np.ones(e, np.int32)), t(up1))
    state, out["installed"], _ = engine.reconfig_step(
        state, t(np.ones(e, bool)), t(shrink), t(up1))
    state, _, out["collapsed"] = engine.reconfig_step(
        state, t(np.zeros(e, bool)), t(shrink), t(up1))
    gk = np.full((k, e), eng.OP_GET, np.int32)
    state, res = engine.kv_step_scan(state, t(gk), t(slot),
                                     t(np.zeros((k, e), np.int32)),
                                     t(lease), t(up1))
    out.update({f"kv2.{f}": getattr(res, f) for f in res._fields})
    out.update({f"state.{f}": getattr(state, f)
                for f in eng.EngineState._fields})
    out["_state"] = state
    return out


def host_plane(x) -> torch.Tensor:
    return x.gather() if isinstance(x, Sharded) else x.cpu()


def mesh_engine_case(card: str, shape: tuple, m: int) -> dict:
    """15(a) at one mesh shape: the scenario through ``ShardedEngine`` and
    through the unsharded engine on card 0, every result and state plane
    bit-equal; launches per shard; F1's device time per shard."""
    n_ens, n_peer = shape
    e = E_FULL
    views = [list(range(M_FULL))]
    devs = mesh_devices(n_ens * n_peer)
    se = ShardedEngine(make_mesh(n_ens, n_peer, devices=devs))
    print(f"15(a) mesh {shape} at {e} x {m} x {S_FULL}, K = {K_FULL} "
          f"[{card}]: {torch.cuda.device_count()} card(s); shards "
          f"{se.mesh.describe()}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = mesh_scenario(se, se.init_state(e, m, S_FULL, views=views), e, m,
                        devs[0])
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = mesh_scenario(LocalEngine, eng.init_state(
        e, m, S_FULL, views=views, device=devs[0]), e, m, devs[0])
    torch.cuda.synchronize()
    local_s = time.perf_counter() - t0
    bad = [name for name in want if name != "_state"
           and not torch.equal(host_plane(got[name]), host_plane(want[name]))]
    if bad:
        raise AssertionError(f"15(a) {shape}: planes differ from the "
                             f"unsharded engine: {bad}")
    if not (want["won1"].all() and want["collapsed"].all()
            and want["kv2.get_ok"].all()):
        raise AssertionError(f"15(a) {shape}: the scenario did not fail "
                             f"over, shrink and read")
    launches = {str(s): dict(c) for s, c in se.launches.items()}
    # F1's device time per shard: three K-round scans, each shard's
    # launch between CUDA events
    st = got["_state"]
    k = K_FULL
    rng = np.random.default_rng(8)
    gk = torch.from_numpy(np.full((k, e), eng.OP_GET, np.int32)).to(devs[0])
    slot = torch.from_numpy(rng.integers(0, S_FULL, (k, e)).astype(
        np.int32)).to(devs[0])
    lease = torch.zeros((k, e), dtype=torch.bool, device=devs[0])
    up = torch.ones((e, m), dtype=torch.bool, device=devs[0])
    shard_ms = "not measured (no F1 on a sharded peer axis)"
    if n_peer == 1:
        se.kv_step_scan(st, gk, slot, gk, lease, up)
        se.time_shards = True
        for _ in range(3):
            se.kv_step_scan(st, gk, slot, gk, lease, up)
        torch.cuda.synchronize()
        se.time_shards = False
        shard_ms = {str(s): v / 3 for s, v in se.shard_ms().items()}
    print(f"15(a) mesh {shape} [{card}]: every result plane and state "
          f"plane (tree hashes included) equal to the unsharded engine; "
          f"scenario wall {mesh_s:.3f} s (unsharded {local_s:.3f} s); "
          f"launches per shard {launches}; F1 device ms per shard of one "
          f"K = {k} read scan {shard_ms}")
    return {"launches": launches, "ms_per_scan": shard_ms,
            "wall_s": mesh_s, "unsharded_wall_s": local_s}


class FullGridEngine(_LocalEngine):
    """The single engine without its sliced steps: a service over it keeps
    the full launch grid and compacts only the packed result, as a mesh
    service does — so idle rows renew their leases alike and the two
    arms' lease mirrors and fast reads can be held equal."""
    full_step = staticmethod(eng.full_step)
    full_step_wide = staticmethod(eng.full_step_wide)


def mesh_keyed(svc: BatchedEnsembleService, rows: list, phase: int,
               ms: list) -> list:
    """One seeded keyed stream on ``rows``: 4 puts a row, a CAS hit and a
    CAS miss, an RMW, a delete, then every key read; the flush calls'
    wall ms go to ``ms``.  Returns the futures' values in order."""
    keys = [f"k{i}" for i in range(4)]
    add = funref.ref("rmw:add", 3 + phase)

    def run(futs):
        while not all(f.done for f in futs):
            t0 = time.perf_counter()
            svc.flush()
            ms.append((time.perf_counter() - t0) * 1e3)
        return [f.value for f in futs]
    out = run([svc.kput_many(x, keys, [b"p%d.%d.%d" % (phase, x, i)
                                       for i in range(4)]) for x in rows])
    vsn = run([svc.kget_many(x, keys[:1], want_vsn=True) for x in rows])
    out += vsn
    out += run([svc.kupdate_many(x, keys[:2], [v[0][2], (1, 1 << 30)],
                                 [b"cas%d" % phase, b"never"])
                for x, v in zip(rows, vsn)]
               + [svc.kmodify_many(x, ["ctr"], add, 0) for x in rows])
    out += run([svc.kdelete_many(x, keys[2:3]) for x in rows])
    svc.runtime.now += 1.0              # leases lapse: reads go round
    reads = run([svc.kget_many(x, keys + ["ctr"], want_vsn=True)
                 for x in rows])
    # every acknowledged write reads back: the CAS hit's value on k0, the
    # puts on k1 and k3, the RMW on ctr; k2 was deleted
    for x, put, rd in zip(rows, out[:len(rows)], reads):
        want = [b"cas%d" % phase, b"p%d.%d.1" % (phase, x), None,
                b"p%d.%d.3" % (phase, x)]
        if any(r[0] != "ok" for r in put) or any(
                w is not None and (r[0], r[1]) != ("ok", w)
                for w, r in zip(want, rd)) or rd[4][0] != "ok":
            raise AssertionError(f"15(b): row {x}: acknowledged writes "
                                 f"did not read back: {rd!r}")
    return out + reads


def wal_files(root: str) -> dict:
    """Every file under a data dir but the checkpoints: name -> bytes."""
    out = {}
    for path, _dirs, files in os.walk(root):
        rel = os.path.relpath(path, root)
        if rel.split(os.sep)[0].startswith("ckpt."):
            continue
        for f in files:
            with open(os.path.join(path, f), "rb") as fh:
                out[os.path.join(rel, f)] = fh.read()
    return out


def same_service(a: BatchedEnsembleService, b: BatchedEnsembleService,
                 label: str, mirrors: bool = True) -> None:
    """Every state plane, the host maps and the leader mirror equal, and
    with ``mirrors`` the read-path mirrors and leases too (a restore
    starts lease-less, its read mirrors empty)."""
    sa = a.engine.gather_state(a.state)
    sb = b.engine.gather_state(b.state)
    bad = diff_fields(sa, sb, eng.EngineState._fields)
    ma, mb = mirrors_of(a), mirrors_of(b)
    bad += [n for n in ma if (mirrors or n == "leader_np")
            and not np.array_equal(ma[n], mb[n])]
    bad += [n for n in ("key_slot", "slot_handle", "values")
            if getattr(a, n) != getattr(b, n)]
    if bad:
        raise AssertionError(f"{label}: the mesh service differs in {bad}")


def mesh_service(dev: torch.device, card: str) -> tuple:
    """15(b) and (c): the keyed stream on a service over ``mesh_engine``
    at (4, 1) and on one over the single engine at the same full launch
    grid (:class:`FullGridEngine`), every row active and
    then MESH_ROWS rows, with data dirs at fsync; then save / restore
    across the two placements."""
    rng = np.random.default_rng(15)
    sub = np.sort(rng.choice(E_FULL, MESH_ROWS, replace=False)).tolist()
    runs = (("every row", list(range(E_FULL))), (f"{MESH_ROWS} rows", sub))
    arms, dirs = {}, []
    for arm in ("single", "mesh"):
        data = tempfile.mkdtemp(prefix=f"mesh15_{arm}_")
        dirs.append(data)
        se = mesh_engine(4, devices=mesh_devices(4)) if arm == "mesh" \
            else FullGridEngine()
        svc = BatchedEnsembleService(
            FixedClock(), E_FULL, M_FULL, S_FULL, tick=None,
            max_ops_per_tick=K_FULL, device=None if arm == "mesh" else dev,
            engine=se, data_dir=data, wal_sync="fsync")
        svc.flush()
        torch.cuda.synchronize()
        if arm == "mesh":
            reset_counts()                      # the mesh path's run
            se.reset_launch_counts()
        got = {}
        for phase, (label, rows) in enumerate(runs):
            ms = []
            b0, f0 = svc.payload_bytes, svc.payload_bytes_full_width
            got[label] = (mesh_keyed(svc, rows, phase, ms), ms,
                          svc.payload_bytes - b0,
                          svc.payload_bytes_full_width - f0)
        torch.cuda.synchronize()
        if arm == "mesh":
            counts = read_counts()
            per_shard = {str(s): dict(c) for s, c in se.launches.items()}
        arms[arm] = (svc, got, data)
    (one, one_got, d1), (msh, msh_got, d2) = arms["single"], arms["mesh"]
    out = {}
    for label, _rows in runs:
        if one_got[label][0] != msh_got[label][0]:
            raise AssertionError(f"15(b) {label}: futures differ")
        out[label] = {arm: {"flush_ms_median": statistics.median(g[label][1]),
                            "flushes": len(g[label][1]),
                            "payload_bytes": g[label][2],
                            "full_width_bytes": g[label][3]}
                      for arm, g in (("single", one_got), ("mesh", msh_got))}
        print(f"15(b) {label} [{card}]: flush median single "
              f"{out[label]['single']['flush_ms_median']:.3f} ms, mesh (4, 1) "
              f"{out[label]['mesh']['flush_ms_median']:.3f} ms over "
              f"{out[label]['mesh']['flushes']} flushes; packed bytes mesh "
              f"{out[label]['mesh']['payload_bytes']} (shard-wise) against "
              f"{out[label]['mesh']['full_width_bytes']} full width, single "
              f"{out[label]['single']['payload_bytes']}")
    same_service(one, msh, "15(b)")
    wa, wb = wal_files(d1), wal_files(d2)
    if not wa or wa != wb:
        raise AssertionError("15(b): the WAL bytes differ")
    if not counts["F1"] or counts["F1 sliced"]:
        raise AssertionError(f"15(b): the mesh path launched {counts}")
    print(f"15(b) [{card}]: results, state, mirrors and WAL bytes "
          f"({sum(len(v) for v in wb.values())} B in {len(wb)} files, fsync) "
          f"equal; mesh launches {counts}, per shard {per_shard}")
    # (c) checkpoints across the placements
    t0 = time.perf_counter()
    msh.save()
    back = BatchedEnsembleService.restore(FixedClock(), d2, tick=None,
                                          max_ops_per_tick=K_FULL, device=dev)
    same_service(msh, back, "15(c) mesh -> single", mirrors=False)
    d3 = tempfile.mkdtemp(prefix="mesh15_back_")
    dirs.append(d3)
    back.save(d3)
    again = BatchedEnsembleService.restore(
        FixedClock(), d3, tick=None, max_ops_per_tick=K_FULL,
        engine=mesh_engine(4, devices=mesh_devices(4)))
    same_service(back, again, "15(c) single -> mesh", mirrors=False)
    torch.cuda.synchronize()
    ckpt_s = time.perf_counter() - t0
    print(f"15(c) [{card}]: save from the mesh, restore on one engine, save, "
          f"restore on the mesh: every state plane, the leaders and the "
          f"key maps equal "
          f"({ckpt_s:.3f} s)")
    for svc in (one, msh, back, again):
        svc.stop()
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)
    return counts, per_shard, {"service": out, "checkpoint_s": ckpt_s}


def mesh_svcnode(card: str) -> dict:
    """15(d): ``python -m riak_ensemble_tpu_torch.svcnode --mesh-devices
    N`` (on one card: N = 4 shards of ``--device cuda:0``) serves a
    ``ServiceClient``; every acknowledged write reads back."""
    import asyncio
    import signal

    from riak_ensemble_tpu_torch import svcnode
    cards = torch.cuda.device_count()
    n = cards if cards > 1 else 4
    data = tempfile.mkdtemp(prefix="mesh15_node_")
    cmd = [sys.executable, "-m", "riak_ensemble_tpu_torch.svcnode",
           "--port", "0", "--n-ens", str(E_FULL), "--n-peers", str(M_FULL),
           "--n-slots", str(S_FULL), "--data-dir", data,
           "--mesh-devices", str(n)]
    if cards == 1:
        cmd += ["--device", "cuda:0"]
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    p = subprocess.Popen(cmd, cwd=root, env=dict(os.environ, PYTHONPATH=root),
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    acked, got = {}, {}
    try:
        line = p.stdout.readline()
        if "svcnode serving" not in line:
            raise AssertionError(f"15(d): svcnode did not start: {line!r} "
                                 f"{p.stderr.read()[-3000:]}")
        boot_s = time.perf_counter() - t0
        host, port = line.rsplit(" ", 1)[1].strip().rsplit(":", 1)
        rows = list(range(0, E_FULL, E_FULL // 64))[:64]

        async def run():
            c = svcnode.ServiceClient(host, int(port))
            await c.connect()
            res = await asyncio.gather(*[
                c.kput_many(r, [f"k{j}" for j in range(16)],
                            [b"%d:%d" % (r, j) for j in range(16)],
                            timeout=120.0) for r in rows])
            for r, rr in zip(rows, res):
                for j, x in enumerate(rr):
                    if x[0] == "ok":
                        acked[(r, f"k{j}")] = b"%d:%d" % (r, j)
            back = await asyncio.gather(*[
                c.kget_many(r, [f"k{j}" for j in range(16)], timeout=120.0)
                for r in rows])
            for r, rr in zip(rows, back):
                for j, x in enumerate(rr):
                    got[(r, f"k{j}")] = x
            stats = await c.stats()
            await c.close()
            return stats
        stats = asyncio.run(run())
    finally:
        p.send_signal(signal.SIGKILL)
        p.wait(60)
        shutil.rmtree(data, ignore_errors=True)
    if len(acked) != 64 * 16 or any(got[k] != ("ok", v)
                                    for k, v in acked.items()):
        raise AssertionError(f"15(d): {len(acked)} of 1024 writes acked, "
                             f"or one did not read back")
    print(f"15(d) svcnode --mesh-devices {n} [{card}]: boot {boot_s:.3f} s; "
          f"1024 acknowledged writes read back over the wire; "
          f"{stats.get('flushes')} flushes")
    return {"mesh_devices": n, "boot_s": boot_s}


#: 15(e)'s shards a process
MESH_CHILD_DEVS = 2


def child_devices(rank: int) -> list:
    """Process ``rank``'s shard devices: cards of its own where there
    are enough, else round robin (one card: both processes on it)."""
    cards = torch.cuda.device_count()
    return [torch.device("cuda", (MESH_CHILD_DEVS * rank + j) % cards)
            for j in range(MESH_CHILD_DEVS)]


def mesh_child(rank: int, coord: str) -> int:
    """One of 15(e)'s two processes: ``distributed.initialize``, a global
    (4, 1) mesh of MESH_CHILD_DEVS shards a process, (a)'s scenario, and
    this process's shards against an unsharded run on its card."""
    local = child_devices(rank)
    backend = distributed.initialize(coord, 2, rank)
    mesh = distributed.global_mesh(1, devices=local)
    se = ShardedEngine(mesh)
    e, m = E_FULL, M_FULL
    got = mesh_scenario(se, se.init_state(e, m, S_FULL), e, m, local[0])
    want = mesh_scenario(LocalEngine, eng.init_state(e, m, S_FULL,
                                                     device=local[0]),
                         e, m, local[0])
    checked = 0
    for name, arr in got.items():
        if name == "_state":
            continue
        full = want[name].cpu()
        for idx, block in arr.shards():
            if not torch.equal(block.cpu(), full[idx]):
                raise AssertionError(f"15(e) rank {rank}: {name} differs")
            checked += 1
    torch.distributed.destroy_process_group()
    print(f"MESH-CHILD rank {rank} backend {backend}: shards "
          f"{mesh.local_shards()} on {mesh.describe()}; {checked} blocks "
          f"equal to the unsharded run; launches {se.launches}", flush=True)
    return 0


def mesh_processes(card: str) -> dict:
    """15(e): two processes of this script under ``distributed.initialize``
    form one global (4, 1) mesh and each checks its own shards."""
    import socket
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{sock.getsockname()[1]}"
    sock.close()
    here = os.path.abspath(__file__)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, here, "--mesh-rank", str(r),
                               "--mesh-coord", coord],
                              cwd=os.path.dirname(here),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or "MESH-CHILD" not in out:
            raise AssertionError(f"15(e) rank {r} failed ({p.returncode}):"
                                 f"\n{out[-2000:]}\n{err[-3000:]}")
        for ln in out.splitlines():
            if ln.startswith("MESH-CHILD"):
                print(f"15(e) [{card}]: {ln}")
    print(f"15(e) [{card}]: two processes, one global (4, 1) mesh: "
          f"{wall:.3f} s wall")
    return {"wall_s": wall}


def phase_mesh(dev: torch.device, card: str) -> tuple:
    """Phase 15: the mesh — (a) the engine at (4, 1) and (2, 2), (b) the
    service over it, (c) checkpoints across placements, (d) svcnode
    ``--mesh-devices``, (e) two processes."""
    t0 = time.perf_counter()
    engine = {"(4, 1)": mesh_engine_case(card, (4, 1), M_FULL),
              "(2, 2)": mesh_engine_case(card, (2, 2), MESH_M2)}
    counts, per_shard, svc = mesh_service(dev, card)
    node = mesh_svcnode(card)
    procs = mesh_processes(card)
    wall = time.perf_counter() - t0
    print(f"phase 15 [{card}]: {wall:.1f} s")
    return counts, {"engine": engine, "service_launches_by_shard": per_shard,
                    **svc, "svcnode": node, "processes": procs,
                    "cards": torch.cuda.device_count(), "wall_s": wall}


# ---------------------------------------------------------------------------
# Phase 16: the nemesis on the card


def cluster_dump() -> list:
    """One ``testing.Cluster`` bring-up on the port's simulator (the host
    alone, as ``tests/test_app_trace.py``'s dump case): three peers of
    ``demo``, a stable leader, one write.  Returns ``dump_ensemble``'s
    rows after checking them against the cluster and ``peer_info``."""
    from riak_ensemble_tpu_torch.testing import Cluster, make_peers
    from riak_ensemble_tpu_torch.utils.trace import dump_ensemble, peer_info
    c = Cluster(seed=42)
    peers = make_peers(3)
    c.create_ensemble("demo", peers)
    leader = c.wait_stable("demo")
    c.kput_ok("demo", "k", b"v")
    infos = dump_ensemble(c.runtime, "demo")
    if (sorted(i["id"] for i in infos) != sorted(peers)
            or infos[0]["id"] != leader or infos[0]["state"] != "leading"
            or infos[0] != peer_info(c.peer("demo", leader))
            or any(i["leader"] != leader for i in infos)):
        raise AssertionError(f"phase 16: dump_ensemble disagrees with the "
                             f"cluster: {infos}")
    return infos


def dump_check(want: list, stage: str) -> None:
    """Before a fault stage: the bring-up again, its dump equal to the
    first one (the same seed, the same cluster)."""
    got = cluster_dump()
    if repr(got) != repr(want):
        raise AssertionError(f"phase 16 {stage}: dump_ensemble {got} "
                             f"differs from the first run's {want}")


def model_round(svc, rnd: int, models: dict, ms: list) -> None:
    """6(b)'s keyed pattern (``kput_many`` of the 48 keys on each of the
    256 rows, then ``kget_many``) on a group leader, every op filed with
    its key's ``KeyModel``; each flush's wall ms into ``ms``.  Every put
    must be acknowledged."""
    puts = [svc.kput_many(x, REPG_KEYS, [b"n%d:%d:%d" % (rnd, x, i)
                                         for i in range(len(REPG_KEYS))])
            for x in REPG_ROWS]
    ops = {(x, k): models[(x, k)].invoke_write(b"n%d:%d:%d" % (rnd, x, i))
           for x in REPG_ROWS for i, k in enumerate(REPG_KEYS)}
    settle_flushes(svc, puts, ms, sync=True)
    for x, f in zip(REPG_ROWS, puts):
        for k, r in zip(REPG_KEYS, f.value):
            if r[0] != "ok":
                raise AssertionError(f"phase 16: put {(x, k)} of round {rnd} "
                                     f"answered {r}")
            models[(x, k)].ack_write(ops[(x, k)])
    gets = [svc.kget_many(x, REPG_KEYS) for x in REPG_ROWS]
    settle_flushes(svc, gets, ms, sync=True)
    for x, f in zip(REPG_ROWS, gets):
        for k, r in zip(REPG_KEYS, f.value):
            if r[0] != "ok":
                raise AssertionError(f"phase 16: get {(x, k)} answered {r}")
            models[(x, k)].ack_read(r[1])


def settle_or_deposed(svc, futs, flushes: int = 12) -> None:
    """Flush until ``futs`` resolve; a deposed leader's flush raises,
    which resolves nothing and ends the loop."""
    from riak_ensemble_tpu_torch.parallel import repgroup
    for _ in range(flushes):
        if all(f.done for f in futs):
            return
        try:
            svc.flush()
        except repgroup.DeposedError:
            return


def export_check(fids: list, tls: list, path: str) -> dict:
    """16(c): ``tools.trace_export`` over stage (a)'s flush ids — the
    leader's span store, and the fleet timelines pulled with the
    replicas' spans — every exported span equal to its record."""
    from riak_ensemble_tpu_torch import obs
    from riak_ensemble_tpu_torch.tools import trace_export
    t0 = time.perf_counter()
    doc = trace_export.export(path, fids)
    fleet = trace_export.fleet_trace_events(tls)
    ms = (time.perf_counter() - t0) * 1e3
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    for e in spans:
        rec = obs.timeline(e["args"]["flush_id"])[e["tid"]]["spans"]
        if not [d for n, d in rec
                if n == e["name"] and abs(d * 1e6 - e["dur"]) < 0.5]:
            raise AssertionError(f"16(c): exported span {e} is not in the "
                                 f"store's record {rec}")
    by_fid = {int(t["flush_id"]): t for t in tls}
    base0 = min(float(t["base_s"]) for t in tls)
    for e in fleet:
        tl = by_fid[e["args"]["flush_id"]]
        want = [(n, (float(tl["base_s"]) - base0 + max(s, 0.0)) * 1e6,
                 d * 1e6)
                for n, s, d in tl["roles"][e["tid"]]["spans"]]
        if not [w for w in want if w[0] == e["name"]
                and abs(w[1] - e["ts"]) < 0.5 and abs(w[2] - e["dur"]) < 0.5]:
            raise AssertionError(f"16(c): exported fleet span {e} is not in "
                                 f"its timeline {want}")
    replica = sum(1 for e in fleet if str(e["tid"]).startswith("replica"))
    if not spans or not replica:
        raise AssertionError(f"16(c): {len(spans)} leader spans, {replica} "
                             f"replica spans exported")
    return {"events": len(doc["traceEvents"]) + len(fleet),
            "leader_spans": len(spans), "replica_spans": replica, "ms": ms}


def phase_nemesis(dev: torch.device, card: str) -> dict:
    """Phase 16: the group of phase 12 (the leader here on the card, two
    replica processes on the same card, a data dir each at
    ``wal_sync="fsync"``) under the nemesis, after ``warmup()``,
    ``takeover()`` and a warm keyed round: (a) a replica SIGSTOPped while
    the keyed pattern runs, SIGCONT and its re-sync, then kill -9 of the
    other replica and a quorum read-back at 2 of 3; (b) the return
    direction of every link blackholed in this process: the leader acks
    nothing, a replica promotes itself and commits, every key read back
    through it under its ``KeyModel``, the old leader fenced after the
    heal; (c) ``tools.trace_export`` over (a)'s flush ids.  Before each
    stage, ``dump_ensemble`` / ``peer_info`` of a ``testing.Cluster``
    bring-up held against the first run's."""
    import asyncio
    import signal

    from riak_ensemble_tpu_torch import faults, obs, svcnode, wire
    from riak_ensemble_tpu_torch.linearizability import KeyModel
    from riak_ensemble_tpu_torch.parallel import repgroup
    t_phase = time.perf_counter()
    want_dump = cluster_dump()
    root = tempfile.mkdtemp(prefix="retpu_p16_")
    procs: dict = {}
    svc = None
    try:
        dirs = {n: os.path.join(root, n) for n in ("leader", "r1", "r2")}
        logs = {n: os.path.join(root, f"{n}.log") for n in ("r1", "r2")}
        t0 = time.perf_counter()
        procs.update(replica_processes(
            {n: (dirs[n], logs[n], 0, 0) for n in ("r1", "r2")}))
        boot_s = time.perf_counter() - t0
        repl = {n: procs[n][1] for n in procs}
        cli = {n: procs[n][2] for n in procs}
        ack_timeout = 5.0
        svc = repgroup.ReplicatedService(
            WallRuntime(), E_FULL, 1, S_FULL, group_size=3,
            peers=[("127.0.0.1", repl[n]) for n in ("r1", "r2")],
            ack_timeout=ack_timeout, data_dir=dirs["leader"], device=dev)
        svc.warmup()
        if not svc.takeover(timeout=60.0):
            raise AssertionError("phase 16: takeover found no majority")
        models = {(x, k): KeyModel(f"{x}/{k}")
                  for x in REPG_ROWS for k in REPG_KEYS}
        before_f1 = {n: client_stats(cli[n])["group"]["kernel_launches"]["F1"]
                     for n in procs}
        reset_counts()                          # this path's run
        svc.flush()                             # elect every row
        model_round(svc, 0, models, [])         # warm: builds, first GC
        # -- (a) SIGSTOP r1 while the keyed pattern runs ------------------
        dump_check(want_dump, "(a)")
        before_fids = set(obs.SPANS.flush_ids())
        g0 = dict(svc.stats()["group"])
        procs["r1"][0].send_signal(signal.SIGSTOP)
        t_stop = time.perf_counter()
        try:
            m = models.setdefault((REPG_ROWS[0], "stop"), KeyModel("stop"))
            op = m.invoke_write(b"s")
            first = svc.kput_many(REPG_ROWS[0], ["stop"], [b"s"])
            settle_flushes(svc, [first], [], sync=True)
            first_ms = (time.perf_counter() - t_stop) * 1e3
            if first.value[0][0] != "ok":
                raise AssertionError(f"16(a): the first put after SIGSTOP "
                                     f"answered {first.value}")
            m.ack_write(op)
            ms_stopped: list = []
            for rnd in (1, 2):
                model_round(svc, rnd, models, ms_stopped)
            if max(ms_stopped) >= ack_timeout * 1e3:
                raise AssertionError(f"16(a): a flush took {max(ms_stopped)}"
                                     f" ms, past the {ack_timeout} s ack "
                                     f"deadline")
        finally:
            procs["r1"][0].send_signal(signal.SIGCONT)
        # re-synced: counted synced by the leader, and at its applied
        # position (by a patch, an install, or its own socket backlog)
        t_cont = time.perf_counter()
        while True:
            if time.perf_counter() - t_cont > 120:
                raise AssertionError("16(a): the SIGCONTed replica never "
                                     "re-synced")
            if svc.stats()["group"]["peers_synced"] < 2:
                svc.heartbeat()
                time.sleep(0.01)
                continue
            svc._drain_pending(block_all=True)
            st = repl_call(repl["r1"], ("status",))
            if (int(st[3]), int(st[4])) == (svc.core.applied_ge,
                                            svc.core.applied_seq):
                break
            time.sleep(0.01)
        resync_ms = (time.perf_counter() - t_cont) * 1e3
        g1 = dict(svc.stats()["group"])
        tree = g1["tree_resyncs"] - g0["tree_resyncs"]
        installs = g1["resyncs"] - g0["resyncs"]
        drops = g1["link_drops"] - g0["link_drops"]
        snap = len(wire.encode(("install", 0, 0, repgroup.dump_state(svc),
                                svc.core.cfg)))
        tree_b = g1["tree_resync_bytes"] - g0["tree_resync_bytes"]
        replicas_match(svc, [repl["r1"], repl["r2"]], "16(a) SIGCONT")
        fids_a = sorted(f for f in obs.SPANS.flush_ids()
                        if f not in before_fids)
        tls = [svc.fleet_timeline(f) for f in fids_a]
        tls = [t for t in tls if t.get("roles") and not t.get("miss")]
        f1_r2 = client_stats(cli["r2"])["group"]["kernel_launches"]["F1"] \
            - before_f1["r2"]
        procs["r2"][0].send_signal(signal.SIGKILL)
        procs["r2"][0].wait()
        # its restart boots while r1 alone carries the quorum; the
        # read-back must end before the restarted r2 is synced
        t_boot = time.perf_counter()
        r2_new = launch_replicas(
            {"r2": (dirs["r2"], logs["r2"], repl["r2"], cli["r2"])})["r2"]
        procs["r2"] = (r2_new[0], repl["r2"], cli["r2"])
        svc.set_fast_reads(False)              # reads ride a quorum round
        model_round(svc, 3, models, [])        # r1 alone carries the quorum
        reads = [svc.kget_many(x, REPG_KEYS) for x in REPG_ROWS]
        settle_flushes(svc, reads, [], sync=True)
        for x, f in zip(REPG_ROWS, reads):
            for k, r in zip(REPG_KEYS, f.value):
                if r[0] != "ok":
                    raise AssertionError(f"16(a): read-back of {(x, k)} at "
                                         f"2 of 3 answered {r}")
                models[(x, k)].ack_read(r[1])
        if svc.stats()["group"]["peers_synced"] != 1:
            raise AssertionError("16(a): the read-back did not run at 2 of 3")
        svc.set_fast_reads(True)
        print(f"16(a) SIGSTOP partition [{card}]: first 2-of-3 commit "
              f"{first_ms:.3f} ms after the SIGSTOP; {len(ms_stopped)} "
              f"flushes while stopped, median "
              f"{statistics.median(ms_stopped):.3f} ms, max "
              f"{max(ms_stopped):.3f} ms (ack deadline {ack_timeout} s); "
              f"re-sync after SIGCONT {resync_ms:.3f} ms: "
              f"{tree} tree patch(es), {tree_b} B, {installs} install(s) "
              f"({snap} B a snapshot), {drops} link drop(s) while stopped; "
              f"lanes equal; kill -9 of r2, {len(REPG_ROWS) * len(REPG_KEYS)}"
              f" keys read back at 2 of 3")
        # -- (b) the return direction blackholed -------------------------
        dump_check(want_dump, "(b)")
        procs["r2"] = serving(*r2_new)
        g2 = dict(svc.stats()["group"])
        t0 = time.perf_counter()
        while svc.stats()["group"]["peers_synced"] < 2:
            if time.perf_counter() - t0 > 120:
                raise AssertionError("16(b): restarted r2 never caught up")
            svc.heartbeat()
            time.sleep(0.01)
        restart_ms = (time.perf_counter() - t0) * 1e3
        boot2_s = t0 - t_boot
        g3 = dict(svc.stats()["group"])
        r2_tree_b = g3["tree_resync_bytes"] - g2["tree_resync_bytes"]
        r2_how = (f"tree patch, {r2_tree_b} B"
                  if g3["tree_resyncs"] > g2["tree_resyncs"] else
                  f"install, {snap} B snapshot"
                  if g3["resyncs"] > g2["resyncs"] else "no patch")
        plan = faults.install(faults.FaultPlan())
        try:
            for link in svc._links:
                plan.drop(link.label, faults.LOCAL)
            t_dark = time.perf_counter()
            dark_rows = REPG_ROWS[:16]
            dark = []
            for x in dark_rows:
                keys = [f"dark:{i}" for i in range(4)]
                ops = [models.setdefault((x, k), KeyModel(f"{x}/{k}"))
                       .invoke_write(b"d%d" % x) for k in keys]
                dark.append((x, keys, ops, svc.kput_many(x, keys,
                                                         [b"d%d" % x] * 4)))
            settle_or_deposed(svc, [f for *_r, f in dark])
            dark_acks = 0
            for x, keys, ops, f in dark:
                if not f.done:
                    raise AssertionError("16(b): a blackholed put never "
                                         "resolved")
                res = f.value if isinstance(f.value, list) \
                    else [f.value] * len(keys)
                for k, op, r in zip(keys, ops, res):
                    dark_acks += isinstance(r, tuple) and r[0] == "ok"
                    models[(x, k)].timeout_write(op)   # ambiguous
            inj = svc.health().get("injected") or {}
            if not inj.get("active") or not all(
                    f"{lk.label}>{faults.LOCAL}" in inj.get("drop", ())
                    for lk in svc._links):
                raise AssertionError(f"16(b): health does not name the "
                                     f"plan: {inj}")
            r = repl_call(repl["r1"], ("promote", [("127.0.0.1",
                                                    repl["r2"])]))
            if r[0] != "ok" or r[1] <= svc._ge:
                raise AssertionError(f"16(b): promotion answered {r}")

            async def new_leader():
                c = svcnode.ServiceClient("127.0.0.1", cli["r1"])
                await c.connect()
                m = models.setdefault((REPG_ROWS[0], "newldr"),
                                      KeyModel("newldr"))
                op = m.invoke_write(b"n0")
                got = await c.kput(REPG_ROWS[0], "newldr", b"n0",
                                   timeout=60.0)
                t_first = time.perf_counter()
                if got[0] != "ok":
                    raise AssertionError(f"16(b): the new leader's first "
                                         f"put answered {got}")
                m.ack_write(op)
                rows: dict = {}
                for (x, k) in models:
                    rows.setdefault(x, []).append(k)
                got_rows = await asyncio.gather(*[
                    c.kget_many(x, keys, timeout=60.0)
                    for x, keys in rows.items()])
                for (x, keys), got in zip(rows.items(), got_rows):
                    for k, r in zip(keys, got):
                        if r[0] != "ok":
                            raise AssertionError(f"16(b): {(x, k)} through "
                                                 f"the new leader: {r}")
                        models[(x, k)].ack_read(r[1])
                await c.close()
                return t_first
            t_first = asyncio.run(new_leader())
            takeover_ms = (t_first - t_dark) * 1e3
            m = models.setdefault((REPG_ROWS[0], "stale"), KeyModel("stale"))
            op = m.invoke_write(b"x")
            stale = svc.kput(REPG_ROWS[0], "stale", b"x")
            settle_or_deposed(svc, [stale])
            if stale.done and isinstance(stale.value, tuple) \
                    and stale.value[0] == "ok":
                dark_acks += 1
            m.timeout_write(op)
            if dark_acks:
                raise AssertionError(f"16(b): the deposed leader acked "
                                     f"{dark_acks} writes after the "
                                     f"blackhole")
            plan.heal()
            for _ in range(60):
                try:
                    svc.heartbeat()
                except repgroup.DeposedError:
                    pass
                if svc._deposed:
                    break
                time.sleep(0.05)
            if not svc._deposed:
                raise AssertionError("16(b): the healed leader never saw "
                                     "that it was deposed")
        finally:
            faults.clear()
        f1_leader = read_counts()
        f1_r1 = client_stats(cli["r1"])["group"]["kernel_launches"]["F1"] \
            - before_f1["r1"]
        print(f"16(b) return-direction blackhole [{card}]: r2 restarted "
              f"from its data dir ({boot2_s:.3f} s to serving) and synced in "
              f"{restart_ms:.3f} ms by {r2_how}; the deposed leader acked "
              f"{dark_acks} of {4 * len(dark_rows) + 1} writes; the promoted "
              f"replica's first ack {takeover_ms:.3f} ms after the "
              f"blackhole; {len(models)} keys read back through it under "
              f"their KeyModels; the old leader fenced after the heal")
        # -- (c) the trace export over (a)'s flushes ---------------------
        dump_check(want_dump, "(c)")
        exp = export_check(fids_a, tls, os.path.join(root, "trace.json"))
        print(f"16(c) trace export [{card}]: {len(fids_a)} flushes, "
              f"{exp['events']} events ({exp['leader_spans']} leader spans, "
              f"{exp['replica_spans']} replica spans on the aligned axis) in "
              f"{exp['ms']:.3f} ms, every span equal to its record")
        launches = {"leader": f1_leader["F1"], "r1": f1_r1, "r2": f1_r2}
        wall = time.perf_counter() - t_phase
        print(f"phase 16 [{card}]: F1 launches leader {f1_leader['F1']} "
              f"(sliced {f1_leader['F1 sliced']}), r1 {f1_r1} (as replica and"
              f" as new leader), r2 {f1_r2} (its first process); replica "
              f"boot {boot_s:.3f} s; {wall:.1f} s")
        return {"counts": f1_leader, "f1_launches_by_host": launches,
                "first_commit_after_sigstop_ms": first_ms,
                "stopped_flush_ms": statistics.median(ms_stopped),
                "resync_ms": resync_ms, "resync_tree_bytes": tree_b,
                "resync_tree_patches": tree, "resync_installs": installs,
                "resync_install_bytes": snap * installs,
                "link_drops_while_stopped": drops,
                "restart_resync_ms": restart_ms,
                "restart_resync_tree_bytes": r2_tree_b,
                "blackhole_to_new_leader_ack_ms": takeover_ms,
                "deposed_leader_acks": dark_acks, "export": exp,
                "wall_s": wall}
    finally:
        faults.clear()
        if svc is not None:
            try:
                svc.stop()
            except repgroup.DeposedError:
                pass
        for p, _r, _c in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGCONT)
                p.kill()
            p.wait()
        shutil.rmtree(root, ignore_errors=True)


def ab_run() -> int:
    """One side of ``--ab``: F1 at the headline shape (full width and
    :data:`AB_SLICED`), phase 6(c) and F1's wide mode at 11(a)'s timed
    shapes (:data:`WIDE_TIMED`), on whichever tree's package this process
    imported; prints the numbers as one ``AB`` JSON line."""
    dev = torch.device("cuda", 0)
    card = card_line()
    out = {"F1 full width": time_full(dev, card, detail=False)}
    for n_real, bucket, k, puts in AB_SLICED:
        out[f"F1 A={bucket} ({n_real} rows) K={k}{' puts' if puts else ''}"] \
            = time_sliced(dev, card, n_real, bucket, k, puts, detail=False)
    out["6(c)"] = phase_pipeline(dev, card)[1]
    for label, chains, sliced in WIDE_TIMED:
        out[f"F1 wide {label}"] = time_wide(dev, card, chains, sliced,
                                            detail=False)
    print("AB " + json.dumps(out))
    return 0


def ab(other: str, card: str) -> int:
    """F1's timings and phase 6(c) in another tree of this package and in
    this one, on one card, in turns: other, this, this, other.  Each turn
    is a process of its own that builds its tree's kernels and runs this
    file's :func:`ab_run`."""
    here = os.path.abspath(__file__)
    runs = []
    for label, root in (("other", other), ("this", os.path.dirname(here)),
                        ("this", os.path.dirname(here)), ("other", other)):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", AB_BOOT, here], cwd=root,
                             capture_output=True, text=True, timeout=900)
        for ln in out.stdout.splitlines():
            if not ln.startswith("AB "):
                print(f"[{label}] {ln}")
        line = [ln for ln in out.stdout.splitlines() if ln.startswith("AB ")]
        if out.returncode != 0 or not line:
            raise AssertionError(f"A/B run in {root} failed "
                                 f"({out.returncode}):\n{out.stderr[-3000:]}")
        runs.append((label, json.loads(line[0][3:])))
        print(f"A/B {label} ({root}) [{card}]: "
              f"{time.perf_counter() - t0:.1f} s")

    def series(name, get):
        print(f"A/B {name} [{card}]: " + "; ".join(
            f"{lab} " + ", ".join(f"{x:.6f}" for l2, r in runs if l2 == lab
                                  for x in get(r))
            for lab in ("other", "this")))
    for mode in runs[0][1]:
        if mode.startswith("F1"):
            for key in ("device_us", "ms", "host_us", "overhead_ms"):
                series(f"{mode} {key}", lambda r: [r[mode][key]])
            if "scalar" in runs[0][1][mode]:
                series(f"{mode}: scalar F1 on the same ops device_us",
                       lambda r: [r[mode]["scalar"]["device_us"]])
    for depth in ("depth 1", "depth 2"):
        series(f"6(c) {depth} ms per flush",
               lambda r: r["6(c)"][depth]["ms_per_flush"])
        for key in ("enqueue", "wait", "unpack", "fanout"):
            series(f"6(c) {depth} {key} ms per flush",
                   lambda r: [sp[key] for sp in r["6(c)"][depth]["split"]])
    series("6(c) device-resident ms per flush",
           lambda r: [r["6(c)"]["device-resident"]])
    return 0


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if "--mesh-rank" in argv:
        # one of phase 15(e)'s two processes
        return mesh_child(int(argv[argv.index("--mesh-rank") + 1]),
                          argv[argv.index("--mesh-coord") + 1])
    profile = (argv[argv.index("--profile") + 1]
               if "--profile" in argv else None)
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    if "--ab" in argv:
        return ab(argv[argv.index("--ab") + 1], card)
    t0 = time.perf_counter()
    secs = build.build_all()
    print(f"build: {time.perf_counter() - t0:.3f} s wall "
          f"({', '.join(f'{n} {v:.3f} s' for n, v in secs.items())})")
    for name, text in build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    if "--f1" in argv:
        # F1 alone: phases 3b and 6(a), no result line
        phase_f1(dev, card)
        phase_f1_sliced(dev, card)
        return 0
    if "--wide" in argv:
        # F1's wide mode alone: phase 11(a), no result line
        phase_f1_wide(dev, card)
        return 0
    if "--repgroup" in argv:
        # the replication group alone: phase 12, no result line
        phase_repgroup(dev, card)
        return 0
    if "--scalar" in argv:
        # the device tree and the scalar plane alone: phase 13
        phase_scalar_plane(dev, card)
        return 0
    if "--tenants" in argv:
        # the scale plane alone: phase 14
        phase_tenant_plane(dev, card)
        return 0
    if "--mesh" in argv:
        # the mesh alone: phase 15
        phase_mesh(dev, card)
        return 0
    if "--nemesis" in argv:
        # the group under the nemesis alone: phase 16
        phase_nemesis(dev, card)
        return 0
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
                                                          profile)[0]}
    host = phase_host_passes(dev, card)
    host_calls = phase_host_arms(dev, card)
    durable = phase_durable(dev, card)
    by_path.update(durable["counts"])
    control_counts, control = phase_control_plane(dev, card)
    by_path.update(control_counts)
    front_counts, codec, front = phase_front_end(dev, card)
    by_path["phase10 svcnode"] = front_counts
    f1_wide = phase_f1_wide(dev, card)
    by_path["phase11b wide service"] = phase_wide_service(dev, card)
    phase_sharded(dev, card)
    group = phase_repgroup(dev, card)
    by_path["phase12 repgroup leader"] = group["counts"]
    scalar_plane = phase_scalar_plane(dev, card)
    tenant_counts, tenants = phase_tenant_plane(dev, card)
    by_path.update(tenant_counts)
    mesh_counts, mesh = phase_mesh(dev, card)
    by_path["phase15 mesh service"] = mesh_counts
    nemesis = phase_nemesis(dev, card)
    by_path["phase16 nemesis leader"] = nemesis.pop("counts")
    f1_by_path = {p: c["F1"] for p, c in by_path.items()}
    sliced_by_path = {p: c["F1 sliced"] for p, c in by_path.items()}
    wide_by_path = {p: c["F1 wide"] for p, c in by_path.items()}
    if not (all(f1_by_path.values()) and k1_exchange and k2_launches
            and sliced_by_path["phase6b compacted keyed service"]
            and wide_by_path["phase11b wide service"]
            and by_path["phase9a reconfig"]["K1"]
            and by_path["phase14 tenants"]["K1"]):
        raise AssertionError(f"a kernel did not launch on its path: F1 "
                             f"{f1_by_path} (sliced {sliced_by_path}, wide "
                             f"{wide_by_path}), K1 {k1_exchange}, K2 "
                             f"{k2_launches}")
    kernels = [{
        "name": "F1 engine_step", "route": "cuda",
        "source": "riak_ensemble_tpu_torch/csrc/engine_step.cu",
        "replaces": "riak_ensemble_tpu/ops/pallas_quorum.py:172",
        "fuses": "riak_ensemble_tpu/ops/engine.py:1386",
        "launches": sum(f1_by_path.values()),
        "launches_by_path": f1_by_path,
        "replica_process_launches": group["replica_f1"],
        "nemesis_launches_by_host": nemesis["f1_launches_by_host"],
        "sliced_launches": sum(sliced_by_path.values()),
        "sliced_launches_by_path": sliced_by_path,
        "max_abs_err": f1["max_abs_err"], "ms": f1["ms"],
        "plain_ms": f1["plain_ms"], "bound_ms": f1["bound_ms"],
        "bound_by": f1["bound_by"], "library_ms": None,
        "device_us": f1["device_us"], "host_us": f1["host_us"],
        "occupancy": f1["occupancy"], "sliced": f1_sliced,
        "mesh_launches_by_shard": {
            "phase15b mesh (4, 1) service":
                {sh: c["F1"] for sh, c in
                 mesh["service_launches_by_shard"].items()},
            **{f"phase15a mesh {shape} engine":
               {sh: c["F1"] for sh, c in case["launches"].items()}
               for shape, case in mesh["engine"].items()}}}, {
        "name": "F1 engine_step, wide mode", "route": "cuda",
        "source": "riak_ensemble_tpu_torch/csrc/engine_step.cu",
        "replaces": "riak_ensemble_tpu/ops/pallas_quorum.py:172",
        "fuses": "riak_ensemble_tpu/ops/engine.py:1421",
        "launches": sum(wide_by_path.values()),
        "launches_by_path": wide_by_path,
        "max_abs_err": 0, "ms": f1_wide["G=1"]["ms"],
        "plain_ms": f1_wide["G=1"]["plain_ms"],
        "bound_ms": f1_wide["G=1"]["bound_ms"],
        "bound_by": f1_wide["G=1"]["bound_by"], "library_ms": None,
        "device_us": f1_wide["G=1"]["device_us"], "shapes": f1_wide}, {
        "name": "K1 quorum_met_e", "route": "cuda",
        "source": "riak_ensemble_tpu_torch/csrc/quorum.cu",
        "replaces": "riak_ensemble_tpu/ops/pallas_quorum.py:172",
        "launches": k1_exchange + sum(c["K1"] for c in by_path.values()),
        "launches_by_path": {"phase3c exchange": k1_exchange,
                             **{p: c["K1"] for p, c in by_path.items()}},
        "compacted_exchange_launches":
            by_path["phase6b compacted keyed service"]["K1"],
        "reconfig_launches": sum(c["K1"] for p, c in by_path.items()
                                 if p.startswith("phase9")),
        "reconfig": control["reconfig"],
        "mesh_launches_by_shard": {
            f"phase15a mesh {shape} engine":
                {sh: c["K1"] for sh, c in case["launches"].items()}
            for shape, case in mesh["engine"].items()},
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
    host_line.append({"name": "wire codec", "route": "host c++",
                      "source": WIRE_SRC,
                      "replaces": "native/wirecodec.cc "
                                  "(riak_ensemble_tpu/wire.py:353)",
                      "calls": front["svcnode"]["codec_calls"],
                      "max_abs_err": 0, **codec})
    print(card)
    print(json.dumps({"kernels": kernels, "host": host_line,
                      "control_plane": {k: v for k, v in control.items()
                                        if k != "reconfig"},
                      "front_end": front,
                      "repgroup": {k: v for k, v in group.items()
                                   if k != "counts"},
                      "scalar_plane": scalar_plane,
                      "tenants": tenants, "mesh": mesh,
                      "nemesis": nemesis}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
