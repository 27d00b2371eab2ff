"""Host↔engine bridge: many ensembles served through the torch engine.

Port of the main-path part of
``riak_ensemble_tpu/parallel/batched_host.py``: a host service that
multiplexes thousands of engine-backed ensembles —

- client ops (kget/kput/kdelete/CAS and their vectorized ``_many``
  forms) queue per ensemble and :meth:`BatchedEnsembleService.flush`
  packs them into ``[K, E]`` op planes for ONE :func:`engine.full_step`
  launch: elections for leaderless/leader-down ensembles fold into the
  same launch;
- the host keeps what consensus doesn't need on the device: key→slot
  per ensemble, the payload store (the device carries int32 handles;
  values live host-side keyed by handle), leases and the ``up`` mask;
- the launch's results come back as ONE bit-packed uint8 buffer
  (:func:`_pack_results_body`), byte-identical to the reference's, and
  resolve the client futures.

It implements one configuration of the reference service — the one the
reference runs with ``RETPU_COMPACT=0 RETPU_FAST_READS=0
RETPU_NATIVE_RESOLVE=0 RETPU_NATIVE_ENQUEUE=0 RETPU_OBS=0`` and no
``RETPU_WIDE``: full-width launches, every read through a device
round, the per-entry plane pack and the pure-Python resolve, launch
pipeline depth 1, no WAL and a caller-driven flush (``tick=None``).
It reads no environment variables.  kmodify, lease fast reads, wide
rounds, compaction, the WAL, membership and the anti-entropy exchange
are later slices.
"""

from __future__ import annotations

import functools
import logging
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from riak_ensemble_tpu_torch.config import Config
from riak_ensemble_tpu_torch.device import DeviceLike, resolve_device
from riak_ensemble_tpu_torch.ops import engine as eng
from riak_ensemble_tpu_torch.runtime import Future, Timer
from riak_ensemble_tpu_torch.types import NOTFOUND

log = logging.getLogger(__name__)


@functools.lru_cache(maxsize=None)
def _bit_weights(device: torch.device) -> torch.Tensor:
    return torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                        device=device)


def packbits(bits: torch.Tensor) -> torch.Tensor:
    """``jnp.packbits`` of a flat bool tensor: MSB first, the tail byte
    zero-padded.  Torch has no packbits, so each group of 8 is weighted
    128, 64, …, 1 and summed."""
    n = bits.numel()
    b = bits.to(torch.int32)
    pad = (-n) % 8
    if pad:
        b = torch.cat([b, b.new_zeros(pad)])
    return (b.view(-1, 8) * _bit_weights(bits.device)).sum(
        -1, dtype=torch.int32).to(torch.uint8)


def _pack_results_body(won: torch.Tensor, res: eng.KvResult,
                       want_vsn: bool) -> torch.Tensor:
    """Flatten a launch's results into ONE uint8 vector on the device
    (batched_host.py:115-157), byte-identical to the reference.

    Layout: packbits([won E | quorum_ok E | corrupt E*M | committed K*E
    | get_ok K*E | found K*E]) ++ bytes([value K*E | (vsn_epoch K*E |
    vsn_seq K*E)]).  The integer planes are the little-endian bytes of
    int32 — the reference's ``bitcast_convert_type(int32 → uint8)`` —
    taken here with ``.view(torch.uint8)`` on a contiguous int32
    tensor.  The reference's ``active_idx`` (compacted-column) form
    waits for the compaction slice."""
    flags = torch.cat([
        won.reshape(-1),
        res.quorum_ok.any(0).reshape(-1),
        res.tree_corrupt.any(0).reshape(-1),
        res.committed.reshape(-1),
        res.get_ok.reshape(-1),
        res.found.reshape(-1),
    ]).to(torch.bool)
    ints = [res.value.reshape(-1)]
    if want_vsn:
        ints += [res.obj_vsn[..., 0].reshape(-1),
                 res.obj_vsn[..., 1].reshape(-1)]
    ints_u8 = torch.cat(ints).to(torch.int32).contiguous().view(torch.uint8)
    return torch.cat([packbits(flags), ints_u8])


def unpack_results(flat: np.ndarray, e: int, m: int, k: int,
                   want_vsn: bool):
    """Invert :func:`_pack_results_body`: one packed uint8 vector →
    ``(won, quorum_ok, corrupt, committed, get_ok, found, value, vsn)``
    host arrays (the k == 0 planes are None).  The reference's unpack
    (batched_host.py:349-428) at full width only: its compacted and
    sliced-step layouts wait for the compaction slice."""
    nbits = 2 * e + e * m + 3 * k * e
    bits = np.unpackbits(flat[:(nbits + 7) // 8],
                         count=nbits).astype(bool)
    ints = flat[(nbits + 7) // 8:].copy().view(np.int32)
    boff = ioff = 0

    def take_bits(n, shape=None):
        nonlocal boff
        out = bits[boff:boff + n]
        boff += n
        return out.reshape(shape) if shape is not None else out

    def take_ints(n, shape=None):
        nonlocal ioff
        out = ints[ioff:ioff + n]
        ioff += n
        return out.reshape(shape) if shape is not None else out

    won = take_bits(e)
    quorum_ok = take_bits(e)
    corrupt = take_bits(e * m, (e, m))
    if k:
        committed = take_bits(k * e, (k, e))
        get_ok = take_bits(k * e, (k, e))
        found = take_bits(k * e, (k, e))
        value = take_ints(k * e, (k, e))
        vsn = None
        if want_vsn:
            vsn = np.stack([take_ints(k * e, (k, e)),
                            take_ints(k * e, (k, e))], axis=-1)
    else:
        committed = get_ok = found = value = vsn = None
    return won, quorum_ok, corrupt, committed, get_ok, found, value, vsn


class WallRuntime:
    """Minimal real-time runtime for driving the service outside a
    simulator: ``now`` is the monotonic clock.  It has no event loop,
    so the caller drives ``flush()``."""

    @property
    def now(self) -> float:
        return time.monotonic()

    def schedule(self, delay: float, fn) -> Timer:
        raise RuntimeError(
            "WallRuntime has no event loop; use tick=None and drive "
            "flush() from the caller")


@dataclass(slots=True)
class _PendingOp:
    kind: int
    slot: int
    handle: int
    fut: Future
    key: Any = None
    #: slot write generation at enqueue (puts only) — lets the failed
    #: path tell whether it was the slot's last queued write
    gen: int = 0
    #: CAS expected version (OP_CAS)
    exp: Tuple[int, int] = (0, 0)
    #: resolve gets as ("ok", value, vsn) instead of ("ok", value)
    want_vsn: bool = False
    #: rounds this entry occupies in the [K, E] op matrix
    n: int = 1


@dataclass(slots=True)
class _PendingBatch:
    """A struct-of-arrays batch of keyed ops for ONE ensemble sharing
    one Future (kput_many/kget_many).  Arrays are COMPACT: keys with no
    slot never queue a device round — their results are pre-filled into
    the accumulator at submit time — and ``pos`` maps each compact row
    back to its position in the caller's key order."""

    kind: int
    slot: Any          # List[int] [n]
    handle: Any        # List[int] [n] (puts; zeros for gets)
    fut: Future
    pos: Any = None    # List[int] [n] position in the caller's order
    keys: Any = None   # list of key objects (puts: for recycle)
    gen: Any = None    # List[int] [n] slot generations (puts)
    exp_e: Any = None  # List[int] [n] CAS expected versions (OP_CAS)
    exp_s: Any = None  # List[int] [n]
    accum: Any = None  # shared _BatchAccum across splits
    want_vsn: bool = False
    n: int = 0

    def split(self, head_n: int) -> Tuple["_PendingBatch", "_PendingBatch"]:
        """Split into (head, tail) when a flush's K cap lands inside
        the batch; both halves share the Future and accumulator."""
        def cut(x, a, b):
            return None if x is None else x[a:b]
        h = _PendingBatch(self.kind, self.slot[:head_n],
                          self.handle[:head_n], self.fut,
                          self.pos[:head_n], cut(self.keys, 0, head_n),
                          cut(self.gen, 0, head_n),
                          cut(self.exp_e, 0, head_n),
                          cut(self.exp_s, 0, head_n), self.accum,
                          self.want_vsn, head_n)
        t = _PendingBatch(self.kind, self.slot[head_n:],
                          self.handle[head_n:], self.fut,
                          self.pos[head_n:], cut(self.keys, head_n, None),
                          cut(self.gen, head_n, None),
                          cut(self.exp_e, head_n, None),
                          cut(self.exp_s, head_n, None), self.accum,
                          self.want_vsn, self.n - head_n)
        return h, t


class _BatchAccum:
    """Positional result assembly for a (possibly split) batch: each
    chunk fills its rows by original position; the shared Future
    resolves once every position is filled."""

    __slots__ = ("remaining", "results")

    def __init__(self, total: int) -> None:
        self.remaining = total
        self.results: List[Any] = [None] * total

    def fill(self, fut: Future, positions: List[int],
             chunk: List[Any], resolver) -> None:
        res = self.results
        for i, r in zip(positions, chunk):
            res[i] = r
        self.remaining -= len(chunk)
        if self.remaining <= 0 and not fut.done:
            resolver(fut, res)


class BatchedEnsembleService:
    """N engine-backed ensembles behind a put/get API.

    ``n_slots`` bounds live keys per ensemble (slots are recycled when
    keys are deleted).  The caller drives :meth:`flush` (``tick`` must
    be None: the timer-driven mode needs an event-loop runtime, which
    this package does not have yet).  The engine state lives on
    ``device`` — CUDA unless ``device="cpu"``.
    """

    def __init__(self, runtime: Any, n_ens: int, n_peers: int,
                 n_slots: int = 128, tick: Optional[float] = None,
                 max_ops_per_tick: int = 64,
                 config: Optional[Config] = None,
                 device: DeviceLike = None) -> None:
        if tick is not None:
            raise NotImplementedError(
                "timer-driven flushing is not ported; pass tick=None "
                "and call flush()")
        self.runtime = runtime
        self.config = config if config is not None else Config()
        self.n_ens, self.n_peers, self.n_slots = n_ens, n_peers, n_slots
        self.max_k = max_ops_per_tick
        self.device = resolve_device(device)
        self.state = eng.init_state(n_ens, n_peers, n_slots,
                                    device=self.device)
        #: host failure detector input (set_peer_up)
        self.up = np.ones((n_ens, n_peers), dtype=bool)
        self._up_dev: Optional[torch.Tensor] = None  # see _up_device
        #: host mirrors of device ballot state (leader changes only via
        #: elections THIS host requested) — election planning costs
        #: zero device round trips
        self.leader_np = np.full((n_ens,), -1, dtype=np.int32)
        self.member_np = np.ones((n_ens, n_peers), dtype=bool)
        #: per-ensemble key→slot and free slots
        self.key_slot: List[Dict[Any, int]] = [dict() for _ in range(n_ens)]
        self.free_slots: List[List[int]] = [
            list(range(n_slots)) for _ in range(n_ens)]
        #: per-ensemble slot write generation: bumped on every queued
        #: put, so a delete's deferred recycle can tell whether a later
        #: write re-used the slot
        self.slot_gen: List[Dict[int, int]] = [dict() for _ in range(n_ens)]
        #: per-ensemble slot -> handle of the last COMMITTED payload
        self.slot_handle: List[Dict[int, int]] = [
            dict() for _ in range(n_ens)]
        #: deferred slot recycles: (key, slot, gen) waiting until no
        #: queued op still references the slot
        self._recycle_pending: List[List[Tuple[Any, int, int]]] = [
            [] for _ in range(n_ens)]
        #: payload store: handle -> value.  0 is the tombstone handle;
        #: released handles are recycled (int32 handles would wrap).
        self.values: Dict[int, Any] = {}
        self._free_handles: List[int] = []
        self._next_handle = 1
        self.queues: List[List[Any]] = [[] for _ in range(n_ens)]
        #: queued device ROUNDS per ensemble (a batch entry occupies
        #: entry.n rounds) — drives flush depth
        self._queue_rounds: List[int] = [0] * n_ens
        #: ensembles with queued ops / pending recycles
        self._active: set = set()
        self._recycle_dirty: set = set()
        #: leader leases, host-side: ensemble -> expiry (runtime.now)
        self.lease_until = np.zeros((n_ens,), dtype=float)
        self.flushes = 0
        self.ops_served = 0
        #: integrity-gate detections (replica flagged corrupt in a round)
        self.corruptions = 0
        #: client waiter exceptions contained by _safe_resolve
        self.waiter_errors = 0
        #: K of the last launch (its quorum launches are K + 2)
        self.last_launch_k = 0

    # -- client API --------------------------------------------------------

    def kput(self, ens: int, key: Any, value: Any) -> Future:
        """Quorum-replicated write; resolves ('ok', vsn) or 'failed'
        (no slot / no quorum this flush)."""
        fut = Future()
        slot = self._slot_for(ens, key, allocate=True)
        if slot is None:
            fut.resolve("failed")
            return fut
        handle = self._alloc_handle()
        self.values[handle] = value
        gen = self.slot_gen[ens].get(slot, 0) + 1
        self.slot_gen[ens][slot] = gen
        self._push(ens, _PendingOp(eng.OP_PUT, slot, handle, fut,
                                   key, gen))
        return fut

    def kput_many(self, ens: int, keys: List[Any],
                  values: List[Any]) -> Future:
        """Vectorized keyed writes: N puts for one ensemble behind ONE
        future, resolving to a list of per-key results (('ok', vsn) |
        'failed') in key order.  Duplicate keys serialize in order;
        keys that can't get a slot resolve 'failed' immediately and
        consume no device round."""
        fut = Future()
        n = len(keys)
        if n != len(values):
            raise ValueError(
                f"kput_many: {n} keys vs {len(values)} values")
        if n == 0:
            fut.resolve([])
            return fut
        accum = _BatchAccum(n)
        slot_l: List[int] = []
        pos_l: List[int] = []
        live_keys: List[Any] = []
        miss_pos: List[int] = []
        ks = self.key_slot[ens]
        fs = self.free_slots[ens]
        for i, key in enumerate(keys):
            s = ks.get(key)
            if s is None:
                if not fs:
                    miss_pos.append(i)   # capacity-fail: no round
                    continue
                s = fs.pop()
                ks[key] = s
            slot_l.append(s)
            pos_l.append(i)
            live_keys.append(key)
        m = len(slot_l)
        handle_l = self._alloc_handles(m)
        self.values.update(zip(handle_l, (values[i] for i in pos_l)))
        sg = self.slot_gen[ens]
        gen_l: List[int] = []
        for s in slot_l:
            g = sg.get(s, 0) + 1
            sg[s] = g
            gen_l.append(g)
        if miss_pos:
            accum.fill(fut, miss_pos, ["failed"] * len(miss_pos),
                       self._safe_resolve)
        if live_keys:
            self._push(ens, _PendingBatch(
                eng.OP_PUT, slot_l, handle_l, fut, pos_l, live_keys,
                gen_l, accum=accum, n=m))
        return fut

    def kget_many(self, ens: int, keys: List[Any],
                  want_vsn: bool = False) -> Future:
        """Vectorized keyed reads: one future resolving to a list of
        (('ok', value|NOTFOUND) | 'failed') in key order (with
        ``want_vsn`` each hit is ('ok', value, (epoch, seq))).  Unknown
        keys resolve ('ok', NOTFOUND) immediately and consume no
        device round."""
        fut = Future()
        n = len(keys)
        if n == 0:
            fut.resolve([])
            return fut
        accum = _BatchAccum(n)
        slot_l: List[int] = []
        pos_l: List[int] = []
        miss_pos: List[int] = []
        ks = self.key_slot[ens]
        for i, key in enumerate(keys):
            s = ks.get(key)
            if s is None:
                miss_pos.append(i)
                continue
            slot_l.append(s)
            pos_l.append(i)
        if miss_pos:
            nf = (("ok", NOTFOUND, (0, 0)) if want_vsn
                  else ("ok", NOTFOUND))
            accum.fill(fut, miss_pos, [nf] * len(miss_pos),
                       self._safe_resolve)
        if slot_l:
            m = len(slot_l)
            self._push(ens, _PendingBatch(
                eng.OP_GET, slot_l, [0] * m, fut, pos_l, accum=accum,
                want_vsn=want_vsn, n=m))
        return fut

    def kget(self, ens: int, key: Any) -> Future:
        """Linearizable read through an ``OP_GET`` round; resolves
        ('ok', value|NOTFOUND) or 'failed'."""
        fut = Future()
        slot = self._slot_for(ens, key, allocate=False)
        if slot is None:
            fut.resolve(("ok", NOTFOUND))
            return fut
        self._push(ens, _PendingOp(eng.OP_GET, slot, 0, fut))
        return fut

    def kget_vsn(self, ens: int, key: Any) -> Future:
        """Read returning the version too: ('ok', value|NOTFOUND,
        (epoch, seq)) — the handle a subsequent :meth:`kupdate` needs.
        An absent key reads as ('ok', NOTFOUND, (0, 0))."""
        fut = Future()
        slot = self._slot_for(ens, key, allocate=False)
        if slot is None:
            fut.resolve(("ok", NOTFOUND, (0, 0)))
            return fut
        self._push(ens, _PendingOp(eng.OP_GET, slot, 0, fut,
                                   want_vsn=True))
        return fut

    def kupdate(self, ens: int, key: Any, expected_vsn: Tuple[int, int],
                value: Any) -> Future:
        """Compare-and-swap (do_kupdate, peer.erl:259-270): commit
        `value` iff the key's current version equals `expected_vsn`;
        (0, 0) on an absent key is create-if-missing.  Resolves
        ('ok', new_vsn) or 'failed'."""
        fut = Future()
        slot = self._slot_for(ens, key, allocate=True)
        if slot is None:
            fut.resolve("failed")
            return fut
        handle = self._alloc_handle()
        self.values[handle] = value
        gen = self.slot_gen[ens].get(slot, 0) + 1
        self.slot_gen[ens][slot] = gen
        self._push(ens, _PendingOp(
            eng.OP_CAS, slot, handle, fut, key, gen,
            exp=(int(expected_vsn[0]), int(expected_vsn[1]))))
        return fut

    def kput_once(self, ens: int, key: Any, value: Any) -> Future:
        """Create-if-missing (do_kput_once, peer.erl:278-284): the
        (0, 0)-expected CAS."""
        return self.kupdate(ens, key, (0, 0), value)

    def kdelete(self, ens: int, key: Any) -> Future:
        """Tombstone write (slot recycled once committed)."""
        fut = Future()
        slot = self._slot_for(ens, key, allocate=False)
        if slot is None:
            fut.resolve(("ok", NOTFOUND))
            return fut
        op = _PendingOp(eng.OP_PUT, slot, 0, fut, key,   # 0 = tombstone
                        self.slot_gen[ens].get(slot, 0))
        self._push(ens, op)
        self._recycle_on_ok(fut, ens, key, slot)
        return fut

    def set_peer_up(self, ens: int, peer: int, up: bool) -> None:
        """Failure-detector input (the host's nodedown/suspend signal)."""
        self.up[ens, peer] = up
        self._up_dev = None

    def execute(self, kind: np.ndarray, slot: np.ndarray,
                val: np.ndarray,
                exp_epoch: Optional[np.ndarray] = None,
                exp_seq: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, np.ndarray,
                           np.ndarray, np.ndarray]:
        """Bulk array API: run ``[K, E]`` op matrices through the service
        in one launch and return ``(committed, get_ok, found, value)`` as
        ``[K, E]`` arrays.  Callers address slots directly and carry
        int32 payloads inline (no host handle store).  Payload 0 is the
        tombstone (a put of 0 is a delete).  OP_RMW rows carry the fun
        code in ``exp_epoch`` and return the computed value.  Elections
        fold in and leases check/renew as for queued ops."""
        kind = np.asarray(kind, np.int32)
        val = np.asarray(val, np.int32)
        if ((kind == eng.OP_PUT) & (val < 0)).any():
            raise ValueError("negative put payloads are not encodable "
                             "(int32 handles; 0 = tombstone/delete)")
        k = int(kind.shape[0])
        slot = np.asarray(slot, np.int32)
        committed, get_ok, found, value, _ = self._launch(
            kind, slot, val, k, want_vsn=False,
            exp_e=None if exp_epoch is None
            else np.asarray(exp_epoch, np.int32),
            exp_s=None if exp_seq is None
            else np.asarray(exp_seq, np.int32))
        self.ops_served += int((kind != eng.OP_NOOP).sum())
        return committed, get_ok, found, value

    def flush(self) -> int:
        """One device launch for everything queued; returns ops served."""
        active = self._active
        k = min(self.max_k,
                max((self._queue_rounds[e] for e in active), default=0))
        if k == 0 and not self._election_inputs()[0].any():
            return 0
        # Bucket the batch depth to the next power of two (capped at
        # max_k), as the reference does for its compile cache — kept so
        # the launch shapes, and the packed buffers, match it.
        if k:
            b = 1
            while b < k:
                b <<= 1
            k = min(b, self.max_k)

        kind = np.zeros((k, self.n_ens), dtype=np.int32)
        slot = np.zeros((k, self.n_ens), dtype=np.int32)
        val = np.zeros((k, self.n_ens), dtype=np.int32)
        exp_e = np.zeros((k, self.n_ens), dtype=np.int32)
        exp_s = np.zeros((k, self.n_ens), dtype=np.int32)
        #: (ensemble, taken ops) pairs — ACTIVE ensembles only
        taken: List[Tuple[int, List[Any]]] = []
        still_active = set()
        for e in sorted(active):
            q = self.queues[e]
            ops: List[Any] = []
            rounds = idx = 0
            while idx < len(q) and rounds < k:
                op = q[idx]
                if rounds + op.n <= k:
                    ops.append(op)
                    rounds += op.n
                    idx += 1
                else:
                    # K cap lands inside a batch: take the head rounds
                    # now; the tail (same Future/accumulator) leads the
                    # next flush.
                    head, tail = op.split(k - rounds)
                    ops.append(head)
                    rounds = k
                    q[idx] = tail
                    break
            self.queues[e] = q[idx:]
            self._queue_rounds[e] -= rounds
            if self.queues[e]:
                still_active.add(e)
            if ops:
                taken.append((e, ops))
            j = 0
            for op in ops:
                if isinstance(op, _PendingBatch):
                    n = op.n
                    kind[j:j + n, e] = op.kind
                    slot[j:j + n, e] = op.slot
                    val[j:j + n, e] = op.handle
                    if op.exp_e is not None:
                        exp_e[j:j + n, e] = op.exp_e
                        exp_s[j:j + n, e] = op.exp_s
                    j += n
                else:
                    kind[j, e] = op.kind
                    slot[j, e] = op.slot
                    val[j, e] = op.handle
                    exp_e[j, e], exp_s[j, e] = op.exp
                    j += 1
        self._active = still_active
        try:
            planes = self._launch(kind, slot, val, k, want_vsn=True,
                                  exp_e=exp_e, exp_s=exp_s)
        except BaseException:
            # A failed device launch must not orphan the taken ops:
            # fail them all, then let the error reach the flush() caller.
            for e, ops in taken:
                for op in ops:
                    self._fail_entry(e, op)
            raise
        return self._resolve_flush(taken, planes)

    # -- internals ---------------------------------------------------------

    def _up_device(self) -> torch.Tensor:
        """Device copy of the up mask, re-uploaded only after a
        failure-detector change (steady state: zero h2d bytes)."""
        if self._up_dev is None:
            self._up_dev = torch.from_numpy(self.up.copy()).to(self.device)
        return self._up_dev

    def _alloc_handle(self) -> int:
        if self._free_handles:
            return self._free_handles.pop()
        h = self._next_handle
        assert h <= 0x7FFFFFFF, "2^31 live payloads cannot fit int32 handles"
        self._next_handle += 1
        return h

    def _alloc_handles(self, m: int) -> List[int]:
        """``m`` payload handles in ONE slab operation — the pooled tail
        (in the exact order ``m`` sequential pops would yield) then a
        fresh contiguous range."""
        free = self._free_handles
        t = min(m, len(free))
        out = free[len(free) - t:][::-1]
        if t:
            del free[len(free) - t:]
        if t < m:
            h0 = self._next_handle
            self._next_handle = h0 + (m - t)
            assert self._next_handle - 1 <= 0x7FFFFFFF, \
                "2^31 live payloads cannot fit int32 handles"
            out.extend(range(h0, self._next_handle))
        return out

    def _release_handle(self, handle: int) -> None:
        """Drop a payload and make its handle reusable (double release
        is a no-op)."""
        if handle and self.values.pop(handle, None) is not None:
            self._free_handles.append(handle)

    def _slot_for(self, ens: int, key: Any, allocate: bool) -> Optional[int]:
        slot = self.key_slot[ens].get(key)
        if slot is not None or not allocate:
            return slot
        if not self.free_slots[ens]:
            return None
        slot = self.free_slots[ens].pop()
        self.key_slot[ens][key] = slot
        return slot

    def _drain_recycles(self) -> None:
        """Free slots whose recycle was deferred, once nothing queued
        references them and the conditions still hold: no later put
        bumped the generation, nothing live is committed, and the key
        still owns the slot."""
        if not self._recycle_dirty:
            return
        dirty, self._recycle_dirty = self._recycle_dirty, set()
        for e in dirty:
            pend = self._recycle_pending[e]
            if not pend:
                continue
            busy = set()
            for op in self.queues[e]:
                if isinstance(op, _PendingBatch):
                    busy.update(op.slot)
                else:
                    busy.add(op.slot)
            keep = []
            for key, slot, gen in pend:
                if slot in busy:
                    keep.append((key, slot, gen))
                elif self.slot_gen[e].get(slot, 0) == gen \
                        and self.slot_handle[e].get(slot, 0) == 0 \
                        and self.key_slot[e].get(key) == slot:
                    del self.key_slot[e][key]
                    self.free_slots[e].append(slot)
                # else: the slot was re-used meanwhile — drop the stale
                # recycle request
            self._recycle_pending[e] = keep
            if keep:  # still blocked: revisit on a later drain
                self._recycle_dirty.add(e)

    def _push(self, ens: int, op) -> None:
        self.queues[ens].append(op)
        self._queue_rounds[ens] += op.n
        self._active.add(ens)

    def _queue_recycle(self, ens: int, item: Tuple[Any, int, int]) -> None:
        self._recycle_pending[ens].append(item)
        self._recycle_dirty.add(ens)

    def _recycle_on_ok(self, fut: Future, ens: int, key: Any,
                       slot: int) -> None:
        """Once a delete commits, queue the slot for deferred recycling
        (validated and applied by _drain_recycles)."""
        gen = self.slot_gen[ens].get(slot, 0)

        def recycle(result):
            if isinstance(result, tuple) and result[0] == "ok":
                self._queue_recycle(ens, (key, slot, gen))
        fut.add_waiter(recycle)

    def _election_inputs(self) -> Tuple[np.ndarray, np.ndarray]:
        """Elect wherever there is no leader or the leader is down;
        candidate = lowest-index up member.  Host mirrors only."""
        leader = self.leader_np
        leader_up = np.zeros((self.n_ens,), dtype=bool)
        has = leader >= 0
        leader_up[has] = self.up[np.nonzero(has)[0], leader[has]]
        cand_ok = self.up & self.member_np
        any_up = cand_ok.any(1)
        cand = np.where(any_up, cand_ok.argmax(1), -1).astype(np.int32)
        elect = (~has | ~leader_up) & any_up
        return elect, cand

    def _fetch_packed(self, flat: torch.Tensor) -> np.ndarray:
        """Block until the launch's packed result is on the host (the
        ONE device→host transfer per launch)."""
        return flat.cpu().numpy()

    def _launch(self, kind: np.ndarray, slot: np.ndarray, val: np.ndarray,
                k: int, want_vsn: bool,
                exp_e: Optional[np.ndarray] = None,
                exp_s: Optional[np.ndarray] = None):
        """One synchronous :func:`engine.full_step` launch + host
        bookkeeping: upload the planes, step, pack, fetch the packed
        buffer, unpack, and apply the leader/lease mirrors.  Returns np
        result planes ``(committed, get_ok, found, value, vsn)`` (None
        planes for k == 0; vsn None unless asked).

        The step updates the engine state in place, so a launch that
        fails on the device leaves the state as the failed step left it
        (the reference's donated launch has the same contract)."""
        elect, cand = self._election_inputs()
        now = self.runtime.now
        lease_ok = self.lease_until > now
        dev = self.device

        def up_(a) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        e = self.n_ens
        lease_j = (up_(lease_ok)[None, :].expand(k, e) if k
                   else torch.zeros((0, e), dtype=torch.bool, device=dev))
        state, won, res = eng.full_step(
            self.state, up_(elect), up_(cand), up_(kind), up_(slot),
            up_(val), lease_j, self._up_device(),
            exp_epoch=None if exp_e is None else up_(exp_e),
            exp_seq=None if exp_s is None else up_(exp_s))
        self.state = state
        self.last_launch_k = k
        flat = self._fetch_packed(_pack_results_body(won, res, want_vsn))
        (won_np, quorum_ok, corrupt_np, committed, get_ok, found, value,
         vsn) = unpack_results(flat, e, self.n_peers, k, want_vsn)
        # Host mirror: a won election installed our candidate.
        self.leader_np = np.where(won_np, cand, self.leader_np)
        # Lease renewal: a won election, or any round in which the
        # leader confirmed its epoch with a quorum (peer.erl:1092-1095).
        renew = won_np | quorum_ok
        self.lease_until[renew] = now + self.config.lease()
        # Device-detected integrity failures are counted.  The
        # reference follows them with an anti-entropy exchange sweep;
        # that sweep is not ported yet (the in-round read repair still
        # heals every slot a successful read touches).
        if k:
            self.corruptions += int(corrupt_np.sum())
        self.flushes += 1
        return committed, get_ok, found, value, vsn

    def _safe_resolve(self, fut: Future, result: Any) -> None:
        """Resolve a client future, containing waiter exceptions so one
        client's callback cannot abort the resolve loop."""
        try:
            fut.resolve(result)
        except Exception:
            self.waiter_errors += 1
            log.exception("client future waiter raised")

    def _fail_entry(self, e: int, op) -> None:
        """Fail one queue entry (scalar op or batch)."""
        if isinstance(op, _PendingBatch):
            self._fail_batch(e, op)
        else:
            self._fail_op(e, op)

    def _fail_batch(self, e: int, op: _PendingBatch) -> None:
        if op.fut.done:
            return
        if op.kind in (eng.OP_PUT, eng.OP_CAS):
            for i in range(op.n):
                self._release_handle(op.handle[i])
                if op.keys is not None:
                    self._queue_recycle(e, (op.keys[i], op.slot[i],
                                            op.gen[i]))
        op.accum.fill(op.fut, op.pos, ["failed"] * op.n,
                      self._safe_resolve)

    def _fail_op(self, e: int, op: _PendingOp) -> None:
        """Resolve one queued op as failed, releasing a put's payload
        and queueing its slot for recycling: a failed write that was
        the slot's last queued write may leave it holding nothing
        committed."""
        if op.fut.done:
            return
        if op.kind in (eng.OP_PUT, eng.OP_CAS):
            self._release_handle(op.handle)
            if op.key is not None:
                self._queue_recycle(e, (op.key, op.slot, op.gen))
        self._safe_resolve(op.fut, "failed")

    def _resolve_batch(self, e: int, j: int, op: _PendingBatch,
                       planes) -> None:
        """Resolve one batch entry from result-plane column slices."""
        committed, get_ok, found, value, vsn = planes
        n = op.n
        results: List[Any] = []
        append = results.append
        if op.kind in (eng.OP_PUT, eng.OP_CAS):
            comm_l = committed[j:j + n, e].tolist()
            vs_l = vsn[j:j + n, e].tolist()
            keys = op.keys if op.keys is not None else [None] * n
            slot_handle = self.slot_handle[e]
            recycle = self._recycle_pending[e].append
            self._recycle_dirty.add(e)
            release = self._release_handle
            for comm, s, h, g, key, vs in zip(comm_l, op.slot, op.handle,
                                              op.gen, keys, vs_l):
                if not comm:
                    release(h)
                    if key is not None:
                        recycle((key, s, g))
                    append("failed")
                    continue
                old = slot_handle.pop(s, 0)
                if old != h:
                    release(old)
                if h:
                    slot_handle[s] = h
                append(("ok", tuple(vs)))
        else:  # OP_GET batch
            ok_l = get_ok[j:j + n, e].tolist()
            found_l = found[j:j + n, e].tolist()
            val_l = value[j:j + n, e].tolist()
            vs_l = vsn[j:j + n, e].tolist()
            values = self.values
            for ok, fnd, v, vs in zip(ok_l, found_l, val_l, vs_l):
                if ok:
                    out = values.get(v, NOTFOUND) if fnd and v != 0 \
                        else NOTFOUND
                    append(("ok", out, tuple(vs)) if op.want_vsn
                           else ("ok", out))
                else:
                    append("failed")
        op.accum.fill(op.fut, op.pos, results, self._safe_resolve)

    def _resolve_flush(self, taken, planes) -> int:
        """Resolve every taken op from the result planes, in device
        round order per ensemble (the per-op oracle loop of the
        reference, batch entries through :meth:`_resolve_batch`)."""
        committed, get_ok, found, value, vsn = planes
        if committed is None:  # k == 0: election-only launch, no ops
            assert not taken, "ops taken but no result planes"
            self._drain_recycles()
            return 0
        # one bulk conversion to Python lists, only if a scalar op needs
        # per-op cells
        committed_l = get_ok_l = found_l = value_l = vsn_l = None
        if any(not isinstance(op, _PendingBatch)
               for _e, ops in taken for op in ops):
            committed_l = committed.tolist()
            get_ok_l = get_ok.tolist()
            found_l = found.tolist()
            value_l = value.tolist()
            vsn_l = vsn.tolist()
        served = 0
        for e, ops in taken:
            slot_handle = self.slot_handle[e]
            j = -1
            for op in ops:
                if isinstance(op, _PendingBatch):
                    self._resolve_batch(e, j + 1, op, planes)
                    served += op.n
                    j += op.n
                    continue
                j += 1
                served += 1
                if op.kind in (eng.OP_PUT, eng.OP_CAS):
                    if committed_l[j][e]:
                        # Release the payload this write superseded
                        # (rounds resolve in device order, so the last
                        # committed handle per slot survives).
                        old = slot_handle.pop(op.slot, 0)
                        if old != op.handle:
                            self._release_handle(old)
                        if op.handle:
                            slot_handle[op.slot] = op.handle
                        self._safe_resolve(op.fut,
                                           ("ok", tuple(vsn_l[j][e])))
                    else:
                        self._fail_op(e, op)
                elif get_ok_l[j][e]:
                    v = value_l[j][e]
                    out = (self.values.get(v, NOTFOUND)
                           if found_l[j][e] and v != 0 else NOTFOUND)
                    # vsn is the object's — a tombstone's real version
                    # rides along with NOTFOUND, so CAS chains work
                    self._safe_resolve(
                        op.fut, ("ok", out, tuple(vsn_l[j][e]))
                        if op.want_vsn else ("ok", out))
                else:
                    self._fail_op(e, op)
        self.ops_served += served
        self._drain_recycles()
        return served
