"""Sharding the consensus engine over an ('ens', 'peer') device grid.

Port of ``riak_ensemble_tpu/parallel/mesh.py`` (:func:`make_mesh`,
:class:`ShardedEngine`, :func:`mesh_engine`, with the reference's names
and shapes):

- **'ens' axis** — ensembles are independent consensus groups, so E
  splits into contiguous blocks, one per grid row, with no cross-device
  traffic (the reference's data-parallel axis);
- **'peer' axis** — one ensemble's M peer replicas split into contiguous
  blocks across a row's devices; vote counts, the proposal epoch and the
  newest-object selection become sums and maxima over the row (the
  reference's ``psum`` / ``pmax`` over the 'peer' mesh axis).  'peer' is
  innermost: a row's peer shards are neighbouring devices.

A single controller has no ``shard_map``, so a collective in the middle
of a step needs every peer shard's partial first.  Each peer shard of a
row runs the step in a thread of its own (under ``torch.cuda.device`` of
its device); :class:`ThreadPeerAxis` ``sum`` / ``max`` deposit the
partial, wait for the row at a barrier, and reduce the deposited list in
shard order — integer reductions, so the result is exact and the same
in every shard.  Across processes the same interface runs over
``torch.distributed.all_reduce`` (:mod:`.distributed`).

On the card: with an unsharded peer axis each ens shard steps as the
single-device engine does — ``full_step`` is one launch of kernel F1 on
the shard's device, an exchange one of X1, a reconfig step one of R1, an
election's gate K1 — and every shard is launched before any is waited
on (nothing in a launch waits for the card).  With a sharded peer axis the shards run
the engine's plain torch steps with the collectives, as the reference
runs its ``jnp`` engine, never its Pallas kernel, there
(``engine.py:478-482``); F1 over a sharded peer axis is later work.

A device list may repeat a device: eight ``cpu`` shards stand in for
the reference tests' eight virtual CPU devices, and one card can hold
all shards of a mesh.

State and results: a :class:`MeshState` holds each shard's
:class:`..ops.engine.EngineState` on its device; :meth:`ShardedEngine.
shard_state` / :meth:`~ShardedEngine.gather_state` map it to and from
one state.  Every other output is a :class:`Sharded` array (a
:class:`..ops.engine.KvResult` of them for the K/V steps): its blocks
stay on their devices until ``gather()`` / ``numpy()`` joins them.
Inputs are global arrays (tensors on any device, or numpy), split per
shard.  Like the single engine, the steps update the shards' object and
tree planes in place (F1 every plane).

The reference's ``_make_step`` zero CAS planes (``_default_exp``,
``mesh.py:48-54``) and identity placement program (``_canon``) are XLA
concerns: the port keeps ``_make_step``'s call convention only, and its
sliced-step absence — a mesh service keeps the full grid and compacts
the packed result per ens shard (``batched_host``'s shard-wise pack).
"""

from __future__ import annotations

import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from riak_ensemble_tpu_torch.ops import (
    cuda_engine, cuda_exchange, cuda_quorum, cuda_reconfig)
from riak_ensemble_tpu_torch.ops import engine as eng
from riak_ensemble_tpu_torch.ops.quorum import views_to_mask

#: (ens index, peer index) of one shard in the grid
Shard = Tuple[int, int]

#: (ens dim, peer dim or None) of each plane: an array without a peer dim
#: is replicated along the row's peer shards
STATE_SPECS = {"epoch": (0, 1), "fact_seq": (0, 1), "leader": (0, None),
               "view_mask": (0, 2), "view_vsn": (0, None),
               "pend_vsn": (0, None), "commit_vsn": (0, None),
               "obj_seq_ctr": (0, None), "obj_epoch": (0, 1),
               "obj_seq": (0, 1), "obj_val": (0, 1), "tree_leaf": (0, 1),
               "tree_node": (0, 1)}
#: the scan's [K, E] and the wide scan's [G, E, W] results alike
RESULT_SPECS = {"committed": (1, None), "get_ok": (1, None),
                "found": (1, None), "value": (1, None),
                "obj_vsn": (1, None), "quorum_ok": (1, None),
                "tree_corrupt": (1, 2)}
E = (0, None)        # [E] per-ensemble vectors
EM = (0, 1)          # [E, M] per-replica planes
KE = (1, None)       # [K, E] / [G, E, W] op planes

#: seconds a peer shard waits for its row at a collective before the
#: step is declared hung
BARRIER_TIMEOUT_S = 600.0


def _counts() -> Dict[str, int]:
    """The kernels' launch counts in this process, read from the
    wrappers' own counters."""
    return {"F1": cuda_engine.engine_step_launches,
            "K1": cuda_quorum.quorum_launches,
            "X1": cuda_exchange.exchange_launches,
            "R1": cuda_reconfig.reconfig_launches}


def _on(dev: torch.device):
    """``dev`` as the current card (a no-op for the CPU)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def default_devices() -> List[torch.device]:
    """Every visible card; raises when there is none (a CPU mesh names
    its devices: ``devices=["cpu"] * n``)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "the mesh runs on CUDA devices and none is visible; pass "
            "devices=['cpu'] * n for a CPU mesh")
    return [torch.device("cuda", i) for i in range(n)]


class Mesh:
    """An ``(ens, peer)`` grid of shards, 'peer' innermost.

    ``devices[i][j]`` is shard (i, j)'s ``torch.device`` where this
    process holds it, else None; ``ranks[i][j]`` is the process that
    holds it (0 everywhere in one process).  ``row_axis`` maps a row
    whose peer shards span processes to the factory of its
    cross-process peer axis (:mod:`.distributed`)."""

    def __init__(self, devices: Sequence[Sequence[Optional[torch.device]]],
                 ranks: Optional[Sequence[Sequence[int]]] = None,
                 rank: int = 0,
                 row_axis: Optional[Dict[int, Callable[[int], Any]]] = None
                 ) -> None:
        self.devices = [list(r) for r in devices]
        n_ens, n_peer = len(self.devices), len(self.devices[0])
        self.shape = {"ens": n_ens, "peer": n_peer}
        self.ranks = ([list(r) for r in ranks] if ranks is not None
                      else [[0] * n_peer for _ in range(n_ens)])
        self.rank = rank
        self.row_axis = dict(row_axis or {})

    def local_shards(self) -> List[Shard]:
        """This process's shards, row-major."""
        return [(i, j) for i in range(self.shape["ens"])
                for j in range(self.shape["peer"])
                if self.ranks[i][j] == self.rank]

    @property
    def all_local(self) -> bool:
        return len(self.local_shards()) == (self.shape["ens"]
                                            * self.shape["peer"])

    @property
    def device(self) -> torch.device:
        """The first local shard's device: where a service over this
        mesh keeps its own tensors."""
        i, j = self.local_shards()[0]
        return self.devices[i][j]

    def describe(self) -> str:
        return ", ".join(f"({i},{j}) {self.devices[i][j]}"
                         for i, j in self.local_shards())


def make_mesh(n_ens: int, n_peer: int = 1,
              devices: Optional[Sequence[Any]] = None) -> Mesh:
    """Mesh of shape (ens=n_ens, peer=n_peer) over the first
    ``n_ens * n_peer`` of ``devices`` (default: every card), 'peer'
    innermost.  The list may repeat a device."""
    devs = [torch.device(d) for d in
            (devices if devices is not None else default_devices())]
    assert len(devs) >= n_ens * n_peer, \
        f"need {n_ens * n_peer} devices, have {len(devs)}"
    return Mesh([[devs[i * n_peer + j] for j in range(n_peer)]
                 for i in range(n_ens)])


class _PeerGroup:
    """The in-process collective of one grid row's peer shards: a
    barrier and two deposit lists used in turn, so a shard that runs
    ahead into the next collective cannot overwrite a list another shard
    is still reading (to reach the collective after that it must pass a
    barrier every shard has reached)."""

    def __init__(self, n: int) -> None:
        self.n = n
        self.barrier = threading.Barrier(n, timeout=BARRIER_TIMEOUT_S)
        self._bufs: List[List[Optional[torch.Tensor]]] = [[None] * n,
                                                          [None] * n]
        self._turn = [0] * n

    def reduce(self, idx: int, x: torch.Tensor, op: str) -> torch.Tensor:
        buf = self._bufs[self._turn[idx] & 1]
        self._turn[idx] += 1
        buf[idx] = x
        self.barrier.wait()
        acc = buf[0].to(x.device)
        for part in buf[1:]:
            part = part.to(x.device)
            acc = acc + part if op == "sum" else torch.maximum(acc, part)
        return acc


class ThreadPeerAxis:
    """Peer shard ``index``'s view of its row's in-process collective:
    the reference's ``psum`` (``sum``), ``pmax`` (``max``) and
    ``axis_index`` (``index``)."""

    def __init__(self, group: _PeerGroup, index: int) -> None:
        self._group = group
        self.index = index

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return self._group.reduce(self.index, x, "sum")

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self._group.reduce(self.index, x, "max")


class Sharded:
    """One global array held as per-shard blocks on their devices.

    ``spec`` is (ens dim, peer dim or None); without a peer dim every
    peer shard of a row holds the same block.  ``gather`` joins the
    blocks in shard order (every shard must be this process's);
    :meth:`shards` lists this process's blocks with their global index,
    like a JAX array's ``addressable_shards``."""

    def __init__(self, mesh: Mesh, blocks: Dict[Shard, torch.Tensor],
                 spec: Tuple[int, Optional[int]]) -> None:
        self.mesh = mesh
        self.blocks = blocks
        self.ens_dim, self.peer_dim = spec

    def _any(self) -> torch.Tensor:
        return next(iter(self.blocks.values()))

    @property
    def shape(self) -> Tuple[int, ...]:
        shape = list(self._any().shape)
        shape[self.ens_dim] *= self.mesh.shape["ens"]
        if self.peer_dim is not None:
            shape[self.peer_dim] *= self.mesh.shape["peer"]
        return tuple(shape)

    def gather(self, device: Any = "cpu") -> torch.Tensor:
        if not self.mesh.all_local:
            raise ValueError("this array spans processes; each process "
                             "reads its own blocks through shards()")
        dev = torch.device(device)
        n_ens, n_peer = self.mesh.shape["ens"], self.mesh.shape["peer"]
        rows = []
        for i in range(n_ens):
            if self.peer_dim is None:
                rows.append(self.blocks[(i, 0)].to(dev))
            else:
                rows.append(torch.cat([self.blocks[(i, j)].to(dev)
                                       for j in range(n_peer)],
                                      dim=self.peer_dim))
        return torch.cat(rows, dim=self.ens_dim)

    def cpu(self) -> torch.Tensor:
        return self.gather("cpu")

    def numpy(self) -> np.ndarray:
        return self.cpu().numpy()

    def shards(self) -> List[Tuple[Tuple[slice, ...], torch.Tensor]]:
        out = []
        for (i, j), t in self.blocks.items():
            idx = [slice(None)] * t.dim()
            n = t.shape[self.ens_dim]
            idx[self.ens_dim] = slice(i * n, (i + 1) * n)
            if self.peer_dim is not None:
                n = t.shape[self.peer_dim]
                idx[self.peer_dim] = slice(j * n, (j + 1) * n)
            out.append((tuple(idx), t))
        return out


class MeshState:
    """Each local shard's :class:`EngineState` on its device.  A field
    read (``state.epoch``) is a :class:`Sharded` view of that plane;
    iterating yields the fields in ``EngineState`` order."""

    _fields = eng.EngineState._fields

    def __init__(self, mesh: Mesh, shards: Dict[Shard, eng.EngineState]
                 ) -> None:
        self.mesh = mesh
        self.shards = shards

    def field(self, name: str) -> Sharded:
        return Sharded(self.mesh, {s: getattr(st, name)
                                   for s, st in self.shards.items()},
                       STATE_SPECS[name])

    def __iter__(self):
        return (self.field(f) for f in self._fields)

    def gather(self, device: Any = "cpu") -> eng.EngineState:
        """The whole state as one :class:`EngineState` on ``device``."""
        return eng.EngineState(*(self.field(f).gather(device)
                                 for f in self._fields))

    def keep_rows(self, rows: np.ndarray):
        """:func:`..ops.engine.keep_rows` shard by shard (ens shard i holds
        rows ``[i * El, (i + 1) * El)``): the function that writes every
        shard's kept planes back."""
        rows = np.asarray(rows, dtype=np.int64)
        restores = []
        for (i, _j), st in self.shards.items():
            el = st.obj_epoch.shape[0]
            mine = rows[(rows >= i * el) & (rows < (i + 1) * el)] - i * el
            restores.append(eng.keep_rows(st, mine))

        def restore() -> None:
            for fn in restores:
                fn()
        return restore

    def clone(self) -> "MeshState":
        return MeshState(self.mesh, {
            s: eng.EngineState(*(t.clone() for t in st))
            for s, st in self.shards.items()})


for _f in eng.EngineState._fields:
    setattr(MeshState, _f, property(lambda self, f=_f: self.field(f)))


class ShardedEngine:
    """The engine's steps over a ('ens', 'peer') :class:`Mesh` — the
    mesh serving engine (mesh.py:71-300).

    E must divide by the mesh's 'ens' size and M by its 'peer' size (pad
    views with absent peers: all-zero view columns are inert).  There
    are no sliced steps: a service over a mesh keeps the full grid.

    ``launches`` counts kernels F1, K1, X1 and R1 per shard on the
    unsharded-peer path (read from the wrappers' own counts around each
    shard's call; :meth:`reset_launch_counts` sets them to 0).  With
    ``time_shards`` set, each shard's calls on the card are timed with
    CUDA events into ``shard_events`` (read with :meth:`shard_ms`)."""

    def __init__(self, mesh: Mesh) -> None:
        self.mesh = mesh
        self.device = mesh.device
        n_peer = mesh.shape["peer"]
        self._pool = (ThreadPoolExecutor(max_workers=n_peer,
                                         thread_name_prefix="peer-shard")
                      if n_peer > 1 else None)
        self.launches: Dict[Shard, Dict[str, int]] = {}
        self.reset_launch_counts()
        self.time_shards = False
        self.shard_events: Dict[Shard, list] = {}
        self.full_step = self._make_step(eng.full_step)
        self.full_step_wide = self._make_step(eng.full_step_wide)

    def _make_step(self, fn):
        """The serving steps' call convention (keyword CAS planes,
        default absent) over a fused step of the engine."""
        def step(state, elect, cand, kind, slot, val, lease_ok, up,
                 exp_epoch=None, exp_seq=None):
            def body(st, el, ca, k, sl, v, lz, u, xe, xs, axis):
                return fn(st, el, ca, k, sl, v, lz, u, xe, xs, axis=axis)
            return self._run(body, state,
                             [(elect, E), (cand, E), (kind, KE),
                              (slot, KE), (val, KE), (lease_ok, KE),
                              (up, EM), (exp_epoch, KE), (exp_seq, KE)],
                             [E, RESULT_SPECS])
        return step

    # -- placement ---------------------------------------------------------

    @property
    def n_ens_shards(self) -> int:
        """Number of shards along the 'ens' mesh axis."""
        return int(self.mesh.shape["ens"])

    @property
    def n_peer_shards(self) -> int:
        """Number of shards along the 'peer' mesh axis."""
        return int(self.mesh.shape["peer"])

    def reset_launch_counts(self) -> None:
        self.launches = {s: {"F1": 0, "K1": 0, "X1": 0, "R1": 0}
                         for s in self.mesh.local_shards()}

    def shard_ms(self) -> Dict[Shard, float]:
        """Device ms of each shard's timed calls (see ``time_shards``)."""
        return {s: sum(a.elapsed_time(b) for a, b in evs)
                for s, evs in self.shard_events.items()}

    def _block(self, x, spec: Tuple[int, Optional[int]], shard: Shard,
               copy: bool = False) -> Optional[torch.Tensor]:
        """Shard ``shard``'s block of the global array ``x`` on its
        device, contiguous and starting on a 16-byte boundary (F1's
        contract; a row block of a view may not) — a copy when
        ``copy``."""
        if x is None:
            return None
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        ens_dim, peer_dim = spec
        i, j = shard
        idx = [slice(None)] * x.dim()
        for dim, k, n in ((ens_dim, i, self.n_ens_shards),
                          (peer_dim, j, self.n_peer_shards)):
            if dim is None:
                continue
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                                 f"divide into {n} shards")
            w = x.shape[dim] // n
            idx[dim] = slice(k * w, (k + 1) * w)
        dev = self.mesh.devices[i][j]
        t = x[tuple(idx)].to(dev, copy=copy).contiguous()
        return t.clone() if t.data_ptr() % 16 else t

    def shard_state(self, state: eng.EngineState) -> MeshState:
        """Place one state onto the mesh (every plane copied)."""
        if isinstance(state, MeshState):
            return state
        return MeshState(self.mesh, {
            s: eng.EngineState(*(self._block(getattr(state, f),
                                             STATE_SPECS[f], s, copy=True)
                                 for f in eng.EngineState._fields))
            for s in self.mesh.local_shards()})

    def gather_state(self, state: MeshState,
                     device: Any = "cpu") -> eng.EngineState:
        """A mesh state as one :class:`EngineState` on ``device``."""
        return state.gather(device)

    def init_state(self, n_ensembles: int, n_peers: int, n_slots: int,
                   n_views: int = 2,
                   views: Optional[Sequence[Sequence[int]]] = None,
                   device: Any = None) -> MeshState:
        """:func:`..ops.engine.init_state` built shard by shard on the
        mesh's devices (``device`` is not used: the mesh places it)."""
        del device
        n_e, n_p = self.n_ens_shards, self.n_peer_shards
        if n_ensembles % n_e or n_peers % n_p:
            raise ValueError(f"E={n_ensembles} must divide by the ens "
                             f"axis ({n_e}) and M={n_peers} by the peer "
                             f"axis ({n_p})")
        el, ml = n_ensembles // n_e, n_peers // n_p
        if views is None:
            vm = np.zeros((n_views, n_peers), dtype=bool)
            vm[0, :] = True
        else:
            assert len(views) <= n_views
            vm = views_to_mask(views, n_views, n_peers)
        shards = {}
        for i, j in self.mesh.local_shards():
            dev = self.mesh.devices[i][j]
            st = eng.init_state(el, ml, n_slots, n_views, device=dev)
            part = torch.as_tensor(vm[:, j * ml:(j + 1) * ml], device=dev)
            shards[(i, j)] = st._replace(
                view_mask=part.expand(el, n_views, ml).contiguous())
        return MeshState(self.mesh, shards)

    # -- the step runner ---------------------------------------------------

    def _call(self, body, shard: Shard, st, args, axis):
        """``body`` on one shard, with its device current; counts F1, K1,
        X1 and R1 launches (and times the call when ``time_shards``)."""
        dev = self.mesh.devices[shard[0]][shard[1]]
        with _on(dev):
            before = _counts()
            ev = None
            if self.time_shards and dev.type == "cuda":
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            out = body(st, *args, axis=axis)
            if ev is not None:
                ev[1].record()
                self.shard_events.setdefault(shard, []).append(ev)
            if axis is None:
                n = self.launches[shard]
                for name, c in _counts().items():
                    n[name] += c - before[name]
        return out

    def _row(self, body, i: int, state, args) -> Dict[Shard, Any]:
        """Run ``body`` on row ``i``'s local peer shards."""
        local = [s for s in self.mesh.local_shards() if s[0] == i]

        def shard_args(s):
            return [self._block(x, spec, s) for x, spec in args]

        def st_of(s):
            return None if state is None else state.shards[s]
        if self.n_peer_shards == 1:
            s = local[0]
            return {s: self._call(body, s, st_of(s), shard_args(s), None)}
        if i in self.mesh.row_axis:
            if len(local) != 1:
                raise ValueError(f"row {i} spans processes with "
                                 f"{len(local)} shards here; a "
                                 f"cross-process row holds one per "
                                 f"process")
            s = local[0]
            axis = self.mesh.row_axis[i](s[1])
            return {s: self._call(body, s, st_of(s), shard_args(s), axis)}
        group = _PeerGroup(self.n_peer_shards)

        def task(s):
            try:
                return self._call(body, s, st_of(s), shard_args(s),
                                  ThreadPeerAxis(group, s[1]))
            except BaseException:
                group.barrier.abort()
                raise
        futs = {s: self._pool.submit(task, s) for s in local}
        out, first = {}, None
        for s, f in futs.items():
            try:
                out[s] = f.result()
            except threading.BrokenBarrierError as exc:
                first = first or exc
            except BaseException as exc:   # the cause, not a victim
                first = exc if (first is None or isinstance(
                    first, threading.BrokenBarrierError)) else first
        if first is not None:
            raise first
        return out

    def _run(self, body, state: Optional[MeshState], args, out_specs):
        """``body(shard_state, *shard_args, axis=)`` on every local
        shard, row by row; returns the new :class:`MeshState` (when the
        body returns one first) and the outputs as :class:`Sharded`
        arrays (a ``KvResult`` of them for a dict spec)."""
        outs: Dict[Shard, Any] = {}
        for i in sorted({s[0] for s in self.mesh.local_shards()}):
            outs.update(self._row(body, i, state, args))
        shards = list(outs)
        rets = []
        if state is not None and len(out_specs) < len(outs[shards[0]]):
            rets.append(MeshState(self.mesh,
                                  {s: outs[s][0] for s in shards}))
            off = 1
        else:
            off = 0
        for n, spec in enumerate(out_specs):
            vals = {s: outs[s][off + n] for s in shards}
            if isinstance(spec, dict):
                rets.append(eng.KvResult(*(
                    Sharded(self.mesh, {s: getattr(v, f)
                                        for s, v in vals.items()},
                            spec[f])
                    for f in eng.KvResult._fields)))
            else:
                rets.append(Sharded(self.mesh, vals, spec))
        return tuple(rets)

    # -- steps -------------------------------------------------------------

    def elect_step(self, state, elect, cand, up):
        return self._run(eng.elect_step, state,
                         [(elect, E), (cand, E), (up, EM)], [E])

    def kv_step_scan(self, state, kind, slot, val, lease_ok, up,
                     exp_epoch=None, exp_seq=None):
        """Ops are ``[K, E]`` (a scan of K rounds), matching
        :func:`..ops.engine.kv_step_scan`."""
        return self._run(eng.kv_step_scan, state,
                         [(kind, KE), (slot, KE), (val, KE),
                          (lease_ok, KE), (up, EM), (exp_epoch, KE),
                          (exp_seq, KE)], [RESULT_SPECS])

    # full_step / full_step_wide are instance attributes built in
    # __init__ (the serving steps' call convention)

    def reconfig_step(self, state, propose, new_view, up):
        """Joint-consensus membership change over the mesh
        (:func:`..ops.engine.reconfig_step`)."""
        return self._run(eng.reconfig_step, state,
                         [(propose, E), (new_view, EM), (up, EM)], [E, E])

    def reconfig_propose(self, state, propose, new_view, vsn, up):
        """General views-list cons over the mesh
        (:func:`..ops.engine.reconfig_propose`)."""
        return self._run(eng.reconfig_propose, state,
                         [(propose, E), (new_view, EM), (vsn, E), (up, EM)],
                         [E])

    def reconfig_transition(self, state, run, up):
        """Views-list collapse over the mesh
        (:func:`..ops.engine.reconfig_transition`)."""
        return self._run(eng.reconfig_transition, state,
                         [(run, E), (up, EM)], [E])

    def exchange_step(self, state, run, up):
        """Anti-entropy sweep over the mesh
        (:func:`..ops.engine.exchange_step`)."""
        return self._run(eng.exchange_step, state, [(run, E), (up, EM)],
                         [EM, E])

    def keep_rows(self, state, rows):
        """Before :meth:`exchange_step`: a function that undoes it.  On
        card shards with the peer axis whole each shard's exchange steps
        its rows in place, so those are kept
        (:meth:`MeshState.keep_rows`); over a sharded peer axis or on CPU
        shards it returns new tensors and there is nothing to keep."""
        if self.mesh.shape["peer"] > 1 or self.device.type != "cuda":
            return lambda: None
        return state.keep_rows(rows)

    def verify_trees(self, state):
        """Integrity sweep over the mesh
        (:func:`..ops.engine.verify_trees`); per replica, no collective."""
        def body(st, axis):
            return eng.verify_trees(st, axis)
        return self._run(body, state, [], [EM, EM])

    def rebuild_trees(self, state, mask):
        """Tree rebuild over the mesh
        (:func:`..ops.engine.rebuild_trees`)."""
        def body(st, m, axis):
            return (eng.rebuild_trees(st, m),)
        return self._run(body, state, [(mask, EM)], [])[0]

    def reset_rows(self, state, mask, new_view):
        """Ensemble-row recycle over the mesh
        (:func:`..ops.engine.reset_rows`)."""
        def body(st, m, nv, axis):
            return (eng.reset_rows(st, m, nv),)
        return self._run(body, state, [(mask, E), (new_view, EM)], [])[0]


def mesh_engine(n_devices: Optional[int] = None, n_peer: int = 1,
                devices: Optional[Sequence[Any]] = None) -> ShardedEngine:
    """A serving :class:`ShardedEngine` over the first ``n_devices``
    cards (default: all of them), ``n_peer`` of the mesh innermost on
    the 'peer' axis — the svcnode entry point (``--mesh-devices``).
    ``devices`` names them instead (repeats allowed; ``["cpu"] * 8`` is
    the CPU tests' mesh).  Asked for more cards than
    ``torch.cuda.device_count()`` shows, it raises naming the count."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        want = have if n_devices is None else int(n_devices)
        if want > have or want == 0:
            raise ValueError(
                f"mesh_engine: asked for {want} devices but torch sees "
                f"{have} CUDA device(s); pass devices=[...] to place the "
                f"shards (['cpu'] * {max(want, 1)} for a CPU mesh, or one "
                f"card repeated)")
        devs: List[Any] = [torch.device("cuda", i) for i in range(want)]
    else:
        devs = list(devices)
        want = len(devs) if n_devices is None else int(n_devices)
        if want > len(devs):
            raise ValueError(f"mesh_engine: asked for {want} devices but "
                             f"{len(devs)} were given")
    if want % n_peer:
        raise ValueError(f"mesh_engine: {want} devices do not divide into "
                         f"n_peer={n_peer} columns")
    return ShardedEngine(make_mesh(want // n_peer, n_peer,
                                   devices=devs[:want]))
