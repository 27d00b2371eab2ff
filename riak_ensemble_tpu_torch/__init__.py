"""riak_ensemble_tpu_torch: the batched ensemble engine on PyTorch + CUDA.

A second package beside :mod:`riak_ensemble_tpu` (the JAX reference).
It serves the same keyed service on an NVIDIA H100: the host service
packs queued ops into ``[K, E]`` planes, one fused engine step runs
the election and K K/V rounds on the card, and one bit-packed result
buffer comes back per flush.

Layout mirrors the reference so each counterpart is easy to find:

- :mod:`.ops.u32` — uint32 lanes carried as int32 bit patterns;
- :mod:`.ops.quorum` — the scalar and batched quorum predicates;
- :mod:`.ops.cuda_quorum` — kernel K1 (the engine's quorum reduce,
  CUDA C++ in ``csrc/quorum.cu``) and its plain PyTorch version;
- :mod:`.ops.hash` — the Merkle lane hash (format 3) and the device
  Merkle tree, whose exchange :mod:`.synctree.remote_sync` streams
  between processes;
- :mod:`.ops.engine` — the engine state and the fused step;
- :mod:`.parallel.batched_host` — the keyed service, with its
  observability plane (:mod:`.obs`) on by default;
- :mod:`.svcnode` — its network front end (``ServiceServer``,
  ``ServiceClient``, ``serve``) over the restricted wire codec
  (:mod:`.wire`, its C++ half in ``csrc/host/wirecodec.cc``) on the
  real-time runtime (:mod:`.netruntime`);
- :mod:`.interop` — bit-exact state conversion to and from numpy;
- riak_ensemble's own scalar plane on the simulator runtime
  (:mod:`.runtime`): :mod:`.storage`, :mod:`.synctree`, :mod:`.msg`,
  :mod:`.router`, :mod:`.directory`, :mod:`.lease`, :mod:`.backend`,
  :mod:`.worker`, :mod:`.peer`, :mod:`.root`, :mod:`.manager`,
  :mod:`.state`, :mod:`.client`, :mod:`.app`, :mod:`.utils.clock`, and
  the harness :mod:`.testing` (``Cluster``, ``ManagedCluster``), with
  :mod:`.netnode`, a node of that plane as an OS process over
  :mod:`.netruntime`, and :mod:`.linearizability`, the history checker;
- the scale plane under consensus management: :mod:`.service_directory`
  (svcnodes registered in the root ensemble's directory) and
  :mod:`.service_manager` (the tenant registry, rendezvous placement,
  the reconciler and the versioned handoff between services);
- :mod:`.tools.trace_export` — Chrome / Perfetto trace JSON of flush
  timelines, flight-recorder dumps and fleet timelines
  (``python -m riak_ensemble_tpu_torch.tools.trace_export``).

As the reference's, the package re-exports the record types (``Obj``,
``Fact``, ``PeerId``, ``EnsembleInfo``, ``NOTFOUND``), :mod:`.ops` the
quorum predicates and :mod:`.parallel` ``ShardedEngine`` and
``make_mesh``; importing them creates no CUDA context.

The package imports torch, numpy and the standard library only: never
``jax`` and never a module of :mod:`riak_ensemble_tpu`.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from riak_ensemble_tpu_torch.device import resolve_device  # noqa: F401
from riak_ensemble_tpu_torch.types import (  # noqa: F401
    Obj,
    Fact,
    PeerId,
    EnsembleInfo,
    NOTFOUND,
)
