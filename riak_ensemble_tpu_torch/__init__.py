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
- :mod:`.ops.hash` — the Merkle lane hash (format 3);
- :mod:`.ops.engine` — the engine state and the fused step;
- :mod:`.parallel.batched_host` — the keyed service;
- :mod:`.interop` — bit-exact state conversion to and from numpy.

The package imports torch, numpy and the standard library only: never
``jax`` and never a module of :mod:`riak_ensemble_tpu`.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from riak_ensemble_tpu_torch.device import resolve_device  # noqa: F401
