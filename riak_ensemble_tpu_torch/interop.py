"""Bit-exact conversion of engine state and results to and from numpy.

The JAX package's :class:`EngineState` / :class:`KvResult` arrays, as
numpy, carry across to the port's tensors and back without changing a
bit — the "weights carried across" of this system.  The uint32 tree
planes travel as their int32 view (``ndarray.view(np.int32)``) and
come back through ``.view(np.uint32)``; every other field keeps its
dtype.  :func:`state_from_numpy` always copies, so the port's in-place
rounds never write into the caller's arrays.

A JAX mesh state (its global arrays, as numpy) carries to a port mesh
state through :func:`mesh_state_from_numpy` and back through
:func:`mesh_state_to_numpy`; both go through the one state the mesh
shards, so the blocks land where the port's layout puts them.
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from riak_ensemble_tpu_torch.device import DeviceLike, resolve_device
from riak_ensemble_tpu_torch.ops.engine import EngineState, KvResult

#: fields stored as uint32 by the reference (int32 bit patterns here)
UINT32_FIELDS = ("tree_leaf", "tree_node")

_Src = Union[Any, dict]


def _field(src: _Src, name: str):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def _to_tensor(a, name: str, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if name in UINT32_FIELDS:
        if a.dtype != np.uint32:
            raise TypeError(f"{name} must be uint32, got {a.dtype}")
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_numpy(t: torch.Tensor, name: str) -> np.ndarray:
    a = t.detach().cpu().numpy().copy()
    if name in UINT32_FIELDS:
        a = a.view(np.uint32)
    return a


def state_from_numpy(src: _Src, device: DeviceLike = None) -> EngineState:
    """An :class:`EngineState` of tensors on ``device`` (CUDA unless
    ``"cpu"``) from any object (or dict) with the state's field names
    holding array-likes — e.g. the JAX package's ``EngineState``."""
    dev = resolve_device(device)
    return EngineState(*(_to_tensor(_field(src, f), f, dev)
                         for f in EngineState._fields))


def state_to_numpy(state: EngineState) -> EngineState:
    """The same state as an :class:`EngineState` of numpy arrays with
    the reference's dtypes (``tree_*`` back to uint32)."""
    return EngineState(*(_to_numpy(getattr(state, f), f)
                         for f in EngineState._fields))


def result_from_numpy(src: _Src, device: DeviceLike = None) -> KvResult:
    dev = resolve_device(device)
    return KvResult(*(_to_tensor(_field(src, f), f, dev)
                      for f in KvResult._fields))


def result_to_numpy(res: KvResult) -> KvResult:
    return KvResult(*(_to_numpy(getattr(res, f), f)
                      for f in KvResult._fields))


def mesh_state_from_numpy(src: _Src, engine: Any) -> Any:
    """A :class:`..parallel.mesh.MeshState` on ``engine``'s mesh from the
    global arrays of a state (e.g. the JAX ``ShardedEngine``'s)."""
    return engine.shard_state(state_from_numpy(src, device="cpu"))


def mesh_state_to_numpy(state: Any) -> EngineState:
    """A mesh state as one :class:`EngineState` of numpy arrays with the
    reference's dtypes."""
    return state_to_numpy(state.gather())
