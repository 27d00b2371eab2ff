"""Quorum vote reduction — the scalar and batched predicates.

Reference semantics: ``riak_ensemble_msg:quorum_met/5``
(``src/riak_ensemble_msg.erl:377-418``): quorum must be met in EVERY
view, checked in order; per view ``thresh = len(members)//2 + 1`` (or
``len(members)`` for ``required='all'``); the caller counts as one
implicit valid reply when it is a member, except in ``'other'`` mode.
A view with ``nacks >= thresh``, or where everyone was heard from yet
quorum wasn't reached, fails the whole call with ``NACK``; a view that
might still succeed returns ``UNDECIDED`` and later views are not
examined.

- :func:`quorum_met` — the host scalar version, copied unchanged from
  ``riak_ensemble_tpu/ops/quorum.py:54`` (the differential oracle);
- :func:`quorum_met_batch` — the batched version
  (``riak_ensemble_tpu/ops/quorum.py:115-185``) as torch ops over
  ``[..., M]`` peer lanes and ``[..., V, M]`` view masks, all four
  ``REQUIRED_MODES``.  There is no mesh in this package, so the
  reference's ``axis_name`` (the sharded ``psum``) is dropped.

The engine's hot-path form of the same predicate (``required=
"quorum"``, no self term, per-ensemble masks) is kernel K1 in
:mod:`.cuda_quorum`.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

# Result codes (shared by scalar and batched versions).
MET = 1
UNDECIDED = 0
NACK = -1

#: required() modes (msg.erl:43).
REQUIRED_MODES = ("quorum", "all", "all_or_quorum", "other")


def quorum_met(replies: Iterable[Tuple[object, object]],
               self_id: object,
               views: Sequence[Sequence[object]],
               required: str = "quorum",
               extra: "Optional[Callable[[list], bool]]" = None) -> int:
    """Scalar quorum predicate.

    ``replies`` is an iterable of ``(peer_id, reply)`` where a reply of
    the string ``'nack'`` is a negative vote.  Returns MET / UNDECIDED /
    NACK.  ``extra`` is an optional extra predicate on the replies,
    evaluated only once every view has met (the recursion base case,
    msg.erl:382-388) — used by the read path's hash-validity check.
    """
    assert required in REQUIRED_MODES, required
    replies = list(replies)
    for members in views:
        members = list(members)
        filtered = [(p, r) for (p, r) in replies if p in members]
        valid = [p for (p, r) in filtered if r != "nack"]
        nacks = [p for (p, r) in filtered if r == "nack"]
        if required == "all":
            thresh = len(members)
        else:
            thresh = len(members) // 2 + 1
        heard = len(valid)
        if required != "other" and self_id in members:
            heard += 1
        if heard >= thresh:
            continue
        if len(nacks) >= thresh:
            return NACK
        if heard + len(nacks) == len(members):
            return NACK
        return UNDECIDED
    if extra is not None and not extra(replies):
        return UNDECIDED
    return MET


def resolve_views(heard: torch.Tensor, n_nack: torch.Tensor,
                  members: torch.Tensor, thresh: torch.Tensor
                  ) -> torch.Tensor:
    """The shared tail: per-view met/nack from int32 counts ``[..., V]``
    (broadcastable), joint-view AND, and the in-order first-unmet nack
    rule.  Returns int8 ``[...]`` of MET / UNDECIDED / NACK."""
    active = members > 0
    met_v = (heard >= thresh) | ~active
    # Inactive (padding) views count as met and never nack.
    nack_v = ((n_nack >= thresh) | ((heard + n_nack) == members)) & active
    met_v, nack_v = torch.broadcast_tensors(met_v, nack_v)
    all_met = met_v.all(-1)
    # First unmet view, in order: torch.argmin returns the FIRST
    # minimal index (as jnp.argmin does), which is what the reference's
    # left-to-right recursion examines.
    first_unmet = torch.argmin(met_v.to(torch.int32), dim=-1)
    unmet_nacked = torch.gather(nack_v, -1, first_unmet[..., None])[..., 0]
    out = torch.where(all_met, MET, torch.where(unmet_nacked, NACK,
                                                UNDECIDED))
    return out.to(torch.int8)


def quorum_met_batch(valid: torch.Tensor,
                     nack: torch.Tensor,
                     view_mask: torch.Tensor,
                     self_idx: torch.Tensor,
                     required: str = "quorum") -> torch.Tensor:
    """Batched quorum predicate.

    Args:
      valid:      bool ``[..., M]`` — peer m replied positively.
      nack:       bool ``[..., M]`` — peer m replied nack.
      view_mask:  bool ``[..., V, M]`` — membership of peer m in view v.
                  All-zero rows are ignored (views list shorter than V).
      self_idx:   int  ``[...]`` — caller's index on the peer axis, or
                  -1 when the caller is not on this peer axis.
      required:   one of REQUIRED_MODES.

    Returns int8 ``[...]`` of MET / UNDECIDED / NACK.  Counts are int32
    (every reduction names its dtype: torch widens a bare int sum to
    int64).
    """
    assert required in REQUIRED_MODES, required
    vm = view_mask.to(torch.int32)                         # [..., V, M]
    members = vm.sum(-1, dtype=torch.int32)                # [..., V]
    n_valid = (vm * valid[..., None, :].to(torch.int32)).sum(
        -1, dtype=torch.int32)
    n_nack = (vm * nack[..., None, :].to(torch.int32)).sum(
        -1, dtype=torch.int32)
    if required == "all":
        thresh = members
    else:
        thresh = members // 2 + 1
    m = view_mask.shape[-1]
    # jax.nn.one_hot(-1) is all zeros; F.one_hot raises on -1, so the
    # self mask is an explicit comparison against arange(M).
    self_oh = (torch.arange(m, device=view_mask.device)
               == self_idx.to(torch.int64)[..., None]).to(torch.int32)
    self_in_view = (vm * self_oh[..., None, :]).sum(-1, dtype=torch.int32)
    heard = n_valid + self_in_view if required != "other" else n_valid
    return resolve_views(heard, n_nack, members, thresh)


def views_to_mask(views: Sequence[Sequence[int]], n_views: int,
                  n_peers: int) -> np.ndarray:
    """Encode a list of views (of peer indices) as a [V, M] bool mask."""
    mask = np.zeros((n_views, n_peers), dtype=bool)
    for i, view in enumerate(views):
        for p in view:
            mask[i, p] = True
    return mask
