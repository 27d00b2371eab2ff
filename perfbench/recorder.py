"""F1's launches, recorded for its roofline in traced runs only.

:class:`Recorder` wraps the service's engine adapter.  While ``on``, each
step it passes through (``full_step`` or ``full_step_sliced``: one F1
launch on the card) also keeps, on a side stream of its own, the stepped
rows' planes from before the launch, and after it the masks
:func:`perfbench.f1_bytes.launch_bound` needs: the heard replicas, the
replicas and ballots the launch changed, and the op and commit planes.
The side stream's work is not F1's and is left out of the device's busy
time by :mod:`perfbench.trace`, which finds the stream by the marker
kernel :meth:`Recorder.mark` puts on it.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

from perfbench import f1_bytes

_OBJ = ("obj_epoch", "obj_seq", "obj_val", "tree_leaf", "tree_node")
_BALLOT = ("epoch", "fact_seq", "leader", "obj_seq_ctr")


class Recorder:
    """A delegating engine adapter that records F1's launches."""

    def __init__(self, inner: Any) -> None:
        self._inner = inner
        self.on = False
        self.launches: List[dict] = []
        self._side = None

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)

    def side(self):
        if self._side is None:
            self._side = torch.cuda.Stream()
        return self._side

    def mark(self) -> None:
        """A kernel on the side stream that names it in the trace."""
        with torch.cuda.stream(self.side()):
            torch.cuda._sleep(1000)

    def _pre(self, state, rows):
        main = torch.cuda.current_stream()
        side = self.side()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            idx = torch.as_tensor(rows, device=state.epoch.device)
            pre = {f: getattr(state, f).index_select(0, idx)
                   for f in _OBJ + _BALLOT}
        main.wait_stream(side)
        return idx, pre

    def _post(self, state, idx, pre, kind, slot, up, res, n: int) -> None:
        main = torch.cuda.current_stream()
        side = self.side()
        side.wait_stream(main)
        for t in (kind, slot, up, res.committed):
            # made on the main stream, read here: not reused before
            t.record_stream(side)
        with torch.cuda.stream(side):
            r, m = idx.numel(), state.epoch.shape[1]
            wrote = torch.zeros((r, m), dtype=torch.bool, device=idx.device)
            for f in _OBJ:
                post = getattr(state, f).index_select(0, idx)
                wrote |= (post != pre[f]).reshape(r, m, -1).any(2)
            ballot = torch.zeros((r,), dtype=torch.bool, device=idx.device)
            for f in _BALLOT:
                post = getattr(state, f).index_select(0, idx)
                ballot |= (post != pre[f]).reshape(r, -1).any(1)
            heard = (up.index_select(0, idx)
                     & state.view_mask.index_select(0, idx).any(1))
            rec = {"wrote": wrote, "ballot": ballot, "heard": heard,
                   "kind": kind.clone(), "slot": slot.clone(),
                   "committed": res.committed.clone(), "n": n,
                   "s": int(state.obj_val.shape[2]),
                   "v": int(state.view_mask.shape[1])}
            ev = torch.cuda.Event()
            ev.record(side)
        rec["event"] = ev
        self.launches.append(rec)

    def full_step(self, state, elect, cand, kind, slot, val, lease_ok, up,
                  exp_epoch=None, exp_seq=None):
        if not self.on:
            return self._inner.full_step(state, elect, cand, kind, slot,
                                         val, lease_ok, up,
                                         exp_epoch=exp_epoch,
                                         exp_seq=exp_seq)
        rows = np.arange(state.epoch.shape[0])
        idx, pre = self._pre(state, rows)
        out = self._inner.full_step(state, elect, cand, kind, slot, val,
                                    lease_ok, up, exp_epoch=exp_epoch,
                                    exp_seq=exp_seq)
        self._post(out[0], idx, pre, kind, slot, up, out[2], len(rows))
        return out

    def full_step_sliced(self, state, active_idx, elect, cand, kind, slot,
                         val, lease_ok, up, exp_epoch=None, exp_seq=None):
        if not self.on:
            return self._inner.full_step_sliced(
                state, active_idx, elect, cand, kind, slot, val, lease_ok,
                up, exp_epoch=exp_epoch, exp_seq=exp_seq)
        rows = active_idx[active_idx < state.epoch.shape[0]]
        idx, pre = self._pre(state, rows)
        out = self._inner.full_step_sliced(
            state, active_idx, elect, cand, kind, slot, val, lease_ok, up,
            exp_epoch=exp_epoch, exp_seq=exp_seq)
        self._post(out[0], idx, pre, kind, slot, up, out[2], len(rows))
        return out

    def bounds(self) -> List[dict]:
        """Each recorded launch's bound (:func:`f1_bytes.launch_bound`)."""
        out = []
        for rec in self.launches:
            rec["event"].synchronize()
            out.append(f1_bytes.launch_bound(
                rec["heard"].cpu().numpy(), rec["wrote"].cpu().numpy(),
                rec["ballot"].cpu().numpy(), rec["kind"].cpu().numpy(),
                rec["slot"].cpu().numpy(),
                rec["committed"].cpu().numpy(), rec["s"], rec["v"]))
        return out
