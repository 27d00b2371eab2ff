"""The bytes and operations one F1 launch must move and compute.

A frozen copy of the arithmetic of ``cuda_engine.design_bytes`` /
``design_work`` and of ``chip_smoke.f1_bounds`` at the commit that added
the benchmark, so that a later change to the program cannot move its own
yardstick.  ``perfbench/tests/test_perfbench_f1_bytes.py`` holds the copy
equal to the program's functions on CPU-built inputs.

Peaks are NVIDIA's published ones for one H100 SXM at the 700 W limit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

#: HBM3 bandwidth of one H100 SXM (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: int32 operations outside the tensor cores: 132 SMs x 64 lanes x 1.98 GHz
INT32_OPS_PER_S = 132 * 64 * 1.98e9

#: int32 operations of one 16-child fold and of one 4-lane leaf hash
FOLD_OPS = 16 * 4 * 12 + 4 * 19
LEAF_OPS = 4 * 13


def levels(s: int) -> Tuple[list, list]:
    """(sizes, offsets) of the upper levels of an ``s``-leaf width-16
    trie, leafward to root."""
    sizes, n = [], s
    while n > 1:
        n = -(-n // 16)
        sizes.append(n)
    sizes = sizes or [1]
    return sizes, list(np.cumsum([0] + sizes[:-1]))


def n_uppers(s: int) -> int:
    return sum(levels(s)[0])


def design_work(heard: np.ndarray, kind: np.ndarray, slot: np.ndarray,
                committed: np.ndarray, s: int) -> dict:
    """The hashing one launch needs: ``heard [A, M]`` (pads all False),
    ``kind`` / ``slot`` / ``committed [K, A]``.  A round is live when its
    kind is an op (1-4) and its slot valid; every heard replica of a
    staged row gets a verdict per upper node and per slot; each distinct
    written slot's leaf is hashed once per heard replica and each distinct
    node on the written paths refolded once."""
    k, a = kind.shape
    sizes, offs = levels(s)
    u = sum(sizes)
    live = (kind >= 1) & (kind <= 4) & (slot >= 0) & (slot < s)
    done = live & committed.astype(bool)
    n_heard = heard.sum(1)
    staged = live.any(0) if k else np.zeros(a, bool)
    written = np.zeros((a, u), bool)
    slots_written = np.zeros((a, s), bool)
    cols = np.broadcast_to(np.arange(a), (k, a))
    slots_written[cols[done], slot[done]] = True
    for lvl, off in enumerate(offs):
        node = off + np.clip(slot, 0, s - 1) // 16 ** (lvl + 1)
        written[cols[done], node[done]] = True
    verdicts = int((staged * n_heard).sum()) * u
    leaf_verdicts = int((staged * n_heard).sum()) * s
    refolds = int((written.sum(1) * n_heard).sum())
    leaf_writes = int((slots_written.sum(1) * n_heard).sum())
    return {"staged_rows": int(staged.sum()), "live_rounds": int(live.sum()),
            "verdict_folds": verdicts, "refold_folds": refolds,
            "leaf_verdicts": leaf_verdicts, "leaf_writes": leaf_writes,
            "ops": (verdicts * (FOLD_OPS + 4) + refolds * FOLD_OPS
                    + leaf_verdicts * (LEAF_OPS + 4)
                    + leaf_writes * LEAF_OPS)}


def design_bytes(heard: np.ndarray, staged: np.ndarray, wrote: np.ndarray,
                 ballot_changed: np.ndarray, s: int, v: int, k: int,
                 a: int, groups: Optional[int] = None) -> dict:
    """The bytes one launch must move for the ``R`` rows it steps:
    ``heard [R, M]``, ``staged [R]``, ``wrote [R, M]`` (replicas whose
    objects or tree changed), ``ballot_changed [R]``; ``k`` rounds over
    ``a`` columns.  Reads: every stepped row's ballot, view and up masks,
    the replica planes of each heard replica of a staged row, the op and
    election planes.  Writes: each replica that wrote, each changed
    ballot, the result planes and ``won``."""
    m = heard.shape[1]
    u = n_uppers(s)
    replica = 3 * s * 4 + s * 16 + u * 16
    ballot = 2 * m * 4 + 2 * 4
    n_rows = heard.shape[0]
    reads = {"ballot": n_rows * (ballot + v * m + m),
             "replicas": int((heard & staged[:, None]).sum()) * replica,
             "ops": k * a * (5 * 4 + 1) + 5 * a}
    rows = k if groups is None else groups
    writes = {"replicas": int(wrote.sum()) * replica,
              "ballot": int(ballot_changed.sum()) * ballot,
              "results": k * a * (4 + 4 + 8) + rows * a * m + a}
    return {"read": reads, "written": writes,
            "bytes": sum(reads.values()) + sum(writes.values())}


def launch_bound(heard: np.ndarray, wrote: np.ndarray,
                 ballot_changed: np.ndarray, kind: np.ndarray,
                 slot: np.ndarray, committed: np.ndarray, s: int,
                 v: int) -> dict:
    """The least time one launch can take on the card: the larger of its
    bytes over the HBM peak and its design operations over the int32
    peak (``chip_smoke.f1_bounds``).  ``heard`` / ``wrote`` /
    ``ballot_changed`` cover the ``n`` rows stepped (the first ``n``
    columns of the ``[K, A]`` planes; the rest are pads)."""
    k, a = kind.shape
    n, m = heard.shape
    live = (kind >= 1) & (kind <= 4) & (slot >= 0) & (slot < s)
    staged = live[:, :n].any(0) if k else np.zeros(n, bool)
    moved = design_bytes(heard, staged, wrote, ballot_changed, s, v, k, a)
    cols = np.zeros((a, m), bool)
    cols[:n] = heard
    work = design_work(cols, kind, slot, committed, s)
    bytes_s = moved["bytes"] / HBM_BYTES_PER_S
    ops_s = work["ops"] / INT32_OPS_PER_S
    return {"bytes": moved["bytes"], "ops": work["ops"],
            "bytes_s": bytes_s, "ops_s": ops_s,
            "bound_s": max(bytes_s, ops_s)}
