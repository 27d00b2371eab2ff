"""The reduction of a ``torch.profiler`` trace to device numbers.

Input: the ``traceEvents`` of the profiler's Chrome-trace export over the
measured window.  The window is the span of the harness's
``perfbench.window`` annotation; the device's operations are its kernel,
copy and set events, less those on the side stream the F1 recorder uses
(the stream of its marker kernel, ``MARKER``).  Busy time is the union of
those operations' intervals inside the window; idle time is split over
the harness annotations (``perfbench.<phase>``) the host was inside.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "perfbench.window"
PREFIX = "perfbench."
MARKER = "spin_kernel"
#: F1's kernel in ``csrc/engine_step.cu``
F1_KERNEL = "engine_step_kernel"


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce(events: List[dict]) -> Optional[dict]:
    """Busy and window seconds, device time by kernel name, idle gaps by
    host phase; None when the trace has no window or no device event."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("ph") == "X" and "gpu" not in e.get("cat", "")]
    if not win:
        return None
    t0 = float(win[0]["ts"])
    t1 = t0 + float(win[0]["dur"])
    side = {e.get("args", {}).get("stream") for e in events
            if e.get("cat") == "kernel" and MARKER in e.get("name", "")}
    side.discard(None)
    dev, by_name = [], {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
            continue
        if e.get("args", {}).get("stream") in side:
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        dev.append((a, b))
        name = e.get("name", "?")
        s, n = by_name.get(name, (0.0, 0))
        by_name[name] = (s + (b - a) * 1e-6, n + 1)
    if not dev:
        return None
    busy = _merge(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   e["name"][len(PREFIX):]) for e in events
                  if e.get("ph") == "X" and "gpu" not in e.get("cat", "")
                  and e.get("name", "").startswith(PREFIX)
                  and e.get("name") != WINDOW)
    gaps: List[Tuple[float, float]] = []
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    for i in range(0, len(edges), 2):
        if edges[i + 1] > edges[i]:
            gaps.append((edges[i], edges[i + 1]))
    by_phase = _idle_by_phase(gaps, host)
    return {"busy_s": busy_s, "window_s": (t1 - t0) * 1e-6,
            "kernels": by_name, "idle_by_phase": by_phase}


def _idle_by_phase(gaps: List[Tuple[float, float]],
                   host: List[Tuple[float, float, str]]) -> Dict[str, float]:
    """Idle seconds split over the host phases each gap overlaps (the
    part no phase covers: ``other``).  Phases do not nest."""
    out: Dict[str, float] = {}
    j = 0
    for a, b in gaps:
        covered = 0.0
        while j < len(host) and host[j][1] <= a:
            j += 1
        i = j
        while i < len(host) and host[i][0] < b:
            ov = min(b, host[i][1]) - max(a, host[i][0])
            if ov > 0:
                out[host[i][2]] = out.get(host[i][2], 0.0) + ov * 1e-6
                covered += ov
            i += 1
        rest = (b - a) - covered
        if rest > 0:
            out["other"] = out.get("other", 0.0) + rest * 1e-6
    return out


def kernel_time(red: dict, name: str) -> Tuple[float, int]:
    """Device seconds and launches of the kernels whose name holds
    ``name``."""
    s, n = 0.0, 0
    for k, (t, c) in red["kernels"].items():
        if name in k:
            s += t
            n += c
    return s, n


def breakdown(red: dict) -> dict:
    """The result line's ``breakdown``: the ten device operations that
    took most time and the idle time by host phase, longest first."""
    ops = sorted(((k[:200], t) for k, (t, _n) in red["kernels"].items()),
                 key=lambda x: -x[1])[:10]
    gaps = sorted(red["idle_by_phase"].items(), key=lambda x: -x[1])[:10]
    return {"device_ops": [[k, t] for k, t in ops],
            "idle_gaps": [[k, t] for k, t in gaps]}
