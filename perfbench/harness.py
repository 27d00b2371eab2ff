"""The harness: one cell of ``BENCHMARK.json``, from set-up to result line.

A cell names a configuration and a traffic mix; the harness finds each by
name (:func:`config`, :func:`mix`, :func:`metric_reader`), builds the
system on the configuration's shape, loads every record (YCSB's load
phase), warms every launch shape, runs ``WARM_SWEEPS`` closed-loop
sweeps, and then measures for ``seconds``: every client keeps one request
outstanding, a sweep submits the requests of the clients that are ready,
and one ``flush()`` follows each sweep.  After the window it drains what
is still in flight, reads the device's memory peak, and decides
``correct`` by the plain reference (:mod:`perfbench.reference`) on the
ensembles the seed samples.
"""

from __future__ import annotations

import array
import contextlib
import gc
import importlib.util
import json
import os
import resource
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from perfbench import reference as ref
from perfbench import trace as tr
from perfbench.traffic import KeySpace, Traffic, value

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: how long past the window's close the drain waits for answers
DRAIN_S = 60.0
#: closed-loop sweeps in set-up, after the load and the warm-up
WARM_SWEEPS = 20
#: top-level module names that must not be loaded (the JAX stack and the
#: JAX package the port was made from)
FORBIDDEN = ("jax", "jaxlib", "flax", "riak_ensemble_tpu")


# -- finding the pieces by name ----------------------------------------------

def manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _entry(items: List[dict], name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(man: dict, name: str) -> dict:
    return _entry(man["workloads"], name, "workload")


def config(man: dict, name: str, root: str = ROOT) -> dict:
    ent = _entry(man["configs"], name, "configuration")
    with open(os.path.join(root, ent["file"])) as f:
        return json.load(f)


def mix(name: str, root: str = ROOT) -> dict:
    with open(os.path.join(root, "perfbench", "traffic", f"{name}.json")) as f:
        return json.load(f)


def metric_reader(name: str, root: str = ROOT) -> Callable[[Any], Any]:
    """The ``read(run)`` function of ``metrics/<name>.py``.  A quantity
    split by the end-to-end metric it moves in each cell
    (``<quantity>.<part>``) is read by ``metrics/<quantity>.py`` unless
    the part has a file of its own."""
    path = os.path.join(root, "perfbench", "metrics", f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(root, "perfbench", "metrics",
                            name.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(man: dict, cell: str, traced: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with a trace its per-layer ones (those without ``workloads`` are in
    every cell)."""
    group = man["per_layer"] if traced else man["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


# -- one run ------------------------------------------------------------

class Run:
    """What a run measured; the metric readers read it."""

    def __init__(self) -> None:
        self.setup_s = 0.0
        self.window_s = 0.0
        self.attempted = 0
        self.acked = 0
        self.failed = 0
        self.latency_s = np.zeros(0)
        self.submit_s = 0.0
        self.submit_ops = 0
        self.lat_records: List[Dict[str, float]] = []
        self.stats0: Dict[str, Any] = {}
        self.stats1: Dict[str, Any] = {}
        self.gc_pause_s = 0.0
        self.trace: Optional[dict] = None
        self.f1: Optional[List[dict]] = None


class _Req:
    __slots__ = ("client", "t_sub")

    def __init__(self, client: int, t_sub: float) -> None:
        self.client, self.t_sub = client, t_sub


def _tmp_root() -> str:
    return os.environ.get("TMPDIR") or tempfile.gettempdir()


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(cell: str, seed: int, seconds: float, traced: bool, *,
             root: str = ROOT, device: str = "cuda",
             t_process: Optional[float] = None,
             system_factory: Optional[Callable[..., Any]] = None,
             engine_wrap: Optional[Callable[[Any], Any]] = None,
             overrides: Optional[dict] = None) -> dict:
    """Run one cell; returns the result line's object (``checks`` last).

    ``system_factory(cfg, device)`` replaces the port (the control); ``engine_wrap`` routes the port's launches through a
    wrapper (the planted faults); ``overrides`` (``{"config": {...},
    "traffic": {...}}``) shrink the cell for the CPU tests."""
    t_process = time.monotonic() if t_process is None else t_process
    man = manifest(root)
    wl = workload(man, cell)
    cfg = dict(config(man, wl["config"], root))
    mx = dict(mix(wl["traffic"], root))
    if overrides:
        cfg.update(overrides.get("config", {}))
        mx.update(overrides.get("traffic", {}))
    keys = KeySpace(cfg)
    traffic = Traffic(mx, keys, seed)
    names = keys.names
    tails = keys.tails(seed)
    import torch

    on_card = device.startswith("cuda")
    if system_factory is None:
        from perfbench.system import PortSystem
        system_factory = PortSystem
    system = system_factory(cfg, device)
    if engine_wrap is not None:
        system.wrap_engine(engine_wrap)
    recorder = None
    if traced and on_card:
        from perfbench.recorder import Recorder

        def record(engine):
            nonlocal recorder
            recorder = Recorder(engine)
            return recorder
        system.wrap_engine(record)
    run = Run()
    sample = set(traffic.sample_ensembles().tolist())
    history: Dict[int, List[tuple]] = {e: [] for e in sample}

    # -- set-up: the load phase, then the cell's launch shapes ---------------
    load_vals = traffic.load_values()
    load_futs = []
    for e in range(keys.n_ens):
        recs = keys.records_of(e)
        if not recs.size:
            continue
        ks = [names[r] for r in recs.tolist()]
        vs = [value(tails, r, 0, t)
              for r, t in zip(recs.tolist(), load_vals[recs].tolist())]
        fut = system.put(e, ks, vs)
        load_futs.append(fut)
        if e in sample:
            _keep(history[e], ref.PUT, ks, vs, fut)
    _drain(system, lambda: all(f.done for f in load_futs), DRAIN_S)
    if hasattr(system, "warmup"):
        system.warmup()

    # -- the closed loop ---------------------------------------------------
    n_clients = traffic.clients
    next_n = [0] * n_clients
    ready: List[int] = list(range(n_clients))
    lat = array.array("d")
    t_done = array.array("d")
    acked_n = array.array("q")
    state = {"outstanding": 0, "submit_s": 0.0, "submit_ops": 0}
    PUT, GET = ref.PUT, ref.GET

    def finish(rq: _Req, acked: int) -> None:
        t = time.perf_counter()
        lat.append(t - rq.t_sub)
        t_done.append(t)
        acked_n.append(acked)
        state["outstanding"] -= 1
        ready.append(rq.client)

    def waiter(rq: _Req):
        def w(res) -> None:
            finish(rq, int(isinstance(res, list) and ref.ok(res[0])))
        return w

    def submit(c: int) -> None:
        n = next_n[c]
        next_n[c] = n + 1
        e, rec, read, tail, serial = traffic.request(c, n)
        ks = [names[rec]]
        rq = _Req(c, time.perf_counter())
        state["outstanding"] += 1
        if read:
            t0 = time.perf_counter()
            fut = system.get(e, ks)
            state["submit_s"] += time.perf_counter() - t0
            if e in sample:
                _keep(history[e], GET, ks, None, fut)
        else:
            vs = [value(tails, rec, serial, tail)]
            t0 = time.perf_counter()
            fut = system.put(e, ks, vs)
            state["submit_s"] += time.perf_counter() - t0
            if e in sample:
                _keep(history[e], PUT, ks, vs, fut)
        state["submit_ops"] += 1
        fut.add_waiter(waiter(rq))

    def phase(name: str):
        if traced and on_card:
            return torch.autograd.profiler.record_function(tr.PREFIX + name)
        return contextlib.nullcontext()

    def sweep() -> None:
        nonlocal ready
        cur, ready = ready, []
        with phase("submit"):
            for c in cur:
                submit(c)
        with phase("flush"):
            system.flush()

    for _ in range(WARM_SWEEPS):
        sweep()
    lat_n0 = len(lat)
    state["submit_s"] = 0.0
    state["submit_ops"] = 0

    gc_state = {"t": 0.0, "on": False, "pause": 0.0, "gen": [0, 0, 0]}

    def gc_cb(ph: str, info: dict) -> None:
        if not gc_state["on"]:
            return
        if ph == "start":
            gc_state["t"] = time.perf_counter()
        else:
            gc_state["pause"] += time.perf_counter() - gc_state["t"]
            gc_state["gen"][info["generation"]] += 1

    # every window starts from the same collector state: set-up's garbage
    # is collected in set-up, not in the first flushes of the window
    gc.collect()
    gc.callbacks.append(gc_cb)
    if on_card:
        torch.cuda.synchronize()
    system.new_lat_records()
    run.stats0 = system.stats()
    prof = None
    if traced and on_card:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
        recorder.mark()
        recorder.on = True
    recs: List[Dict[str, float]] = []
    t_start = time.perf_counter()
    run.setup_s = time.monotonic() - t_process
    t_end = t_start + seconds
    gc_state["on"] = True
    try:
        with phase("window"):
            while time.perf_counter() < t_end:
                sweep()
                recs.extend(system.new_lat_records())
    finally:
        gc_state["on"] = False
        gc.callbacks.remove(gc_cb)
    t_close = time.perf_counter()
    if prof is not None:
        recorder.on = False
        torch.cuda.synchronize()
        prof.__exit__(None, None, None)
    run.stats1 = system.stats()
    run.lat_records = recs
    run.gc_pause_s = gc_state["pause"]
    run.submit_s, run.submit_ops = state["submit_s"], state["submit_ops"]

    # -- drain: every answer due in the window, a minute past close at most --
    _drain(system, lambda: state["outstanding"] == 0, DRAIN_S)
    unanswered_reqs = state["outstanding"]

    lat_a = np.frombuffer(lat, dtype=np.float64)[lat_n0:]
    done_a = np.frombuffer(t_done, dtype=np.float64)[lat_n0:]
    acked_a = np.frombuffer(acked_n, dtype=np.int64)[lat_n0:]
    # the window runs from the first timed submit to the end of the sweep
    # in which the clock passed ``seconds``: a closed loop's answers land
    # in bursts at the end of each flush, so a cut at ``seconds`` itself
    # would count whole flushes or none
    inwin = done_a <= t_close
    run.window_s = t_close - t_start
    run.latency_s = lat_a[inwin]
    run.acked = int(acked_a[inwin].sum())
    run.attempted = int(inwin.sum())
    run.failed = run.attempted - run.acked
    n_fl = run.stats1["flushes"] - run.stats0["flushes"]
    _log(f"perfbench: host: {n_fl} flushes, {gc_state['pause']:.6f} s in "
         f"collections {gc_state['gen']} (by generation), cpu MHz "
         f"{_cpu_mhz():.0f}")
    _log(f"perfbench: {cell} seed {seed}: window {run.window_s:.6f} s "
         f"({seconds} s asked), {len(run.latency_s)} requests completed in "
         f"it, {run.attempted} ops, {run.acked} acked; {unanswered_reqs} "
         f"requests unanswered after the drain")
    if len(run.latency_s):
        _log(f"perfbench: ack p99 {np.percentile(run.latency_s, 99) * 1e3}"
             f" ms over {len(run.latency_s)} requests")

    mem_peak = (int(torch.cuda.max_memory_allocated()) if on_card else 0)
    _log(f"perfbench: memory peak: device {mem_peak} B, host "
         f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024} B "
         f"(resident)")
    if prof is not None:
        run.trace = _reduce_profile(prof)
        run.f1 = recorder.bounds()

    # -- correct: the reference on the sampled ensembles ----------------------
    checks = _check(system, history, cfg)

    metrics: Dict[str, dict] = {}
    for m in cell_metrics(man, cell, traced):
        val = metric_reader(m["name"], root)(run)
        if val is None:
            _log(f"perfbench: metric {m['name']} found nothing to read")
            continue
        metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
    found = sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))
    if found:
        raise ForbiddenModules(found)
    result = {"correct": all(v["value"] <= v["limit"]
                             for v in checks.values()),
              "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics,
              "device": _device(on_card, mem_peak, run.trace)}
    if run.trace is not None:
        result["breakdown"] = tr.breakdown(run.trace)
    result["checks"] = checks
    return result


class ForbiddenModules(RuntimeError):
    """A module of the JAX stack or the JAX package was loaded."""

    def __init__(self, found: List[str]) -> None:
        super().__init__("loaded: " + ", ".join(found))
        self.found = found


def _cpu_mhz() -> float:
    """The host cores' mean clock as the kernel reports it (0: unknown)."""
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f
                   if line.startswith("cpu MHz")]
    except (OSError, ValueError, IndexError):
        return 0.0
    return sum(mhz) / len(mhz) if mhz else 0.0


def _keep(hist: List[tuple], kind: int, keys: List[Any],
          values: Optional[List[Any]], fut) -> None:
    """Note a sampled op batch in submit order; its answer fills the entry
    when it resolves.  Entries are tuples of atomic values, which the
    garbage collector stops tracking, so the sample does not lengthen the
    program's collections."""
    i = len(hist)
    keys_t = tuple(keys)
    vals_t = None if values is None else tuple(values)
    hist.append((kind, keys_t, vals_t, None))

    def answered(res) -> None:
        hist[i] = (kind, keys_t, vals_t,
                   tuple(res) if isinstance(res, list) else res)
    fut.add_waiter(answered)


def _drain(system, done: Callable[[], bool], limit_s: float) -> None:
    t_stop = time.perf_counter() + limit_s
    while not done() and time.perf_counter() < t_stop:
        system.flush()


def _reduce_profile(prof) -> Optional[dict]:
    fd, path = tempfile.mkstemp(prefix="perfbench-trace-", suffix=".json",
                                dir=_tmp_root())
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    return tr.reduce(events)


def _device(on_card: bool, mem_peak: int, red: Optional[dict]) -> dict:
    if on_card:
        import torch
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": 1, "memory_peak_bytes": mem_peak}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    if red is not None:
        dev["busy_s"] = red["busy_s"]
        dev["window_s"] = red["window_s"]
    return dev


def _check(system, history: Dict[int, List[tuple]], cfg: dict) -> dict:
    """The numbers compared, each with its limit: every sampled answer
    against the reference, and the final state read back through the
    service and from a quorum of device replicas."""
    t0 = time.perf_counter()
    tally = ref.Tally()
    models: Dict[int, ref.Ensemble] = {}
    for e, hist in sorted(history.items()):
        models[e] = ref.replay(hist, tally)
    quorum = int(cfg["quorum"])
    rows = np.array(sorted(models), dtype=np.int64)
    keys_of = {e: list(m.kv) for e, m in models.items()}
    checks = {k: {"value": v, "limit": 0} for k, v in tally.as_dict().items()}
    t2 = time.perf_counter()
    checks["readback_mismatch"] = {
        "value": _read_back(system, keys_of, models), "limit": 0}
    t3 = time.perf_counter()
    held = system.replicas(rows, keys_of)
    checks["replica_short"] = {
        "value": sum(ref.replica_short(models[e], held[e], quorum)
                     for e in models), "limit": 0}
    system.close()
    _log(f"perfbench: check: replay {t2 - t0:.3f} s, read back "
         f"{t3 - t2:.3f} s, replicas "
         f"{time.perf_counter() - t3:.3f} s")
    _log(f"perfbench: compared {tally.compared} answers on "
         f"{len(models)} ensembles, {sum(len(v) for v in keys_of.values())} "
         f"keys read back")
    return checks


def _read_back(system, keys_of: Dict[int, List[Any]],
               models: Dict[int, ref.Ensemble]) -> int:
    futs = {e: system.get(e, ks) for e, ks in keys_of.items() if ks}
    _drain(system, lambda: all(f.done for f in futs.values()), DRAIN_S)
    return sum(ref.compare_reads(models[e], keys_of[e],
                                 f.value if f.done else None)
               for e, f in futs.items())
