"""The metric readers' arithmetic on canned records, counters and
profiler events."""

import numpy as np
import pytest

from perfbench import harness
from perfbench import trace as tr


def read(name, run):
    return harness.metric_reader(name)(run)


def canned_run():
    run = harness.Run()
    run.window_s = 2.0
    run.acked = 900
    run.latency_s = np.linspace(0.001, 0.100, 100)
    run.setup_s = 12.5
    run.submit_s, run.submit_ops = 0.003, 1_000
    run.lat_records = [
        {"h2d": 0.001, "dispatch": 0.002, "unpack": 0.010, "resolve": 0.020,
         "wal": 0.004},
        {"h2d": 0.003, "dispatch": 0.002, "unpack": 0.030, "resolve": 0.000,
         "wal": 0.006},
        {"svc_compaction": 0.5},
    ]
    run.stats0 = {"flushes": 10, "grid_occupancy": 1.0,
                  "read_fastpath_hits": 5, "read_fastpath_misses": 5}
    run.stats1 = {"flushes": 20, "grid_occupancy": 0.75,
                  "read_fastpath_hits": 35, "read_fastpath_misses": 15}
    run.gc_pause_s = 0.1
    return run


def test_end_to_end_readers():
    run = canned_run()
    assert read("ops_per_s", run) == 450.0
    assert read("ack_p99_ms", run) == pytest.approx(
        np.percentile(run.latency_s, 99) * 1e3)
    # a quantity split by cell is read by the quantity's one reader
    assert read("ack_p99_ms.host", run) == read("ack_p99_ms", run)
    assert read("setup_s", run) == 12.5


def test_program_span_and_counter_readers():
    run = canned_run()
    assert read("submit_us_per_op", run) == pytest.approx(3.0)
    assert read("enqueue_ms", run) == pytest.approx(4.0)
    assert read("settle_ms", run) == pytest.approx(30.0)
    # 10 launches at 1.0, then 10 more bring the mean to 0.75
    assert read("grid_occupancy_pct", run) == pytest.approx(50.0)
    assert read("fast_read_hit_pct", run) == pytest.approx(75.0)
    assert read("gc_pause_ms_per_s", run) == pytest.approx(50.0)
    assert read("gc_pause_ms_per_s.ops", run) == pytest.approx(50.0)


def test_readers_find_nothing_in_an_empty_run():
    run = harness.Run()
    run.stats0 = run.stats1 = {"flushes": 3, "grid_occupancy": 1.0,
                               "read_fastpath_hits": 0,
                               "read_fastpath_misses": 0}
    for name in ("ack_p99_ms.host", "submit_us_per_op", "enqueue_ms",
                 "settle_ms", "grid_occupancy_pct", "fast_read_hit_pct",
                 "f1_roofline", "device_idle_pct"):
        assert read(name, run) is None, name


def _ev(name, cat, ts, dur, stream=None):
    e = {"name": name, "ph": "X", "cat": cat, "ts": ts, "dur": dur}
    if stream is not None:
        e["args"] = {"stream": stream}
    return e


EVENTS = [
    _ev(tr.WINDOW, "user_annotation", 0, 1000),
    _ev("perfbench.submit", "user_annotation", 0, 400),
    _ev("perfbench.flush", "user_annotation", 400, 600),
    _ev("void engine_step_kernel<false>(Params)", "kernel", 450, 50, 7),
    _ev("void engine_step_kernel<false>(Params)", "kernel", 700, 50, 7),
    _ev("Memcpy DtoH", "gpu_memcpy", 480, 40, 9),
    # the recorder's side stream: its marker names it, and it is left out
    _ev("spin_kernel", "kernel", 500, 5, 13),
    _ev("reduce_kernel", "kernel", 510, 100, 13),
    # outside the window: clipped away
    _ev("late", "kernel", 1200, 50, 7),
]


def test_trace_reduction():
    red = tr.reduce(EVENTS)
    assert red["window_s"] == pytest.approx(1e-3)
    # 450-520 and 700-750
    assert red["busy_s"] == pytest.approx(120e-6)
    assert tr.kernel_time(red, tr.F1_KERNEL) == (pytest.approx(100e-6), 2)
    assert red["idle_by_phase"]["submit"] == pytest.approx(400e-6)
    assert red["idle_by_phase"]["flush"] == pytest.approx(480e-6)
    b = tr.breakdown(red)
    assert b["device_ops"][0][0].startswith("void engine_step_kernel")
    assert b["idle_gaps"][0][0] == "flush"


def test_device_readers_on_the_reduced_trace():
    run = harness.Run()
    run.trace = tr.reduce(EVENTS)
    assert read("device_idle_pct", run) == pytest.approx(88.0)
    run.f1 = [{"bound_s": 20e-6}, {"bound_s": 30e-6}]
    assert read("f1_roofline", run) == pytest.approx(50.0)
    run.f1 = run.f1[:1]          # a launch the recorder missed: nothing
    assert read("f1_roofline", run) is None


def test_no_window_no_reduction():
    assert tr.reduce([e for e in EVENTS if e["name"] != tr.WINDOW]) is None
