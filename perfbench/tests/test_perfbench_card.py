"""One cell for a few seconds on a card, as the driver runs it."""

import json
import os
import subprocess
import sys

import pytest

from perfbench import harness


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark runs on the card only")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "riak_sc_mem.ycsb_b", "--seed", str(2 ** 31 + 77),
         "--seconds", "3", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=360,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {"ops_per_s", "ack_p99_ms", "setup_s"}


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "riak_sc_mem.ycsb_a", "--seed", "1", "--seconds", "1"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
