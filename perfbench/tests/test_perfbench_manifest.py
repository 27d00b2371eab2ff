"""The manifest, discovery by name, and what the benchmark may import."""

import ast
import hashlib
import json
import os
import shutil

import pytest

from perfbench import harness

ROOT = harness.ROOT
BENCH = os.path.join(ROOT, "perfbench")
#: top-level names the benchmark must never import
FORBIDDEN = {"jax", "jaxlib", "flax", "riak_ensemble_tpu"}
PORT = "riak_ensemble_tpu_torch"


def test_every_entry_resolves_by_name():
    man = harness.manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    for wl in man["workloads"]:
        assert harness.workload(man, wl["name"]) is wl
        cfg = harness.config(man, wl["config"])
        assert cfg["name"] == wl["config"]
        assert harness.mix(wl["traffic"])["clients"] > 0
        for traced in (False, True):
            ms = harness.cell_metrics(man, wl["name"], traced)
            assert ms, (wl["name"], traced)
            for m in ms:
                assert callable(harness.metric_reader(m["name"]))
        e2e = {m["name"] for m in harness.cell_metrics(man, wl["name"],
                                                       False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        for m in harness.cell_metrics(man, wl["name"], True):
            assert m["moves"] in e2e, (wl["name"], m["name"])
    with pytest.raises(KeyError):
        harness.workload(man, "no_such_cell")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            out.add(node.module.split(".")[0])
    return out


def _sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = _imports(path) & FORBIDDEN
        assert not bad, (path, bad)


@pytest.mark.parametrize("name", ["reference.py", "control.py", "zipf.py",
                                  "traffic.py", "f1_bytes.py", "trace.py"])
def test_the_yardstick_imports_nothing_of_the_port(name):
    assert PORT not in _imports(os.path.join(BENCH, name))


def _digest(path):
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def test_a_new_config_mix_and_metric_need_only_new_files(tmp_path):
    root = str(tmp_path)
    shutil.copytree(BENCH, os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = {p: _digest(p) for p in _walk(root)
              if not p.endswith("BENCHMARK.json")}
    base = json.load(open(os.path.join(BENCH, "configs",
                                       "riak_sc_mem.json")))
    base.update({"name": "tiny_kv", "n_ens": 8, "n_slots": 24,
                 "record_count": 96})
    json.dump(base, open(os.path.join(root, "perfbench", "configs",
                                      "tiny_kv.json"), "w"))
    json.dump({"clients": 8, "read_share": 0.25},
              open(os.path.join(root, "perfbench", "traffic",
                                "tiny_mix.json"), "w"))
    with open(os.path.join(root, "perfbench", "metrics",
                           "acked_per_request.py"), "w") as f:
        f.write("def read(run):\n"
                "    n = len(run.latency_s)\n"
                "    return run.acked / n if n else None\n")
    man = json.load(open(os.path.join(root, "BENCHMARK.json")))
    man["configs"].append({"name": "tiny_kv", "source": "test",
                           "file": "perfbench/configs/tiny_kv.json",
                           "reduced": [], "why": "test"})
    man["workloads"].append({"name": "tiny_kv.tiny_mix", "config": "tiny_kv",
                             "traffic": "tiny_mix", "chips": 1,
                             "why": "test"})
    man["per_layer"].append({"name": "acked_per_request", "unit": "ops",
                             "better": "higher", "source": "host_clock",
                             "layer": "client to queue",
                             "moves": "ops_per_s",
                             "workloads": ["tiny_kv.tiny_mix"]})
    json.dump(man, open(os.path.join(root, "BENCHMARK.json"), "w"))

    res = harness.run_cell("tiny_kv.tiny_mix", 3, 0.5, True, root=root,
                           device="cpu")
    assert res["correct"] is True
    assert res["metrics"]["acked_per_request"]["value"] == 1.0
    after = {p: _digest(p) for p in before}
    assert after == before


def _walk(root):
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            yield os.path.join(d, f)
