"""The port's scalar plane as OS processes: three
``python -m riak_ensemble_tpu_torch.netnode`` processes, one node each,
over TCP on loopback — the mirror of ``tests/test_netcluster.py:146`` and
``:196``.

- enable → join × 2 → a cross-node ensemble → K/V through a leader on
  another process, CAS included;
- once all three replicas answer the leader, kill -9 of the leader-hint
  node's process: the survivors re-elect and keep serving, and the node
  restarted from its data root on its old port rejoins the ensemble;
  every acknowledged write reads back.

The test waits only on readiness lines and on the killed node's port
binding again (at most 10 s), never on fixed sleeps, and each wait has a
limit of its own.  A node script retries an op that timed out and counts
a write as acknowledged only when it answered ``ok``.
"""

import os
import queue
import socket
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COMMON = """
import asyncio, os
from riak_ensemble_tpu_torch.types import PeerId

async def until_ok(op, tries=300, pause=0.2):
    # a timed-out or unavailable op is retried, never taken as done
    r = ("error", "not_started")
    for _ in range(tries):
        r = await op()
        if r[0] == "ok":
            return r
        await asyncio.sleep(pause)
    raise AssertionError(r)

async def wait_file(path, limit=120.0):
    end = asyncio.get_running_loop().time() + limit
    while not os.path.exists(path):
        assert asyncio.get_running_loop().time() < end, path
        await asyncio.sleep(0.05)

async def all_three_answer(node, limit=120.0):
    # every replica answers the leader's commit (count_quorum == 3): a
    # replica whose tree exchange has not finished yet does not vote, so
    # a kill before this leaves the ensemble without a quorum
    end = asyncio.get_running_loop().time() + limit
    n = 0
    while asyncio.get_running_loop().time() < end:
        n = await node.runtime.await_future(
            node.manager.count_quorum("kv", timeout=2.0), 4.0)
        if n >= 3:
            return
        await asyncio.sleep(0.3)
    raise AssertionError(n)

async def cluster_of_three(node):
    assert (await node.enable()) == "ok"
    print("ENABLED", flush=True)
    for _ in range(600):
        if len(node.members()) >= 3:
            break
        await asyncio.sleep(0.1)
    assert len(node.members()) >= 3, node.members()
    print("MEMBERS_OK", flush=True)
    # leader hint on node1: ops from this process route cross-node
    peers = [PeerId(1, "node1"), PeerId(0, "node0"), PeerId(2, "node2")]
    assert (await node.create_ensemble("kv", peers)) == "ok"
"""

NODE0_SCRIPT = COMMON + """
async def main(node):
    await cluster_of_three(node)
    await until_ok(lambda: node.kover("kv", "k", b"v1", timeout=3.0))
    r = await until_ok(lambda: node.kget("kv", "k", timeout=5.0))
    assert r[1].value == b"v1", r
    cur = r[1]
    r = await node.kupdate("kv", "k", cur, b"v2", timeout=5.0)
    while r[0] != "ok":
        # an ambiguous CAS may have landed: read before trying again
        got = await until_ok(lambda: node.kget("kv", "k", timeout=5.0))
        if got[1].value == b"v2":
            break
        r = await node.kupdate("kv", "k", got[1], b"v2", timeout=5.0)
    r = await until_ok(lambda: node.kget("kv", "k", timeout=5.0))
    assert r[1].value == b"v2", r
    print("RESULT_OK", flush=True)
    await asyncio.sleep(120)
"""

NODE0_KILL_SCRIPT = COMMON + """
async def main(node):
    await cluster_of_three(node)
    acked = {}
    for i in range(8):
        key, val = f"k{i}", b"v1-%d" % i
        await until_ok(lambda: node.kover("kv", key, val, timeout=3.0))
        acked[key] = val
    await all_three_answer(node)
    print("WROTE_V1", flush=True)

    # the test kills node1 (the leader hint) and then drops this file:
    # a new leader must emerge from node0 and node2
    await wait_file(os.environ["KILLED_MARK"])
    for i in range(8):
        key, val = f"k{i}", b"v2-%d" % i
        await until_ok(lambda: node.kover("kv", key, val, timeout=2.0),
                       tries=600)
        acked[key] = val
    r = await until_ok(lambda: node.kget("kv", "k0", timeout=5.0))
    assert r[1].value == acked["k0"], r
    print("SURVIVED_KILL", flush=True)

    # node1 restarts from its data root: wait until all three replicas
    # answer, then read every acknowledged write back
    await all_three_answer(node, limit=180.0)
    for key, val in acked.items():
        r = await until_ok(lambda: node.kget("kv", key, timeout=5.0))
        assert r[1].value == val, (key, r)
    print("RESULT_OK", len(acked), flush=True)
    await asyncio.sleep(120)
"""

JOINER_SCRIPT = """
import asyncio

async def main(node):
    r = None
    for _ in range(600):
        r = await node.join("node0", timeout=10.0)
        if r == "ok":
            break
        await asyncio.sleep(0.3)
    assert r == "ok", r
    print("JOINED", flush=True)
    await asyncio.sleep(300)
"""

IDLE_SCRIPT = """
import asyncio

async def main(node):
    print("UP", flush=True)
    await asyncio.sleep(300)
"""


def _free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        socks.append(s)
    for s in socks:
        s.close()
    return ports


def _port_free(port, wait=10.0):
    """Wait until ``port`` binds again (as the restarted node's listener
    will, with ``SO_REUSEADDR``), for at most ``wait`` seconds."""
    end = time.monotonic() + wait
    while True:
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("127.0.0.1", port))
            return
        except OSError:
            assert time.monotonic() < end, f"port {port} stayed taken"
            time.sleep(0.05)
        finally:
            s.close()


class Nodes:
    """The three node processes, with a reader thread per process that
    files its lines in a queue."""

    def __init__(self, tmp_path, scripts, extra_env=None):
        self.tmp = tmp_path
        ports = _free_ports(3)
        self.ports = {f"node{i}": p for i, p in enumerate(ports)}
        self.peer_args = []
        for name, p in self.ports.items():
            self.peer_args += ["--peer", f"{name}=127.0.0.1:{p}"]
        self.scripts = {}
        for name, body in scripts.items():
            path = tmp_path / f"{name}_script.py"
            path.write_text(body)
            self.scripts[name] = str(path)
        self.env = dict(os.environ, **(extra_env or {}))
        self.env["PYTHONPATH"] = ROOT + os.pathsep + self.env.get(
            "PYTHONPATH", "")
        self.procs, self.lines = [], {}

    def spawn(self, node, script):
        p = subprocess.Popen(
            [sys.executable, "-m", "riak_ensemble_tpu_torch.netnode",
             "--node", node, *self.peer_args, "--fast",
             "--data-root", str(self.tmp / node),
             "--script", self.scripts[script]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=self.env, cwd=ROOT)
        self.procs.append(p)
        q = self.lines[node] = queue.Queue()
        seen = []

        def reader():
            for line in p.stdout:
                seen.append(line.rstrip())
                q.put(line.rstrip())
            q.put(None)
        threading.Thread(target=reader, daemon=True).start()
        q.seen = seen
        return p

    def wait_line(self, node, mark, limit):
        q = self.lines[node]
        end = time.monotonic() + limit
        while True:
            try:
                line = q.get(timeout=max(0.0, end - time.monotonic()))
            except queue.Empty:
                line = None
            if line is None:
                raise AssertionError(f"{node} never printed {mark} in "
                                     f"{limit} s: {q.seen[-40:]!r}")
            if line.startswith(mark):
                return line

    def stop(self):
        for p in self.procs:
            p.kill()
        for p in self.procs:
            p.wait(timeout=10)


def test_three_process_cluster(tmp_path):
    nodes = Nodes(tmp_path, {"node0": NODE0_SCRIPT, "join": JOINER_SCRIPT})
    try:
        nodes.spawn("node0", "node0")
        nodes.spawn("node1", "join")
        nodes.spawn("node2", "join")
        nodes.wait_line("node0", "ENABLED", 60)
        nodes.wait_line("node0", "MEMBERS_OK", 90)
        nodes.wait_line("node0", "RESULT_OK", 120)
    finally:
        nodes.stop()


def test_process_kill_and_restart(tmp_path):
    """Kill the leader-hint node's process: the survivors re-elect and
    keep serving; the process restarted on its old port reloads its
    persisted state and rejoins; every acknowledged write reads back."""
    killed = tmp_path / "killed"
    nodes = Nodes(tmp_path, {"node0": NODE0_KILL_SCRIPT,
                             "join": JOINER_SCRIPT, "idle": IDLE_SCRIPT},
                  {"KILLED_MARK": str(killed)})
    try:
        nodes.spawn("node0", "node0")
        victim = nodes.spawn("node1", "join")
        nodes.spawn("node2", "join")
        nodes.wait_line("node0", "WROTE_V1", 120)
        victim.kill()
        victim.wait(timeout=10)
        killed.write_text("")
        nodes.wait_line("node0", "SURVIVED_KILL", 120)
        _port_free(nodes.ports["node1"])
        nodes.spawn("node1", "idle")
        nodes.wait_line("node1", "UP", 60)
        line = nodes.wait_line("node0", "RESULT_OK", 120)
        assert line.split()[1] == "8"
    finally:
        nodes.stop()
