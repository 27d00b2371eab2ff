"""One-node process entry for real (multi-process) deployments.

Copied from ``riak_ensemble_tpu/netnode.py`` with its imports pointed at
this package, so the port imports nothing of the JAX package.  It runs
the scalar plane only and touches no device.

Each OS process runs this module for one node: it brings up the
networked runtime (:mod:`riak_ensemble_tpu_torch.netruntime`), the node's
stack (storage → manager → routers, the sup-tree order), and either
idles as a cluster member or executes a user script — an async
function ``main(node)`` — for orchestration (tests, operational
one-shots).

    python -m riak_ensemble_tpu_torch.netnode --node node0 \
        --peer node0=127.0.0.1:7501 --peer node1=127.0.0.1:7502 \
        --fast --script bring_up.py

The :class:`AsyncNode` handle exposes awaitable versions of the public
surface: enable/join/remove/create_ensemble and the client K/V API.
"""

from __future__ import annotations

import argparse
import asyncio
import sys
from typing import Any, Dict, Optional, Sequence, Tuple

from riak_ensemble_tpu_torch import funref
from riak_ensemble_tpu_torch import router as routerlib
from riak_ensemble_tpu_torch.client import translate
from riak_ensemble_tpu_torch.config import Config, fast_test_config
from riak_ensemble_tpu_torch.manager import Manager
from riak_ensemble_tpu_torch.netruntime import NetRuntime
from riak_ensemble_tpu_torch.storage import Storage
from riak_ensemble_tpu_torch.types import NOTFOUND, Obj, PeerId


class AsyncNode:
    def __init__(self, runtime: NetRuntime, manager: Manager,
                 storage: Storage) -> None:
        self.runtime = runtime
        self.manager = manager
        self.storage = storage
        self.node = runtime.node

    # -- cluster ops -------------------------------------------------------

    async def enable(self, wait: float = 60.0) -> str:
        result = self.manager.enable()
        if result != "ok":
            return result
        deadline = self.runtime.now + wait
        while self.runtime.now < deadline:
            peer = self.manager.local_peers.get(
                ("root", PeerId("root", self.node)))
            if peer is not None and peer.fsm_state == "leading":
                return "ok"
            await asyncio.sleep(0.05)
        return "timeout"

    async def join(self, other_node: str, timeout: float = 60.0):
        return await self.runtime.await_future(
            self.manager.join_async(other_node, timeout), timeout + 5.0)

    async def remove(self, target: str, timeout: float = 60.0):
        return await self.runtime.await_future(
            self.manager.remove_async(target, timeout), timeout + 5.0)

    async def create_ensemble(self, ensemble: Any,
                              peers: Sequence[PeerId], mod: str = "basic",
                              args=(), timeout: float = 30.0):
        leader = peers[0] if peers else None
        return await self.runtime.await_future(
            self.manager.create_ensemble(ensemble, leader, list(peers),
                                         mod, tuple(args), timeout),
            timeout + 5.0)

    def members(self) -> Sequence[str]:
        return self.manager.cluster()

    # -- async client (client.erl surface) ----------------------------------

    async def _sync(self, ensemble, event, timeout: float):
        if not self.manager.enabled():
            return ("error", "unavailable")
        fut = routerlib.sync_send_event_fut(self.runtime, self.node,
                                            ensemble, event, timeout)
        try:
            result = await self.runtime.await_future(fut, timeout + 2.0)
        except asyncio.TimeoutError:
            result = "timeout"
        return translate(result)

    async def kget(self, ensemble, key, timeout: float = 10.0, opts=()):
        return await self._sync(ensemble, ("get", key, tuple(opts)),
                                timeout)

    async def kover(self, ensemble, key, value, timeout: float = 10.0):
        return await self._sync(ensemble, ("overwrite", key, value),
                                timeout)

    async def kput_once(self, ensemble, key, value, timeout: float = 10.0):
        return await self._sync(
            ensemble, ("put", key, funref.ref("peer:kput_once"), [value]),
            timeout)

    async def kupdate(self, ensemble, key, current: Obj, new,
                      timeout: float = 10.0):
        return await self._sync(
            ensemble, ("put", key, funref.ref("peer:kupdate"),
                       [current, new]), timeout)

    async def kdelete(self, ensemble, key, timeout: float = 10.0):
        return await self.kover(ensemble, key, NOTFOUND, timeout)

    async def ksafe_delete(self, ensemble, key, current: Obj,
                           timeout: float = 10.0):
        return await self.kupdate(ensemble, key, current, NOTFOUND,
                                  timeout)


async def run_node(node: str, peers: Dict[str, Tuple[str, int]],
                   config: Optional[Config] = None,
                   data_root: Optional[str] = None, seed: int = 0,
                   script: Optional[Any] = None) -> None:
    config = config if config is not None else Config()
    runtime = NetRuntime(node, peers, seed=seed)
    await runtime.start()
    storage = Storage(runtime, node, config, data_root)
    manager = Manager(runtime, node, config, storage)
    handle = AsyncNode(runtime, manager, storage)
    try:
        if script is not None:
            await script(handle)
        else:
            await asyncio.Event().wait()  # serve forever
    finally:
        await runtime.stop()


def _parse_peer(spec: str) -> Tuple[str, Tuple[str, int]]:
    name, addr = spec.split("=", 1)
    host, port = addr.rsplit(":", 1)
    return name, (host, int(port))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--node", required=True)
    ap.add_argument("--peer", action="append", required=True,
                    help="node=host:port (repeat; must include --node)")
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fast", action="store_true",
                    help="test-speed timeouts (fast_test_config)")
    ap.add_argument("--script", default=None,
                    help="python file defining `async def main(node)`")
    args = ap.parse_args(argv)

    peers = dict(_parse_peer(s) for s in args.peer)
    config = fast_test_config() if args.fast else Config()
    script = None
    if args.script:
        import importlib.util
        spec = importlib.util.spec_from_file_location("node_script",
                                                      args.script)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        script = mod.main
    asyncio.run(run_node(args.node, peers, config, args.data_root,
                         args.seed, script))
    return 0


if __name__ == "__main__":
    sys.exit(main())
