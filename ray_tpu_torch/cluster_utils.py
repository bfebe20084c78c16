"""Multi-node cluster-in-one-machine test harness.

Parity target: reference python/ray/cluster_utils.py:135 (Cluster — the
load-bearing mechanism for multi-node testing: `add_node()` spawns real
raylets with fake resources on one machine; cf. SURVEY §4). Here each
`add_node` spawns a real NodeAgent subprocess with declared (fake) resources;
workers/actors/objects behave exactly as on a real multi-host cluster, modulo
shared /dev/shm (same as the reference's shared plasma on one box).

Counterpart: ray_tpu/cluster_utils.py (copied; `add_node(num_gpus=)`
advertises "GPU" in place of `num_tpus` and "TPU", and nodes run the
port's node agent).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

from ray_tpu_torch._private import rpc
from ray_tpu_torch._private.accelerators import GPU_RESOURCE
from ray_tpu_torch._private.bootstrap import HeadNode
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.resources import ResourceSet


class _NodeHandle:
    def __init__(self, node_id: str, proc: subprocess.Popen):
        self.node_id = node_id
        self.proc = proc


class Cluster:
    def __init__(self, initialize_head: bool = True, head_node_args: dict | None = None):
        args = dict(head_node_args or {})
        args.setdefault("num_cpus", 1)
        self.head = HeadNode(**args)
        self.controller_addr = self.head.start()
        self.nodes: list[_NodeHandle] = []
        self._io = rpc.EventLoopThread(name="cluster-util")
        self._conn: rpc.Connection | None = None

    @property
    def address(self) -> str:
        return f"{self.controller_addr[0]}:{self.controller_addr[1]}"

    def _call(self, method: str, **kw):
        async def _go():
            global_conn = self._conn
            if global_conn is None or global_conn.closed:
                self._conn = await rpc.connect(*self.controller_addr)
                await self._conn.call("register", kind="client", worker_id="cluster-util", address=None)
            return await self._conn.call(method, **kw)

        return self._io.run(_go(), timeout=30)

    def add_node(
        self,
        num_cpus: float = 1,
        num_gpus: float = 0,
        resources: dict | None = None,
        labels: dict | None = None,
        env: dict | None = None,
    ) -> _NodeHandle:
        node_id = NodeID.from_random().hex()
        res = {"CPU": float(num_cpus)}
        if num_gpus:
            res[GPU_RESOURCE] = float(num_gpus)
        res.update(resources or {})
        penv = dict(os.environ)
        penv.update(env or {})
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        # Forward the driver's sys.path (like HeadNode does for the local
        # node): workers on this node must unpickle by-reference functions
        # from any module the driver can import. Explicit PYTHONPATH stays
        # first so it can shadow inherited driver paths.
        driver_paths = [p for p in sys.path if p and os.path.exists(p)]
        existing = penv.get("PYTHONPATH", "")
        penv["PYTHONPATH"] = os.pathsep.join(
            ([existing] if existing else []) + [pkg_root] + driver_paths)
        proc = subprocess.Popen(
            [
                sys.executable,
                "-m",
                "ray_tpu_torch._private.node_agent",
                "--controller",
                self.address,
                "--node-id",
                node_id,
                "--session",
                self.head.session_id,
                "--resources",
                json.dumps(ResourceSet(res).raw()),
                "--labels",
                json.dumps(labels or {}),
            ],
            env=penv,
        )
        handle = _NodeHandle(node_id, proc)
        self.nodes.append(handle)
        self._wait_node_state(node_id, alive=True)
        return handle

    def remove_node(self, node: _NodeHandle, allow_graceful: bool = False):
        node.proc.kill()
        node.proc.wait(timeout=10)
        try:
            # Explicit removal: skip the liveness suspicion grace window
            # (the kill is a fact, not a blip) so dependent failure
            # handling (actor restarts, object loss) runs immediately.
            self._call("kill_node", node_id=node.node_id)
        except Exception:
            pass
        self._wait_node_state(node.node_id, alive=False)
        self.nodes.remove(node)

    def _wait_node_state(self, node_id: str, alive: bool, timeout: float = 30.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            snap = self._call("state_snapshot")
            ent = snap["nodes"].get(node_id)
            if ent is not None and ent["alive"] == alive:
                return
            time.sleep(0.05)
        raise TimeoutError(f"node {node_id[:8]} did not become alive={alive}")

    def wait_for_nodes(self, timeout: float = 30.0):
        for n in self.nodes:
            self._wait_node_state(n.node_id, alive=True, timeout=timeout)

    def shutdown(self):
        for n in list(self.nodes):
            try:
                n.proc.kill()
            except Exception:
                pass
        self._io.stop()
        self.head.stop()
