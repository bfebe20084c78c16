"""In-process head bootstrap: controller + head node agent.

Parity target: reference python/ray/_private/node.py
(start_head_processes:1437 — spawns the gcs_server and raylet C++ binaries as
daemons). TPU-era simplification: the control plane is asyncio services, so a
single-host cluster hosts controller + head agent on the driver's IO loop
thread — zero extra processes beyond the worker pool; `ray-tpu start` runs
the same objects standalone for multi-host clusters.

Counterpart: ray_tpu/_private/bootstrap.py (copied; the head counts GPUs).
"""

from __future__ import annotations

import os
import uuid

from ray_tpu_torch._private import rpc
from ray_tpu_torch._private.accelerators import host_resources
from ray_tpu_torch._private.controller import Controller
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.node_agent import NodeAgent
from ray_tpu_torch._private.resources import ResourceSet
from ray_tpu_torch._private.rtconfig import CONFIG


class HeadNode:
    """Controller + head NodeAgent living on one event loop thread."""

    def __init__(
        self,
        num_cpus: float | None = None,
        num_gpus: float | None = None,
        resources: dict | None = None,
        labels: dict | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
        worker_env: dict | None = None,
        session_id: str | None = None,
    ):
        # An explicit session_id restarts a head INTO an existing session
        # (controller-restart FT: surviving agents/workers keep their shm
        # namespace and re-register).
        self.session_id = session_id or uuid.uuid4().hex
        self.host = host
        self.port = port
        res = host_resources(num_cpus, num_gpus)
        res.update(resources or {})
        self.resources = ResourceSet(res)
        self.labels = labels or {}
        self.worker_env = dict(worker_env or {})
        # Workers must be able to unpickle by-reference functions from any
        # module the DRIVER can import (e.g. pytest-inserted test dirs, user
        # script dirs). For a local head, inheriting the driver's sys.path
        # is the runtime-env equivalent of the reference's working_dir
        # shipping (python/ray/_private/runtime_env/packaging.py).
        import sys

        # Keep zipimport entries (.egg/.zip) too; explicit user-provided
        # PYTHONPATH stays FIRST so it can shadow inherited driver paths.
        driver_paths = [p for p in sys.path if p and os.path.exists(p)]
        existing = self.worker_env.get("PYTHONPATH", "")
        self.worker_env["PYTHONPATH"] = os.pathsep.join(
            ([existing] if existing else []) + driver_paths)
        self.io = rpc.EventLoopThread(name="rt-head")
        self.controller: Controller | None = None
        self.agent: NodeAgent | None = None
        self.node_id = NodeID.from_random().hex()
        self.controller_addr: tuple | None = None

    def start(self) -> tuple:
        async def _up():
            self.controller = Controller(self.session_id)
            port = await self.controller.start(self.host, self.port)
            self.controller_addr = (self.host, port)
            self.agent = NodeAgent(
                node_id=self.node_id,
                session_id=self.session_id,
                controller_addr=self.controller_addr,
                resources_raw=self.resources.raw(),
                labels=self.labels,
                host=self.host,
                env=self.worker_env,
            )
            await self.agent.start()

        self.io.run(_up(), timeout=CONFIG.connect_timeout_s)
        return self.controller_addr

    def stop(self):
        async def _down():
            if self.agent is not None:
                await self.agent.stop()
            if self.controller is not None:
                await self.controller.stop()

        try:
            self.io.run(_down(), timeout=10)
        except Exception:
            pass
        self.io.stop()
        # Clean any session shm leftovers.
        import glob

        for p in glob.glob(os.path.join(CONFIG.shm_dir, f"rt_{self.session_id[:8]}_*")):
            try:
                os.unlink(p)
            except OSError:
                pass
