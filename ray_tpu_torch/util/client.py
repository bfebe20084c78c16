"""Remote-driver ("Ray Client") surface.

Parity target: reference python/ray/util/client/ — a gRPC proxy that lets
a driver OUTSIDE the cluster run the full API, needed there because a
reference driver must colocate with a raylet. This framework's driver
never needs a local node agent: `ray_tpu_torch.init(address=...)` already runs
the complete API from any machine that can reach the controller (the
worker registers as a remote client; leases, actor pipes, and object
fetches all ride ordinary connections). So the client mode here is a thin
alias with the reference's `ray.init("ray://host:port")` ergonomics:

    from ray_tpu_torch.util.client import connect
    client = connect("host:6380")      # or ray_tpu_torch.init(address=...)
    ...
    client.disconnect()

Counterpart: ray_tpu/util/client.py (copied).
"""

from __future__ import annotations

from typing import Optional

import ray_tpu_torch


class ClientContext:
    """Handle for a remote-driver session (reference ClientContext)."""

    def __init__(self, address: str):
        self.address = address
        self._connected = True

    def disconnect(self):
        if self._connected:
            self._connected = False
            ray_tpu_torch.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.disconnect()
        return False

    def __repr__(self):
        state = "connected" if self._connected else "disconnected"
        return f"ClientContext({self.address!r}, {state})"


def connect(address: str, namespace: str = "default",
            runtime_env: Optional[dict] = None) -> ClientContext:
    """Connect this process as a remote driver (reference
    ray.util.client.connect / ray.init("ray://...")). Accepts the
    "ray://host:port" scheme for drop-in familiarity."""
    if address.startswith("ray://"):
        address = address[len("ray://"):]
    ray_tpu_torch.init(address=address, namespace=namespace,
                 runtime_env=runtime_env)
    return ClientContext(address)
