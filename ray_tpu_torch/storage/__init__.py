"""ray_tpu_torch.storage — the pluggable persistent-storage plane.

One `StorageBackend` seam (README "Checkpointing & storage") shared by
every durable consumer in the runtime: controller state snapshots,
train/tune checkpoints (via the async sharded engine in
`ray_tpu_torch/train/checkpoint.py`), and workflow step memoization. Backends
are addressed by URI scheme — `local://` (and bare paths), `mem://`, and
the fault-injectable `sim://` — and new schemes plug in with
`register_backend`.

Counterpart: ray_tpu/storage/__init__.py (copied).
"""

from ray_tpu_torch.storage.backend import (  # noqa: F401
    StorageBackend,
    StorageError,
    StorageNotFoundError,
    StorageTransientError,
    basename,
    delete,
    delete_prefix,
    exists,
    get_backend,
    get_bytes,
    is_local,
    join,
    listdir,
    local_path,
    makedirs,
    parent,
    parse_uri,
    put,
    register_backend,
    rename,
    scheme_of,
    size,
)
from ray_tpu_torch.storage import sim  # noqa: F401

__all__ = [
    "StorageBackend",
    "StorageError",
    "StorageNotFoundError",
    "StorageTransientError",
    "register_backend",
    "get_backend",
    "parse_uri",
    "scheme_of",
    "is_local",
    "local_path",
    "join",
    "basename",
    "parent",
    "put",
    "get_bytes",
    "exists",
    "listdir",
    "delete",
    "delete_prefix",
    "rename",
    "makedirs",
    "size",
    "sim",
]
