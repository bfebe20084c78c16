"""What a run may not load, may not leave behind, and where it keeps its
caches and session files.

- No module of the JAX package or of JAX itself: the port is measured,
  never the package it was ported from. Top-level names are compared
  whole, so `ray_tpu_torch` is not `ray_tpu`.
- No file of the runtime's in /dev/shm once the run has ended: the
  runtime's session files live under the run's TMPDIR.
- Every cache of a build or a compiler inside the checkout, at a fixed
  path, so that only a cell's first run in a checkout builds.
"""

from __future__ import annotations

import os
import sys
import tempfile

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "ray_tpu"})

#: name prefixes of the runtime's shared-memory files: object store
#: segments, stream rings and compiled-DAG channels
SHM_PREFIXES = ("rt_", "rtring_", "rtch_")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def shm_files() -> set:
    try:
        return {f for f in os.listdir("/dev/shm") if f.startswith(SHM_PREFIXES)}
    except OSError:
        return set()


def set_environment(root: str) -> dict:
    """Point every cache and session path of this process and the
    processes it starts at the run's directories: caches inside the
    checkout at fixed paths, the runtime's session, shared-memory and spill
    files under TMPDIR. Call before torch or the port is imported."""
    tmp = os.path.join(tempfile.gettempdir(), "bench_h100")
    cache = os.path.join(root, "build", "bench_h100")
    env = {
        # the port's kernels build into <checkout>/build/ray_tpu_torch
        "TRITON_CACHE_DIR": os.path.join(cache, "triton"),
        "CUDA_CACHE_PATH": os.path.join(cache, "cuda"),
        "TORCHINDUCTOR_CACHE_DIR": os.path.join(cache, "inductor"),
        "RT_SESSION_DIR": os.path.join(tmp, "session"),
        "RT_SHM_DIR": os.path.join(tmp, "shm"),
        "RT_OBJECT_SPILL_DIR": os.path.join(tmp, "spill"),
        # the SSE stream ring is fixed to /dev/shm: the classic SSE path
        "RT_TOKEN_RING": "0",
        "USE_FLAX": "0",
        # the port's package, for this process and every worker it starts
        "PYTHONPATH": os.pathsep.join(
            [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
                os.pathsep) if p]),
    }
    for key in ("RT_SESSION_DIR", "RT_SHM_DIR", "RT_OBJECT_SPILL_DIR",
                "TRITON_CACHE_DIR", "CUDA_CACHE_PATH"):
        os.makedirs(env[key], exist_ok=True)
    os.environ.update(env)
    if root not in sys.path:
        sys.path.insert(0, root)
    return env
