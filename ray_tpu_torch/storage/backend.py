"""Storage backend seam: the ONE pluggable boundary every durable byte in
the runtime crosses.

Parity target: the role pyarrow.fs plays for reference ray.train/tune
storage (storage_context.py) and the GCS store client plays for controller
state (redis_store_client.h) — except here there is a single ABC shared by
controller snapshots, train/tune checkpoints, and workflow step memoization,
so a new scheme (GCS, S3, ...) plugs in once and every consumer gets it.

A backend is addressed by URI scheme:

    local:///abs/path   (also any bare path)  — the host filesystem
    mem://bucket/key                          — in-process dict (tests)
    sim:///abs/path                           — fault-injectable "remote"
                                                backend over the local fs
                                                (latency/bandwidth caps,
                                                injected failures; see
                                                storage/sim.py)

Semantics every backend must honor:
  - `put` is atomic: a reader never observes a partially written object
    (local: tmp file + os.replace; mem: dict assignment under lock).
  - `rename` is atomic within the backend — the commit primitive the
    checkpoint engine's manifest-last protocol builds on.
  - `listdir` is one level (like os.listdir), returning names.
Paths use "/" separators regardless of backend.

Counterpart: ray_tpu/storage/backend.py (copied).
"""

from __future__ import annotations

import os
import re
import threading
from abc import ABC, abstractmethod
from typing import Callable, Iterable, Union

Parts = Union[bytes, bytearray, memoryview, Iterable]


class StorageError(Exception):
    """Base class for storage-plane failures."""


class StorageTransientError(StorageError):
    """Retryable failure (network blip, injected sim:// fault): callers on
    durable paths (the checkpoint writer) retry these with backoff."""


class StorageNotFoundError(StorageError, FileNotFoundError):
    """The addressed object does not exist."""


class StorageBackend(ABC):
    """Streaming put/get/list/delete/rename over scheme-local paths."""

    scheme: str = ""

    @abstractmethod
    def put(self, path: str, data: Parts) -> int:
        """Atomically store `data` (bytes or an iterable of bytes-like
        parts, written in order — the pickle5-oob streaming shape) at
        `path`, creating parents. Returns bytes written."""

    @abstractmethod
    def get(self, path: str) -> bytes:
        """Full contents of `path`; StorageNotFoundError if absent."""

    @abstractmethod
    def exists(self, path: str) -> bool: ...

    @abstractmethod
    def listdir(self, path: str) -> list[str]:
        """Immediate child names of `path` (empty when absent)."""

    @abstractmethod
    def delete(self, path: str) -> bool:
        """Remove one object; True if it existed."""

    @abstractmethod
    def delete_prefix(self, path: str) -> None:
        """Remove `path` and everything under it (recursive, best-effort)."""

    @abstractmethod
    def rename(self, src: str, dst: str) -> None:
        """Atomic move within this backend (the manifest commit point)."""

    @abstractmethod
    def size(self, path: str) -> int: ...

    def makedirs(self, path: str) -> None:
        """Ensure a directory exists (no-op on flat keyspaces)."""

    def isdir(self, path: str) -> bool:
        return bool(self.listdir(path))


# ------------------------------------------------------------- registry
_SCHEME_RE = re.compile(r"^([a-z][a-z0-9+.-]*)://")
_REGISTRY: dict[str, Callable[[], StorageBackend]] = {}
_INSTANCES: dict[str, StorageBackend] = {}
_reg_lock = threading.Lock()


def register_backend(scheme: str, factory: Callable[[], StorageBackend]) -> None:
    """Plug a new scheme in (factory is called once, lazily)."""
    with _reg_lock:
        _REGISTRY[scheme] = factory
        _INSTANCES.pop(scheme, None)


def parse_uri(uri: str) -> tuple[str, str]:
    """Split a URI into (scheme, backend-local path). Bare paths (no
    scheme) are `local`. `local:///a/b` and `sim:///a/b` keep the absolute
    fs path; `mem://bucket/k` keeps `bucket/k`."""
    m = _SCHEME_RE.match(uri)
    if not m:
        return "local", uri
    scheme = m.group(1)
    rest = uri[m.end():]
    if scheme == "file":
        scheme = "local"
    if scheme in ("local", "sim"):
        # local:///abs -> /abs (the third slash is the path root)
        if not rest.startswith("/"):
            rest = "/" + rest
        return scheme, rest
    return scheme, rest


def get_backend(uri: str) -> tuple[StorageBackend, str]:
    """Resolve `uri` to (backend instance, backend-local path)."""
    scheme, path = parse_uri(uri)
    with _reg_lock:
        be = _INSTANCES.get(scheme)
        if be is None:
            factory = _REGISTRY.get(scheme)
            if factory is None:
                raise StorageError(
                    f"no storage backend registered for scheme {scheme!r} "
                    f"(known: {sorted(_REGISTRY)})")
            be = _INSTANCES[scheme] = factory()
    return be, path


def scheme_of(uri: str) -> str:
    return parse_uri(uri)[0]


def is_local(uri: str) -> bool:
    """True when `uri` addresses the plain host filesystem — consumers may
    then hand the path to code that open()s it directly. sim:// is
    fs-backed but NOT local: direct access would bypass fault injection."""
    return scheme_of(uri) == "local"


def local_path(uri: str) -> str | None:
    """Filesystem path for a local URI, else None."""
    scheme, path = parse_uri(uri)
    return path if scheme == "local" else None


def join(uri: str, *parts: str) -> str:
    """URI-aware path join; keeps bare paths bare (so the default local
    flow produces ordinary fs paths)."""
    out = uri
    for p in parts:
        if not p:
            continue
        out = out.rstrip("/") + "/" + str(p).lstrip("/")
    return out


def basename(uri: str) -> str:
    return uri.rstrip("/").rsplit("/", 1)[-1]


def parent(uri: str) -> str:
    head = uri.rstrip("/").rsplit("/", 1)[0]
    return head if head else "/"


# ------------------------------------------------- module-level conveniences
# The write/read/rename conveniences every consumer rides (controller
# snapshots, train checkpoints, tune state, workflow memoization, flight
# dumps) carry tracing spans: inside a traced context a storage op becomes
# a `storage.*` span with scheme + byte count, so checkpoint stalls and
# slow backends show up in the request/step timeline. Zero-cost when
# tracing is off or the context unsampled (see _private/tracing.span).
from ray_tpu_torch._private import tracing as _tracing  # noqa: E402


def put(uri: str, data: Parts) -> int:
    be, p = get_backend(uri)
    with _tracing.span("storage.put", "storage", {"scheme": be.scheme or
                                                  scheme_of(uri)}):
        return be.put(p, data)


def get_bytes(uri: str) -> bytes:
    be, p = get_backend(uri)
    with _tracing.span("storage.get", "storage", {"scheme": be.scheme or
                                                  scheme_of(uri)}):
        return be.get(p)


def exists(uri: str) -> bool:
    be, p = get_backend(uri)
    return be.exists(p)


def listdir(uri: str) -> list[str]:
    be, p = get_backend(uri)
    return be.listdir(p)


def delete(uri: str) -> bool:
    be, p = get_backend(uri)
    return be.delete(p)


def delete_prefix(uri: str) -> None:
    be, p = get_backend(uri)
    be.delete_prefix(p)


def rename(src_uri: str, dst_uri: str) -> None:
    be, src = get_backend(src_uri)
    be2, dst = get_backend(dst_uri)
    if be is not be2:
        raise StorageError("rename must stay within one backend "
                           f"({src_uri} -> {dst_uri})")
    with _tracing.span("storage.rename", "storage",
                       {"scheme": be.scheme or scheme_of(src_uri)}):
        be.rename(src, dst)


def makedirs(uri: str) -> None:
    be, p = get_backend(uri)
    be.makedirs(p)


def size(uri: str) -> int:
    be, p = get_backend(uri)
    return be.size(p)


def _register_builtins() -> None:
    from ray_tpu_torch.storage.local import LocalBackend
    from ray_tpu_torch.storage.mem import MemBackend
    from ray_tpu_torch.storage.sim import SimBackend

    register_backend("local", LocalBackend)
    register_backend("mem", MemBackend)
    register_backend("sim", SimBackend)


_register_builtins()


def _normpath(path: str) -> str:
    return os.path.normpath(path)
