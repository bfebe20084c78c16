"""Local-filesystem storage backend (`local://` and bare paths).

The default backend for every durable consumer: controller snapshots,
train/tune checkpoints, workflow step memoization. Puts are atomic
(tmp file + os.replace), so a reader — including another process on the
same host — never sees a torn object; rename maps to os.replace, the same
primitive the pre-storage-plane code used for its commit points.

Counterpart: ray_tpu/storage/local.py (copied).
"""

from __future__ import annotations

import os
import shutil
import tempfile

from ray_tpu_torch.storage.backend import (
    StorageBackend,
    StorageError,
    StorageNotFoundError,
)


class LocalBackend(StorageBackend):
    scheme = "local"

    def put(self, path: str, data) -> int:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=".rtput_", dir=d or ".")
        n = 0
        try:
            with os.fdopen(fd, "wb") as f:
                if isinstance(data, (bytes, bytearray, memoryview)):
                    f.write(data)
                    n = len(data)
                else:
                    for part in data:
                        f.write(part)
                        n += len(part)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return n

    def get(self, path: str) -> bytes:
        try:
            with open(path, "rb") as f:
                return f.read()
        except FileNotFoundError as e:
            raise StorageNotFoundError(path) from e

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def listdir(self, path: str) -> list[str]:
        try:
            return sorted(os.listdir(path))
        except (FileNotFoundError, NotADirectoryError):
            return []

    def delete(self, path: str) -> bool:
        try:
            os.unlink(path)
            return True
        except FileNotFoundError:
            return False
        except IsADirectoryError:
            shutil.rmtree(path, ignore_errors=True)
            return True

    def delete_prefix(self, path: str) -> None:
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        else:
            try:
                os.unlink(path)
            except OSError:
                pass

    def rename(self, src: str, dst: str) -> None:
        d = os.path.dirname(dst)
        if d:
            os.makedirs(d, exist_ok=True)
        try:
            os.replace(src, dst)
        except OSError as e:
            # Directory with a non-empty destination: fall back to move.
            if os.path.isdir(src):
                shutil.move(src, dst)
            else:
                raise StorageError(f"rename {src} -> {dst}: {e}") from e

    def size(self, path: str) -> int:
        try:
            return os.path.getsize(path)
        except OSError as e:
            raise StorageNotFoundError(path) from e

    def makedirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def isdir(self, path: str) -> bool:
        return os.path.isdir(path)
