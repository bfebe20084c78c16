"""In-process memory backend (`mem://`).

A flat key->bytes dict behind a lock: the fastest way to unit-test engine
semantics (manifest commit, retention, resharding restore) with zero
filesystem traffic. Process-local by design — actors cannot share a
mem:// root; use local:// or sim:// for cross-process tests.

Counterpart: ray_tpu/storage/mem.py (copied).
"""

from __future__ import annotations

import threading

from ray_tpu_torch.storage.backend import StorageBackend, StorageNotFoundError


class MemBackend(StorageBackend):
    scheme = "mem"

    # Class-level so every get_backend("mem://...") sees one namespace in
    # this process (mirrors how a bucket outlives client objects).
    _store: dict[str, bytes] = {}
    _lock = threading.Lock()

    @staticmethod
    def _norm(path: str) -> str:
        return path.strip("/")

    def put(self, path: str, data) -> int:
        if isinstance(data, (bytes, bytearray, memoryview)):
            blob = bytes(data)
        else:
            blob = b"".join(bytes(p) for p in data)
        with self._lock:
            self._store[self._norm(path)] = blob
        return len(blob)

    def get(self, path: str) -> bytes:
        with self._lock:
            try:
                return self._store[self._norm(path)]
            except KeyError as e:
                raise StorageNotFoundError(path) from e

    def exists(self, path: str) -> bool:
        p = self._norm(path)
        with self._lock:
            if p in self._store:
                return True
            prefix = p + "/"
            return any(k.startswith(prefix) for k in self._store)

    def listdir(self, path: str) -> list[str]:
        p = self._norm(path)
        prefix = p + "/" if p else ""
        out = set()
        with self._lock:
            for k in self._store:
                if k.startswith(prefix):
                    out.add(k[len(prefix):].split("/", 1)[0])
        return sorted(out)

    def delete(self, path: str) -> bool:
        with self._lock:
            return self._store.pop(self._norm(path), None) is not None

    def delete_prefix(self, path: str) -> None:
        p = self._norm(path)
        prefix = p + "/"
        with self._lock:
            for k in [k for k in self._store
                      if k == p or k.startswith(prefix)]:
                del self._store[k]

    def rename(self, src: str, dst: str) -> None:
        s, d = self._norm(src), self._norm(dst)
        sp, dp = s + "/", d + "/"
        with self._lock:
            if s in self._store:
                self._store[d] = self._store.pop(s)
                return
            moved = False
            for k in [k for k in self._store if k.startswith(sp)]:
                self._store[dp + k[len(sp):]] = self._store.pop(k)
                moved = True
            if not moved:
                raise StorageNotFoundError(src)

    def size(self, path: str) -> int:
        with self._lock:
            try:
                return len(self._store[self._norm(path)])
            except KeyError as e:
                raise StorageNotFoundError(path) from e

    def makedirs(self, path: str) -> None:
        pass  # flat keyspace

    @classmethod
    def clear_all(cls) -> None:
        """Test hook: wipe the namespace."""
        with cls._lock:
            cls._store.clear()
