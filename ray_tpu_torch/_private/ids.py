"""Unique identifiers for tasks, objects, actors, nodes, placement groups.

Parity target: reference src/ray/common/id.h + python/ray/includes/unique_ids.pxi.
The reference derives ObjectIDs from (task id, return index) so ownership and
lineage can be recovered from the id alone; we keep that property.

Counterpart: ray_tpu/_private/ids.py (copied).
"""

from __future__ import annotations

import os
import threading

_UNIQUE_LEN = 16  # bytes


class _EntropyPool:
    """Buffered os.urandom: one syscall per 4 KiB instead of one per id.
    os.urandom is a full getrandom()/read syscall, and id minting sits on
    the task-submit hot path — at tens of thousands of submissions/s the
    per-id syscall was the single largest submit-side cost in profiles.
    Ids are not secrets; buffered urandom keeps full entropy. Fork-safe:
    the child's pool resets via os.register_at_fork, so a forked process
    can never re-mint the parent's buffered bytes."""

    __slots__ = ("_buf", "_off", "_lock")

    def __init__(self):
        self._buf = b""
        self._off = 0
        self._lock = threading.Lock()

    def take(self, n: int) -> bytes:
        with self._lock:
            off = self._off
            if off + n > len(self._buf):
                self._buf = os.urandom(max(4096, n))
                off = 0
            self._off = off + n
            return self._buf[off : off + n]

    def reset_after_fork(self):
        # Runs in the forked CHILD: another thread may have held _lock at
        # fork time and no longer exists to release it — REPLACE the lock,
        # never acquire it (the child is single-threaded here).
        self._lock = threading.Lock()
        self._buf = b""
        self._off = 0


_ENTROPY = _EntropyPool()
os.register_at_fork(after_in_child=_ENTROPY.reset_after_fork)


def random_id_bytes(n: int = _UNIQUE_LEN) -> bytes:
    return _ENTROPY.take(n)


class BaseID:
    __slots__ = ("_bytes",)
    _NIL: "BaseID"

    def __init__(self, id_bytes: bytes):
        if not isinstance(id_bytes, bytes):
            raise TypeError(f"id must be bytes, got {type(id_bytes)}")
        self._bytes = id_bytes

    @classmethod
    def from_random(cls):
        return cls(random_id_bytes(_UNIQUE_LEN))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * _UNIQUE_LEN)

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * len(self._bytes)

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self):
        return hash((type(self).__name__, self._bytes))

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()[:16]})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    pass


class NodeID(BaseID):
    pass


class WorkerID(BaseID):
    pass


class ActorID(BaseID):
    pass


class PlacementGroupID(BaseID):
    pass


class TaskID(BaseID):
    pass


class ObjectID(BaseID):
    """Object id = task id (16B) + 4B return index, so the producing task is
    recoverable from the id (lineage reconstruction; cf. reference id.h
    ObjectID::ForTaskReturn)."""

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + index.to_bytes(4, "little"))

    @classmethod
    def from_put(cls) -> "ObjectID":
        # Puts have no producing task; index 0xFFFFFFFF marks "put".
        return cls(random_id_bytes(_UNIQUE_LEN)
                   + (0xFFFFFFFF).to_bytes(4, "little"))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:_UNIQUE_LEN])

    def return_index(self) -> int:
        return int.from_bytes(self._bytes[_UNIQUE_LEN:], "little")

    def is_put(self) -> bool:
        return self.return_index() == 0xFFFFFFFF

    @classmethod
    def nil(cls):
        return cls(b"\x00" * (_UNIQUE_LEN + 4))


class _Counter:
    def __init__(self):
        self._v = 0
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            self._v += 1
            return self._v
