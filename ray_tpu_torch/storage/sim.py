"""Simulated remote storage backend (`sim://`).

The chaos surface for the storage plane, reusing the FaultInjector idiom
from `_private/rpc.py`: a deterministic rule table (op filter + after/times
schedule) that injects failures, plus latency and bandwidth caps so saves
take long enough to kill things in the middle of. Data lands on the local
filesystem underneath (so a process killed mid-save leaves real partial
files for GC tests to find), but consumers must treat sim:// as remote —
`storage.is_local` is False, and direct fs access bypasses injection.

Knobs (env / `_system_config`, read per-op so tests and subprocesses can
flip them without rebuilding backends):
    RT_SIM_STORAGE_LATENCY_S  per-operation latency
    RT_SIM_STORAGE_GBPS       put/get bandwidth cap (0 = unlimited)
    RT_SIM_STORAGE_SEVERED    every op raises StorageTransientError

In-process rules (same shape as rpc.FaultInjector.add_rule):

    faults().add_rule(op="put", after=2, times=1)       # 3rd put fails
    faults().add_rule(op="put", error="fatal")          # non-retryable
    faults().sever()                                    # all ops fail

Counterpart: ray_tpu/storage/sim.py (copied).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ray_tpu_torch.storage.backend import (
    StorageBackend,
    StorageError,
    StorageTransientError,
)
from ray_tpu_torch.storage.local import LocalBackend


@dataclass
class SimFaultRule:
    op: str = "*"              # put|get|list|delete|rename|size|*
    error: str = "transient"   # transient|fatal
    after: int = 0             # matching ops to let through first
    times: Optional[int] = None  # fire at most N times (None = forever)
    match: Optional[Callable[[str], bool]] = None  # path filter
    _seen: int = 0
    _fired: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def admit(self, op: str, path: str) -> bool:
        if self.op != "*" and self.op != op:
            return False
        if self.match is not None and not self.match(path):
            return False
        with self._lock:
            self._seen += 1
            if self._seen <= self.after:
                return False
            if self.times is not None and self._fired >= self.times:
                return False
            self._fired += 1
            return True


class SimFaults:
    """Rule registry + counters (the rpc.FaultInjector idiom, storage
    edition). `stats` counts injected failures per op so tests can assert
    the schedule fired — and that retries actually happened."""

    def __init__(self):
        self._rules: list[SimFaultRule] = []
        self._lock = threading.Lock()
        self.severed = False
        self.stats: dict[str, int] = {}

    def add_rule(self, op: str = "*", *, error: str = "transient",
                 after: int = 0, times: Optional[int] = None,
                 match=None) -> SimFaultRule:
        rule = SimFaultRule(op=op, error=error, after=after, times=times,
                            match=match)
        with self._lock:
            self._rules.append(rule)
        return rule

    def remove_rule(self, rule: SimFaultRule) -> None:
        with self._lock:
            if rule in self._rules:
                self._rules.remove(rule)

    def sever(self) -> None:
        """Simulated network partition to the storage service: every op
        fails transiently until restore()."""
        self.severed = True

    def restore(self) -> None:
        self.severed = False

    def clear(self) -> None:
        with self._lock:
            self._rules.clear()
            self.stats.clear()
        self.severed = False

    def check(self, op: str, path: str) -> None:
        from ray_tpu_torch._private.rtconfig import CONFIG

        if self.severed or CONFIG.sim_storage_severed:
            with self._lock:
                self.stats["severed"] = self.stats.get("severed", 0) + 1
            raise StorageTransientError(
                f"sim storage severed ({op} {path})")
        with self._lock:
            rules = list(self._rules)
        for rule in rules:
            if rule.admit(op, path):
                with self._lock:
                    self.stats[op] = self.stats.get(op, 0) + 1
                if rule.error == "fatal":
                    raise StorageError(
                        f"sim storage injected fatal {op} failure ({path})")
                raise StorageTransientError(
                    f"sim storage injected transient {op} failure ({path})")


_FAULTS = SimFaults()


def faults() -> SimFaults:
    return _FAULTS


class SimBackend(StorageBackend):
    scheme = "sim"

    def __init__(self):
        self._fs = LocalBackend()

    # -- shaping -----------------------------------------------------------
    def _pre(self, op: str, path: str, nbytes: int = 0) -> None:
        from ray_tpu_torch._private.rtconfig import CONFIG

        _FAULTS.check(op, path)
        lat = CONFIG.sim_storage_latency_s
        if lat > 0:
            time.sleep(lat)
        gbps = CONFIG.sim_storage_gbps
        if gbps > 0 and nbytes:
            time.sleep(min(nbytes / (gbps * 1e9), 30.0))

    # -- ops ---------------------------------------------------------------
    def put(self, path: str, data) -> int:
        if not isinstance(data, (bytes, bytearray, memoryview)):
            data = b"".join(bytes(p) for p in data)
        self._pre("put", path, len(data))
        return self._fs.put(path, data)

    def get(self, path: str) -> bytes:
        # Size known only after the read; charge bandwidth on the result.
        self._pre("get", path)
        out = self._fs.get(path)
        from ray_tpu_torch._private.rtconfig import CONFIG

        gbps = CONFIG.sim_storage_gbps
        if gbps > 0 and out:
            time.sleep(min(len(out) / (gbps * 1e9), 30.0))
        return out

    def exists(self, path: str) -> bool:
        self._pre("list", path)
        return self._fs.exists(path)

    def listdir(self, path: str) -> list[str]:
        self._pre("list", path)
        return self._fs.listdir(path)

    def delete(self, path: str) -> bool:
        self._pre("delete", path)
        return self._fs.delete(path)

    def delete_prefix(self, path: str) -> None:
        self._pre("delete", path)
        self._fs.delete_prefix(path)

    def rename(self, src: str, dst: str) -> None:
        self._pre("rename", src)
        self._fs.rename(src, dst)

    def size(self, path: str) -> int:
        self._pre("size", path)
        return self._fs.size(path)

    def makedirs(self, path: str) -> None:
        self._fs.makedirs(path)

    def isdir(self, path: str) -> bool:
        return self._fs.isdir(path)
