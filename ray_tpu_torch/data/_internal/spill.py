"""Exchange spill/restore through the storage plane.

Under memory pressure the pipelined exchange (exchange.py) consolidates
partition shards and writes them through `ray_tpu_torch.storage` instead of
keeping them in shm: any registered backend works (`local://`, `mem://`,
`sim://` — the last one fault-injectable, which is how the chaos tests
sever the spill path). A spilled shard travels as a tiny `SpilledPart`
marker; the reduce task that consumes it restores the payload
transparently, retrying `StorageTransientError` with bounded backoff and
raising an attributed `DataSpillError` when the backend stays gone —
never a hang.

Spill policy (driver + task cooperate, both deterministic):

- the driver FORCES a spill on any consolidation submitted while the
  cluster store sits above `STORE_BACKPRESSURE_FRACTION`;
- the task spills when `RT_DATA_MEM_CAP_BYTES` is set and the
  consolidated payload alone exceeds it (the forced-low-cap test knob).

A restored shard deletes its own backing file (best effort): the spill
dir self-cleans as the exchange drains.

Counterpart: ray_tpu/data/_internal/spill.py (copied).
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Optional

from ray_tpu_torch._private.rtconfig import CONFIG
from ray_tpu_torch.exceptions import DataSpillError

#: Transient-failure retry schedule for one storage op: bounded, so a
#: severed backend surfaces in ~1.5s instead of hanging the reduce.
_RETRIES = 5
_RETRY_BASE_S = 0.05


class SpilledPart:
    """Marker for a shard that lives in the storage plane, not shm.
    Picklable and tiny: this is what rides the object store in place of
    the payload."""

    __slots__ = ("uri", "nbytes", "partition")

    def __init__(self, uri: str, nbytes: int, partition: int):
        self.uri = uri
        self.nbytes = nbytes
        self.partition = partition

    def __reduce__(self):
        return (SpilledPart, (self.uri, self.nbytes, self.partition))

    def __repr__(self):
        return f"SpilledPart({self.uri}, {self.nbytes}B, p{self.partition})"


def spill_root() -> str:
    """Storage URI exchange shards spill under (RT_DATA_SPILL_URI, default
    local://<session_dir>/data_spill)."""
    uri = CONFIG.data_spill_uri
    if uri:
        return uri
    return "local://" + os.path.join(CONFIG.session_dir, "data_spill")


def _retrying(op: str, uri: str, partition: Optional[int], fn):
    """Run one storage op with the bounded transient-retry schedule."""
    from ray_tpu_torch.storage.backend import StorageTransientError

    last: Exception | None = None
    for attempt in range(_RETRIES):
        try:
            return fn()
        except StorageTransientError as e:
            last = e
            time.sleep(_RETRY_BASE_S * (2 ** attempt))
    raise DataSpillError(
        f"exchange {op} failed after {_RETRIES} transient retries: {uri} "
        f"(partition {partition}): {last}",
        uri=uri, partition=partition, op=op) from last


def spill_bytes(blob: bytes, uri: str, partition: int) -> SpilledPart:
    """Write one consolidated shard payload; returns the marker that rides
    the object store in its place."""
    from ray_tpu_torch import storage

    _retrying("spill", uri, partition, lambda: storage.put(uri, blob))
    return SpilledPart(uri, len(blob), partition)


def spill_entries(entries: list, uri: str, partition: int) -> SpilledPart:
    return spill_bytes(
        pickle.dumps(entries, protocol=pickle.HIGHEST_PROTOCOL),
        uri, partition)


def restore(part: SpilledPart) -> list:
    """Read a spilled shard back (bounded retries, attributed error) and
    best-effort delete its backing file — the spill dir self-cleans."""
    from ray_tpu_torch import storage

    blob = _retrying("restore", part.uri, part.partition,
                     lambda: storage.get_bytes(part.uri))
    entries = pickle.loads(blob)
    try:
        storage.delete(part.uri)
    except Exception:
        pass  # injected fault or already gone; the payload is what matters
    return entries
