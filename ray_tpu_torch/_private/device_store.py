"""Device object plane: actor-resident array objects with tiered transfer.

Parity target: the reference runtime's direct-transport design for GPU
objects (device-resident tensors stay pinned in the producing actor behind
an ObjectRef carrying a device-location hint, and move peer-to-peer over
collective/RDMA transports instead of round-tripping through the plasma
store). This is its torch edition, built on the owner-side refcounting
plumbing: a `torch.Tensor` produced by a task or actor method is PINNED in the
producing process's DeviceObjectTable instead of being copied to host,
pickled and flushed through the shm store; what crosses the wire is a tiny
placeholder blob whose deserialization resolves through a tier ladder:

  tier 0  same process   the pinned snapshot itself, no further copy
  tier 1  same host      the producer exports ONCE into the shm store (the
                         pickle-5 out-of-band buffer view of the device
                         bytes is written straight into the mmap — no
                         payload pickle, no double host copy); consumers
                         attach the segment and rebuild the tensor on
                         the recorded device
  tier 2  cross host     export + chunked streamed fetch RPC over the
                         existing object plane, preferring an established
                         collective-group connection to the producer
                         (parallel/collectives, train worker groups) over
                         a fresh TCP connect

Ownership rides the existing refcount machinery: the submitting owner
refcounts the ObjectRef; when the last ref dies the free fans out
controller -> node agents -> producing workers (`device_free`) and the
table entry (plus any shm export) is dropped. Producer death surfaces a
clean ObjectLostError naming the lost producer instead of a hang.

`RT_DEVICE_OBJECTS=0` disables every routing decision in this module, so
all values take today's host-store path byte-for-byte. Values the plane
does not serve (non-contiguous tensors, tensors that require grad,
sub-threshold tensors) take the host store.

Counterpart: ray_tpu/_private/device_store.py, which pins single-device
`jax.Array`s. Here the pinned value is a copy, taken at pin time, of a
contiguous `torch.Tensor` on any device (a CPU tensor too, so the plane runs without a card); the
descriptor records its device and dtype, the export is its host bytes
(bf16 through a uint16 view, since numpy has no bf16), and a consumer
rebuilds it on the recorded device.
"""

from __future__ import annotations

import pickle
import sys
import threading
import time

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private import tracing as _tracing
from ray_tpu_torch._private.rtconfig import CONFIG


class DeviceObjectTable:
    """Per-process table of produced arrays pinned in (device) memory.

    The pin holds a snapshot of the producer's `torch.Tensor`, taken at pin
    time on its own device (`_snapshot`), so consumers can read it later
    without the producer having paid a host copy at production time, and
    without seeing the producer's later in-place writes. Entries die on the
    owner-tracked free fan-out (`device_free`) or with the process."""

    __slots__ = ("_lock", "_entries", "_bytes")

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict[str, dict] = {}  # oid -> {"array","nbytes","exported"}
        self._bytes = 0

    def pin(self, oid: str, array, nbytes: int) -> None:
        with self._lock:
            if oid in self._entries:
                return
            self._entries[oid] = {"array": array, "nbytes": nbytes}
            self._bytes += nbytes

    def get(self, oid: str):
        with self._lock:
            ent = self._entries.get(oid)
            return None if ent is None else ent["array"]

    def holds(self, oid: str) -> bool:
        with self._lock:
            return oid in self._entries

    def discard(self, oid: str) -> bool:
        """Drop a pin. Returns True if an entry existed."""
        with self._lock:
            ent = self._entries.pop(oid, None)
            if ent is None:
                return False
            self._bytes -= ent["nbytes"]
            return True

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def stats(self) -> dict:
        with self._lock:
            return {"count": len(self._entries), "bytes": self._bytes}


_TABLE = DeviceObjectTable()
_conn_lock = threading.Lock()
_conns: dict[tuple, object] = {}  # producer addr -> cached rpc.Connection
# Resolve-tier counters (GIL-atomic int bumps, no lock): how this
# process's placeholder resolutions landed. The llm_pipeline_decode bench
# gate reads these off every stage actor to PROVE the zero-RPC steady
# state — `export_rpc` and `fetch` must stay at 0 when producers export
# eagerly at publish time (dag._EdgePublisher).
_RESOLVE_STATS = {"tier0": 0, "store_hit": 0, "export_rpc": 0, "fetch": 0,
                  "edge_pins": 0}


def resolve_stats() -> dict:
    return dict(_RESOLVE_STATS)


def reset_resolve_stats() -> None:
    for k in _RESOLVE_STATS:
        _RESOLVE_STATS[k] = 0
# Fired (from any thread) after every pin/discard/clear so the hosting
# process can report 0<->nonzero residency transitions (worker_proc tells
# its node agent, which exempts pinned pool workers from the idle reap).
_pins_listener = None


def set_pins_listener(cb) -> None:
    global _pins_listener
    _pins_listener = cb


def _notify_pins() -> None:
    cb = _pins_listener
    if cb is not None:
        try:
            cb()
        except Exception:
            pass


def table() -> DeviceObjectTable:
    return _TABLE


def table_stats() -> dict:
    return _TABLE.stats()


# ------------------------------------------------------------- eligibility
def eligible(value, min_bytes: "int | None" = None) -> bool:
    """True iff `value` should ride the device plane: a contiguous, strided
    torch.Tensor that does not require grad, at or above the size
    threshold, with the plane enabled. Cheap for non-tensor values (one
    sys.modules probe + one isinstance) — this runs on every task/actor
    return. `min_bytes` overrides the general plane's
    RT_DEVICE_OBJECT_MIN_BYTES threshold (compiled-DAG edges pass
    RT_DAG_EDGE_MIN_BYTES: pre-negotiated point-to-point edges amortize
    the pin on much smaller tensors)."""
    torch = sys.modules.get("torch")
    if torch is None:
        # No torch imported in this process => the value can't be a tensor.
        return False
    if not isinstance(value, torch.Tensor):
        return False
    if not CONFIG.device_objects:
        return False
    if value.layout != torch.strided or not value.is_contiguous() \
            or value.requires_grad:
        return False
    return value.nbytes >= (CONFIG.device_object_min_bytes
                            if min_bytes is None else min_bytes)


# ------------------------------------------------------------ wire format
class _DeviceRef:
    """Placeholder that rides the wire in place of the array payload.
    Unpickling it IN ANY PROCESS resolves through the tier ladder — so the
    hint flows through every existing path (direct replies, inline
    advertises, task args, borrowed refs) without new unpickler hooks."""

    __slots__ = ("desc",)

    def __init__(self, desc: dict):
        self.desc = desc

    def __reduce__(self):
        return (_resolve, (self.desc,))


class _ExportWrap:
    """Wrapper for the shm EXPORT blob: deserializing the export in any
    consumer rebuilds a tensor on the producer's device,
    so a consumer that finds the exported segment directly (same-host
    sibling, post-fetch read) gets the same type the placeholder path
    yields."""

    __slots__ = ("nd", "device", "dtype")

    def __init__(self, nd, device: str, dtype: str):
        self.nd = nd
        self.device = device
        self.dtype = dtype

    def __reduce__(self):
        return (_rebuild_export, (self.nd, self.device, self.dtype))


def _rebuild_export(nd, device: str, dtype: str):
    import numpy as np
    import torch

    if not nd.flags.writeable:
        # The view is over a shared store segment; a tensor is mutable, so
        # it gets its own bytes.
        nd = np.array(nd)
    t = torch.from_numpy(nd)
    if dtype == "torch.bfloat16":
        t = t.view(torch.bfloat16)  # exported as uint16 (host_view)
    return t.to(device)


def _ref_blob(desc: dict) -> bytes:
    """The placeholder in the standard inline wire layout so every
    existing blob consumer (fast-path deserialize included) handles it
    untouched."""
    from ray_tpu_torch._private.serialization import inline_header_blob

    return inline_header_blob(pickle.dumps(_DeviceRef(desc), protocol=5))


def _make_desc(oid: str, value, nbytes: int, worker) -> dict:
    return {
        "oid": oid,
        "nbytes": nbytes,
        "shape": tuple(value.shape),
        "dtype": str(value.dtype),
        "device": str(value.device),
        "worker": worker.worker_id,
        "addr": tuple(worker.server_addr),
        "node": worker.node_id,
    }


def _snapshot(value):
    """The pinned copy of a produced tensor. The reference pins a
    `jax.Array`, which is immutable; a tensor is not (an optimizer steps
    its parameters in place), so the pin is a clone taken now: on the card
    a device-to-device copy on the current stream, on the CPU a host copy."""
    return value.detach().clone()


def pin_return(oid: str, value, worker) -> tuple:
    """Producer side of a task/actor return: pin a snapshot and emit
    the standard result tuple (oid, inline, size, holder) with the
    placeholder as the inline payload and this worker's RPC address as the
    device-location hint."""
    value = _snapshot(value)
    nbytes = int(value.nbytes)
    _TABLE.pin(oid, value, nbytes)
    _ensure_metrics_flusher()
    _notify_pins()
    blob = _ref_blob(_make_desc(oid, value, nbytes, worker))
    return (oid, [blob], nbytes, tuple(worker.server_addr))


def pin_put(oid: str, value, worker) -> tuple[bytes, int]:
    """Producer side of an owner-local put()/large-arg promotion: pin and
    return (placeholder_blob, nbytes)."""
    value = _snapshot(value)
    nbytes = int(value.nbytes)
    _TABLE.pin(oid, value, nbytes)
    _ensure_metrics_flusher()
    _notify_pins()
    return _ref_blob(_make_desc(oid, value, nbytes, worker)), nbytes


def pin_edge(oid: str, value, worker):
    """Pin a produced array for a PRE-NEGOTIATED point-to-point edge
    (compiled-DAG device edges, README "Compiled graphs"): like pin_return
    but OUTSIDE the owner-refcount plane — no controller registration, no
    free fan-out. The producing stage owns the pin's lifetime and drops it
    via free_local once every consumer's channel read has provably
    advanced past the invocation (the edge protocol's retention window).
    Returns the placeholder object whose pickle is the ~200B wire payload
    and whose unpickle resolves through the ordinary tier ladder."""
    value = _snapshot(value)
    nbytes = int(value.nbytes)
    _TABLE.pin(oid, value, nbytes)
    _RESOLVE_STATS["edge_pins"] += 1
    _ensure_metrics_flusher()
    _notify_pins()
    return _DeviceRef(_make_desc(oid, value, nbytes, worker))


def advert_fields(worker_id: str, node_id: str) -> dict:
    """Extra register_put fields marking a directory entry device-resident
    (consumed by the controller for list_objects' plane column, free
    fan-out routing, and the producer-death lost sweep)."""
    return {"plane": "device", "device_worker": worker_id,
            "device_node": node_id}


def holds(oid: str) -> bool:
    return _TABLE.holds(oid)


def has_pins() -> bool:
    """Lock-free emptiness probe for hot paths (a stale read just defers
    the drop to the fan-out path, which is idempotent)."""
    return bool(_TABLE._entries)


# ------------------------------------------------------------------ frees
def free_local(oids, store=None) -> int:
    """Drop pins (and this process's shm export mappings) for oids produced
    here — the terminal hop of the owner-tracked free fan-out
    (controller -> node agent -> `device_free` push -> this). Returns the
    number of entries dropped."""
    n = 0
    for oid in oids:
        if _TABLE.discard(oid):
            n += 1
            if store is not None:
                try:
                    store.delete(oid)  # export segment, if one was made
                except Exception:
                    pass
    if n:
        _notify_pins()
    return n


def on_worker_shutdown() -> None:
    """Session teardown: drop every pin and forget peer connections (they
    ride the dying IO loop); reset the metrics drain cache so the next
    session's gauges report from scratch."""
    _TABLE.clear()
    with _conn_lock:
        _conns.clear()
    try:
        from ray_tpu_torch.util import metrics

        metrics.reset_device_stats_cache()
    except Exception:
        pass


# -------------------------------------------------------------- producer
def host_view(t):
    """Host ndarray of a tensor's bytes: a D2H copy for a CUDA tensor, a
    view of a CPU tensor's memory (the exporter writes it into the store
    at once, so the view does not outlive the call). bf16, which numpy
    lacks, comes out as its uint16 bit pattern."""
    import torch

    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.uint16)
    return t.cpu().numpy()


def export_to_store(oid: str, store) -> bool:
    """Materialize a pinned array's bytes into the local shm store (the
    same-host / cross-host serving copy). The export blob deserializes to a
    tensor on the producer's device (see _ExportWrap); its out-of-band
    buffer, the tensor's host bytes, is written straight into the
    destination mmap by put_serialized: no pickle of the payload. Idempotent; returns False if the oid
    is neither pinned nor already exported."""
    from ray_tpu_torch._private.serialization import serialize

    arr = _TABLE.get(oid)
    if arr is None:
        return store.contains(oid)
    if store.contains(oid):
        return True  # repeat consumers attach the existing export for free
    sobj = serialize(_ExportWrap(host_view(arr), str(arr.device),
                                 str(arr.dtype)))
    store.put_serialized(oid, sobj)
    return True


# -------------------------------------------------------------- consumer
_tls = threading.local()


def set_resolve_deadline(deadline) -> None:
    """Propagate a get(timeout=...) deadline into placeholder resolution on
    this thread (set around deserialization by Worker._materialize, cleared
    with None): the tier ladder does real network work inside unpickling,
    which must not outlive the caller's timeout. No deadline = the ladder's
    own defaults."""
    _tls.deadline = deadline


def _op_timeout(default: float) -> float:
    d = getattr(_tls, "deadline", None)
    if d is None:
        return default
    rem = d - time.monotonic()
    if rem <= 0:
        raise exc.GetTimeoutError("get() timed out resolving device object")
    return min(default, rem)


def _resolve(desc: dict):
    """Tier-ladder resolution; the unpickle target of _DeviceRef."""
    oid = desc["oid"]
    arr = _TABLE.get(oid)
    if arr is not None:
        _RESOLVE_STATS["tier0"] += 1
        return arr  # tier 0: same process, the pinned snapshot
    from ray_tpu_torch._private.worker import global_worker

    w = global_worker()
    if w is None:
        raise exc.ObjectLostError(
            f"device object {oid[:16]} cannot be resolved: no ray_tpu_torch "
            f"runtime in this process (producer {desc['worker'][:12]})")
    mv = w.store.get(oid)  # a prior resolve / sibling export already local?
    if mv is not None:
        _RESOLVE_STATS["store_hit"] += 1
    else:
        # Tiers 1/2 do real network work (producer export RPC + attach or
        # chunked fetch): span it so a traced consumer's timeline shows
        # where device-object localization time goes. Tier 0 above stays
        # span-free — a zero-copy dict hit must not pay tracing overhead.
        same_host = tuple(desc["addr"])[0] == w.server_addr[0]
        with _tracing.span("device.resolve", "device",
                           {"oid": oid[:16], "nbytes": desc.get("nbytes"),
                            "tier": "same_host" if same_host
                            else "cross_host"}):
            mv = _localize(w, desc)
    return w._deserialize_blob(mv)


def _localize(w, desc: dict):
    """Move the bytes within reach: ask the producer to export, then attach
    (same host) or pull over the streamed fetch RPC (cross host). All
    failures collapse into ObjectLostError naming the lost producer — a
    consumer must never hang on a dead producer."""
    oid = desc["oid"]
    addr = tuple(desc["addr"])
    try:
        conn = _peer_conn(w, addr)
        t = _op_timeout(60)
        rep = w.io.run(conn.call("export_device_object", oid=oid,
                                 _timeout=t), timeout=t + 5)
        if not rep.get("found"):
            raise exc.ObjectLostError(
                f"device object {oid[:16]} lost: producing worker "
                f"{desc['worker'][:12]} no longer holds it (freed or "
                f"restarted)")
        if addr[0] == w.server_addr[0]:
            mv = w.store.get(oid)  # tier 1: same host, attach the export
            if mv is not None:
                _RESOLVE_STATS["export_rpc"] += 1
                return mv
        if _fetch_via_conn(w, conn, oid,
                           timeout=_op_timeout(120.0)):  # tier 2: pull
            mv = w.store.get(oid)
            if mv is not None:
                _RESOLVE_STATS["fetch"] += 1
                return mv
        raise exc.ObjectLostError(
            f"device object {oid[:16]} lost: fetch from producer "
            f"{desc['worker'][:12]} at {addr} returned nothing")
    except (exc.ObjectLostError, exc.GetTimeoutError):
        raise
    except Exception as e:
        raise exc.ObjectLostError(
            f"device object {oid[:16]} lost: producing worker "
            f"{desc['worker'][:12]} at {addr[0]}:{addr[1]} is unreachable "
            f"({type(e).__name__}: {e})") from e


def _peer_conn(w, addr: tuple):
    """Connection to the producer, preferring (in order) an established
    collective-group link to that address — producer and consumer sitting
    in the same group (parallel/collectives, train worker groups) ride the
    group's transport instead of opening a new socket — then a cached
    direct connection, then a fresh connect."""
    conn = _collective_conn(addr)
    if conn is not None:
        return conn
    with _conn_lock:
        conn = _conns.get(addr)
    if conn is not None and not conn.closed:
        return conn
    from ray_tpu_torch._private import rpc

    t = _op_timeout(10)
    conn = w.io.run(rpc.connect(*addr, timeout=t), timeout=t + 5)
    with _conn_lock:
        _conns[addr] = conn
    return conn


def _collective_conn(addr: tuple):
    col = sys.modules.get("ray_tpu_torch.util.collective")
    if col is None:
        return None
    try:
        for g in col._manager._groups.values():
            for rank, a in g.addrs.items():
                if tuple(a) == addr:
                    conn = g.conns.get(rank)
                    if conn is not None and not conn.closed:
                        return conn
    except Exception:
        pass
    return None


def _fetch_via_conn(w, conn, oid: str, timeout: float = 120.0) -> bool:
    """Chunked pull of the exported blob into the local store over an
    existing connection (the fetch_object server side is the same one the
    host object plane serves)."""
    import asyncio

    chunk = CONFIG.object_chunk_bytes

    async def _go():
        rep = await conn.call("fetch_object", oid=oid, offset=0, length=chunk)
        if not rep.get("found"):
            return False
        size = rep["size"]
        data = rep["data"]
        if size <= len(data):
            w.store.put(oid, [data])
            return True
        stream = w.store.begin_stream(oid, size)
        if stream is None:
            return True  # raced: a local copy already exists
        try:
            woff = 0
            while True:
                await asyncio.to_thread(stream.write, woff, data)
                woff += len(data)
                if woff >= size:
                    break
                rep = await conn.call("fetch_object", oid=oid, offset=woff,
                                      length=chunk)
                if not rep.get("found"):
                    return False  # producer dropped it mid-stream
                data = rep["data"]
            sealed = stream.seal()
            stream = None
            return sealed or w.store.contains(oid)
        finally:
            if stream is not None:
                stream.abort()

    return bool(w.io.run(_go(), timeout=timeout))


# ------------------------------------------------------------ observability
_metrics_hooked = False


def _ensure_metrics_flusher() -> None:
    """First pin starts the metrics flusher so the rt_device_objects gauges
    report even in processes that never mint another metric."""
    global _metrics_hooked
    if _metrics_hooked:
        return
    _metrics_hooked = True
    try:
        from ray_tpu_torch.util import metrics

        metrics.ensure_flusher()
    except Exception:
        pass
