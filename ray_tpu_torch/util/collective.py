"""Collective communication library.

Parity target: reference python/ray/util/collective/collective.py
(GroupManager:40, init_collective_group:123, allreduce:268; NCCL/GLOO
backends under util/collective/collective_group/).

Two-tier design:
- **Device tier**: collectives between cards on one program belong to
  `torch.distributed` (NCCL on the card, gloo on the CPU), which the train
  workers join through `train.torch_utils.setup_torch_distributed`. This
  module does not wrap it.
- **Host tier** (this module): cross-process collectives for host data —
  gradient allreduce across worker processes, rendezvous/barriers for worker
  groups, weight broadcast — playing the role the reference's GLOO groups
  play.

Transport: the controller KV is used ONCE per group, as the address
rendezvous. Every collective then runs over DIRECT worker-to-worker RPC
connections in a ring — bandwidth-optimal ring allreduce (reduce-scatter +
all-gather, 2(W-1) steps moving ~2·data/W per link per step), ring
allgather and broadcast forwarding. Nothing flows through the controller,
so per-step gradient sync scales to large worlds instead of serializing
O(world^2) copies through one asyncio loop.

Every rank calls init_collective_group(world_size, rank, group_name) first
(reference collective.py:123), then the collectives; calls are matched by a
per-group monotonically increasing sequence number.

Counterpart: ray_tpu/util/collective.py. Ported: `allreduce` flattens with
`torch.utils._pytree`, and a tensor leaf rides the ring as host numpy
(bf16 widened to f32 from its uint16 bits) and comes back as a tensor of
its dtype on its device.
"""

from __future__ import annotations

import pickle
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private import rpc, watchdog
from ray_tpu_torch._private import tracing as _tracing
from ray_tpu_torch._private.rtconfig import CONFIG
from ray_tpu_torch._private.worker import global_worker

_DEFAULT_TIMEOUT = 120.0


def _op_timeout() -> float:
    """Per-op deadline (RT_COLLECTIVE_TIMEOUT_S; <=0 = module default).
    Every blocking recv inside an op is bounded by it, so a ring wedged on
    a sick peer aborts with CollectiveTimeoutError instead of hanging."""
    t = CONFIG.collective_timeout_s
    return float(t) if t and t > 0 else _DEFAULT_TIMEOUT


class ReduceOp:
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"


_REDUCERS = {
    ReduceOp.SUM: lambda a, b: a + b,
    ReduceOp.PRODUCT: lambda a, b: a * b,
    ReduceOp.MIN: lambda a, b: np.minimum(a, b),
    ReduceOp.MAX: lambda a, b: np.maximum(a, b),
}


# --------------------------------------------------------------- transport
_inbox_cv = threading.Condition()
_inboxes: dict[tuple, deque] = {}  # (group, tag, src) -> messages


def _inbox_deliver(a: dict):
    """Runs on the worker's IO loop for every inbound col_msg push."""
    key = (a["group"], a["tag"], a["src"])
    with _inbox_cv:
        _inboxes.setdefault(key, deque()).append(a["blob"])
        _inbox_cv.notify_all()


def _inbox_recv(group: str, tag: str, src: int,
                timeout: float = _DEFAULT_TIMEOUT) -> bytes:
    key = (group, tag, src)
    deadline = time.monotonic() + timeout
    with _inbox_cv:
        while True:
            q = _inboxes.get(key)
            if q:
                blob = q.popleft()
                if not q:
                    del _inboxes[key]
                return blob
            rem = deadline - time.monotonic()
            if rem <= 0:
                raise TimeoutError(
                    f"collective recv timeout: group={group} tag={tag} src={src}")
            # Stall plane armed: wait in slices, ticking the beacon each
            # one — this block is BOUNDED by the op's own deadline, whose
            # expiry produces the far more actionable
            # CollectiveTimeoutError (it names the wedged peer), so the
            # generic per-task kill ladder must not win the race just
            # because RT_STALL_KILL_S < the op deadline. Unarmed (the
            # default): one full-duration wait, zero extra wakeups.
            if watchdog.is_armed():
                _inbox_cv.wait(min(rem, 0.25))
                watchdog.report_progress()
            else:
                _inbox_cv.wait(rem)


@dataclass
class _Group:
    name: str
    world_size: int
    rank: int
    seq: int = 0
    addrs: dict = field(default_factory=dict)  # rank -> (host, port)
    conns: dict = field(default_factory=dict)  # rank -> rpc.Connection
    # P2P counters, per peer and per direction — INDEPENDENT of the group
    # seq: p2p matches only (src, dst, nth-message), so an asymmetric
    # send/recv pattern must not desync the group's collective sequence.
    p2p_sent: dict = field(default_factory=dict)
    p2p_rcvd: dict = field(default_factory=dict)


class GroupManager:
    """Per-process registry of collective groups (reference GroupManager,
    collective.py:40)."""

    def __init__(self):
        self._groups: dict[str, _Group] = {}

    def create(self, group_name: str, world_size: int, rank: int) -> _Group:
        if not (0 <= rank < world_size):
            raise ValueError(f"rank {rank} out of range for world_size {world_size}")
        g = _Group(group_name, world_size, rank)
        self._groups[group_name] = g
        return g

    def get(self, group_name: str) -> _Group:
        if group_name not in self._groups:
            raise ValueError(
                f"collective group {group_name!r} not initialized in this process; "
                f"call init_collective_group() first")
        return self._groups[group_name]

    def destroy(self, group_name: str):
        g = self._groups.pop(group_name, None)
        if g is not None:
            w = global_worker()
            for conn in g.conns.values():
                try:
                    w.io.run(conn.close(), timeout=5)
                except Exception:
                    pass
            # Drop this rank's address key: a later re-init of the same
            # group name must re-rendezvous against LIVE addresses, not
            # this incarnation's (possibly dead) ones.
            try:
                w.kv("del", ns="collective",
                     key=f"col/{group_name}/addr/{g.rank}")
            except Exception:
                pass


_manager = GroupManager()


def init_collective_group(world_size: int, rank: int, group_name: str = "default"):
    """Join this process to a named collective group: publish this rank's
    RPC address in the controller KV (the one controller round trip per
    group) and collect every peer's (reference init_collective_group:123)."""
    w = _worker()
    w.collective_msg_cb = _inbox_deliver
    # Drop any stale messages from a previous incarnation of this group
    # name in this process (re-init after destroy).
    with _inbox_cv:
        for k in [k for k in _inboxes if k[0] == group_name]:
            del _inboxes[k]
    g = _manager.create(group_name, world_size, rank)
    _kv_put(f"col/{group_name}/addr/{rank}",
            pickle.dumps(tuple(w.server_addr)))
    _wait_all(f"col/{group_name}/addr", world_size)
    for r in range(world_size):
        g.addrs[r] = pickle.loads(_kv_wait(f"col/{group_name}/addr/{r}"))
    return g


def init_prenegotiated_group(world_size: int, rank: int, addrs: dict,
                             group_name: str = "default",
                             connect: bool = False):
    """Join a group whose full rank->(host, port) address map was gathered
    ONCE by a coordinator and pushed to every member — the compiled-DAG
    model applied to collectives: membership is negotiated at compile
    time, like channels are, so joining does no controller KV publish and
    no rendezvous polling (init_collective_group's per-rank put + poll).
    Pipeline/tensor-parallel stages use this: the DAG driver collects each
    stage worker's RPC address at build time and every stage joins with
    one local call. `connect=True` additionally dials every peer now, so
    first-op latency (and the device-object plane's preference for
    established group links, device_store._collective_conn) doesn't wait
    on a lazy connect."""
    w = _worker()
    w.collective_msg_cb = _inbox_deliver
    with _inbox_cv:
        for k in [k for k in _inboxes if k[0] == group_name]:
            del _inboxes[k]
    amap = {int(r): tuple(a) for r, a in addrs.items()}
    if len(amap) != world_size or sorted(amap) != list(range(world_size)):
        raise ValueError(
            f"pre-negotiated group {group_name!r}: address map must cover "
            f"ranks 0..{world_size - 1} exactly (got {sorted(amap)})")
    g = _manager.create(group_name, world_size, rank)
    g.addrs = amap
    if connect:
        for r in range(world_size):
            if r != rank:
                _conn_to(g, r)
    return g


def destroy_collective_group(group_name: str = "default"):
    _manager.destroy(group_name)


def get_rank(group_name: str = "default") -> int:
    return _manager.get(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _manager.get(group_name).world_size


def _conn_to(g: _Group, rank: int):
    conn = g.conns.get(rank)
    if conn is None or conn.closed:
        conn = _worker().io.run(
            rpc.connect(*g.addrs[rank], timeout=10), timeout=30)
        g.conns[rank] = conn
    return conn


def _send_to(g: _Group, rank: int, tag: str, blob: bytes):
    _conn_to(g, rank).push_threadsafe(
        "col_msg", group=g.name, tag=tag, src=g.rank, blob=blob)


def _recv_step(g: _Group, op: str, tag: str, src: int) -> bytes:
    """One bounded ring/p2p receive. A deadline expiry names the op, the
    group, this rank, and the peer the recv was WAITING on — on a ring
    that peer (or someone upstream of it) is the wedged one. Each
    completed step ticks the stall watchdog's progress beacon: a long
    healthy collective is progress, not a stall."""
    try:
        blob = _inbox_recv(g.name, tag, src, timeout=_op_timeout())
    except TimeoutError:
        watchdog.record("collective_timeout", f"{op} {g.name} <- r{src}")
        raise exc.CollectiveTimeoutError(
            f"collective {op!r} timed out after {_op_timeout():.1f}s in "
            f"group {g.name!r} (rank {g.rank}/{g.world_size}, seq {g.seq}): "
            f"still waiting on peer rank {src} — it (or a rank upstream of "
            f"it on the ring) has stalled or died; set "
            f"RT_COLLECTIVE_TIMEOUT_S to tune this deadline") from None
    watchdog.report_progress()
    return blob


# ------------------------------------------------------------- collectives
def allreduce(tensor, op: str = ReduceOp.SUM, group_name: str = "default"):
    """Allreduce a numpy array or tensor (or pytree of them) across the
    group via ring reduce-scatter + ring all-gather. Returns the reduced
    value (functional, unlike the reference's in-place NCCL semantics): a
    tensor leaf comes back as a new tensor of its dtype on its device, a
    numpy leaf as numpy."""
    from torch.utils import _pytree

    g = _manager.get(group_name)
    g.seq += 1
    if g.world_size == 1:
        return tensor
    leaves, treedef = _pytree.tree_flatten(tensor)
    arrs = [_to_ring(x) for x in leaves]
    # Traced task context (if any) spans the whole ring op — the 2(W-1)
    # steps' wall time is exactly the per-step gradient-sync cost.
    with _tracing.span("collective.allreduce", "collective",
                       {"group": group_name, "seq": g.seq,
                        "world": g.world_size}):
        reduced = _ring_allreduce(g, g.seq, arrs, _REDUCERS[op])
    return _pytree.tree_unflatten(
        [_from_ring(r, x) for r, x in zip(reduced, leaves)], treedef)


def _to_ring(x) -> np.ndarray:
    """Host numpy for one leaf. A bf16 tensor leaves the device as its
    uint16 bits (host_view) and is widened to f32, so it sums in f32."""
    import torch

    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    from ray_tpu_torch._private.device_store import host_view

    nd = host_view(x)
    if x.dtype == torch.bfloat16:
        nd = (nd.astype(np.uint32) << 16).view(np.float32)
    return nd


def _from_ring(r: np.ndarray, like):
    import torch

    if not isinstance(like, torch.Tensor):
        return r
    if not r.flags.writeable:
        r = r.copy()  # an in-band unpickled array is read-only
    return torch.from_numpy(r).to(device=like.device, dtype=like.dtype)


def allgather(tensor, group_name: str = "default") -> list:
    """Returns [rank0_value, rank1_value, ...] via a ring (W-1 forwarding
    steps; each step every link carries one rank's value)."""
    g = _manager.get(group_name)
    g.seq += 1
    if g.world_size == 1:
        return [tensor]
    W, r, seq = g.world_size, g.rank, g.seq
    out: list = [None] * W
    out[r] = tensor
    nxt, prv = (r + 1) % W, (r - 1) % W
    carry = pickle.dumps(tensor, protocol=5)
    with _tracing.span("collective.allgather", "collective",
                       {"group": group_name, "seq": seq, "world": W}):
        for step in range(W - 1):
            _send_to(g, nxt, f"ag{seq}.{step}", carry)
            carry = _recv_step(g, "allgather", f"ag{seq}.{step}", prv)
            out[(r - 1 - step) % W] = pickle.loads(carry)
    return out


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    """Ring-forward from src: each rank receives from its predecessor and
    forwards to its successor (unless the successor is src)."""
    g = _manager.get(group_name)
    g.seq += 1
    if g.world_size == 1:
        return tensor
    W, r, seq = g.world_size, g.rank, g.seq
    nxt, prv = (r + 1) % W, (r - 1) % W
    tag = f"bc{seq}"
    with _tracing.span("collective.broadcast", "collective",
                       {"group": group_name, "seq": seq, "world": W}):
        if r == src_rank:
            _send_to(g, nxt, tag, pickle.dumps(tensor, protocol=5))
            return tensor
        blob = _recv_step(g, "broadcast", tag, prv)
        if nxt != src_rank:
            _send_to(g, nxt, tag, blob)
        return pickle.loads(blob)


def reducescatter(tensor, op: str = ReduceOp.SUM, group_name: str = "default"):
    """Reduce across the group, return this rank's 1/world_size slice along
    axis 0 (reference reducescatter)."""
    g = _manager.get(group_name)
    reduced = allreduce(tensor, op, group_name)
    chunks = np.array_split(np.asarray(reduced), g.world_size, axis=0)
    return chunks[g.rank]


def barrier(group_name: str = "default"):
    """Two token laps around the ring: after lap one every rank has entered;
    lap two releases them (a single lap would let rank src exit while the
    tail of the ring is still arriving)."""
    g = _manager.get(group_name)
    g.seq += 1
    if g.world_size == 1:
        return
    W, r, seq = g.world_size, g.rank, g.seq
    nxt, prv = (r + 1) % W, (r - 1) % W
    with _tracing.span("collective.barrier", "collective",
                       {"group": group_name, "seq": seq, "world": W}):
        for lap in range(2):
            tag = f"bar{seq}.{lap}"
            if r == 0:
                _send_to(g, nxt, tag, b"")
                _recv_step(g, "barrier", tag, prv)
            else:
                _recv_step(g, "barrier", tag, prv)
                _send_to(g, nxt, tag, b"")


def send(tensor, dst_rank: int, group_name: str = "default"):
    """P2P send over the direct connection (reference collective.send);
    matched by the per-(src,dst) message counter — deliberately NOT the
    group seq, so asymmetric p2p patterns can't desync the collectives."""
    g = _manager.get(group_name)
    n = g.p2p_sent[dst_rank] = g.p2p_sent.get(dst_rank, 0) + 1
    _send_to(g, dst_rank, f"p2p{n}", pickle.dumps(tensor, protocol=5))


def recv(src_rank: int, group_name: str = "default"):
    g = _manager.get(group_name)
    n = g.p2p_rcvd[src_rank] = g.p2p_rcvd.get(src_rank, 0) + 1
    return pickle.loads(_recv_step(g, "recv", f"p2p{n}", src_rank))


# ---------------------------------------------------------- ring allreduce
def _partition_leaves(arrs: list, w: int) -> list[list[int]]:
    """Contiguous, byte-balanced buckets of leaf indices (one per rank)."""
    sizes = [a.nbytes for a in arrs]
    total = sum(sizes) or 1
    target = total / w
    buckets: list[list[int]] = [[] for _ in range(w)]
    b, acc = 0, 0.0
    for i, sz in enumerate(sizes):
        buckets[b].append(i)
        acc += sz
        # advance once this bucket is full, keeping at least the remaining
        # leaves >= remaining buckets is NOT required (empty buckets ok)
        if acc >= target * (b + 1) and b < w - 1:
            b += 1
    return buckets


def _ring_allreduce(g: _Group, seq: int, arrs: list, reduce2) -> list:
    """Classic ring: W-1 reduce-scatter steps then W-1 all-gather steps.
    Buckets are contiguous groups of pytree leaves (byte-balanced), so
    mixed dtypes/shapes need no flat-buffer packing. At RS step t rank r
    sends bucket (r-t) mod W and reduces into bucket (r-t-1) mod W; after
    W-1 steps r owns fully-reduced bucket (r+1) mod W. AG step t forwards
    bucket (r+1-t) mod W."""
    W, r = g.world_size, g.rank
    buckets = _partition_leaves(arrs, W)
    acc: dict[int, list] = {b: [arrs[i] for i in idxs]
                            for b, idxs in enumerate(buckets)}
    nxt, prv = (r + 1) % W, (r - 1) % W
    for t in range(W - 1):
        sb, rb = (r - t) % W, (r - t - 1) % W
        _send_to(g, nxt, f"rs{seq}.{t}",
                 pickle.dumps(acc[sb], protocol=5))
        inc = pickle.loads(_recv_step(g, "allreduce", f"rs{seq}.{t}", prv))
        acc[rb] = [reduce2(a, b) for a, b in zip(acc[rb], inc)]
    carry = pickle.dumps(acc[(r + 1) % W], protocol=5)
    for t in range(W - 1):
        rb = (r - t) % W
        # Forward the raw blob received last step — re-pickling an already
        # serialized bucket at every hop would cost ~2.G.(W-2)/W extra
        # serialization work per allreduce.
        _send_to(g, nxt, f"ag{seq}.{t}", carry)
        carry = _recv_step(g, "allreduce", f"ag{seq}.{t}", prv)
        acc[rb] = pickle.loads(carry)
    out = [None] * len(arrs)
    for b, idxs in enumerate(buckets):
        for j, i in enumerate(idxs):
            out[i] = acc[b][j]
    return out


# ---------------------------------------------------------------- plumbing
def _worker():
    w = global_worker()
    if w is None:
        raise RuntimeError("ray_tpu_torch.init() must be called before collectives")
    return w


def _kv_put(key: str, value: bytes):
    _worker().kv("put", ns="collective", key=key, value=value)


def _kv_get(key: str):
    return _worker().kv("get", ns="collective", key=key)["value"]


def _kv_wait(key: str, timeout: float = _DEFAULT_TIMEOUT,
             interval: float = 0.003) -> bytes:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = _kv_get(key)
        if v is not None:
            return v
        time.sleep(interval)
    raise TimeoutError(f"collective timeout waiting for {key}")


def _wait_all(prefix: str, world_size: int, timeout: float = _DEFAULT_TIMEOUT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        keys = _worker().kv("keys", ns="collective", prefix=prefix)["keys"]
        if len(keys) >= world_size:
            return
        time.sleep(0.003)
    raise TimeoutError(f"collective rendezvous timeout on {prefix}")
