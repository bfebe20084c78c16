"""Streaming execution of a logical plan over the task pool.

Parity target: reference python/ray/data/_internal/execution/
streaming_executor.py:52 (pull-based streaming over an operator DAG with
bounded in-flight work) + operators/map_operator.py:64 (task-based map) +
logical/optimizers.py (operator fusion).

Design: logical ops are fused into per-block transform chains
(reference's MapOperator fusion), executed as remote tasks with a bounded
in-flight window so a long dataset streams instead of materializing; blocks
live in the object store between stages. All-to-all ops (repartition,
random_shuffle, sort) ride the pipelined map/reduce exchange in
exchange.py (reduce-side merging overlaps the map wave — no stage
barrier); streaming consumption lives in streaming.py. This module owns
the logical plan, fusion, and the per-block map path.

Counterpart: ray_tpu/data/_internal/executor.py (copied).
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable, Optional

import ray_tpu_torch
from ray_tpu_torch.data._internal import exchange as _ex
from ray_tpu_torch.data.block import BlockAccessor, combine_blocks
#: Pause new block submissions while cluster shm usage is above this
#: fraction of capacity (consumers/spill catch up; submissions resume).
STORE_BACKPRESSURE_FRACTION = 0.75
_BP_POLL_S = 0.2

_bp_cache = {"t": 0.0, "hit": False}


def _store_backpressured() -> bool:
    """Cluster object-store usage above the high-water mark? Cached for
    _BP_POLL_S so the hot submit loop costs one controller round trip per
    poll interval, not per block."""
    now = time.monotonic()
    if now - _bp_cache["t"] < _BP_POLL_S:
        return _bp_cache["hit"]
    _bp_cache["t"] = now
    try:
        from ray_tpu_torch._private.worker import global_worker

        w = global_worker()
        rep = w.io.run(w.controller.call("object_store_stats"), timeout=10)
        cap = rep.get("capacity") or 1
        _bp_cache["hit"] = rep.get("shm_bytes", 0) > \
            STORE_BACKPRESSURE_FRACTION * cap
    except Exception:
        _bp_cache["hit"] = False
    return _bp_cache["hit"]


# ------------------------------------------------------------ logical plan
class LogicalOp:
    name = "op"


class Read(LogicalOp):
    name = "Read"

    def __init__(self, blocks_fn: Callable[[], list], num_blocks: int):
        self.blocks_fn = blocks_fn  # () -> list of block payloads or refs
        self.num_blocks = num_blocks


class ReadSource(LogicalOp):
    """Lazy datasource read: each ReadTask runs in a remote task when the
    plan executes (reference read_api.read_datasource -> ReadTask tasks in
    the streaming executor's first operator)."""

    name = "ReadSource"

    def __init__(self, tasks: list):
        self.tasks = tasks  # list[ray_tpu_torch.data.datasource.ReadTask]
        self.num_blocks = len(tasks)


class MapRows(LogicalOp):
    name = "Map"

    def __init__(self, fn):
        self.fn = fn


class FlatMap(LogicalOp):
    name = "FlatMap"

    def __init__(self, fn):
        self.fn = fn


class Filter(LogicalOp):
    name = "Filter"

    def __init__(self, fn):
        self.fn = fn


class MapBatches(LogicalOp):
    name = "MapBatches"

    def __init__(self, fn, batch_size: Optional[int],
                 batch_format: str = "numpy",
                 concurrency: Optional[int] = None,
                 fn_constructor_args: tuple = (),
                 fn_constructor_kwargs: Optional[dict] = None):
        self.fn = fn
        self.batch_size = batch_size
        self.batch_format = batch_format
        # concurrency (or a class fn) switches execution to an actor pool
        # (reference operators/map_operator.py:64 ActorPoolMapOperator).
        self.concurrency = concurrency
        self.fn_constructor_args = fn_constructor_args
        self.fn_constructor_kwargs = fn_constructor_kwargs or {}

    @property
    def needs_actors(self) -> bool:
        return self.concurrency is not None or isinstance(self.fn, type)


class Repartition(LogicalOp):
    name = "Repartition"

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks


class RandomShuffle(LogicalOp):
    name = "RandomShuffle"

    def __init__(self, seed: Optional[int]):
        self.seed = seed


class Sort(LogicalOp):
    name = "Sort"

    def __init__(self, key, descending: bool):
        self.key = key
        self.descending = descending


class Limit(LogicalOp):
    name = "Limit"

    def __init__(self, n: int):
        self.n = n


class Union(LogicalOp):
    name = "Union"

    def __init__(self, other_plan: list):
        self.other_plan = other_plan


# ------------------------------------------------------------- transforms
def _apply_chain(block, chain):
    """Run a fused chain of row/batch transforms over one block in-task."""
    for kind, fn, arg in chain:
        acc = BlockAccessor.for_block(block)
        if kind == "map":
            block = [fn(r) for r in acc.iter_rows()]
        elif kind == "flat_map":
            out = []
            for r in acc.iter_rows():
                out.extend(fn(r))
            block = out
        elif kind == "filter":
            block = [r for r in acc.iter_rows() if fn(r)]
        elif kind == "map_batches":
            bs, fmt = arg if isinstance(arg, tuple) else (arg, "numpy")
            bs = bs or acc.num_rows() or 1
            pieces = []
            n = acc.num_rows()
            for s in range(0, n, bs):
                batch = (acc.to_batch() if (s == 0 and bs >= n)
                         else BlockAccessor.for_block(
                             acc.slice(s, min(s + bs, n))).to_batch())
                if fmt == "pandas":
                    import pandas as pd

                    df = fn(pd.DataFrame(batch))
                    out = {c: df[c].to_numpy() for c in df.columns}
                else:
                    out = fn(batch)
                pieces.append(out)
            block = combine_blocks(pieces) if pieces else block
    return block


@ray_tpu_torch.remote
def _transform_block(block, chain):
    return _apply_chain(block, chain)


@ray_tpu_torch.remote
def _exec_read_task(task, chain):
    """Run a datasource ReadTask (and any fused downstream per-block chain)
    inside a worker: file parsing happens on the cluster, not the driver."""
    block = task()
    return _apply_chain(block, chain) if chain else block


@ray_tpu_torch.remote
class _MapBatchesActor:
    """Actor-pool map worker (reference ActorPoolMapOperator's _MapWorker):
    a callable-class fn is constructed ONCE per actor — the pattern for
    batch inference, where __init__ loads model weights."""

    def __init__(self, fn, args, kwargs):
        self.fn = fn(*args, **kwargs) if isinstance(fn, type) else fn

    def apply(self, block, batch_size, batch_format="numpy"):
        return _apply_chain(
            block, [("map_batches", self.fn, (batch_size, batch_format))])


@ray_tpu_torch.remote
def _split_block(block, sizes):
    acc = BlockAccessor.for_block(block)
    out, off = [], 0
    for s in sizes:
        out.append(acc.slice(off, off + s))
        off += s
    return out if len(out) > 1 else out[0]


def _key_fn(key):
    return key if callable(key) else (
        lambda r, k=key: r[k] if isinstance(r, dict) else r)


@ray_tpu_torch.remote
def _sort_block_local(block, key, descending):
    rows = BlockAccessor.for_block(block).to_rows()
    return sorted(rows, key=_key_fn(key), reverse=descending)


# ---- distributed exchange map tasks (reference planner/exchange/
# sort_task_spec.py + shuffle_task_spec.py map sides; the reduce side —
# consolidation + finalize — lives in exchange.py). Every shard is tagged
# (map_idx, payload) so exchange merges are arrival-order independent; the
# driver touches only sampled keys and refs, never rows. ------------------
@ray_tpu_torch.remote
def _sample_block_keys(block, key, n_samples):
    """Uniform key sample of one block (reference SortTaskSpec.sample)."""
    rows = BlockAccessor.for_block(block).to_rows()
    if not rows:
        return []
    kf = _key_fn(key)
    rng = random.Random(0xC0FFEE ^ len(rows))
    picks = rows if len(rows) <= n_samples else rng.sample(rows, n_samples)
    return [kf(r) for r in picks]


@ray_tpu_torch.remote
def _sort_map(block, map_idx, key, descending, boundaries):
    """Map side of the sort exchange: bucket rows by ASCENDING range
    boundaries, each bucket sorted in final order; one return per range
    (reference sort_task_spec.map)."""
    import bisect

    rows = BlockAccessor.for_block(block).to_rows()
    kf = _key_fn(key)
    buckets: list[list] = [[] for _ in range(len(boundaries) + 1)]
    for r in rows:
        buckets[bisect.bisect_right(boundaries, kf(r))].append(r)
    for b in buckets:
        b.sort(key=kf, reverse=descending)
    if descending:
        buckets.reverse()  # partition 0 holds the LARGEST keys
    tagged = [(map_idx, b) for b in buckets]
    return tagged if len(tagged) > 1 else tagged[0]


@ray_tpu_torch.remote
def _shuffle_map(block, map_idx, k, seed):
    """Map side of the shuffle exchange: permute this block's rows and deal
    them into k sub-blocks (reference shuffle_task_spec.map)."""
    rows = BlockAccessor.for_block(block).to_rows()
    rng = random.Random(seed)
    rng.shuffle(rows)
    per = len(rows) // k
    extra = len(rows) % k
    parts, off = [], 0
    for i in range(k):
        take = per + (1 if i < extra else 0)
        parts.append((map_idx, rows[off:off + take]))
        off += take
    return parts if k > 1 else parts[0]


@ray_tpu_torch.remote
def _repart_map(block, map_idx, k, parts):
    """Map side of the repartition exchange: cut this block's driver-planned
    row ranges into format-preserving slices, one return per output
    partition (empty slice where none of this block lands)."""
    acc = BlockAccessor.for_block(block)
    out: list = [(map_idx, [])] * k
    off = 0
    for pi, take in parts:
        out[pi] = (map_idx, acc.slice(off, off + take))
        off += take
    return out if k > 1 else out[0]


# -------------------------------------------------------------- execution
def _fuse(plan: list) -> list:
    """Fuse consecutive per-row/batch ops into chains (reference fusion
    rule, logical/optimizers.py). Actor-pool map_batches stages break the
    chain: they execute on a dedicated actor pool."""
    fused: list = []
    chain: list = []
    for op in plan:
        if isinstance(op, MapRows):
            chain.append(("map", op.fn, None))
        elif isinstance(op, FlatMap):
            chain.append(("flat_map", op.fn, None))
        elif isinstance(op, Filter):
            chain.append(("filter", op.fn, None))
        elif isinstance(op, MapBatches) and not op.needs_actors:
            chain.append(("map_batches", op.fn, (op.batch_size, op.batch_format)))
        else:
            if chain:
                fused.append(("chain", chain))
                chain = []
            fused.append(("op", op))
    if chain:
        fused.append(("chain", chain))
    return fused


def _windowed_submit(items: list, submit) -> list:
    """Submit one task per item with a bounded in-flight window (streaming
    — reference streaming_executor's bounded operator concurrency). The
    window is the per-operator block budget (RT_DATA_MAX_INFLIGHT_BLOCKS)
    plus the store-backpressure brake (reference backpressure_policy/:
    ConcurrencyCapBackpressurePolicy + the object-store-memory policy)."""
    budget = _ex.inflight_budget()
    out = [None] * len(items)
    in_flight: dict = {}
    i = 0
    while i < len(items) or in_flight:
        while (i < len(items) and len(in_flight) < budget
               and not (in_flight and _store_backpressured())):
            # The brake only engages with work already in flight: progress
            # is always possible even when the store starts above the mark.
            out[i] = submit(items[i])
            # Multi-return submits (exchange map tasks) track their first
            # ref: all returns of one task resolve together.
            in_flight[out[i][0] if isinstance(out[i], list) else out[i]] = i
            i += 1
        if in_flight:
            done, _ = ray_tpu_torch.wait(list(in_flight), num_returns=1, timeout=10)
            for d in done:
                in_flight.pop(d, None)
    return out


def _windowed_map(refs: list, chain) -> list:
    return _windowed_submit(refs, lambda r: _transform_block.remote(r, chain))


def _actor_pool_map(refs: list, op: "MapBatches") -> list:
    """Run a map_batches stage on a pool of actors: least-loaded dispatch
    with a small per-actor pipeline (reference ActorPoolMapOperator +
    _ActorPool in operators/actor_pool_map_operator.py)."""
    n = max(1, min(op.concurrency or 1, len(refs) or 1))
    actors = [_MapBatchesActor.remote(op.fn, tuple(op.fn_constructor_args),
                                      dict(op.fn_constructor_kwargs))
              for _ in range(n)]
    try:
        out = [None] * len(refs)
        pending: dict = {}  # result ref -> actor index
        load = [0] * n
        i = 0
        while i < len(refs) or pending:
            while i < len(refs) and min(load) < 2:
                ai = load.index(min(load))
                r = actors[ai].apply.remote(refs[i], op.batch_size,
                                            op.batch_format)
                out[i] = r
                pending[r] = ai
                load[ai] += 1
                i += 1
            if pending:
                done, _ = ray_tpu_torch.wait(list(pending), num_returns=1, timeout=10)
                for d in done:
                    load[pending.pop(d)] -= 1
        # Results are resolved (inline or node-shm with the agent as holder),
        # so the pool can be torn down before downstream consumption.
        return out
    finally:
        for a in actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass


def _equal_split(refs: list, n: int) -> list[list]:
    """Split blocks into n shards with IDENTICAL row counts (total//n each,
    remainder dropped) — lockstep allreduce training hangs on unequal shards
    (reference streaming_split(equal=True) -> equalize splits)."""
    sizes = _block_sizes(refs)
    total = sum(sizes)
    per = total // n
    shards: list[list] = [[] for _ in range(n)]
    if per == 0:
        return shards
    si, need = 0, per
    for ref, size in zip(refs, sizes):
        # Plan this block's cuts: (target shard | None to drop, row count).
        parts: list[tuple[Optional[int], int]] = []
        off = 0
        while off < size:
            if si >= n:
                parts.append((None, size - off))  # remainder: dropped
                break
            take = min(size - off, need)
            parts.append((si, take))
            off += take
            need -= take
            if need == 0:
                si += 1
                need = per
        if len(parts) == 1 and parts[0][0] is not None:
            shards[parts[0][0]].append(ref)
            continue
        if all(s is None for s, _t in parts):
            continue  # block is entirely dropped remainder: no task needed
        # Cut in a remote task with one return per piece: payloads never
        # visit the driver (streaming_split feeds trainers with datasets
        # larger than driver memory).
        prefs = _split_block.options(num_returns=len(parts)).remote(
            ref, [t for _s, t in parts])
        if not isinstance(prefs, list):
            prefs = [prefs]
        for (sidx, _t), pref in zip(parts, prefs):
            if sidx is not None:
                shards[sidx].append(pref)
    return shards


def execute(plan: list) -> list:
    """Run the logical plan, returning block refs."""
    assert plan and isinstance(plan[0], (Read, ReadSource))
    fused = _fuse(plan[1:])
    if isinstance(plan[0], ReadSource):
        # Fuse the first per-block chain straight into the read tasks: one
        # remote task parses AND transforms each block (reference
        # read->map fusion).
        read_chain = None
        if fused and fused[0][0] == "chain":
            read_chain = fused.pop(0)[1]
        refs = _windowed_submit(
            plan[0].tasks,
            lambda t: _exec_read_task.remote(t, read_chain))
    else:
        refs = [b if isinstance(b, ray_tpu_torch.ObjectRef) else ray_tpu_torch.put(b)
                for b in plan[0].blocks_fn()]
    for kind, item in fused:
        if kind == "chain":
            refs = _windowed_map(refs, item)
            continue
        op = item
        if isinstance(op, Repartition):
            refs = _repartition(refs, op.num_blocks)
        elif isinstance(op, RandomShuffle):
            refs = _random_shuffle(refs, op.seed)
        elif isinstance(op, Sort):
            refs = _global_sort(refs, op.key, op.descending)
        elif isinstance(op, Limit):
            refs = _limit(refs, op.n)
        elif isinstance(op, Union):
            refs = refs + execute(op.other_plan)
        elif isinstance(op, MapBatches):  # actor-pool stage
            refs = _actor_pool_map(refs, op)
        else:
            raise ValueError(f"unknown op {op.name}")
    return refs


@ray_tpu_torch.remote
def _count_rows(block) -> int:
    return BlockAccessor.for_block(block).num_rows()


def _block_sizes(refs: list) -> list[int]:
    """Row counts WITHOUT pulling block payloads to the driver."""
    return ray_tpu_torch.get([_count_rows.remote(r) for r in refs], timeout=600)


def _repartition(refs: list, k: int) -> list:
    return list(_repartition_stream(refs, k))


def _repartition_stream(refs: list, k: int):
    """Repartition as a pipelined exchange: the driver plans row-range
    assignments from block COUNTS, map tasks cut format-preserving slices,
    the exchange's reduce side concatenates each output partition
    (reference planner/exchange/). Rows never visit the driver; returns an
    iterator of partition refs (streaming.py consumes it lazily)."""
    if not refs:
        return iter(())
    sizes = _block_sizes(refs)
    total = sum(sizes)
    target = [total // k + (1 if i < total % k else 0) for i in range(k)]
    # Assign row ranges to output partitions.
    splits_per_block = []
    t_i, t_left = 0, target[0] if target else 0
    for s in sizes:
        parts = []
        left = s
        while left > 0:
            take = min(left, t_left) if t_left else left
            parts.append((t_i, take))
            left -= take
            t_left -= take
            while t_left == 0 and t_i < k - 1:
                t_i += 1
                t_left = target[t_i]
        splits_per_block.append(parts)
    stream = _ex.exchange_partitions(
        refs, op="concat", k=k,
        map_submit=lambda i, r: _repart_map.options(num_returns=k).remote(
            r, i, k, splits_per_block[i]))
    # Empty output partitions (fewer rows than k) are dropped, matching
    # Dataset.num_blocks() semantics for tiny datasets.
    return (b for b, t in zip(stream, target) if t)


def _random_shuffle(refs: list, seed) -> list:
    return list(_random_shuffle_stream(refs, seed))


def _random_shuffle_stream(refs: list, seed):
    """Distributed shuffle exchange (reference shuffle_task_spec.py): map
    tasks permute + deal each block into k sub-blocks, the exchange's
    reduce side merges one sub-block per map and re-permutes. Rows never
    visit the driver."""
    if not refs:
        return iter(())
    k = len(refs)
    base = seed if seed is not None else random.randrange(1 << 30)
    return _ex.exchange_partitions(
        refs, op="shuffle", k=k,
        map_submit=lambda i, r: _shuffle_map.options(num_returns=k).remote(
            r, i, k, base ^ (0x9E3779B9 * (i + 1))),
        finalize_arg=lambda p: base ^ (0x85EBCA6B * (p + 1)))


def _global_sort(refs: list, key, descending) -> list:
    return list(_global_sort_stream(refs, key, descending))


def _global_sort_stream(refs: list, key, descending):
    """Distributed sort exchange (reference sort_task_spec.py): sample keys
    -> compute k-1 range boundaries -> map tasks range-partition + locally
    sort -> the exchange's reduce side heap-merges each range. The driver
    sees sampled KEYS only, never rows."""
    if not refs:
        return iter(())
    k = len(refs)
    if k == 1:
        return iter([_sort_block_local.remote(refs[0], key, descending)])
    # 1. sample (driver holds ~20 keys per block, not rows)
    samples_per_block = 20
    key_samples: list = []
    for sref in _windowed_submit(
            refs, lambda r: _sample_block_keys.remote(
                r, key, samples_per_block)):
        key_samples.extend(ray_tpu_torch.get(sref, timeout=600))
    key_samples.sort()
    if not key_samples:
        return iter(refs)
    # 2. boundaries: k-1 ascending quantile cut points
    boundaries = [key_samples[min(len(key_samples) - 1,
                                  (len(key_samples) * (i + 1)) // k)]
                  for i in range(k - 1)]
    # 3+4. map (range-partition + local sort) feeding the pipelined merge;
    # partition order already matches `descending` — _sort_map reverses
    # bucket order for descending.
    return _ex.exchange_partitions(
        refs, op="sort", k=k,
        map_submit=lambda i, r: _sort_map.options(num_returns=k).remote(
            r, i, key, descending, boundaries),
        finalize_arg=(key, descending))


def _limit(refs: list, n: int) -> list:
    out, have = [], 0
    for ref in refs:
        if have >= n:
            break
        block = ray_tpu_torch.get(ref, timeout=600)
        acc = BlockAccessor.for_block(block)
        r = acc.num_rows()
        if have + r <= n:
            out.append(ref)
            have += r
        else:
            out.append(ray_tpu_torch.put(acc.slice(0, n - have)))
            have = n
    return out
