"""Pipelined distributed exchange: the map/reduce core of the data plane.

Parity target: reference python/ray/data/_internal/planner/exchange/ (the
sort/shuffle task specs) executed the *streaming* way — reference
streaming_executor.py keeps every operator's work bounded and in flight
concurrently instead of materializing stage boundaries.

The exchange here replaces the v0 barrier (`_exchange_maps`: ALL map
tasks complete before any reduce submits) with a pipelined loop:

- map tasks run under the per-operator in-flight budget
  (RT_DATA_MAX_INFLIGHT_BLOCKS) with the store-backpressure brake, and
  each one's partition shards become available the moment it finishes
  (multi-return: one owned object per partition, straight into node shm
  via the task-return `put_serialized` one-copy path — same-host shards
  never round-trip through pickled RPC payloads);
- the reduce side starts merging as soon as a partition's first inputs
  land: whenever a partition has RT_DATA_REDUCE_FANIN shards pending,
  a consolidation task merges them into one object (bounded fan-in,
  applied recursively — no reduce ever takes an unbounded arg list);
- under memory pressure consolidated shards spill through the storage
  plane (spill.py) and restore transparently at the final reduce;
- finalized partition refs are YIELDED in partition order as their
  reduce tasks submit, so a downstream `iter_batches()` consumer starts
  before the exchange drains (streaming.py rides this).

Determinism: every shard is tagged with its producing map index and every
merge orders entries by that tag before combining, so the output is
byte-identical regardless of completion order, pipelining mode
(RT_DATA_PIPELINED_EXCHANGE=0 barrier A/B leg), or mid-exchange retries
(chaos: a SIGKILLed map/reduce worker's shards re-execute through the
runtime's dedup plane and land in the same slots).

Counterpart: ray_tpu/data/_internal/exchange.py (copied).
"""

from __future__ import annotations

import heapq
import pickle
import random
import threading
import time
import uuid
from typing import Callable, Iterator, Optional

import ray_tpu_torch
from ray_tpu_torch._private.rtconfig import CONFIG
from ray_tpu_torch.data._internal import spill as _spill
from ray_tpu_torch.data.block import BlockAccessor, combine_blocks

# ------------------------------------------------------------------ stats
# Process-local exchange telemetry: the driver loop bumps the in-flight /
# stall / ordering / spill fields (spills from the resolved consolidation
# metas, so each spill is counted in exactly one process); reduce tasks
# bump restored_bytes in their own worker process. telemetry.WorkerSampler
# and util.metrics export whatever the local process accumulated
# (sys.modules-gated, like the device-store and llm series).
_STATS_LOCK = threading.Lock()
_STATS = {
    "exchanges": 0,            # completed exchanges (driver)
    "maps_done": 0,            # map tasks completed (driver)
    "reduces_submitted": 0,    # consolidation + final reduce tasks (driver)
    "blocks_inflight": 0,      # gauge: block tasks in flight right now
    "max_inflight": 0,         # high-water mark of the above
    "bp_stalls": 0,            # submit-loop pauses on store backpressure
    "spilled_bytes": 0,        # payload bytes written to the spill backend
    "spilled_parts": 0,        # shards spilled
    "restored_bytes": 0,       # payload bytes restored on consume
    "reduce_before_last_map": 0,  # 1 once a reduce submitted with maps live
    "stream_max_ahead": 0,     # streaming consumption: max unconsumed blocks
}


def exchange_stats() -> dict:
    with _STATS_LOCK:
        return dict(_STATS)


def reset_exchange_stats() -> None:
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0


def _bump(key: str, n: int = 1) -> None:
    with _STATS_LOCK:
        _STATS[key] += n


def _gauge_inflight(n: int) -> None:
    with _STATS_LOCK:
        _STATS["blocks_inflight"] = n
        if n > _STATS["max_inflight"]:
            _STATS["max_inflight"] = n


def note_stream_ahead(n: int) -> None:
    """Streaming consumers report their unconsumed-block high-water mark
    here (pinned by the in-flight-budget test)."""
    with _STATS_LOCK:
        if n > _STATS["stream_max_ahead"]:
            _STATS["stream_max_ahead"] = n


# ------------------------------------------------------------------ helpers
def _key_fn(key):
    return key if callable(key) else (
        lambda r, k=key: r[k] if isinstance(r, dict) else r)


def inflight_budget() -> int:
    return max(1, CONFIG.data_max_inflight_blocks)


def _flatten_parts(parts) -> list:
    """Normalize reduce inputs to a flat list of (map_idx, rows) entries.
    A part is a tagged shard tuple (one map task's output for this
    partition), a list of entries (a consolidation task's output), or a
    SpilledPart marker (restored through the storage plane)."""
    entries: list = []
    for part in parts:
        if isinstance(part, _spill.SpilledPart):
            restored = _spill.restore(part)
            _bump("restored_bytes", part.nbytes)
            entries.extend(restored)
        elif isinstance(part, tuple):
            entries.append(part)
        else:
            entries.extend(part)
    return entries


# ------------------------------------------------------------ remote tasks
@ray_tpu_torch.remote
def _consolidate(spec: Optional[dict], *parts):
    """Incremental reduce-side merge of one partition's pending shards
    (bounded fan-in). Two returns: a tiny meta dict the driver may inspect
    without touching the payload, and the consolidated payload itself —
    either the entry list (staying in shm via the one-copy return path) or
    a SpilledPart marker when the spill policy triggers."""
    entries = _flatten_parts(parts)
    meta = {"nbytes": 0, "spilled": False}
    payload = entries
    if spec is not None:
        blob = pickle.dumps(entries, protocol=pickle.HIGHEST_PROTOCOL)
        meta["nbytes"] = len(blob)
        cap = spec.get("cap") or 0
        if spec.get("force") or (cap and len(blob) > cap):
            payload = _spill.spill_bytes(blob, spec["uri"], spec["partition"])
            # No _bump here: the meta is the single source of truth for
            # spill accounting — the driver resolves it after the drain.
            # A worker-side bump would double-count through the per-process
            # metrics drain once the driver bumps its own stats.
            meta["spilled"] = True
    return [meta, payload]


@ray_tpu_torch.remote
def _finalize_partition(op: str, arg, *parts):
    """Final reduce of one partition. Entries are ordered by producing map
    index first, so output is independent of arrival order and merge
    grouping (see module docstring on determinism)."""
    entries = _flatten_parts(parts)
    entries.sort(key=lambda e: e[0])
    if op == "sort":
        key, descending = arg
        return list(heapq.merge(*[e[1] for e in entries],
                                key=_key_fn(key), reverse=descending))
    if op == "concat":
        # Format-preserving merge (repartition): shards are block slices,
        # not row lists; empty shards (a map had no rows for this
        # partition) would poison columnar concatenation.
        blocks = [e[1] for e in entries
                  if BlockAccessor.for_block(e[1]).num_rows()]
        return combine_blocks(blocks)
    rows: list = []
    for _idx, part_rows in entries:
        rows.extend(part_rows)
    if op == "shuffle":
        random.Random(arg).shuffle(rows)
    return rows


# ------------------------------------------------------------- driver loop
def exchange_partitions(refs: list, *, op: str, k: int,
                        map_submit: Callable[[int, object], list],
                        finalize_arg=None) -> Iterator:
    """Run one all-to-all exchange; yields each partition's final block
    ref in partition order, submitting reduces as inputs land.

    map_submit(i, ref) submits map task i with num_returns=k and returns
    its per-partition shard refs; each shard must be a (map_idx, rows)
    tuple. op is "shuffle" / "sort" / "concat" (+ finalize_arg: the
    partition-seed base for shuffle, (key, descending) for sort).
    """
    from ray_tpu_torch.data._internal.executor import _store_backpressured

    if not refs:
        return
    pipelined = CONFIG.data_pipelined_exchange
    fanin = max(2, CONFIG.data_reduce_fanin)
    budget = inflight_budget()
    mem_cap = CONFIG.data_mem_cap_bytes
    spill_uri = _spill.spill_root()
    ex_id = uuid.uuid4().hex[:8]
    spill_seq = 0
    t0 = time.monotonic()

    # parts[p]: pending reduce inputs for partition p (tagged shard refs
    # and consolidation payload refs). meta_refs: consolidation metas,
    # resolved once at the end for the spill accounting.
    parts: list[list] = [[] for _ in range(k)]
    meta_refs: list = []
    pending: dict = {}  # first shard ref -> full shard ref list
    submitted = 0
    maps_done = 0

    def _spill_spec(p: int) -> Optional[dict]:
        nonlocal spill_seq
        force = _store_backpressured()
        if not force and not mem_cap:
            return None  # no policy armed: skip the serialize-for-size pass
        spill_seq += 1
        return {
            "uri": f"{spill_uri}/ex-{ex_id}/p{p}-{spill_seq}.bin",
            "cap": mem_cap, "partition": p, "force": force,
        }

    def _consolidate_p(p: int) -> None:
        spec = _spill_spec(p)
        out = _consolidate.options(num_returns=2).remote(spec, *parts[p])
        meta_refs.append(out[0])
        parts[p] = [out[1]]
        _bump("reduces_submitted")
        if pending:  # reduce-side merge submitted with maps still in flight
            with _STATS_LOCK:
                _STATS["reduce_before_last_map"] = 1

    while submitted < len(refs) or pending:
        stalled = False
        while submitted < len(refs) and len(pending) < budget:
            if pending and _store_backpressured():
                # The brake only engages with work already in flight:
                # progress is always possible even when the store starts
                # above the mark.
                stalled = True
                break
            shard_refs = map_submit(submitted, refs[submitted])
            if not isinstance(shard_refs, list):
                shard_refs = [shard_refs]
            pending[shard_refs[0]] = shard_refs
            submitted += 1
            _gauge_inflight(len(pending))
        if stalled:
            _bump("bp_stalls")
        if pending:
            done, _ = ray_tpu_torch.wait(list(pending), num_returns=1, timeout=10)
            for d in done:
                shard_refs = pending.pop(d, None)
                if shard_refs is None:
                    continue
                maps_done += 1
                _bump("maps_done")
                for p in range(k):
                    parts[p].append(shard_refs[p if k > 1 else 0])
            _gauge_inflight(len(pending))
            if pipelined and pending:
                # Reduce-side merging starts the moment a partition's
                # pending shards reach the fan-in bound — while maps are
                # still running (the no-barrier core of this module).
                for p in range(k):
                    if len(parts[p]) >= fanin:
                        _consolidate_p(p)

    for p in range(k):
        # Keep the final reduce's fan-in bounded too: a tail of shards
        # that never hit the bound mid-flight consolidates here first.
        while pipelined and len(parts[p]) > fanin:
            _consolidate_p(p)
        arg = finalize_arg(p) if callable(finalize_arg) else finalize_arg
        out = _finalize_partition.remote(op, arg, *parts[p])
        parts[p] = []
        _bump("reduces_submitted")
        yield out

    # Exchange accounting: resolve the (tiny) consolidation metas, emit
    # ONE lifecycle event per exchange — never per block.
    spilled_bytes = spilled_parts = 0
    try:
        for meta in ray_tpu_torch.get(meta_refs, timeout=600):
            if meta.get("spilled"):
                spilled_bytes += meta["nbytes"]
                spilled_parts += 1
    except Exception:
        pass  # a failed consolidation surfaces via its payload consumer
    if spilled_parts:
        _bump("spilled_bytes", spilled_bytes)
        _bump("spilled_parts", spilled_parts)
    _bump("exchanges")
    try:
        from ray_tpu_torch._private.events import emit_event

        if spilled_parts:
            emit_event(
                "data_spill",
                f"exchange {op} spilled {spilled_parts} shard(s)",
                attrs={"op": op, "bytes": spilled_bytes,
                       "parts": spilled_parts,
                       "scheme": spill_uri.split("://", 1)[0]})
        emit_event(
            "data_exchange",
            f"{op} exchange: {len(refs)} maps -> {k} partitions",
            attrs={"op": op, "maps": len(refs), "partitions": k,
                   "pipelined": bool(pipelined),
                   "spilled_bytes": spilled_bytes,
                   "elapsed_s": round(time.monotonic() - t0, 3)})
    except Exception:
        pass


def run_exchange(refs: list, **kw) -> list:
    """Materializing wrapper: run the exchange to completion, return the
    per-partition block refs."""
    return list(exchange_partitions(refs, **kw))
