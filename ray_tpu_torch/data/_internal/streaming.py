"""Streaming consumption: iter_batches without driver materialization.

Parity target: reference python/ray/data/iterator.py (iter_batches) over
_internal/execution/streaming_executor.py output — the consumer reads
batches while upstream operators are still producing blocks.

`iter_batches(plan)` drives the plan's trailing all-to-all op (if any)
through the pipelined exchange LAZILY: exchange.exchange_partitions is a
generator, so each block the consumer pulls advances the exchange by at
most one final-reduce submission. Combined with the bounded look-ahead
window here (the same RT_DATA_MAX_INFLIGHT_BLOCKS budget the exchange
uses for its map wave), the driver never holds more than `budget`
unconsumed block refs — an ingest-to-train loop over a dataset larger
than driver memory stays flat (the budget-pin test reads the high-water
mark from exchange_stats()["stream_max_ahead"]).

Counterpart: ray_tpu/data/_internal/streaming.py (copied).
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator, Optional

import ray_tpu_torch
from ray_tpu_torch.data._internal import exchange as _ex
from ray_tpu_torch.data.block import BlockAccessor, combine_blocks


def stream_blocks(plan: list) -> Iterator:
    """Yield the plan's output block refs, pipelining a trailing
    all-to-all op instead of materializing its full output ref list."""
    from ray_tpu_torch.data._internal import executor as ex

    last = plan[-1] if len(plan) > 1 else None
    if isinstance(last, (ex.Repartition, ex.RandomShuffle, ex.Sort)):
        refs = ex.execute(plan[:-1])
        if isinstance(last, ex.RandomShuffle):
            yield from ex._random_shuffle_stream(refs, last.seed)
        elif isinstance(last, ex.Sort):
            yield from ex._global_sort_stream(refs, last.key, last.descending)
        else:
            yield from ex._repartition_stream(refs, last.num_blocks)
        return
    yield from ex.execute(plan)


def iter_batches(plan: list, *, batch_size: int = 256,
                 batch_format: str = "numpy",
                 on_complete=None) -> Iterable[dict]:
    """Stream column-dict batches from a logical plan with a bounded
    block look-ahead. `on_complete(refs)` fires only when the stream is
    fully drained — Dataset uses it to cache the block refs so a second
    consumption doesn't re-execute the plan."""
    budget = _ex.inflight_budget()
    src = stream_blocks(plan)
    buf: deque = deque()
    seen: list = []
    exhausted = False
    carry: Optional[dict] = None
    while True:
        while not exhausted and len(buf) < budget:
            try:
                ref = next(src)
            except StopIteration:
                exhausted = True
                break
            buf.append(ref)
            seen.append(ref)
            _ex.note_stream_ahead(len(buf))
        if not buf:
            break
        block = ray_tpu_torch.get(buf.popleft(), timeout=600)
        batch = BlockAccessor.for_block(block).to_batch()
        if carry:
            batch = combine_blocks([carry, batch])
            carry = None
        n = len(next(iter(batch.values()))) if batch else 0
        s = 0
        while n - s >= batch_size:
            yield {k: v[s:s + batch_size] for k, v in batch.items()}
            s += batch_size
        if s < n:
            carry = {k: v[s:] for k, v in batch.items()}
    if carry:
        yield carry
    if on_complete is not None:
        on_complete(seen)
