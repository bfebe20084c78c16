"""Dataset: lazy logical plan over distributed blocks.

Parity target: reference python/ray/data/dataset.py:158 (Dataset — lazy
logical plan -> physical operators), iterator APIs
(iterator.py DataIterator), streaming_split feeding trainers
(reference _internal/execution/streaming_executor.py + train integration
session.py:1114 get_dataset_shard).

Counterpart: ray_tpu/data/dataset.py (copied).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import _internal
from ray_tpu_torch.data.block import BlockAccessor
from ray_tpu_torch.data._internal import executor as ex


class Dataset:
    def __init__(self, plan: list):
        self._plan = plan
        self._cached_refs: Optional[list] = None

    # ----------------------------------------------------------- transforms
    def _extend(self, op) -> "Dataset":
        return Dataset(self._plan + [op])

    def map(self, fn: Callable) -> "Dataset":
        return self._extend(ex.MapRows(fn))

    def flat_map(self, fn: Callable) -> "Dataset":
        return self._extend(ex.FlatMap(fn))

    def filter(self, fn: Callable) -> "Dataset":
        return self._extend(ex.Filter(fn))

    def map_batches(self, fn: Callable, *, batch_size: Optional[int] = None,
                    batch_format: str = "numpy",
                    concurrency: Optional[int] = None,
                    fn_constructor_args: tuple = (),
                    fn_constructor_kwargs: Optional[dict] = None) -> "Dataset":
        """Batch transform. A callable CLASS (or concurrency=N) runs on an
        actor pool — __init__ once per actor, the batch-inference pattern
        (reference dataset.py map_batches + ActorPoolMapOperator).
        batch_format: "numpy" (dict of arrays, the device-feed format) or
        "pandas" (DataFrame in, DataFrame out)."""
        if batch_format not in ("numpy", "default", "pandas"):
            raise ValueError(f"unsupported batch_format {batch_format!r}")
        return self._extend(ex.MapBatches(
            fn, batch_size, batch_format=batch_format, concurrency=concurrency,
            fn_constructor_args=fn_constructor_args,
            fn_constructor_kwargs=fn_constructor_kwargs))

    def add_column(self, name: str, fn: Callable) -> "Dataset":
        def _add(batch, _name=name, _fn=fn):
            batch[_name] = _fn(batch)
            return batch

        return self._extend(ex.MapBatches(_add, None))

    def drop_columns(self, cols: list[str]) -> "Dataset":
        drop = set(cols)
        return self._extend(ex.MapBatches(
            lambda b: {k: v for k, v in b.items() if k not in drop}, None))

    def select_columns(self, cols: list[str]) -> "Dataset":
        keep = list(cols)
        return self._extend(ex.MapBatches(
            lambda b: {k: b[k] for k in keep}, None))

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._extend(ex.Repartition(num_blocks))

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        return self._extend(ex.RandomShuffle(seed))

    def sort(self, key=None, descending: bool = False) -> "Dataset":
        return self._extend(ex.Sort(key, descending))

    def limit(self, n: int) -> "Dataset":
        return self._extend(ex.Limit(n))

    def union(self, other: "Dataset") -> "Dataset":
        return self._extend(ex.Union(other._plan))

    # ---------------------------------------------------------- execution
    def materialize(self) -> "Dataset":
        """Execute the plan now; the result holds resolved block refs
        (reference Dataset.materialize -> MaterializedDataset)."""
        refs = self._block_refs()
        out = Dataset([ex.Read(lambda: refs, len(refs))])
        out._cached_refs = refs
        return out

    def _block_refs(self) -> list:
        if self._cached_refs is None:
            self._cached_refs = ex.execute(self._plan)
        return self._cached_refs

    # --------------------------------------------------------- consumption
    def take(self, n: int = 20) -> list:
        out = []
        for ref in self._block_refs():
            block = ray_tpu_torch.get(ref, timeout=600)
            for row in BlockAccessor.for_block(block).iter_rows():
                out.append(row)
                if len(out) >= n:
                    return out
        return out

    def take_all(self) -> list:
        return self.take(n=1 << 62)

    def count(self) -> int:
        total = 0
        for ref in self._block_refs():
            total += BlockAccessor.for_block(ray_tpu_torch.get(ref, timeout=600)).num_rows()
        return total

    def num_blocks(self) -> int:
        return len(self._block_refs())

    def schema(self):
        refs = self._block_refs()
        if not refs:
            return None
        return BlockAccessor.for_block(ray_tpu_torch.get(refs[0], timeout=600)).schema()

    def iter_rows(self) -> Iterable[Any]:
        for ref in self._block_refs():
            yield from BlockAccessor.for_block(ray_tpu_torch.get(ref, timeout=600)).iter_rows()

    def iter_batches(self, *, batch_size: int = 256,
                     batch_format: str = "numpy") -> Iterable[dict]:
        """Stream column-dict batches (reference iter_batches). An
        unexecuted plan streams through _internal.streaming: a trailing
        all-to-all op is consumed block-by-block as its pipelined exchange
        produces reduce outputs, never materialized driver-side. The block
        refs are cached only after a full consumption."""
        if self._cached_refs is not None:
            it = DataIterator(self._cached_refs)
            yield from it.iter_batches(batch_size=batch_size,
                                       batch_format=batch_format)
            return
        from ray_tpu_torch.data._internal import streaming

        def _cache(refs):
            if self._cached_refs is None:
                self._cached_refs = refs

        yield from streaming.iter_batches(
            self._plan, batch_size=batch_size, batch_format=batch_format,
            on_complete=_cache)

    def to_numpy(self, column: Optional[str] = None):
        batches = list(self.iter_batches(batch_size=1 << 30))
        from ray_tpu_torch.data.block import combine_blocks

        merged = combine_blocks(batches) if batches else {}
        if column is not None:
            return merged[column]
        if set(merged.keys()) == {"item"}:
            return merged["item"]
        return merged

    def streaming_split(self, n: int, *, equal: bool = True) -> list["DataIterator"]:
        """Split into n iterators for n training workers (reference
        Dataset.streaming_split feeding get_dataset_shard). equal=True
        (the training default) gives every shard EXACTLY total//n rows,
        dropping the remainder — unequal shards hang lockstep allreduce
        training."""
        refs = self._block_refs()
        if equal:
            return [DataIterator(s) for s in ex._equal_split(refs, n)]
        if len(refs) < n:
            refs = ex._repartition(refs, n)
        shards: list[list] = [[] for _ in range(n)]
        for i, ref in enumerate(refs):
            shards[i % n].append(ref)
        return [DataIterator(s) for s in shards]

    def split(self, n: int) -> list["Dataset"]:
        """General-purpose split: keeps EVERY row (unlike streaming_split's
        training default, which equalizes by dropping the remainder)."""
        return [Dataset([ex.Read(lambda s=s: list(s._refs), len(s._refs))])
                for s in self.streaming_split(n, equal=False)]

    # ------------------------------------------------------------- writes
    def _write(self, path: str, fmt: str, ext: str) -> list[str]:
        """One output file per block, written by remote tasks (reference
        write_parquet/_csv/_json -> per-block write tasks)."""
        import os

        os.makedirs(path, exist_ok=True)
        refs = self._block_refs()
        outs = [_write_block.remote(ref, os.path.join(
            path, f"part-{i:05d}.{ext}"), fmt) for i, ref in enumerate(refs)]
        return ray_tpu_torch.get(outs, timeout=600)

    def write_parquet(self, path: str) -> list[str]:
        return self._write(path, "parquet", "parquet")

    def write_csv(self, path: str) -> list[str]:
        return self._write(path, "csv", "csv")

    def write_json(self, path: str) -> list[str]:
        return self._write(path, "json", "json")

    # --------------------------------------------------------- aggregates
    def _agg(self, on: Optional[str], op: str, combine):
        """Per-block partial aggregates computed in remote tasks; only the
        scalars come back to the driver."""
        refs = self._block_refs()
        if on is None:
            # Resolve the column ONCE from the schema so every block
            # aggregates the same column; require it to be unambiguous.
            schema = self.schema() or {}
            cols = list(schema)
            if len(cols) != 1:
                raise ValueError(
                    f"dataset has columns {cols}; pass on=<column> to aggregate")
            on = cols[0]
        parts = [p for p in ray_tpu_torch.get(
            [_partial_agg.remote(r, on, op) for r in refs], timeout=600)
            if p is not None]
        return combine(parts) if parts else None

    def sum(self, on: Optional[str] = None):
        return self._agg(on, "sum", sum)

    def min(self, on: Optional[str] = None):
        return self._agg(on, "min", min)

    def max(self, on: Optional[str] = None):
        return self._agg(on, "max", max)

    def mean(self, on: Optional[str] = None):
        tot = self._agg(on, "sum_count",
                        lambda ps: tuple(map(sum, zip(*ps))))
        if tot is None:
            return None
        s, n = tot
        return s / n if n else None

    def groupby(self, key) -> "GroupedData":
        return GroupedData(self, key)

    def __repr__(self):
        names = [type(op).__name__ for op in self._plan]
        return f"Dataset(plan={' -> '.join(names)})"


@ray_tpu_torch.remote
def _write_block(block, path: str, fmt: str) -> str:
    import pyarrow as pa

    batch = BlockAccessor.for_block(block).to_batch()
    table = pa.table({k: pa.array(v) for k, v in batch.items()})
    if fmt == "parquet":
        import pyarrow.parquet as pq

        pq.write_table(table, path)
    elif fmt == "csv":
        import pyarrow.csv as pacsv

        pacsv.write_csv(table, path)
    elif fmt == "json":
        import json

        with open(path, "w") as f:
            for row in BlockAccessor.for_block(block).iter_rows():
                f.write(json.dumps(
                    {k: (v.item() if hasattr(v, "item") else v)
                     for k, v in row.items()} if isinstance(row, dict)
                    else row) + "\n")
    else:
        raise ValueError(f"unknown write format {fmt}")
    return path


@ray_tpu_torch.remote
def _partial_agg(block, on: str, op: str):
    """One block's partial aggregate (scalar or (sum, count) pair)."""
    batch = BlockAccessor.for_block(block).to_batch()
    if not batch:
        return None
    if on not in batch:
        raise KeyError(f"block is missing aggregation column {on!r} "
                       f"(has {list(batch)})")
    v = batch[on]
    if not len(v):
        return None
    if op == "sum":
        return np.sum(v)
    if op == "min":
        return np.min(v)
    if op == "max":
        return np.max(v)
    if op == "sum_count":
        return (np.sum(v), len(v))
    raise ValueError(f"unknown aggregate {op}")


@ray_tpu_torch.remote
def _partial_group(block, key, on):
    """Map-side partial aggregation: key -> (rows, values, sum, min, max).
    `values` counts rows that actually carry the aggregation column — mean
    must divide by it, not by the row count."""
    acc = BlockAccessor.for_block(block)
    out: dict = {}
    kf = key if callable(key) else (
        lambda r: r[key] if isinstance(r, dict) else r)
    for row in acc.iter_rows():
        k = kf(row)
        v = row.get(on) if (on is not None and isinstance(row, dict)) else None
        c, vc, s, mn, mx = out.get(k, (0, 0, 0.0, None, None))
        c += 1
        if v is not None:
            vc += 1
            s += v
            mn = v if mn is None else min(mn, v)
            mx = v if mx is None else max(mx, v)
        out[k] = (c, vc, s, mn, mx)
    return out


class GroupedData:
    """groupby aggregations via map-side partial agg + driver combine
    (reference grouped_data.py; the reference shuffles — at this scale a
    tree-combine of partial states is the same result cheaper)."""

    def __init__(self, ds: Dataset, key):
        self._ds = ds
        self._key = key
        # Output rows need a string column name; a callable key has none.
        self._key_col = key if isinstance(key, str) else "key"

    def _combined(self, on: Optional[str]) -> dict:
        parts = ray_tpu_torch.get(
            [_partial_group.remote(r, self._key, on)
             for r in self._ds._block_refs()], timeout=600)
        merged: dict = {}
        for part in parts:
            for k, (c, vc, s, mn, mx) in part.items():
                C, VC, S, MN, MX = merged.get(k, (0, 0, 0.0, None, None))
                merged[k] = (
                    C + c, VC + vc, S + s,
                    mn if MN is None else (MN if mn is None else min(MN, mn)),
                    mx if MX is None else (MX if mx is None else max(MX, mx)))
        return merged

    def _to_dataset(self, rows: list) -> Dataset:
        return Dataset([ex.Read(lambda b=[rows]: b, 1)])

    def count(self) -> Dataset:
        rows = [{self._key_col: k, "count()": c}
                for k, (c, *_rest) in sorted(self._combined(None).items())]
        return self._to_dataset(rows)

    def sum(self, on: str) -> Dataset:
        rows = [{self._key_col: k, f"sum({on})": s}
                for k, (_c, _vc, s, _mn, _mx) in sorted(self._combined(on).items())]
        return self._to_dataset(rows)

    def mean(self, on: str) -> Dataset:
        rows = [{self._key_col: k, f"mean({on})": s / vc}
                for k, (_c, vc, s, _mn, _mx) in sorted(self._combined(on).items())
                if vc]
        return self._to_dataset(rows)

    def min(self, on: str) -> Dataset:
        rows = [{self._key_col: k, f"min({on})": mn}
                for k, (_c, _vc, _s, mn, _mx) in sorted(self._combined(on).items())]
        return self._to_dataset(rows)

    def max(self, on: str) -> Dataset:
        rows = [{self._key_col: k, f"max({on})": mx}
                for k, (_c, _vc, _s, _mn, mx) in sorted(self._combined(on).items())]
        return self._to_dataset(rows)


class DataIterator:
    """Per-consumer block iterator (reference python/ray/data/iterator.py
    DataIterator). Picklable: holds object refs, so it can be shipped to a
    training worker and consumed there."""

    def __init__(self, refs: list):
        self._refs = list(refs)

    def iter_batches(self, *, batch_size: int = 256, batch_format: str = "numpy",
                     drop_last: bool = False) -> Iterable[dict]:
        carry: Optional[dict] = None
        from ray_tpu_torch.data.block import combine_blocks

        for ref in self._refs:
            block = ray_tpu_torch.get(ref, timeout=600)
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
        if carry and not drop_last:
            yield carry

    def iter_rows(self) -> Iterable[Any]:
        for ref in self._refs:
            yield from BlockAccessor.for_block(ray_tpu_torch.get(ref, timeout=600)).iter_rows()

    def materialize(self) -> "Dataset":
        return Dataset([ex.Read(lambda: list(self._refs), len(self._refs))])

    def __reduce__(self):
        return (DataIterator, (self._refs,))
