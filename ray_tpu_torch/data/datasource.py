"""Datasources: pluggable block producers for the read APIs.

Parity target: reference python/ray/data/datasource/datasource.py (Datasource
/ ReadTask) + file_based_datasource.py (path expansion, per-file read tasks)
+ parquet/csv/json/text/binary/numpy datasources. Blocks are columnar dicts
of numpy arrays (or row lists), matching ray_tpu_torch.data.block.BlockAccessor.

Counterpart: ray_tpu/data/datasource.py (copied).
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Any, Callable, Iterable, Optional

import numpy as np


class ReadTask:
    """A picklable unit of read work executed inside a remote task; calling
    it returns ONE block (reference ReadTask returns a block iterable; one
    block per task keeps the plan's block count == parallelism)."""

    def __init__(self, fn: Callable[[], Any], metadata: Optional[dict] = None):
        self._fn = fn
        self.metadata = metadata or {}

    def __call__(self):
        return self._fn()


class Datasource:
    """Base datasource (reference datasource.py:Datasource)."""

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        raise NotImplementedError

    def estimate_inmemory_data_size(self) -> Optional[int]:
        return None


def _expand_paths(paths) -> list[str]:
    """File path / dir / glob expansion (reference file_based_datasource
    path resolution, local scheme only — cloud storage is out of scope for
    the single-host object store; exchange spill goes through the
    `ray_tpu_torch.storage` backend seam, not through datasource paths)."""
    if isinstance(paths, str):
        paths = [paths]
    out: list[str] = []
    for p in paths:
        p = os.path.expanduser(p)
        if os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if not f.startswith((".", "_")))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files found for {paths!r}")
    return out


class FileBasedDatasource(Datasource):
    """One read task per byte-sized file group; subclasses parse a single
    file. Blocks target RT_DATA_BLOCK_BYTES (reference file_based_
    datasource's target_max_block_size): many small files pack into one
    task, one oversized file splits into row-range slices — so the
    exchange downstream gets real parallelism either way, instead of one
    block per file."""

    #: Subclasses where a file's rows cannot be sliced (e.g. one row per
    #: whole file) set this False; oversized files then stay one block.
    _splittable = True

    def __init__(self, paths, **reader_kwargs):
        self._paths = _expand_paths(paths)
        self._kwargs = reader_kwargs

    def _read_file(self, path: str):
        raise NotImplementedError

    def _read_group(self, group: list):
        """group entries: a path (whole file) or a (path, j, m) triplet —
        slice j of m equal row ranges of one oversized file."""
        from ray_tpu_torch.data.block import BlockAccessor, combine_blocks

        blocks = []
        for item in group:
            if isinstance(item, tuple):
                path, j, m = item
                acc = BlockAccessor.for_block(self._read_file(path))
                n = acc.num_rows()
                blocks.append(acc.slice((n * j) // m, (n * (j + 1)) // m))
            else:
                blocks.append(self._read_file(item))
        return blocks[0] if len(blocks) == 1 else combine_blocks(blocks)

    def estimate_inmemory_data_size(self) -> Optional[int]:
        try:
            return sum(os.path.getsize(p) for p in self._paths)
        except OSError:
            return None

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        from ray_tpu_torch._private.rtconfig import CONFIG

        try:
            sizes = [os.path.getsize(p) for p in self._paths]
        except OSError:
            sizes = [0] * len(self._paths)
        total = sum(sizes)
        if total <= 0:
            # No size information: fall back to count-based contiguous
            # chunks, one group per unit of parallelism.
            n = max(1, min(parallelism, len(self._paths)))
            base, extra = divmod(len(self._paths), n)
            groups, start = [], 0
            for i in range(n):
                count = base + (1 if i < extra else 0)
                if count:
                    groups.append(self._paths[start:start + count])
                    start += count
        else:
            # Target bytes per block: RT_DATA_BLOCK_BYTES capped so the
            # requested parallelism is still reachable when the data is
            # small. Contiguous packing keeps block order == file order.
            target = max(1, min(max(1, CONFIG.data_block_bytes),
                                total // max(1, parallelism) or total))
            groups = []
            cur: list = []
            cur_bytes = 0
            for path, size in zip(self._paths, sizes):
                if self._splittable and size > target:
                    if cur:
                        groups.append(cur)
                        cur, cur_bytes = [], 0
                    m = -(-size // target)  # ceil: slices per big file
                    groups.extend([(path, j, m)] for j in range(m))
                    continue
                if cur and cur_bytes + size > target:
                    groups.append(cur)
                    cur, cur_bytes = [], 0
                cur.append(path)
                cur_bytes += size
            if cur:
                groups.append(cur)
        return [ReadTask(_BoundGroupRead(self, g), {"paths": g}) for g in groups]


class _BoundGroupRead:
    """Picklable (datasource, group) closure for a read task."""

    def __init__(self, ds: FileBasedDatasource, group: list):
        self.ds = ds
        self.group = group

    def __call__(self):
        return self.ds._read_group(self.group)


def _table_to_block(table) -> dict:
    """Arrow table -> columnar numpy block."""
    return {name: table.column(name).to_numpy(zero_copy_only=False)
            for name in table.column_names}


class ParquetDatasource(FileBasedDatasource):
    def __init__(self, paths, columns: Optional[list[str]] = None, **kw):
        super().__init__(paths, **kw)
        self._columns = columns

    def _read_file(self, path: str):
        import pyarrow.parquet as pq

        return _table_to_block(pq.read_table(path, columns=self._columns))


class CSVDatasource(FileBasedDatasource):
    def _read_file(self, path: str):
        import pyarrow.csv as pacsv

        return _table_to_block(pacsv.read_csv(path, **self._kwargs))


class JSONDatasource(FileBasedDatasource):
    """JSON-lines (and pyarrow-supported JSON) files."""

    def _read_file(self, path: str):
        import pyarrow.json as pajson

        return _table_to_block(pajson.read_json(path, **self._kwargs))


class TextDatasource(FileBasedDatasource):
    def _read_file(self, path: str):
        with open(path, "r", encoding=self._kwargs.get("encoding", "utf-8")) as f:
            lines = f.read().splitlines()
        if self._kwargs.get("drop_empty_lines", True):
            lines = [l for l in lines if l]
        return {"text": np.asarray(lines, dtype=object)}


class BinaryDatasource(FileBasedDatasource):
    _splittable = False  # one row per whole file: no row ranges to cut

    def _read_group(self, group: list[str]):
        data, paths = [], []
        for p in group:
            with open(p, "rb") as f:
                data.append(f.read())
            paths.append(p)
        block = {"bytes": np.asarray(data, dtype=object)}
        if self._kwargs.get("include_paths", False):
            block["path"] = np.asarray(paths, dtype=object)
        return block

    def _read_file(self, path: str):  # pragma: no cover - _read_group overrides
        raise NotImplementedError


class NumpyDatasource(FileBasedDatasource):
    def _read_file(self, path: str):
        arr = np.load(path, allow_pickle=self._kwargs.get("allow_pickle", False))
        return {"data": arr}


class RangeDatasource(Datasource):
    """range / range_tensor (reference read_api.range: 'id' column)."""

    def __init__(self, n: int, tensor_shape: Optional[tuple] = None,
                 column: str = "id"):
        self.n = n
        self.tensor_shape = tensor_shape
        self.column = column

    def estimate_inmemory_data_size(self) -> int:
        per = 8
        if self.tensor_shape:
            per = 8 * int(np.prod(self.tensor_shape))
        return self.n * per

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        n = max(1, min(parallelism, self.n) if self.n else 1)
        per = self.n // n
        extra = self.n % n
        tasks, start = [], 0
        for i in range(n):
            count = per + (1 if i < extra else 0)
            if count == 0:
                continue
            tasks.append(ReadTask(
                _RangeRead(start, count, self.tensor_shape, self.column),
                {"num_rows": count}))
            start += count
        return tasks


class _RangeRead:
    def __init__(self, start, count, tensor_shape, column):
        self.start, self.count = start, count
        self.tensor_shape, self.column = tensor_shape, column

    def __call__(self):
        ids = np.arange(self.start, self.start + self.count)
        if self.tensor_shape is None:
            return {self.column: ids}
        reps = int(np.prod(self.tensor_shape))
        data = np.repeat(ids, reps).reshape((self.count, *self.tensor_shape))
        return {"data": data}


class ItemsDatasource(Datasource):
    """from_items: local python objects, split across blocks."""

    def __init__(self, items: list):
        self.items = list(items)

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        n = max(1, min(parallelism, len(self.items)) if self.items else 1)
        per = len(self.items) // n
        extra = len(self.items) % n
        tasks, start = [], 0
        for i in range(n):
            count = per + (1 if i < extra else 0)
            if count == 0:
                continue
            chunk = self.items[start:start + count]
            tasks.append(ReadTask(lambda c=chunk: c, {"num_rows": count}))
            start += count
        return tasks
