"""Blocks: the unit of data the executor moves through the object store.

Parity target: reference python/ray/data/block.py (Block/BlockAccessor).
A block is either a list of rows (dicts / scalars) or a column dict of numpy
arrays ("batch layout"). BlockAccessor normalizes between the two.

Counterpart: ray_tpu/data/block.py (copied).
"""

from __future__ import annotations

from typing import Any, Iterable

import numpy as np


def _column(values) -> np.ndarray:
    """Build a numpy column from row values. bytes/str rows must get
    object dtype: numpy's fixed-width S/U dtypes treat trailing NULs as
    padding and silently strip them on element access."""
    if isinstance(values, np.ndarray):
        return values
    vals = values if isinstance(values, list) else list(values)
    if vals and isinstance(vals[0], (bytes, bytearray, str)):
        return np.asarray(vals, dtype=object)
    return np.asarray(vals)


class BlockAccessor:
    def __init__(self, block):
        self.block = block

    @staticmethod
    def for_block(block) -> "BlockAccessor":
        return BlockAccessor(block)

    def is_columnar(self) -> bool:
        return isinstance(self.block, dict)

    def num_rows(self) -> int:
        if self.is_columnar():
            if not self.block:
                return 0
            return len(next(iter(self.block.values())))
        return len(self.block)

    def iter_rows(self) -> Iterable[Any]:
        if self.is_columnar():
            cols = list(self.block.keys())
            for i in range(self.num_rows()):
                yield {c: self.block[c][i] for c in cols}
        else:
            yield from self.block

    def to_rows(self) -> list:
        return list(self.iter_rows())

    def to_batch(self) -> dict:
        """Column dict of numpy arrays."""
        if self.is_columnar():
            return {k: _column(v) for k, v in self.block.items()}
        if not self.block:
            return {}
        first = self.block[0]
        if isinstance(first, dict):
            cols = list(first.keys())
            return {c: _column([r[c] for r in self.block]) for c in cols}
        return {"item": _column(self.block)}

    def slice(self, start: int, end: int):
        if self.is_columnar():
            return {k: v[start:end] for k, v in self.block.items()}
        return self.block[start:end]

    def schema(self):
        if self.is_columnar():
            return {k: np.asarray(v).dtype for k, v in self.block.items()}
        if self.block and isinstance(self.block[0], dict):
            return {k: type(v).__name__ for k, v in self.block[0].items()}
        return {"item": type(self.block[0]).__name__} if self.block else None


def combine_blocks(blocks: list) -> Any:
    """Merge same-layout blocks into one."""
    if not blocks:
        return []
    if isinstance(blocks[0], dict):
        keys = blocks[0].keys()
        return {k: np.concatenate([_column(b[k]) for b in blocks]) for k in keys}
    out = []
    for b in blocks:
        out.extend(b)
    return out
