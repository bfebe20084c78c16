"""Public Dataset constructors.

Parity target: reference python/ray/data/read_api.py (from_items:110,
range:196, read_parquet:771, read_csv:1372, read_json:1178, read_text,
read_binary_files, read_numpy, from_numpy, from_pandas, from_arrow,
read_datasource:446). Reads are lazy: each datasource read task runs inside
a remote task when the plan executes, so file parsing happens on the
cluster, not the driver.

Counterpart: ray_tpu/data/read_api.py (copied).
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np

from ray_tpu_torch.data._internal import executor as ex
from ray_tpu_torch.data.dataset import Dataset
from ray_tpu_torch.data.datasource import (
    BinaryDatasource,
    CSVDatasource,
    Datasource,
    ItemsDatasource,
    JSONDatasource,
    NumpyDatasource,
    ParquetDatasource,
    RangeDatasource,
    TextDatasource,
)

# Default read parallelism when -1 is passed (reference auto-detects from
# cluster size + file sizes; a fixed modest default keeps plans predictable).
DEFAULT_PARALLELISM = 8


def read_datasource(datasource: Datasource, *, parallelism: int = -1) -> Dataset:
    if parallelism <= 0:
        parallelism = DEFAULT_PARALLELISM
    tasks = datasource.get_read_tasks(parallelism)
    return Dataset([ex.ReadSource(tasks)])


def from_items(items: list, *, parallelism: int = -1) -> Dataset:
    return read_datasource(ItemsDatasource(items), parallelism=parallelism)


def range(n: int, *, parallelism: int = -1) -> Dataset:  # noqa: A001 - reference name
    return read_datasource(RangeDatasource(n), parallelism=parallelism)


def range_tensor(n: int, *, shape: tuple = (1,), parallelism: int = -1) -> Dataset:
    return read_datasource(RangeDatasource(n, tensor_shape=tuple(shape)),
                           parallelism=parallelism)


def from_numpy(arrays: Union[np.ndarray, list]) -> Dataset:
    if isinstance(arrays, np.ndarray):
        arrays = [arrays]
    blocks = [{"data": np.asarray(a)} for a in arrays]
    return Dataset([ex.Read(lambda b=blocks: b, len(blocks))])


def from_pandas(dfs) -> Dataset:
    if not isinstance(dfs, list):
        dfs = [dfs]
    blocks = [{c: df[c].to_numpy() for c in df.columns} for df in dfs]
    return Dataset([ex.Read(lambda b=blocks: b, len(blocks))])


def from_arrow(tables) -> Dataset:
    from ray_tpu_torch.data.datasource import _table_to_block

    if not isinstance(tables, list):
        tables = [tables]
    blocks = [_table_to_block(t) for t in tables]
    return Dataset([ex.Read(lambda b=blocks: b, len(blocks))])


def read_parquet(paths, *, columns: Optional[list] = None,
                 parallelism: int = -1, **kw) -> Dataset:
    return read_datasource(ParquetDatasource(paths, columns=columns, **kw),
                           parallelism=parallelism)


def read_csv(paths, *, parallelism: int = -1, **kw) -> Dataset:
    return read_datasource(CSVDatasource(paths, **kw), parallelism=parallelism)


def read_json(paths, *, parallelism: int = -1, **kw) -> Dataset:
    return read_datasource(JSONDatasource(paths, **kw), parallelism=parallelism)


def read_text(paths, *, parallelism: int = -1, **kw) -> Dataset:
    return read_datasource(TextDatasource(paths, **kw), parallelism=parallelism)


def read_binary_files(paths, *, include_paths: bool = False,
                      parallelism: int = -1) -> Dataset:
    return read_datasource(BinaryDatasource(paths, include_paths=include_paths),
                           parallelism=parallelism)


def read_numpy(paths, *, parallelism: int = -1, **kw) -> Dataset:
    return read_datasource(NumpyDatasource(paths, **kw), parallelism=parallelism)
