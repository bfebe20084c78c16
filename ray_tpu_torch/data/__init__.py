"""ray_tpu_torch.data: distributed datasets over the object store.

Parity target: reference python/ray/data/__init__.py — Dataset +
constructors (read_api.py) + datasources. Lazy logical plans execute as
remote tasks with bounded in-flight streaming; blocks are columnar numpy
dicts (host format: feeds torch.from_numpy without a copy for
numeric dtypes).

Counterpart: ray_tpu/data/__init__.py (copied).
"""

from ray_tpu_torch.data.block import BlockAccessor
from ray_tpu_torch.data.dataset import DataIterator, Dataset, GroupedData
from ray_tpu_torch.data.datasource import Datasource, ReadTask
from ray_tpu_torch.data.read_api import (
    from_arrow,
    from_items,
    from_numpy,
    from_pandas,
    range,  # noqa: A004 - reference name
    range_tensor,
    read_binary_files,
    read_csv,
    read_datasource,
    read_json,
    read_numpy,
    read_parquet,
    read_text,
)

__all__ = [
    "BlockAccessor",
    "DataIterator",
    "Dataset",
    "Datasource",
    "GroupedData",
    "ReadTask",
    "from_arrow",
    "from_items",
    "from_numpy",
    "from_pandas",
    "range",
    "range_tensor",
    "read_binary_files",
    "read_csv",
    "read_datasource",
    "read_json",
    "read_numpy",
    "read_parquet",
    "read_text",
]
