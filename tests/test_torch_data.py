"""The port's copy of the data library (`ray_tpu_torch.data`): actor-pool
map_batches, groupby, sort, seeded shuffle, repartition, equal streaming
splits and iter_batches, each held to its numpy expectation; and one
seeded shuffle held to the JAX package's order, which runs in a
subprocess (two runtimes never share a test process).

Counterpart tests: tests/test_data.py. The module brings its own cluster,
with no fixed ports or shm names.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import data as rd

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


class _AddState:
    """Callable class -> actor pool path; __init__ runs once per actor."""

    def __init__(self, delta):
        self.delta = delta
        self.pid = os.getpid()

    def __call__(self, batch):
        return {"id": batch["id"] + self.delta,
                "pid": np.full(len(batch["id"]), self.pid)}


def test_map_batches_actor_pool(cluster):
    ds = rd.range(32, parallelism=8).map_batches(
        _AddState, concurrency=2, fn_constructor_args=(100,))
    rows = ds.take_all()
    assert sorted(r["id"] for r in rows) == list(range(100, 132))
    pids = {r["pid"] for r in rows}
    assert 1 <= len(pids) <= 2 and os.getpid() not in pids


def test_groupby_sums_and_counts(cluster):
    rng = np.random.default_rng(0)
    k = rng.integers(0, 5, 200)
    v = rng.integers(-50, 50, 200)
    ds = rd.from_items([{"k": int(a), "v": int(b)} for a, b in zip(k, v)])
    sums = {r["k"]: r["sum(v)"] for r in ds.groupby("k").sum("v").take_all()}
    counts = {r["k"]: r["count()"]
              for r in ds.groupby("k").count().take_all()}
    assert sums == {int(g): int(v[k == g].sum()) for g in np.unique(k)}
    assert counts == {int(g): int((k == g).sum()) for g in np.unique(k)}


def test_sort_shuffle_repartition(cluster):
    vals = np.random.default_rng(1).permutation(300).tolist()
    assert rd.from_items(vals, parallelism=6).sort().take_all() == sorted(vals)
    assert rd.from_items(vals, parallelism=6).sort(
        descending=True).take_all() == sorted(vals, reverse=True)
    a = rd.from_items(list(range(200)), parallelism=8).random_shuffle(seed=7)
    b = rd.from_items(list(range(200)), parallelism=8).random_shuffle(seed=7)
    order = a.take_all()
    assert sorted(order) == list(range(200)) and order != list(range(200))
    assert b.take_all() == order
    r = rd.range(16, parallelism=2).repartition(4)
    assert r.num_blocks() == 4 and r.take_all() == [{"id": i} for i in range(16)]


def test_streaming_split_equal_and_iter_batches(cluster):
    tokens = np.arange(10 * 5, dtype=np.int32).reshape(10, 5)
    its = rd.from_numpy(tokens).streaming_split(3, equal=True)
    seen = []
    for it in its:
        batches = list(it.iter_batches(batch_size=2))
        assert [len(b["data"]) for b in batches] == [2, 1]
        seen.append(np.concatenate([b["data"] for b in batches]))
    assert [len(s) for s in seen] == [3, 3, 3]
    got = np.concatenate(seen)
    assert len({int(r[0]) for r in got}) == 9  # no row twice
    for row in got:
        assert np.array_equal(row, tokens[row[0] // 5])
    its = rd.range(10, parallelism=3).streaming_split(3, equal=False)
    assert sum(len(list(it.iter_rows())) for it in its) == 10


_JAX_SHUFFLE = """
import json, sys
import ray_tpu
from ray_tpu import data as rd
ray_tpu.init(num_cpus=2)
try:
    out = rd.from_items(list(range(200)), parallelism=8).random_shuffle(
        seed=11).take_all()
finally:
    ray_tpu.shutdown()
print(json.dumps(out))
"""


def test_seeded_shuffle_order_equals_the_jax_package(cluster):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", _JAX_SHUFFLE], env=env,
                          cwd=str(REPO), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    got = rd.from_items(list(range(200)), parallelism=8).random_shuffle(
        seed=11).take_all()
    assert got == want and sorted(got) == list(range(200))
