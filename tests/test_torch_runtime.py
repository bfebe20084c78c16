"""The port's copy of the runtime (`ray_tpu_torch.init`, tasks, actors,
objects), its torch device-object plane, GPU detection, and a guard that
the port stands alone: no module of `ray_tpu_torch/` imports jax, flax,
optax or `ray_tpu`, names a `ray_tpu.` module in a string, or loads one in
a spawned worker.

Counterpart tests: tests/test_core_*.py and the single-node cases of
tests/test_device_objects.py. These bring their own module-scoped cluster
(the shared fixtures start `ray_tpu`), with no fixed ports or shm names.
"""

import ast
import os
import pathlib
import sys
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch._private import accelerators
from ray_tpu_torch.exceptions import ActorDiedError, TaskError
from ray_tpu_torch.experimental import device_objects

REPO = pathlib.Path(__file__).resolve().parents[1]
# 128 KB in bf16, 256 KB in float32: above RT_DEVICE_OBJECT_MIN_BYTES
# (100 KB).
N = 1 << 16


def test_shutdown_leaves_no_shm_segment():
    """A session's shared-memory segments (`rt_<session>_*`) die with it.
    Runs its own cluster, before the module's, and puts an object big
    enough for the shm store."""
    from ray_tpu_torch._private.worker import global_worker

    rt.init(num_cpus=1)
    try:
        prefix = f"rt_{global_worker().store.session}_"
        ref = rt.put(np.arange(1 << 18, dtype=np.float64))  # 2 MB
        assert any(f.startswith(prefix) for f in os.listdir("/dev/shm"))
        assert float(rt.get(ref).sum()) == float(np.arange(1 << 18).sum())
    finally:
        rt.shutdown()
    assert not [f for f in os.listdir("/dev/shm") if f.startswith(prefix)]


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=2)
    yield
    rt.shutdown()


def test_tasks_and_actors(cluster):
    @rt.remote
    def add(a, b):
        return a + b

    assert rt.get([add.remote(i, 1) for i in range(4)]) == [1, 2, 3, 4]

    @rt.remote(num_cpus=0)
    class Counter:
        def __init__(self, start):
            self.n = start

        def inc(self, k=1):
            self.n += k
            return self.n

    c = Counter.remote(10)
    assert rt.get([c.inc.remote(), c.inc.remote(5)]) == [11, 16]
    named = Counter.options(name="port-counter").remote(0)
    rt.get(named.inc.remote())
    assert rt.get(rt.get_actor("port-counter").inc.remote()) == 2


def test_put_get_wait(cluster):
    big = np.arange(1 << 16, dtype=np.float32)  # shm store, not inline
    ref = rt.put(big)
    assert np.array_equal(rt.get(ref), big)

    @rt.remote
    def slow(t):
        time.sleep(t)
        return t

    refs = [slow.remote(0.0), slow.remote(30.0)]
    ready, pending = rt.wait(refs, num_returns=1, timeout=20)
    assert ready == [refs[0]] and pending == [refs[1]]
    assert rt.get(ready[0]) == 0.0
    rt.cancel(refs[1], force=True)


def test_kill_actor(cluster):
    @rt.remote(num_cpus=0)
    class Svc:
        def ping(self):
            return os.getpid()

    s = Svc.remote()
    pid = rt.get(s.ping.remote(), timeout=30)
    assert pid != os.getpid()
    rt.kill(s)
    with pytest.raises(ActorDiedError):
        rt.get(s.ping.remote(), timeout=30)


def test_task_error_arrives_typed(cluster):
    @rt.remote(max_retries=0)
    def boom():
        raise ValueError("bad input 42")

    with pytest.raises(TaskError, match="bad input 42") as ei:
        rt.get(boom.remote(), timeout=30)
    assert isinstance(ei.value.cause, ValueError)


def test_spawned_worker_loads_no_jax_and_nothing_of_ray_tpu(cluster):
    """The worker command line and PYTHONPATH name the port, so a worker
    that runs port code (torch included) never loads the JAX package."""

    @rt.remote
    def loaded():
        import sys

        import ray_tpu_torch.models  # noqa: F401

        return sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                             "optax", "ray_tpu"))

    assert rt.get(loaded.remote(), timeout=60) == []

    @rt.remote(num_cpus=0)
    class Holder:
        def modules(self):
            import sys

            return ("ray_tpu_torch._private.worker_proc" in sys.modules,
                    sys.modules["__main__"].__spec__.name)

    assert rt.get(Holder.remote().modules.remote(), timeout=60) == (
        False, "ray_tpu_torch._private.worker_proc")


def test_tensor_rides_the_device_plane(cluster):
    """A tensor returned from an actor stays pinned in the producer; the
    driver gets a placeholder that resolves to equal values (dtype and
    device kept), and dropping the ref frees the pin."""

    @rt.remote(num_cpus=0)
    class Producer:
        def make(self, fill, dtype):
            import torch

            return torch.full((N,), float(fill), dtype=getattr(torch, dtype))

        def stats(self):
            from ray_tpu_torch.experimental import device_objects as dob

            return dob.device_object_stats()

    p = Producer.remote()
    for dtype in ("float32", "bfloat16"):
        ref = p.make.remote(7, dtype)
        got = rt.get(ref, timeout=60)
        assert isinstance(got, torch.Tensor)
        assert got.dtype == getattr(torch, dtype) and got.device.type == "cpu"
        assert torch.equal(got, torch.full((N,), 7.0, dtype=got.dtype))
        got[0] = -1.0  # a resolved tensor owns its bytes
        assert torch.equal(rt.get(ref, timeout=60)[1:], got[1:])
        stats = rt.get(p.stats.remote(), timeout=60)
        assert stats["count"] == 1 and stats["bytes"] >= N * got.element_size()
        del ref, got
        deadline = time.monotonic() + 20
        while rt.get(p.stats.remote(), timeout=60)["count"] and \
                time.monotonic() < deadline:
            time.sleep(0.1)
        assert rt.get(p.stats.remote(), timeout=60)["count"] == 0


def test_same_process_get_returns_the_pinned_tensor(cluster):
    """Tier 0 resolves to the pinned snapshot: equal values, and the
    producer's later in-place change does not reach it (the pin is a copy,
    as a jax.Array pin is immutable in the reference)."""
    t = torch.arange(N, dtype=torch.float32)
    ref = rt.put(t)
    assert torch.equal(rt.get(ref), torch.arange(N, dtype=torch.float32))
    assert device_objects.device_object_stats()["count"] >= 1
    t.add_(5)
    assert torch.equal(rt.get(ref), torch.arange(N, dtype=torch.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_put_tensor_is_a_snapshot(cluster, dtype):
    """`ref = put(t)`, then `t.add_(5)`: the ref keeps the put value, in
    this process and in another one, as a numpy array's does."""
    t = torch.zeros(N, dtype=getattr(torch, dtype))
    ref = rt.put(t)
    t.add_(5)

    @rt.remote
    def total(x):
        return float(x.float().sum())

    assert float(rt.get(ref).float().sum()) == 0.0
    assert rt.get(total.remote(ref), timeout=60) == 0.0
    nd = np.zeros(N, dtype=np.float32)
    ref_nd = rt.put(nd)
    nd += 5
    assert float(rt.get(ref_nd).sum()) == 0.0


def test_eligible_while_another_thread_imports_torch(monkeypatch):
    """A return serialized while another thread of the worker is still
    importing torch (a tune trial whose trainable imports it in setup)
    sees a torch module without its names: the value is no tensor, and
    serializing it must not raise."""
    import types

    from ray_tpu_torch._private import device_store

    monkeypatch.setitem(sys.modules, "torch", types.ModuleType("torch"))
    assert device_store.eligible({"episode_return_mean": 1.0}) is False
    assert device_store.eligible(np.zeros(N, np.float32)) is False


def test_actor_return_is_a_snapshot(cluster):
    """An actor returns its buffer, then a later call changes the buffer in
    place: the first ref still gives the returned values."""

    @rt.remote(num_cpus=0)
    class Holder:
        def __init__(self):
            import torch

            self.buf = torch.zeros(N)

        def get_buf(self):
            return self.buf

        def bump(self):
            self.buf.add_(1)
            return float(self.buf.sum())

    h = Holder.remote()
    first = h.get_buf.remote()
    assert rt.get(h.bump.remote(), timeout=60) == float(N)
    second = h.get_buf.remote()
    assert float(rt.get(first, timeout=60).sum()) == 0.0
    assert float(rt.get(second, timeout=60).sum()) == float(N)


def test_tensors_the_plane_does_not_serve_take_the_host_path(cluster):
    small = torch.arange(16, dtype=torch.float32)
    strided = torch.arange(2 * N, dtype=torch.float32)[::2]
    grad = torch.zeros(N, requires_grad=True)
    for t in (small, strided, grad):
        assert not device_objects.would_ride_device_plane(t)
    assert device_objects.would_ride_device_plane(strided.contiguous())
    got = rt.get(rt.put(strided))
    assert got is not strided and torch.equal(got, strided)


@pytest.mark.parametrize("env, want", [
    ({"RT_NUM_GPUS": "2", "CUDA_VISIBLE_DEVICES": "0"}, 2.0),
    ({"CUDA_VISIBLE_DEVICES": "0,3,5"}, 3.0),
    ({"CUDA_VISIBLE_DEVICES": ""}, None),
])
def test_accelerators_count_gpus(monkeypatch, env, want):
    monkeypatch.delenv("RT_NUM_GPUS", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    res = accelerators.host_resources(num_cpus=4)
    assert res.get("GPU") == want and res["CPU"] == 4.0
    assert not any(k.startswith("TPU") for k in res)
    assert accelerators.host_resources(num_cpus=1, num_gpus=1)["GPU"] == 1.0


def test_telemetry_sample_never_initialises_cuda():
    """The worker sampler reads CUDA memory only once CUDA is initialised;
    on this CPU host it reports no device series, and no compile series
    (eager torch has none)."""
    from ray_tpu_torch._private import telemetry

    out = telemetry.WorkerSampler.sample()
    assert not torch.cuda.is_initialized()
    assert not {"hbm_used", "hbm_peak", "compile_count"} & set(out)


def test_torch_profile_window_is_a_chrome_trace():
    import io
    import json
    import zipfile

    from ray_tpu_torch._private import telemetry

    rep = telemetry.torch_profile(0.05)
    assert rep["mode"] == "torch" and rep["pid"] == os.getpid()
    with zipfile.ZipFile(io.BytesIO(rep["archive"])) as z:
        trace = json.loads(z.read("trace.json"))
    assert "traceEvents" in trace


# ---- the port stands alone
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ray_tpu")


def _port_sources() -> list:
    """The port's modules and the scripts that drive it on the card
    (chip_smoke.py and the probes)."""
    files = sorted((REPO / "ray_tpu_torch").rglob("*.py"))
    files.extend(sorted(REPO.glob("chip_*.py")))
    return files


def _bad_imports(tree) -> set:
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.add(node.module.split(".")[0])
    return found & set(_FORBIDDEN)


# The one name of the JAX package the port may write: the checkpoint tree
# file's stub global, part of the shared on-disk format. The port maps it
# to its own class when it reads and never imports it
# (test_torch_checkpoint.py::test_port_reads_its_format_without_the_jax_package).
_FORMAT_NAMES = {"ray_tpu.train.checkpoint"}


def _bad_strings(tree) -> set:
    """String or bytes literals naming a module of the JAX package
    ("ray_tpu.x"): a sys.modules key, a `-m` target, or a command-line
    match (the CLI's `_is_ours` reads /proc cmdlines as bytes) that would
    silently point there."""
    found = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Constant):
            continue
        value = node.value
        if isinstance(value, bytes):
            value = value.decode(errors="replace")
        elif not isinstance(value, str):
            continue
        if value.startswith("ray_tpu.") and value not in _FORMAT_NAMES:
            found.add(node.value)
    return found


@pytest.mark.parametrize("snippet,bad", [
    ('m = "ray_tpu.scripts.head_main"', {"ray_tpu.scripts.head_main"}),
    ('ok = b"ray_tpu._private.node_agent" in cmdline',
     {b"ray_tpu._private.node_agent"}),
    ('ok = b"ray_tpu_torch._private.node_agent" in cmdline', set()),
    ('fmt = "ray_tpu.train.checkpoint"', set()),
], ids=["str", "bytes", "port_bytes", "format_name"])
def test_module_string_check_catches_str_and_bytes(snippet, bad):
    assert _bad_strings(ast.parse(snippet)) == bad


@pytest.mark.parametrize("check", [_bad_imports, _bad_strings],
                         ids=["imports", "module_strings"])
def test_port_names_nothing_of_the_jax_package(check):
    files = _port_sources()
    assert len(files) > 60
    names = {str(f.relative_to(REPO / "ray_tpu_torch")) for f in files
             if REPO / "ray_tpu_torch" in f.parents}
    assert {"dag/__init__.py", "experimental/channel.py",
            "workflow/__init__.py", "llm/pipeline.py", "tune/__init__.py",
            "tune/_runner.py", "tune/_session.py", "tune/schedulers.py",
            "tune/search.py", "tune/trial.py", "tune/tuner.py",
            "air/__init__.py", "air/session.py", "util/state.py",
            "cluster_utils.py", "scripts/__init__.py", "scripts/cli.py",
            "scripts/head_main.py", "job_submission/__init__.py",
            "autoscaler/__init__.py", "dashboard/__init__.py"} <= names
    assert {f"util/{m}.py" for m in (
        "chaos", "client", "multiprocessing", "pubsub",
        "scheduling_strategies")} <= names
    assert {f"rllib/{m}.py" for m in (
        "__init__", "algorithm", "dqn", "env", "env_runner", "impala",
        "learner", "multi_agent", "replay", "rl_module")} <= names
    bad = {}
    for f in files:
        found = check(ast.parse(f.read_text(), str(f)))
        if found:
            bad[str(f.relative_to(REPO))] = sorted(found)
    assert not bad, bad


def test_collective_tensor_pytrees_over_two_actors(cluster):
    """`util.collective` on tensor pytrees: allreduce sums as numpy does
    (bf16 summed in f32, then rounded once), broadcast and allgather carry
    each leaf whole; every leaf keeps its dtype and device, numpy leaves
    stay numpy."""
    import uuid

    group = f"col-{uuid.uuid4().hex[:8]}"

    @rt.remote(num_cpus=0)
    class Rank:
        def __init__(self, rank):
            from ray_tpu_torch.util import collective

            self.rank = rank
            self.col = collective
            collective.init_collective_group(2, rank, group)

        def tree(self):
            import numpy as np
            import torch

            g = torch.Generator().manual_seed(self.rank)
            return {"f32": torch.randn(5, 3, generator=g),
                    "bf16": torch.randn(7, generator=g).to(torch.bfloat16),
                    "i64": torch.arange(4) * (self.rank + 1),
                    "nd": [np.full(3, float(self.rank))]}

        def run(self):
            t = self.tree()
            return (self.col.allreduce(t, group_name=group),
                    self.col.broadcast(t, src_rank=1, group_name=group),
                    self.col.allgather(t, group_name=group))

    actors = [Rank.remote(r) for r in range(2)]
    trees = [rt.get(a.tree.remote(), timeout=60) for a in actors]
    outs = rt.get([a.run.remote() for a in actors], timeout=120)
    f32 = lambda t: t.float().numpy()  # noqa: E731
    for red, bc, gathered in outs:
        np.testing.assert_array_equal(
            red["f32"].numpy(), trees[0]["f32"].numpy() + trees[1]["f32"].numpy())
        want_bf16 = torch.from_numpy(
            f32(trees[0]["bf16"]) + f32(trees[1]["bf16"])).to(torch.bfloat16)
        assert red["bf16"].dtype == torch.bfloat16
        assert torch.equal(red["bf16"], want_bf16)
        assert red["i64"].dtype == torch.int64
        assert torch.equal(red["i64"], torch.arange(4) * 3)
        assert isinstance(red["nd"][0], np.ndarray)
        np.testing.assert_array_equal(red["nd"][0], np.full(3, 1.0))
        for leaf in ("f32", "bf16", "i64"):
            assert red[leaf].device.type == "cpu"
            assert torch.equal(bc[leaf], trees[1][leaf])
            assert bc[leaf].dtype == trees[1][leaf].dtype
            for r in range(2):
                assert torch.equal(gathered[r][leaf], trees[r][leaf])
