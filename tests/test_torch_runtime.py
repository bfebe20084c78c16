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
    t = torch.arange(N, dtype=torch.float32)
    ref = rt.put(t)
    assert rt.get(ref) is t  # tier 0: identity, no copy
    assert device_objects.device_object_stats()["count"] >= 1


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
    files = sorted((REPO / "ray_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    return files


def _bad_imports(tree) -> set:
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.add(node.module.split(".")[0])
    return found & set(_FORBIDDEN)


def _bad_strings(tree) -> set:
    """String literals naming a module of the JAX package ("ray_tpu.x"):
    a sys.modules key or a `-m` target that would silently point there."""
    return {node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and node.value.startswith("ray_tpu.")}


@pytest.mark.parametrize("check", [_bad_imports, _bad_strings],
                         ids=["imports", "module_strings"])
def test_port_names_nothing_of_the_jax_package(check):
    files = _port_sources()
    assert len(files) > 60
    bad = {}
    for f in files:
        found = check(ast.parse(f.read_text(), str(f)))
        if found:
            bad[str(f.relative_to(REPO))] = sorted(found)
    assert not bad, bad
