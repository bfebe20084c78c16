"""The port's ops plane on the CPU: job submission, the autoscaler, the
dashboard, the remote-driver client, `cluster_utils`, scheduling
strategies, pubsub, `multiprocessing.Pool` and the chaos `NodeKiller`.

Counterpart tests: tests/test_ops_plane.py (all seven), and the single
cases of `NodeAffinitySchedulingStrategy`
(tests/test_cluster_and_ft.py::test_node_affinity), pubsub
(tests/test_metrics_and_groups.py), `Pool`
(tests/test_util_extras.py::test_multiprocessing_pool) and `NodeKiller`
(tests/test_ft_objects.py::test_chaos_mixed_workload, one kill here), on
`ray_tpu_torch`. The autoscaler also launches a node of shape
{"CPU": 1, "GPU": 1} for a pending `num_gpus=1` task, and
`add_node(num_gpus=1)` advertises "GPU". Each test brings its own runtime;
every `get` and wait has a timeout.
"""

import json
import os
import time
import urllib.request

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private.worker import global_worker
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.job_submission import JobStatus, JobSubmissionClient
from ray_tpu_torch.util.scheduling_strategies import (
    NodeAffinitySchedulingStrategy)


def _wait(pred, timeout=60.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.1)
    raise TimeoutError(f"timed out waiting for {what}")


def _address() -> str:
    host, port = global_worker().controller_addr
    return f"{host}:{port}"


@pytest.fixture
def shutdown_only():
    yield
    rt.shutdown()


@pytest.fixture
def ray_start_2cpu(shutdown_only):
    rt.init(num_cpus=2)
    yield


@pytest.fixture
def cluster():
    cluster = Cluster(head_node_args={"num_cpus": 1, "num_gpus": 0})
    yield cluster
    rt.shutdown()
    cluster.shutdown()


@pytest.fixture
def job_client(ray_start_2cpu):
    client = JobSubmissionClient()
    yield client
    client.close()


# ---- tests/test_ops_plane.py
def test_job_submit_success_and_logs(job_client):
    script = (
        "import ray_tpu_torch as rt; rt.init();"
        "f = rt.remote(lambda x=2: x * 21);"
        "print('answer:', rt.get(f.remote(), timeout=60));"
        "rt.shutdown()"
    )
    sid = job_client.submit_job(entrypoint=f'python -c "{script}"')
    status = job_client.wait_until_finished(sid, timeout=120)
    logs = job_client.get_job_logs(sid)
    assert status == JobStatus.SUCCEEDED, logs
    assert "answer: 42" in logs
    jobs = job_client.list_jobs()
    assert any(j["submission_id"] == sid for j in jobs)


def test_job_failure_reports_exit_code(job_client):
    sid = job_client.submit_job(entrypoint="python -c 'raise SystemExit(3)'")
    status = job_client.wait_until_finished(sid, timeout=60)
    assert status == JobStatus.FAILED
    info = job_client.get_job_info(sid)
    assert "exited with code 3" in info["message"]


def test_job_stop(job_client):
    sid = job_client.submit_job(
        entrypoint="python -c 'import time; time.sleep(600)'")
    _wait(lambda: job_client.get_job_status(sid) == JobStatus.RUNNING,
          what="job running")
    assert job_client.stop_job(sid)
    _wait(lambda: job_client.get_job_status(sid) == JobStatus.STOPPED,
          what="job stopped")


@pytest.mark.parametrize("shape,options", [
    ({"CPU": 2}, {"num_cpus": 2}),
    ({"CPU": 1, "GPU": 1}, {"num_cpus": 1, "num_gpus": 1}),
], ids=["cpu", "gpu"])
def test_autoscaler_scales_up_and_down(shutdown_only, shape, options):
    """Demand the head cannot hold (it has 1 CPU and no GPU) launches a
    node of the provider's shape, whose resources the node reports as
    given; once idle, the node is reaped."""
    from ray_tpu_torch.autoscaler import Autoscaler, LocalNodeProvider

    rt.init(num_cpus=1, num_gpus=0)
    w = global_worker()
    address = _address()
    provider = LocalNodeProvider(address, w.session_id, node_shape=shape)
    scaler = Autoscaler(address, provider, min_workers=0, max_workers=2,
                        idle_timeout_s=3.0, interval_s=0.5)
    scaler.start()
    try:
        @rt.remote
        class Big:
            def where(self):
                return os.environ.get("RT_NODE_ID")

        a = Big.options(**options).remote()
        node = rt.get(a.where.remote(), timeout=120)
        assert node is not None
        assert node in provider.non_terminated_nodes()
        total = {n["NodeID"]: n["Resources"] for n in rt.nodes()}[node]
        assert total == {k: float(v) for k, v in shape.items()}, total
        # Free the resources: the idle node must be reaped.
        rt.kill(a)
        _wait(lambda: len(provider.non_terminated_nodes()) == 0, timeout=60,
              what="idle scale-down")
    finally:
        scaler.stop()
        for nid in provider.non_terminated_nodes():  # a failed run's nodes
            provider.terminate_node(nid)


def test_dashboard_endpoints(ray_start_2cpu):
    from ray_tpu_torch.dashboard import start_dashboard

    @rt.remote
    def touch():
        return 1

    assert rt.get(touch.remote(), timeout=60) == 1
    d = start_dashboard(port=0)
    try:
        base = f"http://127.0.0.1:{d.port}"

        def get(path):
            with urllib.request.urlopen(base + path, timeout=10) as r:
                return json.loads(r.read())

        status = get("/api/cluster_status")
        assert "total" in status and status["total"].get("CPU", 0) >= 2
        nodes = get("/api/nodes")["nodes"]
        assert any(n["alive"] for n in nodes)
        tasks = get("/api/tasks")["tasks"]
        assert any(t["name"] == "touch" for t in tasks)
        assert get("/api/jobs")["jobs"] == []
        trace = get("/api/timeline")
        assert any(ev.get("name") == "touch" for ev in trace)
        assert "ray_tpu_torch" in get("/api/version")
    finally:
        d.stop()


def test_remote_driver_client(cluster):
    """util.client: the remote-driver mode (reference ray://) — the full
    API from a process holding only a controller address."""
    from ray_tpu_torch.util.client import connect

    cluster.add_node(num_cpus=2)
    ctx = connect(f"ray://{cluster.address}")
    try:
        @rt.remote
        def f(x):
            return x + 1

        assert rt.get(f.remote(41), timeout=60) == 42
        assert "connected" in repr(ctx)
    finally:
        ctx.disconnect()
    assert not rt.is_initialized()


def test_dashboard_index_ui(ray_start_2cpu):
    """The dashboard serves the live HTML view alongside the JSON APIs."""
    from ray_tpu_torch.dashboard import Dashboard

    dash = Dashboard(_address(), port=0)
    port = dash.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/", timeout=10) as r:
            html = r.read().decode()
        assert "ray_tpu_torch dashboard" in html
        assert "/api/cluster_status" in html  # the UI polls the APIs
        assert "<script>" in html
    finally:
        dash.stop()


# ---- cluster_utils and scheduling strategies
def test_add_gpu_node_and_node_affinity(cluster):
    """`add_node(num_gpus=1)` advertises one "GPU"; a task pinned to that
    node by NodeAffinitySchedulingStrategy runs there, and so does a
    `num_gpus=1` task, since the head has no GPU."""
    n2 = cluster.add_node(num_cpus=1, num_gpus=1)
    rt.init(address=cluster.address)
    totals = {n["NodeID"]: n["Resources"] for n in rt.nodes()}
    assert totals[n2.node_id] == {"CPU": 1.0, "GPU": 1.0}
    assert rt.cluster_resources().get("GPU") == 1.0

    @rt.remote
    def where():
        return os.environ.get("RT_NODE_ID")

    strat = NodeAffinitySchedulingStrategy(node_id=n2.node_id)
    assert rt.get(where.options(scheduling_strategy=strat).remote(),
                  timeout=60) == n2.node_id
    head = NodeAffinitySchedulingStrategy(node_id=cluster.head.node_id)
    assert rt.get(where.options(scheduling_strategy=head).remote(),
                  timeout=60) == cluster.head.node_id
    assert rt.get(where.options(num_gpus=1).remote(),
                  timeout=60) == n2.node_id


# ---- util: pubsub, multiprocessing, chaos
def test_pubsub_actor_channel_and_user_channel(ray_start_2cpu):
    """Subscribers see controller-published actor lifecycle events and
    application events."""
    from ray_tpu_torch.util import pubsub

    sub = pubsub.subscribe(["actor", "custom"])
    try:
        @rt.remote
        class P:
            def hi(self):
                return "hi"

        p = P.remote()
        assert rt.get(p.hi.remote(), timeout=60) == "hi"
        ev = sub.poll(timeout=30)
        assert ev is not None and ev[0] == "actor"
        assert ev[1]["state"] in ("ALIVE", "RESTARTING", "DEAD")

        pubsub.publish("custom", {"k": 41})
        for _ in range(50):
            ev = sub.poll(timeout=10)
            assert ev is not None, "no custom event arrived"
            if ev[0] == "custom":
                assert ev[1] == {"k": 41}
                break
        else:
            raise AssertionError("custom channel event not seen")
    finally:
        sub.close()


def test_multiprocessing_pool(ray_start_2cpu):
    from ray_tpu_torch.util.multiprocessing import Pool

    def cube(x):
        return x ** 3

    def add(a, b):
        return a + b

    with Pool(processes=2) as p:
        assert p.map(cube, range(6)) == [i ** 3 for i in range(6)]
        assert p.starmap(add, [(1, 2), (3, 4)]) == [3, 7]
        ar = p.apply_async(cube, (5,))
        assert ar.get(timeout=60) == 125
        assert sorted(p.imap_unordered(cube, range(4))) == [0, 1, 8, 27]


def test_node_killer_cycle(cluster):
    """NodeKiller kills a worker node and replaces it while retried tasks
    run; the workload completes and the replacement joins."""
    from ray_tpu_torch.util.chaos import NodeKiller

    cluster.add_node(num_cpus=2)
    rt.init(address=cluster.address)

    @rt.remote(max_retries=16)
    def flaky_sum(i):
        time.sleep(0.25)
        return i * 2

    killer = NodeKiller(cluster, interval_s=0.5, max_kills=1,
                        node_resources={"num_cpus": 2}).start()
    try:
        refs = [flaky_sum.remote(i) for i in range(12)]
        assert rt.get(refs, timeout=120) == [i * 2 for i in range(12)]
        _wait(lambda: killer.kills == 1, timeout=30, what="one kill")
    finally:
        killer.stop()
    assert not killer._thread.is_alive()
    assert len(cluster.nodes) == 1  # the replacement
    alive = {n["NodeID"] for n in rt.nodes() if n["Alive"]}
    assert cluster.nodes[0].node_id in alive


# ---- the llm.tokens_per_s series (tests/test_telemetry.py's counterpart)
@pytest.fixture
def telemetry_cluster(monkeypatch, shutdown_only):
    """A runtime with the sampling plane armed at a fast cadence (workers
    inherit the env through the agent spawn path)."""
    monkeypatch.setenv("RT_TELEMETRY_INTERVAL_S", "0.2")
    rt.init(num_cpus=2)
    yield


def test_llm_tokens_per_s_series(telemetry_cluster):
    """A worker that hosts the port's engine exports its decode throughput
    as the dot-qualified `llm.tokens_per_s` series, and `ray-tpu-torch
    top` shows it in the node's TOK/S column (not "-")."""
    from ray_tpu_torch.scripts.cli import _top_lines
    from ray_tpu_torch.util import state

    @rt.remote
    class EngineHost:
        def tick(self):
            # the engine counts in _deliver; the counter is the series'
            # source either way (the module's presence gates sampling)
            from ray_tpu_torch.llm import engine as eng

            eng._count_tokens(1000)
            return True

    h = EngineHost.remote()
    deadline = time.monotonic() + 25
    rows = []
    while time.monotonic() < deadline:
        rt.get(h.tick.remote(), timeout=30)
        rows = state.timeseries(series="llm.tokens_per_s")
        if rows and any(p[1] > 0 for r in rows for p in r["points"]):
            break
        time.sleep(0.2)
    assert rows, "llm.tokens_per_s series never appeared"
    assert any(p[1] > 0 for r in rows for p in r["points"]), rows
    assert not state.timeseries(series="worker.llm.tokens_per_s")
    util = state.cluster_utilization()
    workers = [w for n in util["nodes"].values()
               for w in (n.get("workers") or {}).values()]
    assert any("llm.tokens_per_s" in w for w in workers), util
    frame = _top_lines(util)
    assert "TOK/S" in frame[0]
    # the node rows' TOK/S column (the 8th) holds a rate on the engine's node
    assert any(line.split()[7] != "-" for line in frame[1:]
               if len(line.split()) > 7 and line.split()[1] == "ALIVE"), frame


def test_engine_delivery_moves_tokens_per_s():
    """A CPU ContinuousEngine that hands N tokens to its streams adds N to
    the counter, so the next snapshot reports a positive rate."""
    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.llm import engine as eng
    from ray_tpu_torch.llm.engine import ContinuousEngine, SamplingParams

    cfg = LLMConfig(vocab_size=64, d_model=32, n_layers=1, n_heads=2,
                    max_seq=64)
    engine = ContinuousEngine(cfg, max_batch=2, decode_chunk=4, device="cpu")
    try:
        eng.tokens_per_s_snapshot()  # anchor the window
        before = eng._tok_count
        streams = [engine.submit([1, 2, 3], SamplingParams(
            temperature=0.0, max_tokens=n)) for n in (5, 7)]
        assert [len(s.tokens()) for s in streams] == [5, 7]
    finally:
        engine.shutdown()
    assert eng._tok_count - before == 12
    time.sleep(0.01)
    assert eng.tokens_per_s_snapshot() > 0
