"""The port's compiled DAG, shared-memory channels and workflows on the
CPU: pipelined execution, graph shapes, attributed stage errors, teardown,
device-object edges over torch tensors, the DAG's events and spans, and
durable workflows.

Counterpart tests: tests/test_dag.py, and the channel, compiled-DAG and
workflow cases of tests/test_workflow_dag_llm.py; events and traces are
read through the port's `util.state`, as the reference's tests read them.
The tests that need their own runtime (a flag that stage processes read
at spawn) run first; the rest share this module's
cluster. No fixed ports or shm names.
"""

import os
import time

import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.exceptions import DagStageError, RayTpuError
from ray_tpu_torch.util import state


def _wait(pred, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            last = pred()
            if last:
                return last
        except Exception:
            pass
        time.sleep(0.2)
    raise TimeoutError(f"timed out waiting for {what}")


# ------------------------------------------------ device-object edges
N = 1 << 16  # 256 KB of float32: past RT_DEVICE_OBJECT_MIN_BYTES


def _device_edge_graph():
    from ray_tpu_torch.dag import InputNode, compile

    @rt.remote
    def produce(x):
        return torch.full((N,), float(x), dtype=torch.float32)

    @rt.remote
    def transform(a):
        return a * 2.0 + 1.0

    with InputNode() as inp:
        dag = transform.bind(produce.bind(inp))
    return compile(dag)


def _pins(cdag) -> int:
    return sum(rt.get(a.probe.remote(), timeout=30)["count"]
               for a in cdag._actors)


def test_device_edges_on_off_byte_equivalence(monkeypatch):
    """The same graph over large tensor edges gives equal bytes with device
    edges on (placeholders + tier-ladder resolve) and off
    (RT_DAG_DEVICE_EDGES=0: full pickles through the shm ring), and the on
    path pins."""
    xs = [1, 2, 3, 4]
    runs = {}
    for edges in ("1", "0"):
        monkeypatch.setenv("RT_DAG_DEVICE_EDGES", edges)
        rt.init(num_cpus=4)
        try:
            cdag = _device_edge_graph()
            try:
                runs[edges] = [cdag.execute(x).get(timeout=120) for x in xs]
                pins = _pins(cdag)
            finally:
                cdag.teardown()
        finally:
            rt.shutdown()
        assert (pins > 0) == (edges == "1"), (edges, pins)
    for on, off in zip(runs["1"], runs["0"]):
        assert isinstance(on, torch.Tensor) and isinstance(off, torch.Tensor)
        assert on.dtype == off.dtype and on.shape == off.shape
        assert on.numpy().tobytes() == off.numpy().tobytes()


def test_dag_invocation_spans_when_sampled(monkeypatch):
    """A sampled invocation records a dag.execute root with one dag.stage
    child per stage."""
    monkeypatch.setenv("RT_TRACING", "1")
    rt.init(num_cpus=4)
    try:
        from ray_tpu_torch.dag import InputNode, compile

        @rt.remote
        def a(x):
            return x + 1

        @rt.remote
        def b(x):
            return x * 2

        with InputNode() as inp:
            dag = b.bind(a.bind(inp))
        cdag = compile(dag)
        try:
            assert cdag.execute(3).get(timeout=60) == 8
        finally:
            cdag.teardown()

        def _spans():
            for row in state.list_traces():
                doc = state.get_trace(row["trace_id"])
                spans = doc.get("spans", [])
                roots = [s for s in spans if s.get("n") == "dag.execute"]
                stages = [s for s in spans if s.get("n") == "dag.stage"]
                if roots and len(stages) >= 2 and all(
                        s.get("p") == roots[0].get("s") for s in stages):
                    return spans
            return None

        _wait(_spans, what="dag.execute -> dag.stage span chain")
    finally:
        rt.shutdown()


# ------------------------------------------------------ shared cluster
@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def test_channel_roundtrip(cluster):
    """A channel carries values between processes in order, under its
    rtch_torch_ segment name, and a close with unlink removes it."""
    from ray_tpu_torch.experimental.channel import Channel

    name = f"t{os.getpid()}"
    ch = Channel(name, size=1 << 16)
    back = Channel(name + "r", size=1 << 16)
    try:
        assert ch._path == f"/dev/shm/rtch_torch_{name}"

        @rt.remote
        def echo_loop(name, n):
            from ray_tpu_torch.experimental.channel import Channel as C

            rx = C(name, 1 << 16, _create=False)
            tx = C(name + "r", 1 << 16, _create=False)
            for _ in range(n):
                tx.write(rx.read(timeout=30))
            return True

        ref = echo_loop.remote(name, 200)
        t0 = time.perf_counter()
        for i in range(200):
            ch.write(i)
            assert back.read(timeout=30) == i
        dt = (time.perf_counter() - t0) / 200
        assert rt.get(ref, timeout=60)
        # Cross-process ping-pong through shm must beat a typical RPC RTT.
        assert dt < 0.01, f"channel roundtrip {dt * 1e6:.0f}us"
        ch.write({"t": torch.arange(4)})
    finally:
        ch.close(unlink=True)
        back.close(unlink=True)
    assert not os.path.exists(f"/dev/shm/rtch_torch_{name}")


def test_pipelined_execute_returns_dagrefs_in_flight(cluster):
    """execute() does not wait for the result: with a slow stage many
    invocations are submitted while earlier ones are in the pipe, and they
    fulfill in submission order."""
    from ray_tpu_torch.dag import InputNode, compile

    @rt.remote
    def slow(x):
        time.sleep(0.15)
        return x * 10

    @rt.remote
    def fast(x):
        return x + 1

    with InputNode() as inp:
        dag = fast.bind(slow.bind(inp))
    cdag = compile(dag)
    try:
        t0 = time.perf_counter()
        refs = [cdag.execute(i, timeout=60) for i in range(6)]
        submit_s = time.perf_counter() - t0
        assert submit_s < 0.6, f"submission took {submit_s:.2f}s"
        assert not refs[-1].done()
        assert [r.get(timeout=60) for r in refs] == [
            i * 10 + 1 for i in range(6)]
        assert all(r.done() for r in refs)
        # steady state: the same channels and stages serve many more
        refs = [cdag.execute(i) for i in range(20)]
        assert [r.get(timeout=60) for r in refs] == [
            i * 10 + 1 for i in range(20)]
    finally:
        cdag.teardown()


def test_max_inflight_bounds_submission(cluster, monkeypatch):
    """With RT_DAG_MAX_INFLIGHT=2 and a stage holding results back, a third
    execute() times out; fulfilled results release the window."""
    monkeypatch.setenv("RT_DAG_MAX_INFLIGHT", "2")
    from ray_tpu_torch.dag import InputNode, compile
    from ray_tpu_torch.exceptions import GetTimeoutError

    @rt.remote
    def slow(x):
        time.sleep(0.4)
        return x

    with InputNode() as inp:
        dag = slow.bind(inp)
    cdag = compile(dag)
    try:
        r0 = cdag.execute(0)
        r1 = cdag.execute(1)
        with pytest.raises(GetTimeoutError, match="in flight"):
            cdag.execute(2, timeout=0.05)
        assert r0.get(timeout=30) == 0 and r1.get(timeout=30) == 1
        assert cdag.execute(3).get(timeout=30) == 3
    finally:
        cdag.teardown()


def test_fan_in_fan_out_multi_output_actor_method(cluster):
    """An existing actor's method stage fans out to a function join
    (fan-in) and a second output, with a literal kwarg on a stage; the
    actor keeps its state, serves normal calls and survives teardown."""
    from ray_tpu_torch.dag import InputNode, MultiOutputNode, compile

    @rt.remote
    class Scaler:
        def __init__(self, k):
            self.k = k
            self.calls = 0

        def scale(self, x):
            self.calls += 1
            return x * self.k

        def count(self):
            return self.calls

    @rt.remote
    def inc(x, by=1):
        return x + by

    @rt.remote
    def join(a, b):
        return (a, b)

    actor = Scaler.remote(10)
    with InputNode() as inp:
        s = actor.scale.bind(inp)
        i = inc.bind(inp, by=5)
        dag = MultiOutputNode([join.bind(s, i), inc.bind(s)])
    cdag = compile(dag)
    try:
        for x in (1, 3, 7):
            j, k = cdag.execute(x).get(timeout=60)
            assert j == (10 * x, x + 5)
            assert k == 10 * x + 1
        assert rt.get(actor.count.remote(), timeout=30) == 3
    finally:
        cdag.teardown()
    assert rt.get(actor.count.remote(), timeout=30) == 3
    rt.kill(actor)


def test_diamond_error_names_stage_and_carries_traceback(cluster):
    """A stage's exception reaches the output as a DagStageError naming
    the stage, with the remote traceback; only its invocation fails."""
    from ray_tpu_torch.dag import InputNode, compile

    @rt.remote
    def src(x):
        return x

    @rt.remote
    def left(x):
        if x == 13:
            raise ValueError("kaput-13")
        return x * 2

    @rt.remote
    def right(x):
        return x + 1

    @rt.remote
    def merge(a, b):
        return a + b

    with InputNode() as inp:
        s = src.bind(inp)
        dag = merge.bind(left.bind(s), right.bind(s))
    cdag = compile(dag)
    try:
        assert cdag.execute(2).get(timeout=60) == 2 * 2 + 3
        with pytest.raises(DagStageError) as ei:
            cdag.execute(13).get(timeout=60)
        e = ei.value
        assert isinstance(e, RayTpuError)
        assert e.stage and "left" in e.stage
        assert e.invocation == 1
        assert e.traceback_str and "Traceback" in e.traceback_str
        assert 'raise ValueError("kaput-13")' in e.traceback_str
        assert "kaput-13" in str(e)
        assert cdag.execute(4).get(timeout=60) == 4 * 2 + 5
    finally:
        cdag.teardown()


def test_teardown_unlinks_every_channel(cluster):
    """Teardown leaves no rtch_torch_ segment of the graph behind, also
    after a stage error, and is idempotent."""
    from ray_tpu_torch.dag import InputNode, compile

    @rt.remote
    def maybe_boom(x):
        if x < 0:
            raise RuntimeError("negative")
        return x

    with InputNode() as inp:
        dag = maybe_boom.bind(inp)
    cdag = compile(dag)
    paths = [ch._path for ch in cdag._channels]
    assert paths and all(os.path.exists(p) for p in paths)
    assert all(os.path.basename(p).startswith("rtch_torch_") for p in paths)
    with pytest.raises(DagStageError, match="negative"):
        cdag.execute(-1).get(timeout=60)
    assert cdag.execute(5).get(timeout=60) == 5
    cdag.teardown()
    assert not [p for p in paths if os.path.exists(p)]
    cdag.teardown()
    with pytest.raises(RuntimeError, match="torn down"):
        cdag.execute(1)


def test_oversized_input_fails_attributed_not_hang(cluster):
    from ray_tpu_torch.dag import InputNode, compile

    @rt.remote
    def f(x):
        return len(x)

    with InputNode() as inp:
        dag = f.bind(inp)
    cdag = compile(dag, channel_size=4096)
    try:
        ref = cdag.execute(b"x" * 65536)
        with pytest.raises(DagStageError, match="submission failed"):
            ref.get(timeout=30)
    finally:
        cdag.teardown()


def test_device_edge_pins_retire_no_leak(cluster):
    """Steady churn keeps at most the 2-invocation retention window of
    pins in each producing stage."""
    cdag = _device_edge_graph()
    try:
        for x in range(12):
            out = cdag.execute(x).get(timeout=120)
            assert float(out[0]) == 2.0 * x + 1.0
        stats = [rt.get(a.probe.remote(), timeout=30) for a in cdag._actors]
        assert 0 < max(s["count"] for s in stats) <= 2, stats
    finally:
        cdag.teardown()


def test_device_edge_is_a_snapshot(cluster):
    """A stage that changes its output tensor in place after returning it
    does not change what its consumer read: the edge pins a snapshot."""
    from ray_tpu_torch.dag import InputNode, compile

    @rt.remote
    class Producer:
        def __init__(self):
            self.buf = torch.zeros(N)

        def emit(self, x):
            self.buf.fill_(float(x))
            return self.buf  # the same tensor object every time

    @rt.remote
    def first(a):
        time.sleep(0.2)  # read after the producer's next in-place write
        return float(a[0])

    p = Producer.remote()
    with InputNode() as inp:
        dag = first.bind(p.emit.bind(inp))
    cdag = compile(dag)
    try:
        refs = [cdag.execute(x) for x in (1, 2, 3)]
        assert [r.get(timeout=60) for r in refs] == [1.0, 2.0, 3.0]
    finally:
        cdag.teardown()
    rt.kill(p)


def test_dag_events_compiled_and_teardown(cluster):
    """dag_compiled and dag_teardown land in the event plane under the
    dag id."""
    from ray_tpu_torch.dag import InputNode, compile

    @rt.remote
    def f(x):
        return x

    with InputNode() as inp:
        dag = f.bind(inp)
    cdag = compile(dag)
    dag_id = cdag.dag_id
    assert cdag.execute(1).get(timeout=60) == 1
    cdag.teardown()

    def _events():
        rows = state.list_events(entity=dag_id)
        if {"dag_compiled", "dag_teardown"} <= {e["kind"] for e in rows}:
            return rows
        return None

    rows = _wait(_events, what="dag lifecycle events")
    assert next(e for e in rows
                if e["kind"] == "dag_compiled")["attrs"]["stages"] == 1
    assert next(e for e in rows
                if e["kind"] == "dag_teardown")["attrs"]["clean"] is True


def test_stage_death_event_names_its_node(cluster):
    """A killed stage fails the open invocation with a DagStageError, and
    its dag_stage_death event names the node the stage lived on (recorded
    at compile, while the stage lived)."""
    from ray_tpu_torch.dag import InputNode, compile

    @rt.remote(num_cpus=0)
    class Stage:
        def work(self, x):
            if x == 2:
                time.sleep(60)  # invocation 2 is still open at the kill
            return x + 1

    s = Stage.remote()
    with InputNode() as inp:
        dag = s.work.bind(inp)
    cdag = compile(dag)
    try:
        assert cdag.execute(1).get(timeout=60) == 2
        # kill() returns before the stage's process is gone, so an
        # invocation made after it could still be answered; this one is
        # open (submitted, held by the stage) when the stage is killed
        ref = cdag.execute(2)
        rt.kill(s)
        with pytest.raises(DagStageError):
            ref.get(timeout=60)
        rows = _wait(lambda: [e for e in state.list_events(entity=cdag.dag_id)
                              if e["kind"] == "dag_stage_death"] or None,
                     what="dag_stage_death event")
        assert rows[0]["attrs"]["node"] == state.list_nodes()[0]["node_id"]
    finally:
        cdag.teardown()


def test_compile_records_each_stage_node_while_it_lives(cluster):
    """compile records the node of every stage, an actor method's and a
    function stage's, while the stages are alive; a dag_stage_death event
    names its node from that record rather than from a lookup made after
    the death."""
    from ray_tpu_torch.dag import InputNode, compile

    @rt.remote(num_cpus=0)
    class Stage:
        def work(self, x):
            return x + 1

    def double(x):
        return 2 * x

    s = Stage.remote()
    with InputNode() as inp:
        dag = rt.remote(double).bind(s.work.bind(inp))
    cdag = compile(dag)
    try:
        node = state.list_nodes()[0]["node_id"]
        assert [st.node for st in cdag._stages] == [node, node]
        assert cdag.execute(1).get(timeout=60) == 4
    finally:
        cdag.teardown()


# -------------------------------------------------------------- workflow
def test_workflow_run_and_resume(cluster, tmp_path):
    from ray_tpu_torch import workflow

    workflow.init(str(tmp_path / "wf"))
    marker = tmp_path / "exec_count"
    marker.write_text("0")

    @rt.remote
    def double(x, marker_path):
        p = __import__("pathlib").Path(marker_path)
        p.write_text(str(int(p.read_text()) + 1))
        return x * 2

    @rt.remote
    def add(a, b):
        return a + b

    dag = add.bind(double.bind(3, str(marker)), double.bind(4, str(marker)))
    assert workflow.run(dag, workflow_id="wf1") == 14
    assert marker.read_text() == "2"
    assert workflow.run(dag, workflow_id="wf1") == 14
    assert marker.read_text() == "2"  # every step memoised
    assert workflow.resume("wf1") == 14
    st = workflow.get_status("wf1")
    assert st["status"] == "SUCCESSFUL" and st["skipped"] == 3
    assert workflow.run(dag, workflow_id="wf2") == 14
    assert marker.read_text() == "4"


def test_workflow_memoizes_over_storage_uri(cluster, tmp_path):
    from ray_tpu_torch import workflow
    from ray_tpu_torch.storage.mem import MemBackend

    MemBackend.clear_all()
    workflow.init("mem://wfstore")
    try:
        marker = tmp_path / "exec_count"
        marker.write_text("0")

        @rt.remote
        def bump(x, marker_path):
            p = __import__("pathlib").Path(marker_path)
            p.write_text(str(int(p.read_text()) + 1))
            return x + 1

        dag = bump.bind(41, str(marker))
        assert workflow.run(dag, workflow_id="wfm") == 42
        assert workflow.run(dag, workflow_id="wfm") == 42
        assert marker.read_text() == "1"
        assert "wfm" in workflow.list_all()
        assert workflow.get_status("wfm")["status"] == "SUCCESSFUL"
    finally:
        workflow.init(str(tmp_path / "wf_default"))
        MemBackend.clear_all()


def test_workflow_code_change_invalidates_memoization(cluster, tmp_path):
    from ray_tpu_torch import workflow

    workflow.init(str(tmp_path / "wf"))

    @rt.remote
    def step(x):
        return x + 1

    assert workflow.run(step.bind(10), workflow_id="wf-code") == 11

    @rt.remote
    def step(x):  # noqa: F811 - same name, another body
        return x + 100

    assert workflow.run(step.bind(10), workflow_id="wf-code") == 110
