"""Compiled dataflow graphs: a pipelined, zero-RPC execution plane.

Parity target: reference python/ray/dag/compiled_dag_node.py
(experimental_compile — turn a bound DAG into persistent per-actor
execution loops connected by mutable shm channels, removing ALL per-call
RPC/scheduling from the steady state) + experimental/channel/. This is the
substrate pipeline-/tensor-parallel inference needs: the owner and the
controller are out of the steady-state loop entirely.

Surface (general DAGs: fan-in, fan-out, multi-output, actor methods):

    with InputNode() as inp:
        a = f.bind(inp)                     # function stage
        b = my_actor.work.bind(inp)         # EXISTING actor's method stage
        dag = MultiOutputNode([g.bind(a, b), h.bind(a)])   # fan-in + fan-out
    cdag = compile(dag)
    ref = cdag.execute(x)                   # -> DagRef, returns immediately
    out1, out2 = ref.get(timeout=30)
    cdag.teardown()

The execution plane, in four pieces (README "Compiled graphs"):

- **Pipelined execution.** `execute()` returns a `DagRef` and keeps up to
  `RT_DAG_MAX_INFLIGHT` invocations in flight; a per-invocation sequence
  number rides every edge message, so stages stay in lockstep without any
  barrier (each edge is FIFO; a multi-input stage checks its inputs agree
  on the seq). A driver-side collector thread fulfills DagRefs in order.

- **Device-object edges** (`RT_DAG_DEVICE_EDGES`, default on). A stage
  output that is a large `torch.Tensor` is pinned in the
  producing process's DeviceObjectTable and the channel carries
  only the ~200B placeholder; co-located consumers resolve it zero-copy
  (same process) or one-copy (same-host shm export) instead of paying a
  full pickle through the shm ring. Pins retire on a 2-invocation window:
  writing seq i requires every consumer to have acked seq i-1, which
  proves resolution of seq i-2 completed — so the producer frees i-2's
  pin without any consumer RPC. Off = byte-identical host path.

- **Attributed failure, never a hang.** Stage user-code exceptions ride
  the edges as `_StageError` (stage name + full remote traceback) and
  surface as a typed `DagStageError` on that invocation's DagRef only —
  the pipeline keeps flowing. Stage DEATH (actor SIGKILL, worker/node
  loss) is caught by the driver's liveness monitor watching every stage
  loop task: all in-flight DagRefs fail with a DagStageError naming the
  stage/node/invocation within the detection deadline, and
  `dag_compiled`/`dag_stage_death`/`dag_teardown` land in the cluster event
  plane. Stage loops tick watchdog progress beacons while idle in
  channel waits, so an armed stall ladder never mistakes an idle stage
  for a wedged one. `teardown()` kills every stage loop THEN unlinks
  every channel unconditionally — no shm segment outlives the graph.

- **Tracing.** When the tracing plane samples an invocation, a
  `dag.execute` span (submit -> fulfillment) roots per-stage `dag.stage`
  spans; the TraceContext rides the edge messages.

Every EDGE gets its own SPSC shm channel (a producer consumed by N
downstream nodes writes N channels — the fan-out mechanism; a node with
N upstream DAG args reads N channels — fan-in). Function nodes run in
dedicated stage actors; actor-method nodes attach an execution-loop
THREAD to the existing actor (reference: compiled loops on the bound
actors), so the steady state is channel reads/writes only — no RPC.

The token streams between processes live beside the graph: `stream.py`
(the shared-memory StreamRing, re-exported here) and `push_stream.py`
(the same record contract over rpc), which Serve uses to carry a
replica's streamed output to the proxy.

Counterpart: ray_tpu/dag/__init__.py (copied). An edge pins a
`torch.Tensor` (on the card or the CPU) where the reference pins a
`jax.Array`; the pin is a snapshot taken at publish time
(`device_store.pin_edge`), so a stage that later changes the tensor in
place does not change what its consumer reads. Channels are named under
the runtime's session (`rtch_torch_<session>_<tag>_<n>`), and the
session's shutdown unlinks any that a killed driver left behind. A
stage's node is recorded at compile, while the stage lives, and its
`dag_stage_death` event names it from that record (the reference looks
it up only after the death; `CompiledDAG._stage_node`).
"""

from __future__ import annotations

import os
import threading
import time
import traceback as _tb
import uuid
from typing import Any, Optional

import ray_tpu_torch
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private import events as _events
from ray_tpu_torch._private import tracing as _tracing
from ray_tpu_torch._private import watchdog as _watchdog
from ray_tpu_torch._private.ids import random_id_bytes
from ray_tpu_torch._private.rtconfig import CONFIG
from ray_tpu_torch.dag.stream import RingClosed, StreamRing  # noqa: F401 (re-export)
from ray_tpu_torch.exceptions import DagStageError  # noqa: F401 (re-export)
from ray_tpu_torch.experimental.channel import Channel
from ray_tpu_torch.workflow import DAGNode

_SHUTDOWN = "__rt_dag_stop__"
# How long compile waits for its stage actors to be placed, so each
# stage's node is recorded while it lives (_record_stage_nodes); a stage
# placed later is looked up at its death.
_NODE_RECORD_WAIT_S = 5.0
_CANCELLED = object()  # edge-op sentinel: the hosting loop was cancelled


class InputNode:
    """Placeholder for the execute() argument (reference dag.InputNode)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        return False


class MultiOutputNode:
    """Marks several DAG leaves as the compiled graph's outputs
    (reference dag.MultiOutputNode); DagRef.get() returns a list."""

    def __init__(self, nodes: list):
        self.nodes = list(nodes)


class ActorMethodNode(DAGNode):
    """A bound method of an EXISTING actor (reference: actor.method.bind).
    Created by ActorMethod.bind()."""

    def __init__(self, actor_handle, method_name: str, args, kwargs):
        super().__init__(None, args, kwargs, method_name)
        self.actor_handle = actor_handle
        self.method_name = method_name


class _StageError:
    """A stage's user-code failure riding the edges to the outputs: names
    the stage and carries the FULL formatted remote traceback (surfaced as
    DagStageError at DagRef.get)."""

    __slots__ = ("stage", "msg", "traceback_str")

    def __init__(self, stage: str, msg: str, traceback_str: str = ""):
        self.stage = stage
        self.msg = msg
        self.traceback_str = traceback_str


# --------------------------------------------------------------- edge ops
def _edge_read(ch: Channel, stop: Optional[threading.Event],
               timeout: Optional[float] = None):
    """Read one edge message in stop-checked, beacon-ticking slices: an
    IDLE stage parked here is alive (its watchdog beacon keeps ticking),
    and a cancelled loop (teardown after a peer death) exits promptly
    instead of blocking forever on a dead producer."""
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        if stop is not None and stop.is_set():
            return _CANCELLED
        try:
            return ch.read(timeout=_watchdog.progress_slice_s())
        except TimeoutError:
            _watchdog.report_progress()
            if deadline is not None and time.monotonic() > deadline:
                raise


def _edge_write(ch: Channel, value, stop: Optional[threading.Event],
                timeout: Optional[float] = None) -> Optional[object]:
    """Write one edge message under the same slicing discipline (the
    consumer may be backpressuring us for a while — that is pipelining,
    not a stall). Returns _CANCELLED if the loop was stopped mid-wait."""
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        if stop is not None and stop.is_set():
            return _CANCELLED
        try:
            ch.write(value, timeout=_watchdog.progress_slice_s())
            return None
        except TimeoutError:
            _watchdog.report_progress()
            if deadline is not None and time.monotonic() > deadline:
                raise


class _EdgePublisher:
    """Device-object edge encoder (one per producing node, one for the
    driver's input edges): large torch.Tensors — bare or inside
    a tuple/list stage output (iterative graphs carry (tag, activation,
    meta) messages) — are pinned locally and replaced by the ~200B
    tier-ladder placeholder; everything else passes through untouched.
    Each pinned array is also eagerly EXPORTED into the local shm store at
    publish time: the export precedes the channel write, so a same-host
    consumer's resolve is a store hit — zero RPCs in the steady state —
    instead of an export_device_object round trip back to the producer.
    Pins retire on the 2-invocation window proved safe by channel
    backpressure (module docstring); retirement is grouped per publish so
    multi-array messages keep the same window."""

    __slots__ = ("_pins", "_on", "_min_bytes")

    def __init__(self):
        self._pins: list[list[str]] = []  # oldest first; one group/publish
        self._on: Optional[bool] = None
        self._min_bytes: Optional[int] = None

    def _enabled(self) -> bool:
        on = self._on
        if on is None:
            try:
                on = bool(CONFIG.dag_device_edges)
            except Exception:
                on = True
            self._on = on
        return on

    def publish(self, value):
        if not self._enabled():
            return value
        if self._min_bytes is None:
            try:
                self._min_bytes = int(CONFIG.dag_edge_min_bytes)
            except Exception:
                self._min_bytes = 1024
        group: list[str] = []
        out = self._pub(value, group, depth=0)
        self._pins.append(group)
        return out

    def _pub(self, value, group: list, depth: int):
        if depth < 2 and type(value) in (tuple, list):
            items = [self._pub(v, group, depth + 1) for v in value]
            return tuple(items) if type(value) is tuple else items
        from ray_tpu_torch._private import device_store

        if not device_store.eligible(value, min_bytes=self._min_bytes):
            return value
        from ray_tpu_torch._private.worker import global_worker

        w = global_worker()
        if w is None:
            return value
        oid = random_id_bytes(16).hex()
        ref = device_store.pin_edge(oid, value, w)
        if w.store is not None:
            try:
                # Eager same-host export: one host copy now (the lazy path
                # pays the same copy at first consumer RPC) buys every
                # consumer an RPC-free store-hit resolve.
                device_store.export_to_store(oid, w.store)
            except Exception:
                pass  # consumers fall back to the export-RPC tier
        group.append(oid)
        return ref

    def retire(self, keep: int = 2) -> None:
        while len(self._pins) > keep:
            self._free(self._pins.pop(0))

    def close(self) -> None:
        while self._pins:
            self._free(self._pins.pop())

    @staticmethod
    def _free(oids: list) -> None:
        if not oids:
            return
        try:
            from ray_tpu_torch._private import device_store
            from ray_tpu_torch._private.worker import global_worker

            w = global_worker()
            device_store.free_local(oids, store=w.store if w else None)
        except Exception:
            pass  # process-exit frees are the backstop


# ------------------------------------------------------------- stage loop
def run_stage_loop(call, in_specs: list, out_names: list, kwargs: dict,
                   size: int, *, stage: str = "stage",
                   stop: Optional[threading.Event] = None):
    """The compiled execution loop shared by function-stage actors and
    actor-method loop threads: read every channel input, check lockstep,
    apply, publish every out edge. Stop tokens and upstream stage errors
    pass through; each message is (seq, trace_ctx, value). Returns True on
    a clean stop-token shutdown, False when cancelled via `stop`."""
    in_chs = [(i, Channel(nm, size, _create=False))
              for i, (kind, nm) in enumerate(in_specs) if kind == "ch"]
    literals = [v if kind == "lit" else None for kind, v in in_specs]
    out_chs = [Channel(nm, size, _create=False) for nm in out_names]
    pub = _EdgePublisher()
    try:
        while True:
            args = list(literals)
            stop_tok = False
            err: Optional[_StageError] = None
            seq = None
            ctx = None
            for i, ch in in_chs:
                item = _edge_read(ch, stop)
                if item is _CANCELLED:
                    return False
                if isinstance(item, str) and item == _SHUTDOWN:
                    stop_tok = True
                    continue
                iseq, ictx, val = item
                if seq is None:
                    seq = iseq
                elif iseq != seq and err is None:
                    # FIFO edges make this unreachable in a healthy graph;
                    # it guards channel corruption from turning into
                    # silently mismatched invocations.
                    err = _StageError(
                        stage, f"lockstep violation: edge delivered seq "
                               f"{iseq} while a sibling delivered {seq}")
                if ictx is not None:
                    ctx = ictx
                if isinstance(val, _StageError):
                    if err is None:
                        err = val  # propagate the FIRST upstream error
                else:
                    args[i] = val
            if stop_tok:
                for ch in out_chs:
                    try:
                        _edge_write(ch, _SHUTDOWN, stop, timeout=5)
                    except TimeoutError:
                        pass  # dead/slow peer: teardown unlinks regardless
                return True
            if err is not None:
                out: Any = err
            else:
                t0 = time.time()
                try:
                    out = call(*args, **kwargs)
                except Exception as e:
                    out = _StageError(stage, f"{type(e).__name__}: {e}",
                                      _tb.format_exc())
                if ctx is not None:
                    _tracing.record_span_in(
                        tuple(ctx), "dag.stage", "dag", t0, time.time(),
                        {"stage": stage, "seq": seq,
                         "ok": not isinstance(out, _StageError)})
            wire = pub.publish(out) if not isinstance(out, _StageError) else out
            for ch in out_chs:
                if _edge_write(ch, (seq, ctx, wire), stop) is _CANCELLED:
                    return False
            # Every consumer acked seq-1 for these writes to complete, so
            # resolution of seq-2 provably finished: retire older pins.
            pub.retire(keep=2)
    finally:
        pub.close()
        for _i, ch in in_chs:
            ch.close()
        for ch in out_chs:
            ch.close()
        # Final act: force-drain this process's span/event rings — the
        # driver kills stage actors shortly after the loop exits, and a
        # kill landing between 1 Hz flush ticks would silently eat the
        # last invocations' dag.stage spans.
        try:
            from ray_tpu_torch.util import metrics

            metrics.flush_on_shutdown()
        except Exception:
            pass


class _StageActor:
    """Hosts one compiled FUNCTION stage."""

    def __init__(self, fn, in_specs: list, out_names: list, kwargs: dict,
                 size: int, stage: str):
        self.fn = fn
        self.in_specs = in_specs
        self.out_names = out_names
        self.kwargs = kwargs
        self.size = size
        self.stage = stage

    def run_loop(self):
        return run_stage_loop(self.fn, self.in_specs, self.out_names,
                              self.kwargs, self.size, stage=self.stage)

    def pid(self):
        import os

        return os.getpid()

    def probe(self) -> dict:
        """Introspection for tests/ops: this stage process's device-object
        residency (device-edge pins live here)."""
        from ray_tpu_torch._private import device_store

        return device_store.table_stats()


# ----------------------------------------------------------------- driver
class DagRef:
    """Handle to one in-flight compiled-DAG invocation. `get()` blocks for
    the result; a stage failure raises the typed DagStageError naming the
    stage (and the full remote traceback for user-code errors)."""

    __slots__ = ("seq", "_event", "_value", "_error")

    def __init__(self, seq: int):
        self.seq = seq
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def get(self, timeout: Optional[float] = 60.0):
        if not self._event.wait(timeout):
            raise exc.GetTimeoutError(
                f"compiled-DAG invocation {self.seq} not fulfilled within "
                f"{timeout}s")
        if self._error is not None:
            raise self._error
        return self._value


class _Stage:
    """Driver-side bookkeeping for one stage loop."""

    __slots__ = ("name", "kind", "ref", "actor_id", "handle", "settled",
                 "node")

    def __init__(self, name: str, kind: str, ref, actor_id: str, handle):
        self.name = name
        self.kind = kind          # "stage_actor" | "actor_method"
        self.ref = ref            # the loop task's ObjectRef
        self.actor_id = actor_id
        self.handle = handle      # ActorHandle (stage actors only)
        self.settled = False
        self.node: Optional[str] = None  # recorded while the stage lives


class CompiledDAG:
    def __init__(self, dag, *, channel_size: Optional[int] = None):
        outputs = dag.nodes if isinstance(dag, MultiOutputNode) else [dag]
        tag = uuid.uuid4().hex[:8]
        if channel_size is None:
            channel_size = int(CONFIG.dag_channel_bytes)
        self._size = channel_size
        self._tag = tag
        self.dag_id = f"dag-{tag}"

        # ---- discover nodes + edges (consumer counts drive fan-out)
        nodes: list[DAGNode] = []
        seen: dict[int, DAGNode] = {}

        def visit(n):
            if isinstance(n, InputNode):
                return
            if id(n) in seen:
                return
            seen[id(n)] = n
            for a in list(n.args) + list(n.kwargs.values()):
                if isinstance(a, (DAGNode, InputNode)):
                    visit(a)
            nodes.append(n)  # post-order = topological

        for out in outputs:
            if not isinstance(out, DAGNode):
                raise ValueError("DAG outputs must be bound nodes")
            visit(out)

        # ---- one channel per EDGE, named under the runtime's session so
        # that the session's shutdown sweeps what a killed driver (a serve
        # replica hosting a pipelined engine) could not unlink itself
        from ray_tpu_torch._private.worker import global_worker

        w = global_worker()
        scope = (f"{w.store.session}_" if w is not None
                 and w.store is not None else "")
        self._channels: list[Channel] = []
        counter = [0]

        def new_channel() -> Channel:
            ch = Channel(f"{scope}{tag}_{counter[0]}", channel_size)
            counter[0] += 1
            self._channels.append(ch)
            return ch

        # producer node -> list of its out-edge channels
        out_edges: dict[int, list] = {id(n): [] for n in nodes}
        self._input_edges: list[Channel] = []  # driver-written
        # per node: in_specs aligned with positional args
        in_specs: dict[int, list] = {}
        kw_literals: dict[int, dict] = {}
        stage_names: dict[int, str] = {}
        for idx, n in enumerate(nodes):
            stage_names[id(n)] = f"{n.name}[{idx}]"
            specs = []
            for a in n.args:
                if isinstance(a, InputNode):
                    ch = new_channel()
                    self._input_edges.append(ch)
                    specs.append(("ch", ch.name))
                elif isinstance(a, DAGNode):
                    ch = new_channel()
                    out_edges[id(a)].append(ch)
                    specs.append(("ch", ch.name))
                else:
                    specs.append(("lit", a))
            kws = {}
            for k, a in n.kwargs.items():
                if isinstance(a, (DAGNode, InputNode)):
                    raise ValueError(
                        "DAG args must be positional (kwargs are literals)")
                kws[k] = a
            if not any(kind == "ch" for kind, _v in specs):
                # A node with no channel inputs would free-run decoupled
                # from execute() and its loop could never be stopped by
                # teardown (stop tokens flow along edges).
                raise ValueError(
                    f"DAG node {n.name!r} has no upstream: every node must "
                    f"consume InputNode or another node")
            in_specs[id(n)] = specs
            kw_literals[id(n)] = kws
        # output edges: driver-read
        self._output_edges: list[Channel] = []
        for out in outputs:
            ch = new_channel()
            out_edges[id(out)].append(ch)
            self._output_edges.append(ch)

        # ---- launch stages
        stage_cls = ray_tpu_torch.remote(num_cpus=0, max_concurrency=2)(_StageActor)
        self._actors = []       # our function-stage actors (killed on teardown)
        self._stages: list[_Stage] = []

        try:
            for n in nodes:
                outs = [c.name for c in out_edges[id(n)]]
                name = stage_names[id(n)]
                if isinstance(n, ActorMethodNode):
                    # Attach the loop to the EXISTING actor: a hidden actor
                    # task the worker runtime runs on a dedicated thread
                    # (reference compiled_dag_node attaches exec loops to
                    # bound actors).
                    w = global_worker()
                    refs = w.submit_actor_task(
                        n.actor_handle._actor_id, "__rt_dag_loop__",
                        ({"method": n.method_name,
                          "in_specs": in_specs[id(n)],
                          "out_names": outs,
                          "kwargs": kw_literals[id(n)],
                          "size": channel_size,
                          "stage": name,
                          "tag": tag},), {})
                    self._stages.append(_Stage(
                        name, "actor_method", refs[0],
                        n.actor_handle._actor_id, n.actor_handle))
                else:
                    fn = getattr(n.fn, "_fn", n.fn)
                    a = stage_cls.remote(fn, in_specs[id(n)], outs,
                                         kw_literals[id(n)], channel_size,
                                         name)
                    self._actors.append(a)
                    self._stages.append(_Stage(
                        name, "stage_actor", a.run_loop.remote(),
                        a._actor_id, a))
        except BaseException:
            # Compile failed mid-launch: the caller never gets an object to
            # teardown, so nothing else would ever unlink these segments.
            for a in self._actors:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:
                    pass
            for ch in self._channels:
                try:
                    ch.close(unlink=True)
                except Exception:
                    pass
            raise
        self._multi = isinstance(dag, MultiOutputNode)
        self._record_stage_nodes(wait_s=_NODE_RECORD_WAIT_S)

        # ---- pipelined-driver state
        self._dead = False
        self._dead_error: Optional[DagStageError] = None
        self._torn = False
        self._tearing_down = False
        self._stop = threading.Event()
        self._lock = threading.Lock()          # pending + death transitions
        self._submit_lock = threading.Lock()   # seq order == edge FIFO order
        self._pending: dict[int, tuple] = {}   # seq -> (DagRef, trace handle)
        self._next_seq = 0
        self._inflight = threading.Semaphore(max(1, int(CONFIG.dag_max_inflight)))
        self._publisher = _EdgePublisher()
        # Submission queue: execute() enqueues and returns; the feeder
        # thread pays the input edges' (capacity-1) backpressure, so the
        # driver really does keep RT_DAG_MAX_INFLIGHT invocations in
        # flight instead of being throttled to the first stage's pace.
        self._submit_q: list = []
        self._submit_cv = threading.Condition()
        self._feeder = threading.Thread(
            target=self._feed_loop, daemon=True, name="rt-dag-feed")
        self._feeder.start()
        self._collector = threading.Thread(
            target=self._collect_loop, daemon=True, name="rt-dag-collect")
        self._collector.start()
        self._monitor = threading.Thread(
            target=self._monitor_loop, daemon=True, name="rt-dag-monitor")
        self._monitor.start()
        _events.emit_event(
            "dag_compiled",
            f"compiled DAG {self.dag_id}: {len(nodes)} stages, "
            f"{counter[0]} channels",
            entity=[self.dag_id],
            attrs={"stages": len(nodes), "channels": counter[0]})

    # ------------------------------------------------------------ execute
    def execute(self, value, timeout: float = 60.0) -> DagRef:
        """One invocation: shm writes in, a DagRef back — no per-call RPC.
        Returns immediately while fewer than RT_DAG_MAX_INFLIGHT
        invocations are unfulfilled; beyond that (or under stage
        backpressure) it blocks up to `timeout`. DagRef.get() returns the
        single output value, or a list for MultiOutputNode."""
        self._check_alive()
        if not self._inflight.acquire(timeout=timeout):
            raise exc.GetTimeoutError(
                f"compiled DAG {self.dag_id}: {CONFIG.dag_max_inflight} "
                f"invocations already in flight and none completed within "
                f"{timeout}s")
        acquired = True
        try:
            with self._submit_lock:
                seq = self._next_seq
                self._next_seq += 1
                handle = _tracing.open_root("dag.execute", "dag")
                ctx = (handle[0], handle[1]) if handle is not None else None
                ref = DagRef(seq)
                with self._lock:
                    # Re-checked under the SAME lock _fail_with/teardown
                    # sweep _pending with: a ref registered after the
                    # sweep would never be fulfilled — get(timeout=None)
                    # would hang, violating the never-a-hang contract.
                    self._check_alive()
                    self._pending[seq] = (ref, handle)
                acquired = False  # the collector (or _fail) releases now
                with self._submit_cv:
                    self._submit_q.append((seq, ctx, value))
                    self._submit_cv.notify()
            return ref
        finally:
            if acquired:
                self._inflight.release()

    def _feed_loop(self) -> None:
        """Write queued invocations into the input edges in seq order —
        the single writer, so FIFO holds. A _SHUTDOWN marker (graceful
        teardown) forwards stop tokens BEHIND every queued invocation. Any
        submission failure (e.g. a value larger than RT_DAG_CHANNEL_BYTES)
        kills the graph attributed — a silently dead feeder would strand
        every already-returned DagRef."""
        try:
            while True:
                with self._submit_cv:
                    while not self._submit_q:
                        if self._stop.is_set():
                            return
                        self._submit_cv.wait(timeout=0.2)
                    item = self._submit_q.pop(0)
                if isinstance(item, str) and item == _SHUTDOWN:
                    for ch in self._input_edges:
                        try:
                            _edge_write(ch, _SHUTDOWN, self._stop, timeout=10)
                        except TimeoutError:
                            pass  # dead/slow stage: the kill path handles it
                    return
                seq, ctx, value = item
                wire = self._publisher.publish(value)
                for ch in self._input_edges:
                    if _edge_write(ch, (seq, ctx, wire),
                                   self._stop) is _CANCELLED:
                        return
                self._publisher.retire(keep=2)
        except Exception as e:
            if not (self._stop.is_set() or self._tearing_down):
                self._fail(DagStageError(
                    f"compiled DAG {self.dag_id}: input submission failed "
                    f"({type(e).__name__}: {e})"))

    def _check_alive(self) -> None:
        if self._torn:
            raise RuntimeError("compiled DAG was torn down")
        if self._dead:
            raise self._dag_error()

    def _dag_error(self) -> DagStageError:
        err = self._dead_error
        if err is None:
            err = DagStageError(f"compiled DAG {self.dag_id} is dead")
        return err

    # ---------------------------------------------------------- collector
    def _collect_loop(self) -> None:
        """Read output edges in invocation order and fulfill DagRefs —
        the only consumer of the output channels, so seqs arrive FIFO."""
        try:
            while not self._stop.is_set():
                outs = []
                seq = None
                for ch in self._output_edges:
                    item = _edge_read(ch, self._stop)
                    if item is _CANCELLED:
                        return
                    if isinstance(item, str) and item == _SHUTDOWN:
                        return
                    iseq, _ictx, val = item
                    if seq is None:
                        seq = iseq
                    elif iseq != seq:
                        raise DagStageError(
                            f"compiled DAG {self.dag_id}: output edges "
                            f"disagree on invocation ({iseq} vs {seq})")
                    outs.append(val)
                self._fulfill(seq, outs)
        except Exception as e:  # a dead graph must never hang consumers
            if not (self._stop.is_set() or self._tearing_down):
                self._fail(DagStageError(
                    f"compiled DAG {self.dag_id}: result collection failed "
                    f"({type(e).__name__}: {e})"))

    def _fulfill(self, seq: int, outs: list) -> None:
        with self._lock:
            ent = self._pending.pop(seq, None)
        if ent is None:
            return  # already failed by the monitor
        ref, handle = ent
        errs = [v for v in outs if isinstance(v, _StageError)]
        if errs:
            e = errs[0]
            msg = (f"compiled DAG stage {e.stage!r} failed on invocation "
                   f"{seq}: {e.msg}")
            if e.traceback_str:
                msg += "\n" + e.traceback_str
            ref._error = DagStageError(msg, stage=e.stage, invocation=seq,
                                       traceback_str=e.traceback_str)
        else:
            ref._value = outs if self._multi else outs[0]
        _tracing.close_root(handle, {"seq": seq, "ok": not errs})
        ref._event.set()
        self._inflight.release()

    # ------------------------------------------------------------ monitor
    def _monitor_loop(self) -> None:
        """Stage-liveness watch: a loop task that settles BEFORE teardown
        (actor death, leased-worker death, channel peer gone — or an
        unexpected clean exit) kills the graph with an attributed error on
        every in-flight DagRef. Detection deadline = the runtime's own
        death-detection latency + one monitor poll."""
        try:
            interval = max(0.05, float(CONFIG.dag_monitor_interval_s))
        except Exception:
            interval = 0.2
        while not self._stop.wait(interval):
            for st in self._stages:
                if st.settled:
                    continue
                try:
                    done, _ = ray_tpu_torch.wait([st.ref], num_returns=1,
                                           timeout=0.05)
                except Exception:
                    return  # driver runtime is shutting down
                if not done:
                    continue
                st.settled = True
                if self._tearing_down or self._stop.is_set():
                    continue
                try:
                    ray_tpu_torch.get(st.ref, timeout=5)
                    cause = "stage loop exited unexpectedly"
                except Exception as e:
                    cause = f"{type(e).__name__}: {e}"
                self._on_stage_death(st, cause)
                return

    def _record_stage_nodes(self, wait_s: float) -> None:
        """Record each stage's node while the stage is alive, at compile,
        waiting up to `wait_s` for the stage actors to be placed. One
        `list_actors` call a round; a failed call records nothing and is
        tried again."""
        from ray_tpu_torch.util import state

        deadline = time.monotonic() + wait_s
        while True:
            try:
                placed = {row["actor_id"]: row.get("node_id")
                          for row in state.list_actors(limit=1 << 30)}
            except Exception:
                placed = {}
            for st in self._stages:
                if st.node is None:
                    st.node = placed.get(st.actor_id)
            if all(st.node is not None for st in self._stages) \
                    or time.monotonic() >= deadline:
                return
            time.sleep(0.05)

    def _stage_node(self, st: _Stage) -> Optional[str]:
        """Which node the (dead) stage lived on: the node recorded at
        compile (`_record_stage_nodes`), else a best-effort lookup now.
        This departs from ray_tpu/dag/__init__.py:757-767, which only looks
        the node up after the death: that `util.state.list_actors` call
        is an RPC with a 30 s timeout, made while the runtime is busy
        reaping the dead stage, and under load it lost the node."""
        if st.node is not None:
            return st.node
        try:
            from ray_tpu_torch.util import state

            for row in state.list_actors():
                if row.get("actor_id") == st.actor_id:
                    return row.get("node_id") or row.get("node")
        except Exception:
            pass
        return None

    def _on_stage_death(self, st: _Stage, cause: str) -> None:
        node = self._stage_node(st)
        with self._lock:
            seqs = sorted(self._pending)
        _events.emit_event(
            "dag_stage_death",
            f"compiled DAG {self.dag_id}: stage {st.name!r} died "
            f"({cause}); {len(seqs)} invocation(s) in flight",
            entity=[self.dag_id, st.actor_id],
            attrs={"stage": st.name, "cause": cause,
                   "node": node, "inflight": len(seqs)})

        def mk(seq: Optional[int]) -> DagStageError:
            return DagStageError(
                f"compiled DAG {self.dag_id}: stage {st.name!r}"
                f"{f' on node {node[:12]}' if node else ''} died mid-run "
                f"({cause})"
                + (f"; invocation {seq} was in flight" if seq is not None
                   else ""),
                stage=st.name, node=node, invocation=seq)

        self._fail_with(mk)

    def _fail(self, err: DagStageError) -> None:
        self._fail_with(lambda seq: DagStageError(
            str(err), stage=err.stage, node=err.node, invocation=seq,
            traceback_str=err.traceback_str))

    def _fail_with(self, make_err) -> None:
        """Kill the graph: every in-flight DagRef resolves to an attributed
        error NOW (never a hang), later execute() calls raise the same."""
        with self._lock:
            if self._dead:
                return
            self._dead = True
            self._dead_error = make_err(None)
            pending = sorted(self._pending.items())
            self._pending.clear()
        self._stop.set()
        for seq, (ref, handle) in pending:
            ref._error = make_err(seq)
            _tracing.close_root(handle, {"seq": seq, "ok": False})
            ref._event.set()
            self._inflight.release()

    # ------------------------------------------------------------ teardown
    def teardown(self) -> None:
        """Stop every stage loop, then unlink every channel — both
        UNCONDITIONALLY (a stage dead mid-run leaves peers parked on its
        edges; they are killed/cancelled rather than waited on, and no shm
        segment survives regardless of how the graph ended)."""
        with self._lock:
            if self._torn:
                return
            self._torn = True
        self._tearing_down = True
        clean = not self._dead
        loop_refs = [st.ref for st in self._stages]
        if clean:
            # Graceful path: a stop marker rides the submission queue, so
            # the feeder forwards stop tokens BEHIND every queued
            # invocation and outstanding DagRefs still fulfill before the
            # collector reads the shutdown marker.
            with self._submit_cv:
                self._submit_q.append(_SHUTDOWN)
                self._submit_cv.notify()
            self._feeder.join(timeout=15)
            if self._feeder.is_alive():
                clean = False  # a stage stopped consuming: kill path below
            try:
                ray_tpu_torch.wait(loop_refs, num_returns=len(loop_refs),
                             timeout=10)
            except Exception:
                pass
        self._stop.set()
        # Cooperative cancel for loops attached to EXISTING actors (the
        # actor itself survives teardown; only its loop thread must exit —
        # its upstream may be dead, so the stop token may never arrive).
        from ray_tpu_torch._private.worker import global_worker

        w = global_worker()
        for st in self._stages:
            if st.kind == "actor_method" and not st.settled and w is not None:
                try:
                    w.submit_actor_task(st.actor_id, "__rt_dag_cancel__",
                                        ({"tag": self._tag},), {})
                except Exception:
                    pass
        # Kill-then-unlink: stage actors die unconditionally...
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
        try:
            # ...and we wait for every loop to settle so a straggler can't
            # race the unlink below (strict channel attach backstops this).
            ray_tpu_torch.wait(loop_refs, num_returns=len(loop_refs), timeout=10)
        except Exception:
            pass
        # The feeder/collector must be OUT of their channel ops before the
        # mmaps close: a native futex wait on a just-closed mapping is a
        # segfault, not an exception. Both exit within one stop-checked
        # slice of _stop being set.
        self._feeder.join(timeout=5)
        self._collector.join(timeout=5)
        threads_done = not (self._feeder.is_alive()
                            or self._collector.is_alive())
        # Fail anything still unresolved (torn down with work in flight).
        with self._lock:
            pending = sorted(self._pending.items())
            self._pending.clear()
        for seq, (ref, handle) in pending:
            if ref._event.is_set():
                continue
            ref._error = DagStageError(
                f"compiled DAG {self.dag_id} was torn down with invocation "
                f"{seq} in flight", invocation=seq)
            _tracing.close_root(handle, {"seq": seq, "ok": False})
            ref._event.set()
        # ...then every channel unlinks, no matter what came before. If a
        # driver thread would not settle, unlink the NAME only — the
        # segment is gone from /dev/shm either way, and the mapping dies
        # with the process instead of under a thread still waiting on it.
        self._publisher.close()
        for ch in self._channels:
            try:
                if threads_done:
                    ch.close(unlink=True)
                else:
                    os.unlink(ch._path)
            except OSError:
                pass
            except Exception:
                pass
        _events.emit_event(
            "dag_teardown",
            f"compiled DAG {self.dag_id} torn down "
            f"({'clean' if clean else 'forced'})",
            entity=[self.dag_id], attrs={"clean": clean})
        self._monitor.join(timeout=5)


def compile(dag, **kw) -> CompiledDAG:  # noqa: A001 - reference name
    return CompiledDAG(dag, **kw)
