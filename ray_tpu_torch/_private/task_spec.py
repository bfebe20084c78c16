"""Task specification — the unit handed from submitter to scheduler to worker.

Parity target: reference src/ray/common/task/task_spec.h (TaskSpecification)
+ python/ray/includes/function_descriptor.pxi. Functions are registered once
in the controller KV by id and referenced by hash (cf. reference
python/ray/_private/function_manager.py export/import via GCS KV).

Counterpart: ray_tpu/_private/task_spec.py (copied).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, ClassVar, Optional

NORMAL = "normal"
ACTOR_CREATE = "actor_create"
ACTOR_TASK = "actor_task"

#: num_returns value for streaming-generator tasks (reference
#: num_returns="streaming" -> ObjectRefGenerator).
STREAMING = "streaming"

#: Arg wire-encoding tag for device-plane arrays: ("dref", oid,
#: placeholder_blob). The placeholder (see _private/device_store) carries
#: the producer's device-location hint INSIDE the spec, so the executor
#: resolves it peer-to-peer with no controller round trip — the device
#: edition of the ("ref", oid) encoding below.
DEVICE_REF = "dref"


@dataclass
class SchedulingStrategy:
    """DEFAULT (hybrid pack/spread), SPREAD, node affinity, or placement group.

    Parity: reference python/ray/util/scheduling_strategies.py +
    raylet/scheduling/policy/*."""

    kind: str = "DEFAULT"  # DEFAULT | SPREAD | NODE_AFFINITY | PLACEMENT_GROUP
    node_id: Optional[str] = None
    soft: bool = False
    pg_id: Optional[str] = None
    pg_bundle_index: int = -1
    pg_capture_child_tasks: bool = False

    # Tuple state instead of the default instance-dict pickle: strategy rides
    # in every task frame, and field names in the stream cost real CPU on the
    # 2-4 hops a spec makes (cf. reference: TaskSpecification is a protobuf).
    def __getstate__(self):
        return (self.kind, self.node_id, self.soft, self.pg_id,
                self.pg_bundle_index, self.pg_capture_child_tasks)

    def __setstate__(self, s):
        (self.kind, self.node_id, self.soft, self.pg_id,
         self.pg_bundle_index, self.pg_capture_child_tasks) = s


@dataclass
class TaskSpec:
    task_id: str
    kind: str  # NORMAL | ACTOR_CREATE | ACTOR_TASK
    name: str
    # Function: registered blob id in controller KV ("fn:<id>") — workers cache.
    function_id: str
    method_name: str = ""  # for actor tasks
    # Encoded args: list of ("v", header, [bufs]) or ("ref", oid, owner_addr)
    args: list = field(default_factory=list)
    kwargs: dict = field(default_factory=dict)
    num_returns: int = 1
    resources: dict = field(default_factory=dict)  # raw fixed-point mapping
    strategy: SchedulingStrategy = field(default_factory=SchedulingStrategy)
    max_retries: int = 3
    retry_exceptions: bool = False
    runtime_env: dict = field(default_factory=dict)
    # Ownership (cf. reference core_worker TaskManager/ReferenceCounter):
    owner_id: str = ""  # worker id of submitter
    owner_addr: Optional[tuple] = None  # (host, port) of owner's RPC server
    # Actor linkage:
    actor_id: Optional[str] = None
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    actor_name: Optional[str] = None
    namespace: str = "default"
    get_if_exists: bool = False
    #: "detached" = survives its owner (reference actor lifetime); None =
    #: dies with the owner (fate-sharing) and is never persisted.
    lifetime: Optional[str] = None
    # retry bookkeeping (mutated by controller):
    attempt: int = 0
    #: Actor concurrency groups: {group_name: max_concurrency} (reference
    #: concurrency_group_manager.h); methods opt in via @ray_tpu_torch.method.
    concurrency_groups: Optional[dict] = None
    #: Per-attempt execution deadline (@remote(timeout_s=...)), enforced
    #: worker-side: an attempt running longer is interrupted and fails as a
    #: retryable TaskTimeoutError (system failure under max_retries).
    timeout_s: Optional[float] = None
    #: Trace context (trace_id, parent_span_id) from the tracing plane
    #: (README "Tracing & timeline"): set at submit when the root sampled,
    #: carried across retries AND across the direct->controller failover
    #: re-route so every attempt's execute span chains to one trace. None
    #: (tracing off / unsampled) keeps every wire format at its pre-tracing
    #: arity — the off path is byte-identical.
    trace: Optional[tuple] = None

    def __getstate__(self):
        if self.trace is None:
            # Traceless specs keep the 26-field state: byte-identical wire/
            # snapshot bytes with RT_TRACING unset (pinned by test).
            return (self.task_id, self.kind, self.name, self.function_id,
                    self.method_name, self.args, self.kwargs,
                    self.num_returns, self.resources, self.strategy,
                    self.max_retries, self.retry_exceptions,
                    self.runtime_env, self.owner_id, self.owner_addr,
                    self.actor_id, self.max_restarts, self.max_task_retries,
                    self.max_concurrency, self.actor_name, self.namespace,
                    self.get_if_exists, self.lifetime, self.attempt,
                    self.concurrency_groups, self.timeout_s)
        return (self.task_id, self.kind, self.name, self.function_id,
                self.method_name, self.args, self.kwargs, self.num_returns,
                self.resources, self.strategy, self.max_retries,
                self.retry_exceptions, self.runtime_env, self.owner_id,
                self.owner_addr, self.actor_id, self.max_restarts,
                self.max_task_retries, self.max_concurrency, self.actor_name,
                self.namespace, self.get_if_exists, self.lifetime,
                self.attempt, self.concurrency_groups, self.timeout_s,
                self.trace)

    def __setstate__(self, s):
        if len(s) == 23:  # pre-'lifetime' snapshots: insert None before attempt
            s = s[:22] + (None,) + s[22:]
        if len(s) == 24:  # pre-'concurrency_groups' snapshots
            s = s + (None,)
        if len(s) == 25:  # pre-'timeout_s' snapshots
            s = s + (None,)
        if len(s) == 26:  # pre-'trace' snapshots (and traceless specs)
            s = s + (None,)
        (self.task_id, self.kind, self.name, self.function_id,
         self.method_name, self.args, self.kwargs, self.num_returns,
         self.resources, self.strategy, self.max_retries,
         self.retry_exceptions, self.runtime_env, self.owner_id,
         self.owner_addr, self.actor_id, self.max_restarts,
         self.max_task_retries, self.max_concurrency, self.actor_name,
         self.namespace, self.get_if_exists, self.lifetime,
         self.attempt, self.concurrency_groups, self.timeout_s,
         self.trace) = s

    def clone(self) -> "TaskSpec":
        """Shallow copy with its own SchedulingStrategy. The controller
        mutates specs it accepts (attempt, max_retries, pg_bundle_index);
        over the in-process transport the submitter's live object arrives, so
        ingestion points clone to keep owner-side state (lineage specs,
        shared strategy objects) isolated."""
        new = object.__new__(TaskSpec)
        new.__setstate__(self.__getstate__())
        s = self.strategy
        ns = object.__new__(SchedulingStrategy)
        ns.__setstate__(s.__getstate__())
        new.strategy = ns
        return new

    # Strategy shared by every actor-call spec: actor tasks never visit the
    # scheduler (they ride the actor pipe straight to the bound worker), so
    # nothing ever mutates it.
    _ACTOR_CALL_STRATEGY: ClassVar["SchedulingStrategy"] = None  # set below

    @classmethod
    def for_actor_call(cls, task_id: str, method_name: str, args, kwargs,
                       num_returns: int, name: str, owner_id: str,
                       owner_addr, actor_id: str, attempt: int = 0,
                       trace: Optional[tuple] = None) -> "TaskSpec":
        """Cheap constructor for the actor hot path: skips dataclass default
        factories (~3us/call at n:n rates) and shares one strategy object."""
        sp = object.__new__(cls)
        sp.task_id = task_id
        sp.kind = ACTOR_TASK
        sp.name = name
        sp.function_id = ""
        sp.method_name = method_name
        sp.args = args
        sp.kwargs = kwargs
        sp.num_returns = num_returns
        sp.resources = {}
        sp.strategy = cls._ACTOR_CALL_STRATEGY
        sp.max_retries = 0
        sp.retry_exceptions = False
        sp.runtime_env = {}
        sp.owner_id = owner_id
        sp.owner_addr = owner_addr
        sp.actor_id = actor_id
        sp.max_restarts = 0
        sp.max_task_retries = 0
        sp.max_concurrency = 1
        sp.actor_name = None
        sp.namespace = "default"
        sp.get_if_exists = False
        sp.lifetime = None
        sp.attempt = attempt
        sp.concurrency_groups = None
        sp.timeout_s = None
        sp.trace = trace
        return sp

    _NORMAL_CALL_STRATEGY: ClassVar["SchedulingStrategy"] = None  # set below

    def task_call_tuple(self) -> tuple:
        """Compact wire record for direct-path `exec_tasks` frames (the
        owner-side leased dispatch): frame-constant fields — owner, the
        class's resources/strategy — ride once per frame; the full 24-field
        spec pickle costs ~3x this on encode+decode at direct-dispatch
        rates. Executor-side counterpart: `leased_task_spec`. The trailing
        trace context rides ONLY when sampled — traceless records keep the
        11-field pre-tracing arity (byte-identical off, pinned by test)."""
        call = (self.task_id, self.function_id, self.name, self.args,  # rtcheck: wire=exec_tasks.call
                self.kwargs, self.num_returns, self.max_retries,
                self.retry_exceptions, self.runtime_env or None, self.attempt,
                self.timeout_s, self.trace)
        return call if self.trace is not None else call[:11]

    @classmethod
    def for_normal_call(cls, call: tuple, owner_id: str, owner_addr,
                        resources: dict) -> "TaskSpec":
        """Rebuild an executor-side NORMAL spec from a `task_call_tuple`
        wire record (cheap constructor, same shape as for_actor_call)."""
        if len(call) == 10:  # pre-'timeout_s' wire records
            call = call + (None,)
        if len(call) == 11:  # traceless records (and pre-'trace' senders)
            call = call + (None,)
        (task_id, function_id, name, args, kwargs, num_returns, max_retries,  # rtcheck: wire=exec_tasks.call
         retry_exceptions, runtime_env, attempt, timeout_s, trace) = call
        sp = object.__new__(cls)
        sp.task_id = task_id
        sp.kind = NORMAL
        sp.name = name
        sp.function_id = function_id
        sp.method_name = ""
        sp.args = args
        sp.kwargs = kwargs
        sp.num_returns = num_returns
        sp.resources = resources
        # The executor never schedules a leased spec: share one strategy.
        sp.strategy = cls._NORMAL_CALL_STRATEGY
        sp.max_retries = max_retries
        sp.retry_exceptions = retry_exceptions
        sp.runtime_env = runtime_env or {}
        sp.owner_id = owner_id
        sp.owner_addr = owner_addr
        sp.actor_id = None
        sp.max_restarts = 0
        sp.max_task_retries = 0
        sp.max_concurrency = 1
        sp.actor_name = None
        sp.namespace = "default"
        sp.get_if_exists = False
        sp.lifetime = None
        sp.attempt = attempt
        sp.concurrency_groups = None
        sp.timeout_s = timeout_s
        sp.trace = trace
        return sp

    def actor_call_tuple(self) -> tuple:
        """Compact wire record for `actor_calls` frames — the full 24-field
        spec pickle costs ~9us/call encode+decode and 293B; this is ~1/3 of
        both. Frame-constant fields (owner, actor id) ride once per frame.
        The trace context rides only when sampled (see task_call_tuple)."""
        call = (self.task_id, self.method_name, self.args, self.kwargs,  # rtcheck: wire=actor_calls.call
                self.num_returns, self.name, self.attempt, self.trace)
        return call if self.trace is not None else call[:7]

    def ref_arg_oids(self) -> list[str]:
        """Oids of by-reference arguments — the single place that knows the
        ('ref', oid) arg wire encoding (used by locality scheduling and
        executor-side prefetch). DEVICE_REF ('dref') args are deliberately
        excluded: their placeholder already names the producer, so a
        controller-backed prefetch/locality probe would be a wasted round
        trip — resolution pulls peer-to-peer at decode time."""
        out = []
        for a in self.args or ():
            if isinstance(a, (tuple, list)) and a and a[0] == "ref":
                out.append(a[1])
        for a in (self.kwargs or {}).values():
            if isinstance(a, (tuple, list)) and a and a[0] == "ref":
                out.append(a[1])
        return out

    def return_object_ids(self) -> list[str]:
        # Object id hex = task id hex + 4B little-endian return index hex
        # (ids.ObjectID.for_task_return) — derivable by string concat, which
        # matters: this runs once per call on both submitter and executor.
        n = self.num_returns
        if n == 1:
            return [self.task_id + "00000000"]
        if n == STREAMING:
            # Streaming generator (reference core_worker.proto:478
            # ReportGeneratorItemReturns): item oids use indices 0..k-1 as
            # they are yielded; the single declared return is the COMPLETION
            # sentinel at the reserved max index. It resolves to the item
            # count on success (or the stream's error), so every existing
            # submit/retry/cancel/failure path that touches "the task's
            # return ids" drives the generator's end-of-stream for free.
            return [self.task_id + "ffffffff"]
        tid = self.task_id
        return [tid + i.to_bytes(4, "little").hex() for i in range(n)]


TaskSpec._ACTOR_CALL_STRATEGY = SchedulingStrategy()
TaskSpec._NORMAL_CALL_STRATEGY = SchedulingStrategy()


def actor_call_spec(call: tuple, owner_id: str, owner_addr, actor_id: str) -> TaskSpec:
    """Rebuild an executor-side spec from an `actor_calls` wire record."""
    if len(call) == 7:  # traceless records (and pre-'trace' senders)
        call = call + (None,)
    task_id, method_name, args, kwargs, num_returns, name, attempt, trace = call  # rtcheck: wire=actor_calls.call
    return TaskSpec.for_actor_call(
        task_id, method_name, args, kwargs, num_returns, name,
        owner_id, tuple(owner_addr) if owner_addr else None, actor_id,
        attempt=attempt, trace=trace)
