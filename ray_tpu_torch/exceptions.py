"""Exception hierarchy for the ray_tpu_torch runtime.

Parity target: ray/exceptions.py in the reference (RayError, RayTaskError,
RayActorError, ObjectLostError, GetTimeoutError, ...). Re-designed minimal set
for the TPU-native runtime.

Counterpart: ray_tpu/exceptions.py (copied).
"""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for all ray_tpu_torch runtime errors."""


class TaskError(RayTpuError):
    """Wraps an exception raised inside a remote task/actor method.

    Mirrors the reference's RayTaskError (python/ray/exceptions.py): the remote
    traceback is captured as text and re-raised at `get()` on the caller.
    """

    def __init__(self, function_name: str, traceback_str: str, cause: Exception | None = None):
        self.function_name = function_name
        self.traceback_str = traceback_str
        self.cause = cause
        super().__init__(
            f"Remote task {function_name!r} failed:\n{traceback_str}"
        )


class OutOfMemoryError(RayTpuError):
    """The node memory monitor killed a worker to relieve memory pressure
    (reference ray.exceptions.OutOfMemoryError, memory_monitor.h +
    worker_killing_policy.h)."""


class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died unexpectedly."""


class ActorError(RayTpuError):
    """Base for actor-related failures."""


class ActorDiedError(ActorError):
    """The actor is dead (crashed, killed, or out of restarts).

    Parity: reference RayActorError / ActorDiedError.
    """


class ActorUnavailableError(ActorError):
    """The actor is temporarily unreachable (e.g. restarting)."""


class ObjectLostError(RayTpuError):
    """Object's value was lost (all copies gone) and could not be reconstructed."""


class ObjectReconstructionError(ObjectLostError):
    """Lineage reconstruction failed (e.g. non-retryable parent task)."""


class OwnerDiedError(ObjectLostError):
    """The owner process of this object died, so the object is unrecoverable."""


class TaskCancelledError(RayTpuError):
    """The task was cancelled via ray_tpu_torch.cancel() (reference TaskCancelledError;
    cancel RPC core_worker.proto:492)."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """`get()` timed out. The message carries the producing task's status
    (queued/running, node, seconds since its last progress beacon) when the
    runtime can attribute it — the first question a stalled-get user asks."""


class TaskTimeoutError(RayTpuError, TimeoutError):
    """A task exceeded its per-attempt execution deadline
    (`@remote(timeout_s=...)`). Enforced worker-side; treated as a system
    failure, so the attempt retries under `max_retries` before this
    surfaces at `get()`."""


class CollectiveTimeoutError(RayTpuError, TimeoutError):
    """A host-tier collective op (util.collective) exceeded its per-op
    deadline (RT_COLLECTIVE_TIMEOUT_S) — typically a ring wedged on a sick
    peer. The message names the op, group, rank, and the peer the op was
    waiting on."""


def _rebuild_back_pressure_error(message, deployment, reason, queued,
                                 retry_after_s):
    return BackPressureError(message, deployment=deployment, reason=reason,
                             queued=queued, retry_after_s=retry_after_s)


class BackPressureError(RayTpuError):
    """A serve request was shed by admission control instead of queued
    unboundedly (README "Overload & admission control").

    Raised from the router when a deployment's bounded queue is full
    (`reason="queue_full"`), when a queued request could not be assigned
    before its `queue_deadline_s` (`reason="deadline"`), from the HTTP
    proxy's per-route token bucket (`reason="rate_limit"`), or replica-side
    when a request lands on a replica already at `max_ongoing_requests`
    (`reason="replica_busy"` — a cross-router race; routers retry these
    against other replicas). `retry_after_s` is the shed's retry hint — the
    proxy surfaces it as an HTTP `Retry-After` header on the 429/503.
    """

    def __init__(self, message: str, *, deployment: str | None = None,
                 reason: str = "queue_full", queued: int = 0,
                 retry_after_s: float = 1.0):
        self.deployment = deployment
        self.reason = reason
        self.queued = queued
        self.retry_after_s = retry_after_s
        super().__init__(message)

    def __reduce__(self):
        return (_rebuild_back_pressure_error,
                (str(self), self.deployment, self.reason, self.queued,
                 self.retry_after_s))


def _rebuild_dag_stage_error(message, stage, node, invocation, traceback_str):
    return DagStageError(message, stage=stage, node=node,
                         invocation=invocation, traceback_str=traceback_str)


class DagStageError(RayTpuError):
    """A compiled-DAG stage failed or died (README "Compiled graphs").

    Raised on `DagRef.get()` for the invocation(s) the failure covers:
    either the stage's user code raised (the remote traceback is carried in
    `traceback_str`), or the stage process/actor died mid-steady-state (the
    compiled driver's liveness monitor attributes the death). `stage` names
    the failed stage, `node` the node it ran on when known, `invocation`
    the in-flight sequence number the error was delivered for.
    """

    def __init__(self, message: str, *, stage: str | None = None,
                 node: str | None = None, invocation: int | None = None,
                 traceback_str: str | None = None):
        self.stage = stage
        self.node = node
        self.invocation = invocation
        self.traceback_str = traceback_str
        super().__init__(message)

    def __reduce__(self):
        return (_rebuild_dag_stage_error,
                (str(self), self.stage, self.node, self.invocation,
                 self.traceback_str))


def _rebuild_data_spill_error(message, uri, partition, op):
    return DataSpillError(message, uri=uri, partition=partition, op=op)


class DataSpillError(RayTpuError):
    """An exchange shard could not be spilled to — or restored from — the
    storage plane (README "Data plane").

    Raised from the exchange's merge/reduce tasks after the bounded
    transient-retry budget is exhausted (e.g. a severed `sim://` spill
    backend): the shuffle fails attributed, never hangs. `uri` names the
    shard that failed, `partition` the reduce partition it belonged to,
    `op` whether the failure was on the `spill` (write) or `restore`
    (read) side.
    """

    def __init__(self, message: str, *, uri: str | None = None,
                 partition: int | None = None, op: str | None = None):
        self.uri = uri
        self.partition = partition
        self.op = op
        super().__init__(message)

    def __reduce__(self):
        return (_rebuild_data_spill_error,
                (str(self), self.uri, self.partition, self.op))


class RuntimeEnvSetupError(RayTpuError):
    """Setting up the runtime environment for a task/actor failed."""


class PendingCallsLimitExceeded(RayTpuError):
    """Actor's pending call queue exceeded max_pending_calls."""


class NodeDiedError(RayTpuError):
    """The node hosting the resource died."""
