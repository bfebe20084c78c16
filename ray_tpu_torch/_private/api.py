"""The runtime's public API, which `ray_tpu_torch/__init__.py` loads on
first use (so importing the models or kernels starts no runtime module).

Counterpart: ray_tpu/__init__.py. Public API parity target: reference
python/ray/_private/worker.py (init:1286, shutdown:1931, get:2718,
put:2854, wait:2919, remote:3407). The accelerator option is `num_gpus`.
"""

from __future__ import annotations

import atexit
import logging
import os
import threading
from typing import Any, Iterable, Sequence

from ray_tpu_torch import exceptions  # noqa: F401
from ray_tpu_torch._private.bootstrap import HeadNode
from ray_tpu_torch._private.rtconfig import CONFIG
from ray_tpu_torch._private.worker import (
    ObjectRef,
    ObjectRefGenerator,
    Worker,
    global_worker,
    set_global_worker,
)
from ray_tpu_torch.actor import ActorClass, ActorHandle, get_actor, kill, method  # noqa: F401
from ray_tpu_torch.remote_function import RemoteFunction

logger = logging.getLogger(__name__)

_head: HeadNode | None = None
_init_lock = threading.Lock()
_config_baseline: dict | None = None


def is_initialized() -> bool:
    return global_worker() is not None


def init(
    address: str | None = None,
    *,
    num_cpus: float | None = None,
    num_gpus: float | None = None,
    resources: dict[str, float] | None = None,
    labels: dict[str, str] | None = None,
    namespace: str = "default",
    runtime_env: dict | None = None,
    ignore_reinit_error: bool = False,
    log_to_driver: bool = True,
    _system_config: dict | None = None,
    _worker_env: dict | None = None,
):
    """Start (or connect to) a cluster and attach this process as the driver.

    With no `address`, brings up an in-process head (controller + node agent,
    cf. reference node.py:1437 start_head_processes) and a worker pool of
    subprocesses. With `address="host:port"`, connects to a running cluster
    (started via `ray-tpu start --head`).
    """
    global _head
    with _init_lock:
        if global_worker() is not None:
            if ignore_reinit_error:
                return
            raise RuntimeError("ray_tpu_torch.init() called twice; use shutdown() first.")
        global _config_baseline
        # Save the OVERRIDE table, not the resolved values: restoring the
        # full resolved snapshot would freeze every flag as an override and
        # silently disable RT_* env resolution for the rest of the process.
        _config_baseline = dict(CONFIG._overrides)
        CONFIG.apply_system_config(_system_config)
        if CONFIG.fault_injection:
            # Chaos-test gate: must flip on BEFORE the head/agent/worker
            # connections are created so the injector tracks them.
            from ray_tpu_torch._private import rpc as _rpc

            _rpc.enable_fault_injection()
        if address is None:
            # Submitted jobs inherit the cluster address from their runner
            # (reference: RAY_ADDRESS set by the job supervisor).
            address = os.environ.get("RT_ADDRESS") or None
        if address is None:
            _head = HeadNode(
                num_cpus=num_cpus,
                num_gpus=num_gpus,
                resources=resources,
                labels=labels,
                worker_env=_worker_env,
            )
            controller_addr = _head.start()
            session_id = _head.session_id
        else:
            host, port = address.rsplit(":", 1)
            controller_addr = (host, int(port))
            # Session id is learned from the controller at register time.
            session_id = "remote"
        w = Worker(mode="driver", session_id=session_id, controller_addr=controller_addr)
        w.connect()
        if address is not None:
            # Adopt the cluster's session id for the shared shm namespace.
            rep = w.io.run(w.controller.call("ping"))
            w.session_id = rep["session_id"]
            w.store.session = rep["session_id"][:8]
        w.namespace = namespace
        if log_to_driver:
            try:
                w.io.run(w.controller.call("subscribe_logs", on=True), timeout=10)
            except Exception:
                pass
        set_global_worker(w)
        atexit.register(shutdown)
        return w


def shutdown():
    global _head, _config_baseline
    w = global_worker()
    if w is not None:
        w.disconnect()
    if _head is not None:
        _head.stop()
        _head = None
    # Session-scoped fault injection dies with the session (env-gated
    # injection is process-scoped and stays): stale rules must not apply
    # to a later init() that never asked for injection.
    if CONFIG.fault_injection and not os.environ.get("RT_FAULT_INJECTION"):
        from ray_tpu_torch._private import rpc as _rpc

        _rpc.disable_fault_injection()
    # _system_config overrides are session-scoped: restore the pre-init
    # override table so the next init() in this process starts clean.
    if _config_baseline is not None:
        try:
            CONFIG._overrides.clear()
            CONFIG._overrides.update(_config_baseline)
            # The cluster snapshot received at registration is session
            # state too: a later init() against a different cluster must
            # not inherit this one's resolved table.
            CONFIG._snapshot.clear()
        except Exception:
            pass
        _config_baseline = None
    try:
        atexit.unregister(shutdown)
    except Exception:
        pass


def _require_worker() -> Worker:
    w = global_worker()
    if w is None:
        raise RuntimeError("ray_tpu_torch.init() has not been called.")
    return w


def remote(*args, **options):
    """@remote decorator for functions and classes (reference worker.py:3407)."""
    import inspect

    def decorate(obj):
        if inspect.isclass(obj):
            return ActorClass(obj, options)
        return RemoteFunction(obj, options)

    if len(args) == 1 and not options and (inspect.isfunction(args[0]) or inspect.isclass(args[0])):
        return decorate(args[0])
    if args:
        raise TypeError("@remote takes keyword options only, e.g. @remote(num_cpus=2)")
    return decorate


def put(value) -> ObjectRef:
    return _require_worker().put(value)


def get(refs, timeout: float | None = None):
    w = _require_worker()
    if isinstance(refs, ObjectRef):
        return w.get([refs], timeout=timeout)[0]
    if not isinstance(refs, (list, tuple)):
        raise TypeError(f"get() expects an ObjectRef or list, got {type(refs)}")
    for r in refs:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"get() list must contain only ObjectRefs, got {type(r)}")
    return w.get(list(refs), timeout=timeout)


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: float | None = None,
    fetch_local: bool = True,
):
    w = _require_worker()
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    return w.wait(list(refs), num_returns=num_returns, timeout=timeout)


def cancel(ref, *, force: bool = False):
    """Cancel a queued or running task (reference ray.cancel,
    core_worker.proto:492 CancelTask). Non-force delivers KeyboardInterrupt
    to the executing worker and get() raises TaskCancelledError; force kills
    the worker process and get() raises WorkerCrashedError. Child tasks are
    not cancelled recursively. Accepts an ObjectRefGenerator to cancel a
    streaming task mid-stream."""
    w = _require_worker()
    if isinstance(ref, ObjectRefGenerator):
        return w.cancel_task(ref.task_id, force)
    return w.cancel_task(ref.task_id(), force)


def cluster_resources() -> dict[str, float]:
    return _require_worker().cluster_resources()["total"]


def available_resources() -> dict[str, float]:
    return _require_worker().cluster_resources()["available"]


def nodes() -> list[dict]:
    snap = _require_worker().state_snapshot()
    return [
        {"NodeID": nid, "Alive": n["alive"], "Resources": n["total"], "Labels": n["labels"]}
        for nid, n in snap["nodes"].items()
    ]


def timeline(filename: str | None = None) -> list[dict]:
    """Chrome-trace task timeline (reference ray.timeline(),
    _private/state.py:965): complete "X" events per task execution plus
    process/thread name metadata — opens directly in Perfetto /
    chrome://tracing. Pass filename to also write the JSON file."""
    w = _require_worker()
    rep = w.io.run(w.controller.call("get_task_events"), timeout=30)
    events = rep["events"]
    node_pid: dict[str, int] = {}
    trace: list[dict] = []
    seen_threads: set[tuple[int, int]] = set()
    for ev in events:
        pid = node_pid.setdefault(ev["node_id"], len(node_pid) + 1)
        tid = int(ev["pid"])
        if (pid, 0) not in seen_threads:
            seen_threads.add((pid, 0))
            trace.append({"ph": "M", "name": "process_name", "pid": pid,
                          "args": {"name": f"node {ev['node_id'][:8]}"}})
        if (pid, tid) not in seen_threads:
            seen_threads.add((pid, tid))
            trace.append({"ph": "M", "name": "thread_name", "pid": pid,
                          "tid": tid,
                          "args": {"name": f"worker {ev['worker_id'][:8]}"}})
        trace.append({
            "ph": "X",
            "name": ev["name"],
            "cat": ev["kind"],
            "pid": pid,
            "tid": tid,
            "ts": ev["start"] * 1e6,
            "dur": max(1.0, (ev["end"] - ev["start"]) * 1e6),
            "args": {"task_id": ev["task_id"], "attempt": ev["attempt"],
                     "ok": ev["ok"]},
        })
    if filename:
        import json as _json

        with open(filename, "w") as f:
            _json.dump(trace, f)
    return trace
