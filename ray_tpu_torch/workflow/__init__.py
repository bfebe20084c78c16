"""ray_tpu_torch.workflow — durable workflows with exactly-once step memoization.

Parity target: reference python/ray/workflow (api.py run:123, resume;
workflow continuation/checkpoint semantics over a DAG of tasks). A
workflow is a DAG of `.bind()`ed remote functions; every step's result is
checkpointed to storage under a deterministic step key, so `resume()` (or
simply re-`run`ning the same workflow_id) skips completed steps — the
recovery contract that makes long pipelines restartable.

Step memoization rides the pluggable storage plane (`ray_tpu_torch/storage/`):
`init(storage=...)` accepts any backend URI (`local://`, `mem://`,
`sim://`, a bare path), and every step write is atomic on the backend —
a crash mid-write never half-memoizes a step.

Counterpart: ray_tpu/workflow/__init__.py (copied; the default store is
`~/ray_tpu_torch_workflows`).
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Any, Optional

import ray_tpu_torch
from ray_tpu_torch import storage as _st

_STORAGE = os.path.expanduser("~/ray_tpu_torch_workflows")


class DAGNode:
    """A bound (fn, args, kwargs) node; args may contain other DAGNodes."""

    def __init__(self, fn, args: tuple, kwargs: dict, name: str):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.name = name


def bind(remote_fn, *args, **kwargs) -> DAGNode:
    """workflow-step binding for a @ray_tpu_torch.remote function (also exposed
    as RemoteFunction.bind)."""
    inner = getattr(remote_fn, "_fn", remote_fn)
    return DAGNode(remote_fn, args, kwargs,
                   getattr(inner, "__name__", "step"))


def init(storage: Optional[str] = None):
    """Point the workflow store at a storage-plane URI (or local path)."""
    global _STORAGE
    if storage:
        _STORAGE = storage
    _st.makedirs(_STORAGE)


def _step_dir(workflow_id: str) -> str:
    return _st.join(_STORAGE, workflow_id, "steps")


def _hash_const(h, c):
    """Deterministic const digest. repr() is NOT enough: nested code
    objects embed memory addresses and frozenset element order follows
    per-process string-hash randomization — both would silently change a
    step's key on every fresh interpreter and defeat resume."""
    import types

    if isinstance(c, types.CodeType):
        h.update(b"\x01code")
        _hash_code(h, c)
    elif isinstance(c, (frozenset, set)):
        # Length prefix + per-element terminators: without them distinct
        # consts concatenate to identical digest streams ({1,2} vs {12}).
        h.update(b"\x01set%d" % len(c))
        for item in sorted(repr(i) for i in c):
            h.update(item.encode())
            h.update(b"\x00")
    elif isinstance(c, tuple):
        h.update(b"\x01tup%d" % len(c))
        for item in c:
            _hash_const(h, item)
    else:
        h.update(repr(c).encode())
        h.update(b"\x00")


def _hash_code(h, code):
    h.update(code.co_code)
    for c in code.co_consts:
        _hash_const(h, c)


def _step_key(node: DAGNode, child_keys: list[str]) -> str:
    """Deterministic content key: function CODE + literal args + child step
    keys. Same DAG -> same keys across runs, which is what memoization
    keys on; hashing the bytecode (not just the name) means EDITING a
    step's body invalidates its memoized results instead of silently
    replaying stale ones (reference content-addresses via checkpointed
    DAG state)."""
    h = hashlib.sha1()
    h.update(node.name.encode())
    inner = getattr(node.fn, "_fn", node.fn)
    code = getattr(inner, "__code__", None)
    if code is not None:
        _hash_code(h, code)
    for a in list(node.args) + sorted(node.kwargs.items()):
        if isinstance(a, DAGNode):
            continue  # covered by child_keys
        try:
            h.update(pickle.dumps(a))
        except Exception:
            h.update(repr(a).encode())
    for ck in child_keys:
        h.update(ck.encode())
    return f"{node.name}-{h.hexdigest()[:16]}"


def _run_node(node: Any, workflow_id: str, stats: dict):
    if not isinstance(node, DAGNode):
        return node, None
    child_keys = []
    args = []
    for a in node.args:
        v, ck = _run_node(a, workflow_id, stats)
        args.append(v)
        if ck:
            child_keys.append(ck)
    kwargs = {}
    for k, a in node.kwargs.items():
        v, ck = _run_node(a, workflow_id, stats)
        kwargs[k] = v
        if ck:
            child_keys.append(ck)
    key = _step_key(node, child_keys)
    path = _st.join(_step_dir(workflow_id), key + ".pkl")
    if _st.exists(path):
        stats["skipped"] += 1
        return pickle.loads(_st.get_bytes(path)), key
    value = ray_tpu_torch.get(node.fn.remote(*args, **kwargs), timeout=600)
    # Backend puts are atomic: a crash mid-write never half-memoizes.
    _st.put(path, pickle.dumps(value))
    stats["executed"] += 1
    return value, key


def run(dag: DAGNode, *, workflow_id: str) -> Any:
    """Execute the DAG durably; completed steps (from any earlier run of
    this workflow_id) are skipped (reference workflow.run + resume)."""
    init()
    stats = {"executed": 0, "skipped": 0}
    value, _ = _run_node(dag, workflow_id, stats)
    meta = {"workflow_id": workflow_id, "status": "SUCCESSFUL", **stats}
    _st.put(_st.join(_STORAGE, workflow_id, "result.pkl"),
            pickle.dumps({"value": value, "meta": meta}))
    return value


def resume(workflow_id: str, dag: Optional[DAGNode] = None) -> Any:
    """Re-drive a workflow: with the DAG, identical to run (memoization
    does the skipping); without it, return the stored final result."""
    if dag is not None:
        return run(dag, workflow_id=workflow_id)
    path = _st.join(_STORAGE, workflow_id, "result.pkl")
    if not _st.exists(path):
        raise ValueError(f"workflow {workflow_id!r} has no stored result; "
                         f"pass the DAG to resume execution")
    return pickle.loads(_st.get_bytes(path))["value"]


def get_status(workflow_id: str) -> Optional[dict]:
    path = _st.join(_STORAGE, workflow_id, "result.pkl")
    if not _st.exists(path):
        n = len(_st.listdir(_step_dir(workflow_id)))
        return {"workflow_id": workflow_id, "status": "RUNNING" if n else None,
                "steps_done": n}
    return pickle.loads(_st.get_bytes(path))["meta"]


def list_all() -> list[str]:
    return sorted(_st.listdir(_STORAGE))
