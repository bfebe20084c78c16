"""@remote functions.

Parity target: reference python/ray/remote_function.py (RemoteFunction:41,
_remote:308 — options resolution, pickling the function once by value) and
the `.options(...)` override pattern.

Counterpart: ray_tpu/remote_function.py (copied; the accelerator option is
num_gpus).
"""

from __future__ import annotations

import functools
from typing import Any

from ray_tpu_torch._private.resources import normalize_resources
from ray_tpu_torch._private.task_spec import SchedulingStrategy
from ray_tpu_torch._private.worker import global_worker


def _to_strategy(opt) -> SchedulingStrategy:
    if opt is None:
        return SchedulingStrategy()
    if isinstance(opt, SchedulingStrategy):
        return opt
    if isinstance(opt, str):
        if opt in ("DEFAULT", "SPREAD"):
            return SchedulingStrategy(kind=opt)
        raise ValueError(f"unknown scheduling strategy {opt!r}")
    # util.scheduling_strategies objects duck-type via to_internal()
    if hasattr(opt, "to_internal"):
        return opt.to_internal()
    raise TypeError(f"bad scheduling strategy {opt!r}")


_TASK_OPTION_KEYS = {
    "num_cpus", "num_gpus", "resources", "memory", "num_returns",
    "max_retries", "retry_exceptions", "scheduling_strategy", "name",
    "runtime_env", "placement_group", "placement_group_bundle_index",
    # Per-attempt execution deadline, enforced worker-side: an attempt
    # running past it is interrupted and retried under max_retries as a
    # system failure (TaskTimeoutError) — README "Stall detection".
    "timeout_s",
}


class RemoteFunction:
    def __init__(self, fn, options: dict[str, Any] | None = None):
        self._fn = fn
        self._options = dict(options or {})
        # Resolved (resources, strategy) computed once on first .remote():
        # options are immutable per instance (.options() returns a new one),
        # and re-normalizing them cost ~15us per call at submit rates.
        self._resolved = None
        functools.update_wrapper(self, fn)

    def bind(self, *args, **kwargs):
        """DAG-node binding (reference dag API / workflow steps): builds a
        lazy node whose args may be other bound nodes."""
        from ray_tpu_torch.workflow import bind as _wf_bind

        return _wf_bind(self, *args, **kwargs)

    def options(self, **overrides) -> "RemoteFunction":
        bad = set(overrides) - _TASK_OPTION_KEYS
        if bad:
            raise ValueError(f"Unknown task options: {sorted(bad)}")
        merged = dict(self._options)
        merged.update(overrides)
        return RemoteFunction(self._fn, merged)

    def remote(self, *args, **kwargs):
        w = global_worker()
        if w is None:
            raise RuntimeError("ray_tpu_torch.init() must be called before .remote()")
        o = self._options
        if self._resolved is None:
            resources = normalize_resources(
                num_cpus=o.get("num_cpus"),
                num_gpus=o.get("num_gpus"),
                resources=o.get("resources"),
                memory=o.get("memory"),
                default_cpus=1.0,
            )
            strategy = _to_strategy(o.get("scheduling_strategy"))
            pg = o.get("placement_group")
            if pg is not None:
                strategy = SchedulingStrategy(
                    kind="PLACEMENT_GROUP",
                    pg_id=pg.id if hasattr(pg, "id") else pg,
                    pg_bundle_index=o.get("placement_group_bundle_index", -1),
                )
            self._resolved = (resources, strategy)
        resources, strategy = self._resolved
        num_returns = o.get("num_returns", 1)
        refs = w.submit_task(
            self._fn,
            args,
            kwargs,
            name=o.get("name"),
            num_returns=num_returns,
            resources=resources,
            strategy=strategy,
            max_retries=o.get("max_retries"),
            retry_exceptions=o.get("retry_exceptions", False),
            runtime_env=o.get("runtime_env"),
            timeout_s=o.get("timeout_s"),
        )
        if num_returns == 1:
            return refs[0]
        return refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self._fn.__name__!r} cannot be called directly; "
            f"use {self._fn.__name__}.remote()."
        )
