"""Actors: stateful remote workers.

Parity target: reference python/ray/actor.py (ActorClass:617,
ActorClass._remote:907, ActorHandle:1287, ActorMethod:116) — named actors,
max_restarts, get_if_exists; handles pickle across processes and re-resolve
via the controller (reference: actor table in GCS, gcs_actor_manager).

Counterpart: ray_tpu/actor.py (copied; the accelerator option is num_gpus).
"""

from __future__ import annotations

from typing import Any

from ray_tpu_torch._private.resources import normalize_resources
from ray_tpu_torch._private.task_spec import SchedulingStrategy
from ray_tpu_torch._private.worker import global_worker
from ray_tpu_torch.remote_function import _to_strategy

_ACTOR_OPTION_KEYS = {
    "num_cpus", "num_gpus", "resources", "memory", "name", "namespace",
    "get_if_exists", "max_restarts", "max_task_retries", "max_concurrency",
    "scheduling_strategy", "lifetime", "runtime_env", "placement_group",
    "placement_group_bundle_index", "concurrency_groups",
}


def method(*, concurrency_group: str | None = None, num_returns: int | None = None):
    """Method decorator (reference python/ray/actor.py @ray.method): tags an
    actor method with a concurrency group and/or return arity."""

    def deco(fn):
        if concurrency_group is not None:
            fn._rt_concurrency_group = concurrency_group
        if num_returns is not None:
            fn._rt_num_returns = num_returns
        return fn

    return deco


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str, num_returns: int = 1):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns

    def options(self, num_returns: int = 1):
        return ActorMethod(self._handle, self._name, num_returns)

    def remote(self, *args, **kwargs):
        w = global_worker()
        refs = w.submit_actor_task(
            self._handle._actor_id,
            self._name,
            args,
            kwargs,
            num_returns=self._num_returns,
            max_task_retries=self._handle._max_task_retries,
        )
        return refs[0] if self._num_returns == 1 else refs

    def bind(self, *args, **kwargs):
        """Compiled-graph binding of this EXISTING actor's method
        (reference actor.method.bind -> dag.DAGNode); compile() attaches a
        channel execution loop to the actor."""
        from ray_tpu_torch.dag import ActorMethodNode

        return ActorMethodNode(self._handle, self._name, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(f"Actor method {self._name!r} must be called with .remote().")


class ActorHandle:
    def __init__(self, actor_id: str, max_task_retries: int = 0,
                 method_meta: dict | None = None):
        self._actor_id = actor_id
        self._max_task_retries = max_task_retries
        # method name -> num_returns from @ray_tpu_torch.method(num_returns=...)
        # (introspected at ActorClass.remote; rides pickled handles).
        self._method_meta = method_meta or {}

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        # Cache in the instance dict: the next `handle.method` skips
        # __getattr__ (and the ActorMethod alloc) entirely — actor call
        # dispatch is a hot path.
        m = ActorMethod(self, name, self._method_meta.get(name, 1))
        self.__dict__[name] = m
        return m

    def __repr__(self):
        return f"ActorHandle({self._actor_id[:12]})"

    def __reduce__(self):
        # NB: cached ActorMethods in __dict__ are deliberately not pickled.
        return (ActorHandle,
                (self._actor_id, self._max_task_retries, self._method_meta))

    def __hash__(self):
        return hash(self._actor_id)

    def __eq__(self, other):
        return isinstance(other, ActorHandle) and other._actor_id == self._actor_id


class ActorClass:
    def __init__(self, cls, options: dict[str, Any] | None = None):
        self._cls = cls
        self._options = dict(options or {})

    def options(self, **overrides) -> "ActorClass":
        bad = set(overrides) - _ACTOR_OPTION_KEYS
        if bad:
            raise ValueError(f"Unknown actor options: {sorted(bad)}")
        merged = dict(self._options)
        merged.update(overrides)
        return ActorClass(self._cls, merged)

    def remote(self, *args, **kwargs) -> ActorHandle:
        w = global_worker()
        if w is None:
            raise RuntimeError("ray_tpu_torch.init() must be called before .remote()")
        o = self._options
        lifetime = o.get("lifetime")
        if lifetime not in (None, "detached", "non_detached"):
            raise ValueError(f"lifetime must be None, 'detached' or 'non_detached', got {lifetime!r}")
        # Non-detached actors fate-share with a driver/actor owner
        # (controller _reap_owned_actors); 'detached' opts out.
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
        actor_id = w.create_actor(
            self._cls,
            args,
            kwargs,
            name=o.get("name"),
            namespace=o.get("namespace", "default"),
            get_if_exists=o.get("get_if_exists", False),
            resources=resources,
            strategy=strategy,
            max_restarts=o.get("max_restarts", 0),
            max_task_retries=o.get("max_task_retries", 0),
            max_concurrency=o.get("max_concurrency", 1),
            concurrency_groups=o.get("concurrency_groups"),
            runtime_env=o.get("runtime_env"),
            actor_display_name=self._cls.__name__,
            lifetime=None if lifetime == "non_detached" else lifetime,
        )
        meta = {name: getattr(fn, "_rt_num_returns")
                for name, fn in vars(self._cls).items()
                if callable(fn) and hasattr(fn, "_rt_num_returns")}
        return ActorHandle(actor_id, max_task_retries=o.get("max_task_retries", 0),
                           method_meta=meta)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class {self._cls.__name__!r} cannot be instantiated directly; "
            f"use {self._cls.__name__}.remote()."
        )


def get_actor(name: str, namespace: str = "default") -> ActorHandle:
    w = global_worker()
    rep = w.io.run(w.controller.call("get_actor_info", name=name, namespace=namespace, wait=False))
    if rep["status"] != "ok":
        raise ValueError(f"Failed to look up actor {name!r} in namespace {namespace!r}")
    return ActorHandle(rep["actor_id"], max_task_retries=rep.get("max_task_retries", 0))


def kill(actor: ActorHandle, *, no_restart: bool = True):
    w = global_worker()
    w.kill_actor(actor._actor_id, no_restart=no_restart)
